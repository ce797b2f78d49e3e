"""Take the v5 banded-product kernel body apart on one card: rows 5 and 7
of the kernel table (``stencil_step_mxu_batched`` and
``stencil_step_mxu_k_local``, one template body) beside variants of the
body with one part removed, to see where its time goes.

    python3 tools/ab_mxu.py [--rounds N] CHECKOUT [CHECKOUT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each CHECKOUT is the root of a checkout of this repository (for instance
the parent commit unpacked with ``git archive`` into ``.scratch/parent``,
then ``.``); its ``src/repro_torch/kernels/csrc/squeeze_stencil.cu`` is
read, the body it holds is recognised (the tensor-core body issues
``mma.sync``; the body before it is one thread per window cell on the
CUDA cores), and each variant of that body is the source with one text
edit, built with the port's nvcc flags into its own library under
``build/ab_mxu/`` (all in parallel) and called through ctypes:

- ``shipped``: the source as it is;
- ``no-products``: both band products removed, the aggregate a cheap
  stand-in read from the window;
- ``no-rule``: ``Rule`` update removed, the aggregate written in its place;
- ``stage-store``: no substep at all, the windows staged and the centers
  stored;
- ``no-store`` (tensor-core body): the centers computed, never stored;
- ``no-reload`` (tensor-core body): each warp loads its first pair's
  blocks only and computes every later pair on them (neighbor ids still
  loaded);
- ``no-prefetch`` (tensor-core body): the next pair's blocks issued after
  this pair is done, into the same staging buffer;
- ``occupancy-3``, ``occupancy-4`` (tensor-core body): the kernel's
  launch bounds ask for 3 or 4 CTAs an SM (fewer registers a thread).

Only ``shipped`` computes the function; it is held against the plain
version bit for bit. The inputs are the main paths' (``chip_smoke.py``
phases 6 and 13): row 5 is LIFE over sierpinski r=16 m=2, B=4, k=2 with
the default packing; row 7 is shard 0's whole-domain pass of the
``dist-mxu`` engine over 4 shards at the same size (p2p exchange, B=4,
k=2). Every variant is timed at both on CUDA events, 10 launches a
reading, variants in turn and back (N rounds). One JSON line per result;
the card's name and power limit first, each library's registers and
spills (ptxas) next.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("src/repro_torch/kernels/csrc/squeeze_stencil.cu")
OUT = ROOT / "build" / "ab_mxu"

# ---- the body before the tensor cores: one thread per window cell -------
OLD_PRODUCTS_START = "    for (int term = 0; term < n_terms; ++term) {\n"
OLD_PRODUCTS_END = """#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (!cs.on[i]) continue;
      A agg[C];"""
OLD_STAND_IN = """#pragma unroll
    for (int i = 0; i < CPT; ++i)
      for (int c = 0; c < C; ++c)
        acc[i][c] = (float)cur[(cs.g[i] * C + c) * ww + cs.cell[i]];
"""
OLD_RULE = "      Rule::apply(tile, tile, cs.cell[i], ww, agg, cs.m[i], ra);\n"
OLD_SUBSTEPS_START = "  for (int j = 0; j < k; ++j) {\n    float acc[CPT][C];"
OLD_SUBSTEPS_END = ("  store_cells<Rule, CPT>(cs, cur, dst, blk0, nb, b, rho, "
                    "k);")

# ---- the tensor-core body ------------------------------------------------
NEW_PRODUCTS = ("      products1<X3>(f, lane, wc + c * 64, wc + (C + c) * 64, "
                "e[c]);\n")
NEW_STAND_IN = """      for (int i = 0; i < 4; ++i)
        e[c][i] = wc[((i >> 1) * C + c) * 64 + own + (i & 1)];
"""
NEW_RULE = re.compile(r"Rule::update\((\w), agg, m, ra, nx\);")
NEW_SUBSTEPS = "  for (int j = 0; j < gm.k; ++j) {\n"
NEW_BOUNDS = "__global__ void __launch_bounds__(kMxuWarps * 32)\n"
NEW_STORE = "  if (!cen) return;\n"
NEW_RELOAD = """    if (ahead)
      issue<Rule, H>(src, pc, stage + (buf ^ 1) * stage_step, nu, row_n,
                     first_in, gm, lane);
"""
NEW_PREFETCH = "    const bool ahead = NT == 1 && has_next;\n"
#: the centers' values still computed (a store they might reach), never
#: stored
NO_STORE = """  float keep = 0.f;
  for (int s = 0; s < 2; ++s)
    for (int c = 0; c < C; ++c) keep += st[s][c][0] + st[s][c][1];
  if (keep != -1.f || !cen) return;
"""


def _span(text: str, start: str, end: str, new: str) -> str:
    """``text`` with the span from ``start`` up to (not including)
    ``end`` replaced by ``new``; each marker must occur once."""
    for m in (start, end):
        if text.count(m) != 1:
            raise SystemExit(f"ab_mxu: the body no longer holds {m!r}")
    a = text.index(start)
    return text[:a] + new + text[text.index(end):]


def _swap(text: str, old: str, new: str, every: bool = False) -> str:
    """``text`` with ``old`` (which must occur once, or at least once when
    ``every``) replaced by ``new``."""
    n = text.count(old)
    if n != 1 and not (every and n):
        raise SystemExit(f"ab_mxu: the body no longer holds {old!r}")
    return text.replace(old, new)


def _sub(text: str, pattern, new: str) -> str:
    """``text`` with every match of ``pattern`` (at least one) replaced."""
    text, n = pattern.subn(new, text)
    if not n:
        raise SystemExit(f"ab_mxu: the body no longer holds {pattern!r}")
    return text


#: body -> variant -> the source's text -> the variant's
EDITS = {
    "cuda-cores": {
        "shipped": lambda t: t,
        "no-products": lambda t: _span(
            t, OLD_PRODUCTS_START, OLD_PRODUCTS_END, OLD_STAND_IN),
        "no-rule": lambda t: _swap(
            t, OLD_RULE, "      tile[cs.cell[i]] = (T)(agg[0] * cs.m[i]);\n"),
        "stage-store": lambda t: _span(t, OLD_SUBSTEPS_START,
                                       OLD_SUBSTEPS_END, ""),
    },
    "tensor-cores": {
        "shipped": lambda t: t,
        "no-products": lambda t: _swap(t, NEW_PRODUCTS, NEW_STAND_IN),
        "no-rule": lambda t: _sub(
            t, NEW_RULE, "for (int c = 0; c < C; ++c) nx[c] = agg[c] * m;"),
        "stage-store": lambda t: _swap(
            t, NEW_SUBSTEPS, "  for (int j = 0; j < 0; ++j) {\n",
            every=True),
        "no-store": lambda t: _swap(t, NEW_STORE, NO_STORE),
        "no-reload": lambda t: _swap(t, NEW_RELOAD, ""),
        "no-prefetch": lambda t: _swap(t, NEW_PREFETCH,
                                       "    const bool ahead = false;\n"),
        "occupancy-3": lambda t: _swap(
            t, NEW_BOUNDS, NEW_BOUNDS.replace("32)", "32, 3)")),
        "occupancy-4": lambda t: _swap(
            t, NEW_BOUNDS, NEW_BOUNDS.replace("32)", "32, 4)")),
    },
}


def body_of(text: str) -> str:
    return "tensor-cores" if "mma.sync" in text else "cuda-cores"


def build_variants(build, checkouts):
    """{(tag, variant): (library, ptxas summary)} for every checkout."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, co in enumerate(checkouts):
        text = (co / CU).read_text()
        body = body_of(text)
        for name, edit in EDITS[body].items():
            tag = f"{i}:{body}"
            stem = f"{i}-{body}-{name}"
            cu = OUT / f"{stem}.cu"
            cu.write_text(edit(text))
            procs[(tag, name)] = (stem, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                 str(OUT / f"{stem}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ab_mxu: {stem} failed to build:\n{log}")
        libs[key] = (ctypes.CDLL(str(OUT / f"{stem}.so")), ptxas(log))
    return libs


def ptxas(log: str) -> dict:
    """{mxu kernel instance: "registers/spill bytes"} from nvcc's log."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = {}
    for e in chip_smoke.ptxas_summary(log):
        if "mxu" not in e["entry"]:
            continue
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        out[e["entry"][:40]] = (f"{regs.group(1) if regs else '?'}/"
                                f"{spill.group(1) if spill else 0}")
    return out


def main(argv) -> int:
    rounds = 2
    if argv[:1] == ["--rounds"]:
        rounds, argv = int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    checkouts = [Path(a).resolve() for a in argv]
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.core import fractals as F
    from repro_torch.core.compact import shared_layout
    from repro_torch.core.stencil import default_fusion_k, make_engine
    from repro_torch.kernels import build
    from repro_torch.kernels import squeeze_stencil as sk
    from repro_torch.workloads import rules as R
    if not torch.cuda.is_available():
        print("ab_mxu: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    libs = build_variants(build, checkouts)
    for (tag, name), (_, summary) in libs.items():
        print(json.dumps({"build": tag, "variant": name,
                          "ptxas": summary}), flush=True)

    frac, r, m = F.SIERPINSKI, 16, 2
    lay = shared_layout(frac, r, m)
    k = default_fusion_k(lay.rho)
    wl = R.LIFE
    single = make_engine("cuda-mxu", frac, r, m, workload=wl)
    states = torch.stack([single.init_random(i) for i in range(4)])
    dist = make_engine("dist-mxu", frac, r, m, workload=wl, n_shards=4,
                       exchange="p2p")
    s5, halo, ex = dist.local_inputs(dist.from_dense(states), k)
    stream = torch.cuda.current_stream().cuda_stream
    tail = sk._rule_args(wl, stream)
    rule = sk._rule(wl)

    rm, cm = sk._mxu_operators_on(wl, lay.rho + 2 * k, "cuda")

    def geometry(tag, p, pieces):
        """The C arguments after P and their types: the tensor-core body
        takes mxu_plan's (nt, spw, warps), the body before none."""
        if tag.endswith("cuda-cores"):
            return [], []
        plan = sk.mxu_plan(torch.uint8, 1, lay.rho, k, p, pieces)
        return [plan.nt, plan.spw, plan.warps], [ctypes.c_int] * 3

    def launch(f, name, args, tag, p, pieces):
        extra, types = geometry(tag, p, pieces)
        sig = sk._SIGNATURES[name]
        n = len(args)
        f.argtypes = sig[:n] + types + sig[len(sig) - len(tail):]
        rc = f(*args, *extra, *tail)
        if rc:
            raise RuntimeError(f"{name}: launch failed with error {rc}")

    def row5(lib, tag, out):
        p = lay.macro_tiles(k)[0]
        launch(lib.sq_stencil_step_mxu, "sq_stencil_step_mxu",
               [rule, states.data_ptr(), out.data_ptr(),
                lay.device_table("neighbor_table", "cuda").data_ptr(),
                lay.device_table("window_mask", "cuda", k).data_ptr(),
                rm.data_ptr(), cm.data_ptr(), rm.shape[0], lay.n_blocks, 4,
                lay.rho, k, p], tag, p, False)

    def row7(lib, tag, out):
        p = lay.macro_tiles_for(s5.shape[2], k)[0]
        launch(lib.sq_stencil_step_mxu_k_local,
               "sq_stencil_step_mxu_k_local",
               [rule, s5.data_ptr(), out.data_ptr(),
                *(h.data_ptr() for h in halo), ex.data_ptr(),
                lay.device_table("window_mask", "cuda", k).data_ptr(),
                rm.data_ptr(), cm.data_ptr(), rm.shape[0], s5.shape[2], 4,
                lay.rho, k, p], tag, p, True)

    rows = {"row5": (row5, states, lambda: sk.stencil_step_mxu_batched_plain(
                lay, states, wl, k=k)),
            "row7": (row7, s5, lambda: sk.stencil_step_mxu_k_local_plain(
                lay, s5, halo, ex, wl, k=k))}
    print(json.dumps({"shapes": {n: list(x.shape) for n, (_, x, _) in
                                 rows.items()}, "k": k}), flush=True)
    for rname, (call, x, plain) in rows.items():
        want = plain()
        for (tag, name), (lib, _) in libs.items():
            if name != "shipped":
                continue
            out = torch.empty_like(x)
            call(lib, tag, out)
            torch.cuda.synchronize()
            err = int((out.int() - want.int()).abs().max())
            print(json.dumps({"check": rname, "build": tag,
                              "max_abs_err": err}), flush=True)
            if err:
                return 1
        del want
    times = {key: {n: [] for n in rows} for key in libs}
    order = list(libs)
    outs = {n: torch.empty_like(x) for n, (_, x, _) in rows.items()}
    for _ in range(rounds):
        for key in order + order[::-1]:
            for rname, (call, _, _) in rows.items():
                times[key][rname].append(cs.cuda_ms(
                    torch, lambda: call(libs[key][0], key[0], outs[rname]),
                    10))
    for (tag, name), t in times.items():
        print(json.dumps({"build": tag, "variant": name, "ms": t}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
