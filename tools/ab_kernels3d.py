"""Time the two 3D stencil kernels of several checkouts on one card, and take
their bodies apart: rows 8 (``stencil3d_step_fused_k``) and 9
(``stencil3d_step_mxu_k``) of the kernel table beside variants of each
body with one part removed, to see where its time goes.

    python3 tools/ab_kernels3d.py [--rounds N] [--shipped] CHECKOUT [...]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each CHECKOUT is the root of a checkout of this repository (for instance
the parent commit unpacked with ``git archive`` into ``.scratch/parent``,
then ``.``). Its ``src/repro_torch/kernels/csrc/squeeze_stencil3d.cu`` is
read and the body it holds is recognised: the CTA body (``step3_kernel``
alone: 256 threads stride over the cells of G windows in shared memory,
barrier-joined phases) or the bodies that replaced it on windows of w <=
16 (``column_kernel`` for row 8: a thread a window column, its cells in
registers; ``tc_kernel`` for row 9: a warp a window plane, the banded
products on the tensor cores). Each variant of that body is the source
with one text edit, built with the port's nvcc flags into its own library
under ``build/ab_kernels3d/`` (all builds in parallel):

- ``shipped``: the source as it is;
- ``stage-store``: no substep at all, the windows staged and the centers
  stored;
- ``no-rule``: the rule removed, the aggregate (times the mask) written
  in its place;
- ``no-mask``: every cell's mask 1 (no mask built or read);
- ``ids-only``: the neighbor ids loaded and the centers stored, no block
  staged and no substep;
- ``no-stage``: the substeps on the first window's staged cells, no block
  staged after it (what the loads cost beside the arithmetic).

``--shipped`` builds the shipped source only. Each checkout is then timed
in a process of its own, which imports that checkout's port and calls
each library through its own wrapper (``squeeze_stencil3d._c_function``
pointed at the variant's library), so that entries whose C arguments
differ between checkouts are each called as their checkout calls them.
The inputs are the 3D main path's (``chip_smoke.py`` phase 10): the
Menger sponge r=6 m=2 (rho=9, 160,000 blocks), one simulation of LIFE3D
and of HEAT3D at the default depth k=3. Only ``shipped`` computes the
function; it is held against the plain version (row 8 bit for bit, row 9
exactly for LIFE3D and within rtol = atol = 1e-5 for HEAT3D). Every
variant is timed on CUDA events, 10 launches a reading, the variants in
turn and back (N rounds, default 2; 0 checks only). One JSON line per
result: the card's name and power limit first, each library's registers
and spills (ptxas) next, then per checkout the ms of every reading and
its median.
"""
from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CU = Path("src/repro_torch/kernels/csrc/squeeze_stencil3d.cu")
OUT = ROOT / "build" / "ab_kernels3d"
KERNELS = ("fused", "mxu")

# ---- the CTA body: 256 threads over G windows in shared memory ----------
CTA_SUBSTEPS = "    for (int j = 1; j <= k; ++j) {\n      const int span"
CTA_RULE = "        nxt[(size_t)g * www + cell] = Rule::apply(tile[cell], agg, m, ra);\n"
CTA_NO_RULE = "        nxt[(size_t)g * www + cell] = (T)(agg * m);\n"
CTA_MASK = ("        const int m = wm[cell] * (d == kSelf || ids[g * kIds + d] "
            "< nb);\n")
CTA_STAGE = "    for (int t = threadIdx.x; t < slots * www; t += blockDim.x) {\n"

# ---- the column and tensor-core bodies ----------------------------------
COL_SUBSTEPS = "    for (int j = 1; j <= gm.k; ++j) {  // column substeps\n"
COL_RULE = "    q[z] = Rule::cell(old, agg, (cmask >> z) & 1u, ra);\n"
COL_NO_RULE = "    q[z] = agg * (A)((cmask >> z) & 1u);\n"
COL_MASK = "    const unsigned cmask = column_mask(cl, ids, wmc, gm.nb);\n"
COL_LOAD = "    load_column<T, W>(src, nxt, cl, ids_n, itn.b, gm);\n"
TC_SUBSTEPS = "    for (int j = 1; j <= gm.k; ++j) {  // plane substeps\n"
TC_RULE = ("            u[i][4 * nt + c] =\n"
           "                Rule::tc_cell(u[i][4 * nt + c], e[i][nt][c], m, ra);\n")
TC_NO_RULE = "            u[i][4 * nt + c] = e[i][nt][c] * (float)m;\n"
TC_MASK = "            const unsigned m = mb >> (8 * i + 4 * nt + c) & 1u;\n"
TC_LOAD = "    load_column<T, 16>(src, nxt, cl, ids_n, itn.b, gm);\n"


def _swap(text: str, old: str, new: str) -> str:
    """``text`` with ``old`` (which must occur once) replaced by ``new``."""
    if text.count(old) != 1:
        raise SystemExit(f"ab_kernels3d: the body no longer holds {old!r}")
    return text.replace(old, new)


def _no_substeps(t: str, marker: str) -> str:
    return _swap(t, marker, marker.replace("j <= ", "j <= 0 * "))


def _new_edit(*pairs):
    """An edit of the column and tensor-core bodies: (marker, replacement)
    pairs."""
    def edit(t):
        for pair in pairs:
            t = _swap(t, *pair)
        return t
    return edit


#: the loads of the next item's columns into registers
NEXT_LOADS = ((COL_LOAD, ""), (TC_LOAD, ""))


#: body -> variant -> the source's text -> the variant's
EDITS = {
    "cta": {
        "shipped": lambda t: t,
        "stage-store": lambda t: _no_substeps(t, CTA_SUBSTEPS),
        "no-rule": lambda t: _swap(t, CTA_RULE, CTA_NO_RULE),
        "no-mask": lambda t: _swap(t, CTA_MASK, "        const int m = 1;\n"),
        "ids-only": lambda t: _no_substeps(_swap(
            t, CTA_STAGE, CTA_STAGE.replace("slots * www", "0")),
            CTA_SUBSTEPS),
        "no-stage": lambda t: _swap(
            t, CTA_STAGE, CTA_STAGE.replace("slots * www", "0")),
    },
    "new": {
        "shipped": lambda t: t,
        "stage-store": lambda t: _no_substeps(_no_substeps(
            t, COL_SUBSTEPS), TC_SUBSTEPS),
        "no-rule": _new_edit((COL_RULE, COL_NO_RULE), (TC_RULE, TC_NO_RULE)),
        "no-mask": _new_edit(
            (COL_MASK, "    const unsigned cmask = ~0u;\n"),
            (TC_MASK, "            const unsigned m = 1u;\n")),
        "ids-only": lambda t: _no_substeps(_no_substeps(_new_edit(
            *NEXT_LOADS)(t), COL_SUBSTEPS), TC_SUBSTEPS),
        "no-stage": _new_edit(*NEXT_LOADS),
    },
}


def body_of(text: str) -> str:
    return "new" if "column_kernel" in text else "cta"


def ptxas(log: str) -> dict:
    """{3D kernel instance: "registers/spill bytes"} from nvcc's log."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = {}
    for e in chip_smoke.ptxas_summary(log):
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        out[e["entry"][:56]] = (f"{regs.group(1) if regs else '?'}/"
                                f"{spill.group(1) if spill else 0}")
    return out


def build_variants(checkouts, shipped_only):
    """{checkout index: {variant: library path}}, every build started at
    once; prints each library's ptxas summary."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {}   # every edit first: a stale marker stops before any build
    for i, co in enumerate(checkouts):
        text = (co / CU).read_text()
        body = body_of(text)
        for name, edit in EDITS[body].items():
            if shipped_only and name != "shipped":
                continue
            sources[(i, name)] = (f"{i}-{body}-{name}", edit(text))
    procs = {}
    for key, (stem, text) in sources.items():
        cu = OUT / f"{stem}.cu"
        cu.write_text(text)
        procs[key] = (stem, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"{stem}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (i, name), (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ab_kernels3d: {stem} failed to build:\n{log}")
        libs.setdefault(i, {})[name] = str(OUT / f"{stem}.so")
        print(json.dumps({"build": stem, "ptxas": ptxas(log)}), flush=True)
    return libs


def measure(checkout: Path, libs: dict, rounds: int) -> int:
    """Check and time every variant of one checkout (run in a process of
    its own, which imports that checkout's port)."""
    sys.path.insert(0, str(checkout / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.core import compact3d, fractals3d
    from repro_torch.core.stencil import default_fusion_k
    from repro_torch.kernels import squeeze_stencil3d as k3
    from repro_torch.workloads import rules

    loaded = {n: ctypes.CDLL(p) for n, p in libs.items()}

    def use(name):
        def c_function(fn):
            f = getattr(loaded[name], fn)
            f.argtypes, f.restype = k3._SIGNATURES[fn], ctypes.c_int
            return f
        k3._c_function = c_function

    lay = compact3d.BlockLayout3D(fractals3d.REGISTRY3D["menger"], 6, 2)
    k = default_fusion_k(lay.rho)
    mask = lay.device_table("micro_mask", "cuda")
    fns = {"fused": k3.stencil3d_step_fused_k, "mxu": k3.stencil3d_step_mxu_k}
    rows = {}
    for wl in (rules.LIFE3D, rules.HEAT3D):
        g = torch.Generator(device="cuda")
        g.manual_seed(51)
        s = wl.init(g, (lay.n_blocks,) + (lay.rho,) * 3, "cuda")
        s = (s * mask.to(s.dtype)).contiguous()
        for kern in KERNELS:
            rows[f"{kern}/{wl.name}"] = (fns[kern], s, wl)
            use("shipped")
            got = fns[kern](lay, s, wl, k=k)
            want = getattr(k3, f"stencil3d_step_{kern}_k_plain")(
                lay, s, wl, k=k)
            diff = (got.double() - want.double()).abs()
            exact = kern == "fused" or wl.dtype == torch.uint8
            bound = 0.0 if exact else 1e-5 * (1 + want.double().abs())
            err = float(diff.max())
            print(json.dumps({"checkout": str(checkout),
                              "check": f"{kern}/{wl.name}",
                              "max_abs_err": err}), flush=True)
            if bool((diff > bound).any()):
                return 1
            del got, want, diff
    outs = {n: torch.empty_like(s) for n, (_, s, _) in rows.items()}
    times = {v: {n: [] for n in rows} for v in loaded}
    order = list(loaded)
    for _ in range(rounds):
        for v in order + order[::-1]:
            use(v)
            for n, (fn, s, wl) in rows.items():
                times[v][n].append(cs.cuda_ms(
                    torch, lambda: fn(lay, s, wl, k=k, out=outs[n]), 10))
    for v, t in times.items() if rounds else ():
        print(json.dumps({"checkout": str(checkout), "variant": v, "ms": t,
                          "median_ms": {n: statistics.median(x)
                                        for n, x in t.items()}}),
              flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return measure(Path(argv[1]), json.loads(argv[2]), int(argv[3]))
    rounds, shipped_only = 2, False
    while argv[:1] in (["--rounds"], ["--shipped"]):
        if argv[0] == "--rounds":
            rounds, argv = int(argv[1]), argv[2:]
        else:
            shipped_only, argv = True, argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("ab_kernels3d: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    checkouts = [Path(a).resolve() for a in argv]
    libs = build_variants(checkouts, shipped_only)
    rc = 0
    for i, co in enumerate(checkouts):
        rc |= subprocess.run([sys.executable, __file__, "--one", str(co),
                              json.dumps(libs[i]), str(rounds)]).returncode
    print(cs.nvidia_smi(), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
