"""Take the warp body of the 2D stencil kernels apart on one card: rows 4
and 6 of the kernel table (``stencil_step_fused_k``, v4, and
``stencil_step_fused_k_local``, kernel 6: one template body), rows 1 and 2
(``stencil_step_blocks``, v1, and ``stencil_step_strips``, v2, on the same
body at k = 1 where the checkout's entries take ``step_plan``'s W and
warps; v2 as the step alone and its strip gather) and row 3
(``stencil_step_fused``, v3: v4 at k = 1 where its entry takes
``fused_plan``'s W and warps, else the CTA body) beside variants of the
body with one part removed, to see where its time goes.

    python3 tools/ab_fused.py [--rounds N] CHECKOUT [CHECKOUT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each CHECKOUT is the root of a checkout of this repository (for instance
the parent commit unpacked with ``git archive`` into ``.scratch/parent``,
then ``.``); its ``src/repro_torch/kernels/csrc/squeeze_stencil.cu`` is
read, the body it holds is recognised (the warp body keeps each window
column in a lane's registers, ``warp_kernel``; the body before it is a
CTA of 256 threads over G windows in shared memory, ``step_kernel``), and
so is whether its entries take the plan's W and warps (``fused_plan``'s
for v4, kernel 6 and v3, ``step_plan``'s for v1 and v2: those of the
running checkout are passed where they do), and
each variant of that body is the source with one text edit, built with
the port's nvcc flags into its own library under ``build/ab_fused/``
(all in parallel) and called through ctypes:

- ``shipped``: the source as it is;
- ``stage-store``: no substep at all, the windows staged and the centers
  stored;
- ``no-rule``: the rule removed, the aggregate (times the mask) written
  in its place;
- ``no-mask``: every cell's mask 1 (no mask built or read);
- ``ids-only``: the neighbor ids (or existence rows) loaded and the
  centers stored, no block staged (after a warp's first group) and no
  substep;
- ``rows-only`` (a source whose v1 stages its blocks whole): v1 stages of
  each neighbor block only the loads that hold the rows its window reads,
  as v4 and v3 do;
- ``mask-existence`` (a source whose v3 runs the warp body at k = 1): v3's
  mask gated by the neighbors' existence as v4's at k >= 2 (one ballot of
  the neighbor ids a group), where the shipped body takes the center's
  bits alone;
- ``fixed-width`` (the same): the stagings' load widths fixed at 16 bytes
  when compiled (it computes the function only where the runs allow 16
  bytes, as at the shapes timed here, v1, v2 and v3 timed).

``shipped``, ``rows-only``, ``mask-existence`` and ``fixed-width`` compute
the function; each is held against the plain version bit for bit. The inputs are the main paths'
(``chip_smoke.py`` phases 6 and 13): row 4 is v4 over sierpinski r=16
m=2, B=1, k=2 with LIFE, and also with HEAT and GRAY_SCOTT; row 6 is shard
0's whole-domain pass of the ``dist-fused`` engine over 4 shards at the
same size (p2p exchange, LIFE, k=2,
``DistributedSqueezeEngine.local_inputs``); rows 1 and 2 are v1 and v2 at
the same size with LIFE and HEAT (rho = 4) and v1 with LIFE at r=16 m=3
(rho = 8), v2's strips gathered once, and v2's gather alone with LIFE and
HEAT (the library's gather kernel, or the plain PyTorch gather for a
source that has none, as the port had before it); row 3 is v3 at the same
size with LIFE and HEAT. Rows 1 and 2 (row 3) are timed for every variant
of a source whose v1 and v2 (v3) run the warp body, and for its
``shipped`` build only otherwise; each variant only at the rows it
changes. Every variant is timed at each on CUDA
events, 10 launches a reading, variants in turn and back (N rounds). One
JSON line per result; the card's name and power limit first, each
library's registers and spills (ptxas) next.
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
OUT = ROOT / "build" / "ab_fused"

# ---- the CTA body: 256 threads over G windows in shared memory ----------
CTA_SUBSTEPS = "  for (int j = 1; j <= k; ++j) {\n    const int lo = j,"
CTA_RULE = ("      Rule::apply(tile, nxt + (size_t)g * C * ww, y * w + x, ww, "
            "agg, m,\n                  ra);\n")
CTA_NO_RULE = ("      for (int c = 0; c < C; ++c)\n"
               "        nxt[((size_t)g * C + c) * ww + y * w + x] =\n"
               "            (typename Rule::T)(agg[c] * m);\n")
CTA_MASK = "      int m = cell_mask(wm, ids + g * 9, y, x, w, rho, k, nb);\n"
CTA_LOADS = ("    load_windows<Rule>(src, buf0, ids, slots, nb, b, rho, k);\n",
             "    load_pieces<Rule>(src, pc, buf0, slots, blk0, nb, b, rho, "
             "k);\n")

# ---- the warp body: a lane a window column, rows in registers -----------
WARP_SUBSTEPS = "  for (int j = 1; j <= k; ++j) {  // substeps\n"
WARP_RULE = "    Rule::cell(mid, agg, (colmask >> y) & 1u, ra, nx);\n"
WARP_NO_RULE = ("    for (int c = 0; c < C; ++c)\n"
                "      nx[c] = agg[c] * (A)((colmask >> y) & 1u);\n")
WARP_MASK = "    const unsigned colmask = column_mask(cm, e);\n"
WARP_STAGE = "    stage_column<Rule, W>(stage, off, gm.cstride, v);\n"
WARP_ISSUE = ("    issue_group<Rule, H, G>(src, pc, stage, it1, r1, olo, ohi, gm, "
              "lane);\n")
# v1 stages each neighbor block whole; rows-only: the loads [olo, ohi) of
# the rows its window reads, as v4's (the source before v3's k = 1 body)
WHOLE = ("            stage_tail(slot, from, 0, rho2, on ? rho2 : 0, gm.vin, "
         "gm.per,\n                       gm.per);\n")
ROWS = ("            stage_tail(slot, from, olo, ohi, on ? ohi : 0, gm.vin, "
        "gm.per,\n                       gm.per);\n")
ROWS_GATE = "  if (H == kInKernel && lane < 8 * G) {\n"
# the source whose v3 runs the warp body at k = 1 (KC = 1): its mask the
# center's bits alone at k = 1
K1_MASK = "  if (KC == 1) cm.dir[0] = cm.dir[1] = cm.dir[2] = 8;\n"
#: the functions whose staging load widths ``fixed-width`` fixes
WIDTH_FNS = ("__device__ __forceinline__ void issue_group(",
             "__device__ __forceinline__ void stage_run(")


def _swap(text: str, old: str, new: str, every: bool = False) -> str:
    """``text`` with ``old`` (which must occur once, or at least once when
    ``every``) replaced by ``new``."""
    n = text.count(old)
    if n != 1 and not (every and n):
        raise SystemExit(f"ab_fused: the body no longer holds {old!r}")
    return text.replace(old, new)


def _no_substeps(t: str, marker: str) -> str:
    return _swap(t, marker, marker.replace("j <= k", "j <= 0"))


def _fixed_width(t: str) -> str:
    """issue_group and stage_run with 16-byte loads fixed when compiled:
    every load width they read (gm.vin, gm.per, gm.svin, gm.sper) a
    constant."""
    for fn in WIDTH_FNS:
        start = t.index(fn)
        end = t.index("\n}\n", start)
        body = t[start:end]
        if "gm.per" not in body:
            raise SystemExit(f"ab_fused: {fn} no longer reads gm.per")
        for old, new in (("gm.svin", "16"),
                         ("gm.sper", "(16 / (int)sizeof(T))"),
                         ("gm.vin", "16"), ("gm.per", "(16 / (int)sizeof(T))")):
            body = body.replace(old, new)
        t = t[:start] + body + t[end:]
    return t




#: body -> variant -> the source's text -> the variant's
EDITS = {
    "cta": {
        "shipped": lambda t: t,
        "stage-store": lambda t: _no_substeps(t, CTA_SUBSTEPS),
        "no-rule": lambda t: _swap(t, CTA_RULE, CTA_NO_RULE),
        "no-mask": lambda t: _swap(t, CTA_MASK, "      int m = 1;\n"),
        "ids-only": lambda t: _no_substeps(_swap(_swap(
            t, CTA_LOADS[0], "    ;\n"), CTA_LOADS[1], "    ;\n"),
            CTA_SUBSTEPS),
    },
    "warp": {
        "shipped": lambda t: t,
        "stage-store": lambda t: _no_substeps(t, WARP_SUBSTEPS),
        "no-rule": lambda t: _swap(t, WARP_RULE, WARP_NO_RULE),
        "no-mask": lambda t: _swap(
            t, WARP_MASK, "    const unsigned colmask = ~0u;\n"),
        "ids-only": lambda t: _no_substeps(_swap(_swap(
            t, WARP_ISSUE, ""), WARP_STAGE, ""), WARP_SUBSTEPS),
    },
}
#: the warp body whose v1 stages whole blocks: the same, and rows-only
EDITS["warp-whole"] = dict(EDITS["warp"], **{
    "rows-only": lambda t: _swap(_swap(t, WHOLE, ROWS), ROWS_GATE,
                                 "  if (H != kPieces && lane < 8 * G) {\n")})
#: the warp body with v3 at k = 1: the same, and v3's mask and the
#: stagings' widths
EDITS["warp-k1"] = dict(EDITS["warp-whole"], **{
    "mask-existence": lambda t: _swap(
        t, K1_MASK, K1_MASK.replace("KC == 1", "kOne")),
    "fixed-width": _fixed_width})
#: the variants that compute the function, and the rows each changes
#: (None: every row)
EXACT = {"shipped": None, "rows-only": ("row1",),
         "mask-existence": ("row3",), "fixed-width": ("row1", "row2", "row3")}


def body_of(text: str) -> str:
    if "warp_kernel" not in text:
        return "cta"
    if K1_MASK in text:
        return "warp-k1"
    return "warp-whole" if WHOLE in text else "warp"


#: the entries that take a plan's W and warps (after k, or v1's, v2's and
#: v3's rho) where the source has the body the plan picks
PLANNED = ("sq_stencil_step_fused_k", "sq_stencil_step_fused_k_local",
           "sq_stencil_step_blocks", "sq_stencil_step_strips",
           "sq_stencil_step_fused")


def takes_plan(text: str, entry: str) -> bool:
    """Whether the source's entry takes the plan's (W, warps)."""
    found = re.search(rf"int {entry}\((.*?)\)", text, re.S)
    return bool(found) and "int warps" in found.group(1)


def build_variants(build, checkouts, cu=CU, edits=EDITS, body=None,
                   planned=PLANNED, out=OUT,
                   kernels=("warp_kernel", "step_kernel", "gather_kernel")):
    """{(tag, variant): (library, ptxas summary, {entry: whether it takes
    the plan})} for every checkout: its source ``cu`` recognised by
    ``body`` (default ``body_of``), each of ``edits[body]`` applied and
    built into ``out``, the ptxas lines of the named ``kernels`` kept."""
    out.mkdir(parents=True, exist_ok=True)
    body_fn = body or body_of
    sources = {}   # every edit first: a stale marker stops before any build
    for i, co in enumerate(checkouts):
        text = (co / cu).read_text()
        kind = body_fn(text)
        takes = {e: takes_plan(text, e) for e in planned}
        for name, edit in edits[kind].items():
            sources[(f"{i}:{kind}", name)] = (
                f"{i}-{kind}-{name}", edit(text), takes)
    procs = {}
    for key, (stem, text, _) in sources.items():
        src = out / f"{stem}.cu"
        src.write_text(text)
        procs[key] = (stem, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(out / f"{stem}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (stem, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{out.name}: {stem} failed to build:\n{log}")
        libs[key] = (ctypes.CDLL(str(out / f"{stem}.so")),
                     ptxas(log, kernels), sources[key][2])
    return libs


def ptxas(log: str, kernels=("warp_kernel", "step_kernel",
                             "gather_kernel")) -> dict:
    """{kernel instance: "registers/spill bytes"} from nvcc's log, for the
    instances of the named ``kernels`` (by default the warp body's, the CTA
    body's and the gather's)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    out = {}
    for e in chip_smoke.ptxas_summary(log):
        if not any(n in e["entry"] for n in kernels):
            continue
        text = " ".join(e["ptxas"])
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        out[e["entry"][:48]] = (f"{regs.group(1) if regs else '?'}/"
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
    from repro_torch.workloads.base import halo_needs
    if not torch.cuda.is_available():
        print("ab_fused: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    libs = build_variants(build, checkouts)
    for (tag, name), (_, summary, _) in libs.items():
        print(json.dumps({"build": tag, "variant": name,
                          "ptxas": summary}), flush=True)

    frac, r, m = F.SIERPINSKI, 16, 2
    lay = shared_layout(frac, r, m)
    k = default_fusion_k(lay.rho)
    nbr = lay.device_table("neighbor_table", "cuda")
    wmask = lay.device_table("window_mask", "cuda", k)
    stream = torch.cuda.current_stream().cuda_stream
    states = {wl.name: make_engine("cuda-fused", frac, r, m,
                                   workload=wl).init_random(3)
              for wl in (R.LIFE, R.HEAT, R.GRAY_SCOTT)}
    dist = make_engine("dist-fused", frac, r, m, workload=R.LIFE,
                       n_shards=4, exchange="p2p")
    s5, halo, ex = dist.local_inputs(dist.from_dense(states["life"]), k)

    def call(lib, name, args, x, wl, pieces):
        """One launch of entry ``name`` of ``lib``; the plan's parameters
        it takes follow k (v1, v2 and v3: rho)."""
        f, _, takes = lib
        f = getattr(f, name)
        types = list(sk._SIGNATURES[name])
        if takes[name]:
            if name == "sq_stencil_step_fused":   # v4's plan at k = 1
                plan = sk._fused_plan_for(lay_of(x), x, wl, 1, False)
            elif name.startswith("sq_stencil_step_fused_k"):
                plan = sk._fused_plan_for(lay, x, wl, k, pieces)
            else:
                plan = sk._step_plan_for(lay_of(x), x, wl, pieces)
            args = args + [plan.W, plan.warps]
        else:   # an entry without the plan: no W, warps after k (or rho)
            del types[len(args):len(args) + 2]
        f.argtypes = types
        f.restype = ctypes.c_int
        rc = f(*args, *sk._rule_args(wl, stream))
        if rc:
            raise RuntimeError(f"{name}: launch failed with error {rc}")

    def row4(wl):
        x = states[wl.name]

        def launch(lib, out):
            call(lib, "sq_stencil_step_fused_k",
                 [sk._rule(wl), x.data_ptr(), out.data_ptr(),
                  nbr.data_ptr(), wmask.data_ptr(), lay.n_blocks, 1,
                  lay.rho, k], x, wl, False)
        return launch, x, lambda: sk.stencil_step_fused_k_plain(
            lay, x, wl, k=k)

    def row6(lib, out):
        call(lib, "sq_stencil_step_fused_k_local",
             [sk._rule(R.LIFE), s5.data_ptr(), out.data_ptr(),
              *(h.data_ptr() for h in halo), ex.data_ptr(),
              wmask.data_ptr(), s5.shape[2], s5.shape[0], lay.rho, k],
             s5, R.LIFE, True)

    rows = {f"row4/{wl.name}": row4(wl)
            for wl in (R.LIFE, R.HEAT, R.GRAY_SCOTT)}
    rows["row6/life"] = (row6, s5, lambda: sk.stencil_step_fused_k_local_plain(
        lay, s5, halo, ex, R.LIFE, k=k))

    def who(row, entry=None):
        """The builds timed at ``row``: the variants that change it (every
        knock-out), where the source's ``entry`` runs the warp body (or
        its shipped build)."""
        return {key for key, lib in libs.items()
                if (key[1] not in EXACT or EXACT[key[1]] is None
                    or row in EXACT[key[1]])
                and (entry is None or lib[2][entry] or key[1] == "shipped")}
    rows = {n: (*v, who("row4")) for n, v in rows.items()}

    # rows 1 and 2: v1 and v2 at k = 1 (rho = 4), v1 also at rho = 8
    lay8 = shared_layout(frac, r, 3)
    layouts = {lay.n_blocks: lay, lay8.n_blocks: lay8}

    def lay_of(x):
        return layouts[x.shape[-3]]
    shipped = {key for key in libs if key[1] == "shipped"}
    s8 = make_engine("cuda-blocks", frac, r, 3, workload=R.LIFE,
                     fusion_k=1).init_random(4)
    needs = {wl.name: halo_needs(wl.weights2d) for wl in (R.LIFE, R.HEAT)}
    strips = {n: sk.gather_halo_strips_plain(
        lay, states[n][None, None], needs[n]) for n in needs}

    def row1(wl, x):
        ly = lay_of(x)

        def launch(lib, out):
            call(lib, "sq_stencil_step_blocks",
                 [sk._rule(wl), x.data_ptr(), out.data_ptr(),
                  ly.device_table("neighbor_table", "cuda").data_ptr(),
                  ly.device_table("micro_mask", "cuda").data_ptr(),
                  ly.n_blocks, 1, ly.rho], x, wl, False)
        return (launch, x, lambda: sk.stencil_step_blocks_plain(ly, x, wl),
                who("row1", "sq_stencil_step_blocks"))

    def row2(wl):
        x = states[wl.name]

        def launch(lib, out):
            call(lib, "sq_stencil_step_strips",
                 [sk._rule(wl), x.data_ptr(), out.data_ptr(),
                  strips[wl.name].data_ptr(),
                  lay.device_table("micro_mask", "cuda").data_ptr(),
                  lay.n_blocks, 1, lay.rho], x, wl, True)
        return (launch, x, lambda: sk.stencil_step_strips_plain(lay, x, wl),
                who("row2", "sq_stencil_step_strips"))

    wmask1 = lay.device_table("window_mask", "cuda", 1)

    def row3(wl):
        x = states[wl.name]

        def launch(lib, out):
            call(lib, "sq_stencil_step_fused",
                 [sk._rule(wl), x.data_ptr(), out.data_ptr(), nbr.data_ptr(),
                  wmask1.data_ptr(), lay.n_blocks, 1, lay.rho], x, wl, False)
        return (launch, x, lambda: sk.stencil_step_fused_plain(lay, x, wl),
                who("row3", "sq_stencil_step_fused"))

    def gather(wl):
        """The library's gather kernel, or the plain PyTorch gather."""
        x = states[wl.name][None, None]
        bits = sum(1 << d for d, i in enumerate(sk._NEED_OF_DIR)
                   if needs[wl.name][i])

        def launch(lib, out):
            f = lib[0]
            if not hasattr(f, "sq_gather_halo_strips"):
                return sk.gather_halo_strips_plain(lay, x, needs[wl.name])
            f = f.sq_gather_halo_strips
            f.argtypes = sk._SIGNATURES["sq_gather_halo_strips"]
            f.restype = ctypes.c_int
            rc = f(x.data_ptr(), out.data_ptr(), nbr.data_ptr(),
                   lay.n_blocks, 1, lay.rho, x.element_size(), bits, stream)
            if rc:
                raise RuntimeError(f"gather: launch failed with error {rc}")
        return launch, strips[wl.name], lambda: strips[wl.name], shipped
    for wl in (R.LIFE, R.HEAT):
        rows[f"row1/{wl.name}"] = row1(wl, states[wl.name])
        rows[f"row2/{wl.name}"] = row2(wl)
    rows["row1/life-rho8"] = row1(R.LIFE, s8)
    rows["row2/gather"] = gather(R.LIFE)
    rows["row2/gather-heat"] = gather(R.HEAT)
    for wl in (R.LIFE, R.HEAT):
        rows[f"row3/{wl.name}"] = row3(wl)
    print(json.dumps({"shapes": {n: list(row[1].shape) for n, row in
                                 rows.items()}, "k": k}), flush=True)
    for rname, (launch, x, plain, who) in rows.items():
        want = plain()
        for (tag, name), lib in libs.items():
            if name not in EXACT or (tag, name) not in who:
                continue
            out = torch.empty_like(x)
            got = launch(lib, out)
            out = out if got is None else got
            torch.cuda.synchronize()
            err = float((out.double() - want.double()).abs().max())
            print(json.dumps({"check": rname, "build": tag, "variant": name,
                              "max_abs_err": err}), flush=True)
            if err:
                return 1
        del want
    times = {key: {n: [] for n, row in rows.items() if key in row[3]}
             for key in libs}
    order = list(libs)
    outs = {n: torch.empty_like(x) for n, (_, x, _, _) in rows.items()}
    for _ in range(rounds):
        for key in order + order[::-1]:
            for rname, (launch, _, _, who) in rows.items():
                if key in who:
                    times[key][rname].append(cs.cuda_ms(
                        torch, lambda: launch(libs[key], outs[rname]), 10))
    for (tag, name), t in times.items():
        print(json.dumps({"build": tag, "variant": name, "ms": t}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
