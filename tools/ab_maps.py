"""Take the lambda map kernel apart on one card: row 11 of the kernel
table (``lambda_map_tc``, ``sq_lambda_map`` in ``csrc/squeeze_maps.cu``)
beside variants of its body with one part changed or removed, and row 10
(``nu_map_tc``, ``sq_nu_map``, whose code no variant changes) as the
control.

    python3 tools/ab_maps.py [--rounds N] CHECKOUT [CHECKOUT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each CHECKOUT is the root of a checkout of this repository (for instance
the parent commit unpacked with ``git archive`` into ``.scratch/parent``,
then ``.``); its ``squeeze_maps.cu`` is read and its lambda body recognised
(``grouped``: a lookup a group of L levels in tables built by
``lambda_map.lambda_tables``; ``loop``: the body before it, a thread a
coordinate running the level loop, taken as it is). Each variant of a
grouped body is the source with one text edit, built with the port's nvcc
flags into its own library under ``build/ab_maps/`` (all in parallel, with
``tools/ab_fused.py``'s ``build_variants``) and called through ctypes:

- ``shipped``: the source as it is;
- ``levels6``: groups of 6 levels for s = 2 (729-entry tables; three
  lookups at r = 16, the top one in a table of its own);
- ``scalar``: every coordinate on the scalar path (no 16-byte loads or
  stores);
- ``unroll2``: two quads of coordinates a thread and turn, both loaded
  before either is computed (more bytes in flight);
- ``no-lookup``: each table lookup replaced by its index (not the
  function: what the lookups cost).

The first four compute the function; each is held against the plain
version bit for bit. The inputs: row 11 at the main path's shape
(``chip_smoke.py`` phase 6: sierpinski r=16, every compact cell, 43 M),
lambda over carpet r=8 (16.7 M cells, s = 3) and row 10, nu over the
expanded coordinates of the same sierpinski cells. Every variant is timed
at the rows it changes (``levels6`` at s = 2; nu on the shipped builds) on
CUDA events, 10 launches a reading, variants in turn and back (N rounds).
One JSON line per result; the card's name and power limit first, each
library's registers and spills (ptxas) next.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from ab_fused import _swap, build_variants  # noqa: E402

CU = Path("src/repro_torch/kernels/csrc/squeeze_maps.cu")
OUT = ROOT / "build" / "ab_maps"

LEVELS2 = "constexpr int kLambdaL2 = 8;"
VEC = ("  g.vec = (((uintptr_t)cx | (uintptr_t)cy | (uintptr_t)ex | "
       "(uintptr_t)ey)")
LOOKUP = ("    const int e = tab[(i < groups - 1 ? 0 : g.top_off) + rx + d * "
          "ry];\n")
QUADS = "  for (long long i = first; i < quads; i += stride) {\n"
QUAD_BODY = """    const int4 x = reinterpret_cast<const int4*>(cx)[i];
    const int4 y = reinterpret_cast<const int4*>(cy)[i];
    int4 ox, oy;
    lambda_one<S, K, L, NG>(x.x, y.x, g, tab, ox.x, oy.x);
    lambda_one<S, K, L, NG>(x.y, y.y, g, tab, ox.y, oy.y);
    lambda_one<S, K, L, NG>(x.z, y.z, g, tab, ox.z, oy.z);
    lambda_one<S, K, L, NG>(x.w, y.w, g, tab, ox.w, oy.w);
    reinterpret_cast<int4*>(ex)[i] = ox;
    reinterpret_cast<int4*>(ey)[i] = oy;
  }
"""


UNROLLED = """  long long i = first;
  for (; i + stride < quads; i += 2 * stride) {
    const int4 x0 = reinterpret_cast<const int4*>(cx)[i];
    const int4 y0 = reinterpret_cast<const int4*>(cy)[i];
    const int4 x1 = reinterpret_cast<const int4*>(cx)[i + stride];
    const int4 y1 = reinterpret_cast<const int4*>(cy)[i + stride];
    int4 a0, b0, a1, b1;
    lambda_one<S, K, L, NG>(x0.x, y0.x, g, tab, a0.x, b0.x);
    lambda_one<S, K, L, NG>(x0.y, y0.y, g, tab, a0.y, b0.y);
    lambda_one<S, K, L, NG>(x0.z, y0.z, g, tab, a0.z, b0.z);
    lambda_one<S, K, L, NG>(x0.w, y0.w, g, tab, a0.w, b0.w);
    lambda_one<S, K, L, NG>(x1.x, y1.x, g, tab, a1.x, b1.x);
    lambda_one<S, K, L, NG>(x1.y, y1.y, g, tab, a1.y, b1.y);
    lambda_one<S, K, L, NG>(x1.z, y1.z, g, tab, a1.z, b1.z);
    lambda_one<S, K, L, NG>(x1.w, y1.w, g, tab, a1.w, b1.w);
    reinterpret_cast<int4*>(ex)[i] = a0;
    reinterpret_cast<int4*>(ey)[i] = b0;
    reinterpret_cast<int4*>(ex)[i + stride] = a1;
    reinterpret_cast<int4*>(ey)[i + stride] = b1;
  }
  for (; i < quads; i += stride) {
"""


def _unroll2(t: str) -> str:
    """The lambda kernel's quad loop two quads a turn, then the rest."""
    return _swap(t, QUADS + QUAD_BODY, UNROLLED + QUAD_BODY)


#: body -> variant -> the source's text -> the variant's
EDITS = {
    "loop": {"shipped": lambda t: t},
    "grouped": {
        "shipped": lambda t: t,
        "levels6": lambda t: _swap(t, LEVELS2, LEVELS2.replace("8", "6")),
        "scalar": lambda t: _swap(t, VEC, VEC.replace("g.vec = (",
                                                      "g.vec = 0 && (")),
        "unroll2": _unroll2,
        "no-lookup": lambda t: _swap(t, LOOKUP,
                                     "    const int e = rx + d * ry;\n"),
    },
}
#: the variants that compute the function, and the s each is timed at
#: (None: every s)
EXACT = {"shipped": None, "levels6": 2, "scalar": None, "unroll2": None}
#: the group length a variant's tables take, by s
VARIANT_LEVELS = {"levels6": {2: 6}}


def body_of(text: str) -> str:
    return "grouped" if LEVELS2 in text else "loop"


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
    from repro_torch.core.compact import compact_meshgrid
    from repro_torch.kernels import build
    from repro_torch.kernels import lambda_map as lm
    from repro_torch.kernels import nu_map as nm
    if not torch.cuda.is_available():
        print("ab_maps: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    libs = build_variants(build, checkouts, cu=CU, edits=EDITS,
                          body=body_of, planned=(), out=OUT,
                          kernels=("lambda_kernel", "nu_kernel"))
    for (tag, name), (_, summary, _) in libs.items():
        print(json.dumps({"build": tag, "variant": name,
                          "ptxas": summary}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def nu_row(frac, r, ex, ey):
        out = (torch.empty_like(ex), torch.empty_like(ey),
               torch.empty(ex.shape, dtype=torch.bool, device="cuda"))
        plan = nm.nu_plan(frac, r)
        tables = nm.device_tables(frac, plan.levels, plan.top, "cuda")

        def launch(key):
            f = libs[key][0].sq_nu_map
            f.argtypes = [P] * 5 + [LL, I, I, I, I, P, I, P]
            f.restype = I
            rc = f(ex.data_ptr(), ey.data_ptr(), *(o.data_ptr() for o in out),
                   ex.numel(), r, frac.s, frac.k, plan.levels,
                   tables.data_ptr(), plan.entries, stream)
            if rc:
                raise RuntimeError(f"{key}: sq_nu_map failed with {rc}")
            return out
        return (launch, lambda: nm.nu_map_tc_plain(frac, r, ex, ey),
                {key for key in libs if key[1] == "shipped"})

    def lambda_row(frac, r, cx, cy):
        out = (torch.empty_like(cx), torch.empty_like(cy))
        h_lambda = torch.from_numpy(frac.h_lambda.astype("int32")).cuda()
        tables = {}

        def launch(key):
            lib, name = libs[key][0], key[1]
            f = lib.sq_lambda_map
            head = [cx.data_ptr(), cy.data_ptr(), *(o.data_ptr()
                                                   for o in out),
                    cx.numel(), r, frac.s, frac.k]
            if key[0].endswith("loop"):   # ..., h_lambda, stream
                f.argtypes = [P] * 4 + [LL, I, I, I, P, P]
                args = head + [h_lambda.data_ptr(), stream]
            else:                         # ..., levels, tables, entries
                levels = VARIANT_LEVELS.get(name, {}).get(
                    frac.s, lm.LEVELS.get(frac.s, 2))
                plan = lm.lambda_plan(frac, r, levels)
                if levels not in tables:
                    tables[levels] = torch.from_numpy(lm.lambda_tables(
                        frac, levels, plan.top)).cuda()
                f.argtypes = [P] * 4 + [LL, I, I, I, I, P, I, P]
                args = head + [levels, tables[levels].data_ptr(),
                               plan.entries, stream]
            f.restype = I
            rc = f(*args)
            if rc:
                raise RuntimeError(f"{key}: sq_lambda_map failed with {rc}")
            return out

        def who():
            return {key for key in libs
                    if key[1] not in EXACT or EXACT[key[1]] in (None, frac.s)}
        return (launch, lambda: lm.lambda_map_tc_plain(frac, r, cx, cy),
                who())

    def compact(frac, r):
        return (c.contiguous() for c in compact_meshgrid(frac, r, "cuda"))

    sier, carpet = F.SIERPINSKI, F.CARPET
    cx16, cy16 = compact(sier, 16)
    ex16, ey16 = lm.lambda_map_tc_plain(sier, 16, cx16, cy16)
    cx8, cy8 = compact(carpet, 8)
    rows = {"row11/sierpinski-r16": lambda_row(sier, 16, cx16, cy16),
            "row11/carpet-r8": lambda_row(carpet, 8, cx8, cy8),
            "row10/sierpinski-r16": nu_row(sier, 16, ex16.contiguous(),
                                           ey16.contiguous())}
    print(json.dumps({"coordinates": {n: int(cx16.numel()) if "sier" in n
                                      else int(cx8.numel()) for n in rows}}),
          flush=True)
    for rname, (launch, plain, who) in rows.items():
        want = plain()
        for key in libs:
            if key[1] not in EXACT or key not in who:
                continue
            got = launch(key)
            torch.cuda.synchronize()
            err = max(float((g.long() - w.long()).abs().max())
                      for g, w in zip(got, want))
            print(json.dumps({"check": rname, "build": key[0],
                              "variant": key[1], "max_abs_err": err}),
                  flush=True)
            if err:
                return 1
        del want
    times = {key: {n: [] for n, row in rows.items() if key in row[2]}
             for key in libs}
    order = list(libs)
    for _ in range(rounds):
        for key in order + order[::-1]:
            for rname, (launch, _, who) in rows.items():
                if key in who:
                    times[key][rname].append(cs.cuda_ms(
                        torch, lambda: launch(key), 10))
    for (tag, name), t in times.items():
        print(json.dumps({"build": tag, "variant": name, "ms": t}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
