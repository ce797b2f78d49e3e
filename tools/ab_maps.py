"""Take the nu map kernel apart on one card: row 10 of the kernel table
(``nu_map_tc``, ``sq_nu_map`` in ``csrc/squeeze_maps.cu``) beside variants
of its body with one part changed or removed, and row 11
(``lambda_map_tc``, ``sq_lambda_map``, whose code no variant changes) as
the control.

    python3 tools/ab_maps.py [--rounds N] CHECKOUT [CHECKOUT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each CHECKOUT is the root of a checkout of this repository (for instance
the parent commit unpacked with ``git archive`` into ``.scratch/parent``,
then ``.``); its ``squeeze_maps.cu`` is read and its nu body recognised
(``grouped``: a lookup a group of L levels in tables built by
``nu_map.nu_tables``; ``loop``: the body before it, a thread a coordinate
running the level loop, taken as it is). Each variant of a grouped body is
the source with one text edit, built with the port's nvcc flags into its
own library under ``build/ab_maps/`` (all in parallel, with
``tools/ab_fused.py``'s builder) and called through ctypes:

- ``shipped``: the source as it is;
- ``levels6``: groups of 6 levels for s = 2 (4096-entry tables);
- ``levels4``: groups of 4 levels for s = 3 (6561-entry tables);
- ``scalar``: every coordinate on the scalar path (no 16-byte loads or
  stores);
- ``streaming``: the vector stores marked streaming (``st.global.cs``);
- ``no-lookup``: each table lookup replaced by its index (not the
  function: what the lookups cost);
- ``no-groups``: no group at all, the loads, clip and stores alone (not
  the function: the body's floor).

The first five compute the function; each is held against the plain
version bit for bit. The inputs: row 10 at the main path's shape
(``chip_smoke.py`` phase 6: sierpinski r=16, the expanded coordinates of
every compact cell, 43 M) and at the cell engine's north-east neighbors
of the same cells (off the grid and in holes where those are), nu over
carpet r=8 (16.7 M cells, s = 3) and row 11, lambda over sierpinski r=16.
Every variant is timed at the rows it changes (``levels6`` at s = 2,
``levels4`` at s = 3; lambda on the shipped builds) on CUDA events, 10
launches a reading, variants in turn and back (N rounds). One JSON line
per result; the card's name and power limit first, each library's
registers and spills (ptxas) next.
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

LEVELS2 = "constexpr int kLevels2 = 4;"
LEVELS3 = "constexpr int kLevels3 = 2;"
VEC = "  g.vec = ((("
STORES = ("    reinterpret_cast<int4*>(cx)[i] = ox;\n"
          "    reinterpret_cast<int4*>(cy)[i] = oy;\n"
          "    reinterpret_cast<unsigned*>(valid)[i] = v;\n")
STREAMING = ("    __stcs(reinterpret_cast<int4*>(cx) + i, ox);\n"
             "    __stcs(reinterpret_cast<int4*>(cy) + i, oy);\n"
             "    __stcs(reinterpret_cast<unsigned*>(valid) + i, v);\n")
LOOKUP = "    const int e = tab[at];\n"
GROUPS = "  const int groups = NG >= 0 ? NG : g.groups;\n"

#: body -> variant -> the source's text -> the variant's
EDITS = {
    "loop": {"shipped": lambda t: t},
    "grouped": {
        "shipped": lambda t: t,
        "levels6": lambda t: _swap(t, LEVELS2, LEVELS2.replace("4", "6")),
        "levels4": lambda t: _swap(t, LEVELS3, LEVELS3.replace("2", "4")),
        "scalar": lambda t: _swap(t, VEC, "  g.vec = 0 && ((("),
        "streaming": lambda t: _swap(t, STORES, STREAMING),
        "no-lookup": lambda t: _swap(t, LOOKUP,
                                     "    const int e = (int)at;\n"),
        "no-groups": lambda t: _swap(t, GROUPS,
                                     "  const int groups = 0;\n"),
    },
}
#: the variants that compute the function, and the s each is timed at
#: (None: every s)
EXACT = {"shipped": None, "levels6": 2, "levels4": 3, "scalar": None,
         "streaming": None}
#: the group length a variant's tables take, by s
VARIANT_LEVELS = {"levels6": {2: 6}, "levels4": {3: 4}}


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
                          kernels=("nu_kernel", "lambda_kernel"))
    for (tag, name), (_, summary, _) in libs.items():
        print(json.dumps({"build": tag, "variant": name,
                          "ptxas": summary}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def coords(frac, r, shift=(0, 0)):
        cx, cy = (c.contiguous() for c in compact_meshgrid(frac, r, "cuda"))
        ex, ey = lm.lambda_map_tc_plain(frac, r, cx, cy)
        return ((ex + shift[0]).contiguous(), (ey + shift[1]).contiguous(),
                cx, cy)

    def nu_row(frac, r, ex, ey):
        out = (torch.empty_like(ex), torch.empty_like(ey),
               torch.empty(ex.shape, dtype=torch.bool, device="cuda"))
        h_nu = torch.from_numpy(frac.h_nu.astype("int32")).cuda()
        tables = {}

        def launch(key):
            lib, name = libs[key][0], key[1]
            f = lib.sq_nu_map
            head = [ex.data_ptr(), ey.data_ptr(), *(o.data_ptr()
                                                   for o in out),
                    ex.numel(), r, frac.s, frac.k]
            if key[0].endswith("loop"):   # ..., n, h_nu, stream
                f.argtypes = [P] * 5 + [LL, I, I, I, I, P, P]
                args = head + [frac.side(r), h_nu.data_ptr(), stream]
            else:                         # ..., levels, tables, entries
                levels = VARIANT_LEVELS.get(name, {}).get(
                    frac.s, nm.group_levels(frac.s))
                plan = nm.nu_plan(frac, r, levels)
                if levels not in tables:
                    tables[levels] = torch.from_numpy(nm.nu_tables(
                        frac, levels, plan.top)).cuda()
                f.argtypes = [P] * 5 + [LL, I, I, I, I, P, I, P]
                args = head + [levels, tables[levels].data_ptr(),
                               plan.entries, stream]
            f.restype = I
            rc = f(*args)
            if rc:
                raise RuntimeError(f"{key}: sq_nu_map failed with {rc}")
            return out

        def who():
            return {key for key in libs
                    if key[1] not in EXACT or EXACT[key[1]] in (None, frac.s)}
        return (launch, lambda: nm.nu_map_tc_plain(frac, r, ex, ey), who())

    def lambda_row(frac, r, cx, cy):
        out = (torch.empty_like(cx), torch.empty_like(cy))
        h = torch.from_numpy(frac.h_lambda.astype("int32")).cuda()

        def launch(key):
            f = libs[key][0].sq_lambda_map
            f.argtypes = [P] * 4 + [LL, I, I, I, P, P]
            f.restype = I
            rc = f(cx.data_ptr(), cy.data_ptr(), *(o.data_ptr() for o in out),
                   cx.numel(), r, frac.s, frac.k, h.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"{key}: sq_lambda_map failed with {rc}")
            return out
        return (launch, lambda: lm.lambda_map_tc_plain(frac, r, cx, cy),
                {key for key in libs if key[1] == "shipped"})

    sier, carpet = F.SIERPINSKI, F.CARPET
    ex16, ey16, cx16, cy16 = coords(sier, 16)
    rows = {"row10/sierpinski-r16": nu_row(sier, 16, ex16, ey16)}
    ne = coords(sier, 16, (1, -1))
    rows["row10/sierpinski-r16-ne"] = nu_row(sier, 16, ne[0], ne[1])
    ex8, ey8, _, _ = coords(carpet, 8)
    rows["row10/carpet-r8"] = nu_row(carpet, 8, ex8, ey8)
    rows["row11/sierpinski-r16"] = lambda_row(sier, 16, cx16, cy16)
    print(json.dumps({"coordinates": {n: int(ex16.numel()) if "sier" in n
                                      else int(ex8.numel()) for n in rows}}),
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
