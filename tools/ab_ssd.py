"""Take the SSD chunk kernel apart on one card: row 13 of the kernel table
(``ssd_chunk``, ``sq_ssd_chunk`` in ``csrc/ssd_chunk.cu``) beside variants
of its body with one part changed or removed, and beside the body of
another checkout (the parent), in turns.

    python3 tools/ab_ssd.py [--rounds N] CHECKOUT [CHECKOUT ...]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each CHECKOUT is the root of a checkout of this repository (for instance
the parent commit unpacked with ``git archive`` into ``.scratch/parent``,
then ``.``); its ``ssd_chunk.cu`` is read and its body recognised
(``tc``: the tensor-core body, cb into a workspace, then a persistent grid
over (chunk, head) units whose geometry ``ssd_chunk.ssd_plan`` picks;
``fp32``: the body before it, one CTA a chunk and group of heads on the
CUDA cores, taken as it is). Each variant of a ``tc`` body is the source
with one text edit, built with the port's nvcc flags into its own library
under ``build/ab_ssd/`` (all in parallel, with ``tools/ab_fused.py``'s
``build_variants``) and called through ctypes:

- ``shipped``: the source as it is;
- ``no-exp``: the decay exp(cs_l - cs_m) of the scores replaced by 1 (not
  the function: what the exponents cost);
- ``1xtf32``: every product in one TF32 pass (hi x hi) in place of three
  (not the function at the 2e-5 bar: what the split costs);
- ``one-buffer``: one x buffer (the plan passed with x_buffers = 1), so a
  unit's x is staged only once the unit before is done, while the other
  warps wait (the function: what the overlap of loads and products
  gives);
- ``acc-in-c``: the y and cb products' three passes too added straight to
  the running accumulator, not a k-step at a time (the function, less
  accurately: the first body);
- ``state-fresh``: the state products' passes too summed a k-step at a
  time (the function);
- ``one-cta``: one CTA of 8 warps an SM (launch bounds (256, 1): up to
  255 registers), the units split over 132 CTAs (the function);
- ``wide-cta``, ``narrow-cta``: one CTA of 16 warps an SM, two CTAs of 8,
  wherever the plan picks the other (the function; x buffers: two where
  they fit, else one; a chunk whose x does not fit two CTAs is skipped by
  ``narrow-cta``);
- ``state16``: state items of 32 x 16 in place of 32 x 32 (twice as
  many, half the accumulators; the function);
- ``state64x16``: state items of 64 x 16 (P = 64 in one item, so each B
  element is loaded from L2 once a unit; the function);
- ``no-state``, ``no-y``: no state items, no y items (not the function:
  what each costs);
- ``no-bload``, ``no-cbload``: the state items' loads of B from L2, the y
  items' loads of cb from L2, replaced by a constant (not the function:
  what those loads cost);
- ``no-cb``, ``cb-only``: the launch of cb's kernel left out, the unit
  kernel's left out (not the function: what each launch costs).

``shipped``, ``one-buffer``, ``acc-in-c``, ``state-fresh``, ``one-cta``,
``wide-cta``, ``narrow-cta``, ``state16`` and ``state64x16`` are held
against
the plain version at the reference's bar (2e-5) (the outputs set to NaN
before each check); the others are timed and their largest error
printed. The inputs are mamba2-780m's (``chip_smoke.MAMBA2``: B=4,
S=2048, 48 heads of P=64, N=128) cut into chunks of 128 (the table's row;
the ``fp32`` body takes only this one), 256 and 512. Every build is timed
at each chunk it takes on CUDA events, 10 launches a reading, builds in
turn and back (N rounds). One JSON line per result; the card's name and
power limit first, each library's registers and spills (ptxas) next.
"""
from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from ab_fused import _swap, build_variants  # noqa: E402

CU = Path("src/repro_torch/kernels/csrc/ssd_chunk.cu")
OUT = ROOT / "build" / "ab_ssd"

EXP = "ca.x * expf(csa - ea) * da"
SPLIT_LO = "  s.lo = tf32(x - __uint_as_float(s.hi));\n"
SMALL = ("  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);\n"
         "  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);\n")
ITEMS = "  const int n_state = PT * NT, n_items = n_state + RT * PS;\n"
CB_LAUNCH = "  lower_cb_kernel<<<dim3((unsigned)n_chunks,"
UNIT_LAUNCH = "  kernel<<<(unsigned)ctas, 32 * warps, smem, s>>>("
BOUNDS = "__launch_bounds__(32 * kWarps, 16 / kWarps)"
COLS = "constexpr int kStateCols = 32;"
ROWS = "constexpr int kStateRows = 32;"
BLOAD = ("        to[nt][0] = __ldg(bb + (long long)min(ma, L - 1) * N + n);\n"
         "        to[nt][1] = __ldg(bb + (long long)min(ma + 1, L - 1) * N + "
         "n);\n")
CBLOAD = ("      na = __ldg(reinterpret_cast<const float2*>(cba + 8 * (s + "
          "1)));\n      nb = __ldg(reinterpret_cast<const float2*>(cbb + 8 * "
          "(s + 1)));\n")

#: body -> variant -> the source's text -> the variant's
EDITS = {
    "fp32": {"shipped": lambda t: t},
    "tc": {
        "shipped": lambda t: t,
        "no-exp": lambda t: _swap(_swap(_swap(_swap(
            t, EXP, "ca.x * da"), "cb.x * expf(csb - ea) * da", "cb.x * da"),
            "ca.y * expf(csa - eb) * db", "ca.y * db"),
            "cb.y * expf(csb - eb) * db", "cb.y * db"),
        "1xtf32": lambda t: _swap(_swap(t, SPLIT_LO, "  s.lo = 0u;\n"),
                                  SMALL, ""),
        "one-buffer": lambda t: t,
        "acc-in-c": lambda t: _swap(t, "mma3<true>", "mma3<false>",
                                    every=True),
        "state-fresh": lambda t: _swap(t, "mma3<false>(acc[mt][nt]",
                                       "mma3<true>(acc[mt][nt]"),
        "one-cta": lambda t: _swap(t, BOUNDS, "__launch_bounds__(32 * "
                                   "kWarps, 1)"),
        "wide-cta": lambda t: t,
        "narrow-cta": lambda t: t,
        "state16": lambda t: _swap(t, COLS, COLS.replace("32", "16")),
        "state64x16": lambda t: _swap(_swap(t, COLS, COLS.replace(
            "32", "16")), ROWS, ROWS.replace("32", "64")),
        "no-bload": lambda t: _swap(
            t, BLOAD, "        to[nt][0] = to[nt][1] = 0.5f + n;\n"),
        "no-cbload": lambda t: _swap(
            t, CBLOAD, "      na = nb = make_float2(0.5f, 0.25f + s);\n"),
        "no-state": lambda t: _swap(t, ITEMS, ITEMS.replace(
            "n_state = PT * NT", "n_state = 0")),
        "no-y": lambda t: _swap(t, ITEMS, ITEMS.replace(" + RT * PS", "")),
        "no-cb": lambda t: _swap(t, CB_LAUNCH, "  if (0)" + CB_LAUNCH[1:]),
        "cb-only": lambda t: _swap(t, UNIT_LAUNCH, "  if (0)" +
                                   UNIT_LAUNCH[1:]),
    },
}
#: the variants that compute the function at the bar
EXACT = ("shipped", "one-buffer", "acc-in-c", "state-fresh", "one-cta",
         "wide-cta", "narrow-cta", "state16", "state64x16")
#: x buffers of a variant's launches (the others: ``ssd_plan``'s)
VARIANT_XBUF = {"one-buffer": 1}
#: CTAs an SM of a variant's grid (the others: ``ssd_plan``'s)
VARIANT_PER_SM = {"one-cta": 1, "wide-cta": 1, "narrow-cta": 2}


def body_of(text: str) -> str:
    return "tc" if "ssd_kernel" in text else "fp32"


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
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_chunk as ts
    if not torch.cuda.is_available():
        print("ab_ssd: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    libs = build_variants(build, checkouts, cu=CU, edits=EDITS,
                          body=body_of, planned=(), out=OUT,
                          kernels=("ssd_chunk_kernel", "ssd_kernel",
                                   "lower_cb_kernel"))
    for (tag, name), (_, summary, _) in libs.items():
        print(json.dumps({"build": tag, "variant": name,
                          "ptxas": summary}), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    mb = cs.MAMBA2
    x, dt, a, bm, cm = cs._ssd_inputs(torch, mb["b"], mb["s"], mb["h"],
                                      mb["p"], mb["n"], 93)
    shapes = {}
    for chunk in (mb["chunk"],) + cs.SSD_CHUNKS:
        xc, dtc, bc, cc = ts.to_chunks(x, dt, bm, cm, chunk)
        c, ll, h, p = xc.shape
        out = (torch.empty_like(xc), torch.empty((c, h, p, mb["n"]),
                                                 device="cuda"))
        plan = ts.ssd_plan(c, ll, h, p)
        work = torch.empty((c, plan.rows, plan.rows), device="cuda")
        shapes[chunk] = (xc, dtc, bc, cc, out, plan, work)
        print(json.dumps({"chunk": chunk, "chunks": c,
                          "plan": plan._asdict()}), flush=True)

    def grid(plan, ll, p, units, name):
        """(heads, ctas, x_buffers, warps) of a variant's launch, or None
        where its layout does not fit."""
        per_sm = VARIANT_PER_SM.get(name, 16 // plan.warps)
        warps = 8 if name in ("one-cta", "narrow-cta") else 16 // per_sm
        if per_sm == 16 // plan.warps and name not in VARIANT_XBUF:
            return plan.heads, plan.ctas, plan.x_buffers, warps
        heads = -(-units // min(units, per_sm * ts.SMS))
        budget = min(build.MAX_SMEM,
                     ts.SM_SMEM // per_sm - ts.CTA_RESERVED)
        for xb in (VARIANT_XBUF.get(name, 2), 1):
            if ts.smem_bytes(ll, p, heads, xb) <= budget:
                return heads, -(-units // heads), xb, warps
        return None

    def launch(key, chunk):
        xc, dtc, bc, cc, out, plan, work = shapes[chunk]
        c, ll, h, p = xc.shape
        f = libs[key][0].sq_ssd_chunk
        head = [xc.data_ptr(), dtc.data_ptr(), a.data_ptr(), bc.data_ptr(),
                cc.data_ptr(), out[0].data_ptr(), out[1].data_ptr()]
        if key[0].endswith("fp32"):   # ..., n_chunks, L, H, P, N, HG
            groups = min(h, max(1, -(-build.PERSISTENT_CTAS // c)))
            f.argtypes = [P] * 7 + [LL, I, I, I, I, I, P]
            args = head + [c, ll, h, p, mb["n"], -(-h // groups), stream]
        else:   # ..., work, ..., heads, ctas, xbuf, warps
            heads, ctas, xbuf, warps = grid(plan, ll, p, c * h, key[1])
            f.argtypes = [P] * 8 + [LL] + [I] * 8 + [P]
            args = head + [work.data_ptr(), c, ll, h, p, mb["n"], heads,
                           ctas, xbuf, warps, stream]
        f.restype = I
        rc = f(*args)
        if rc:
            raise RuntimeError(f"{key}: sq_ssd_chunk failed with {rc}")
        return out

    def takes(key, chunk):
        if key[0].endswith("fp32"):
            return chunk == mb["chunk"]
        xc, plan = shapes[chunk][0], shapes[chunk][5]
        return grid(plan, chunk, xc.shape[3], xc.shape[0] * xc.shape[2],
                    key[1]) is not None
    for chunk, (xc, dtc, bc, cc, *_rest) in shapes.items():
        want = ts.ssd_chunk_plain(xc, dtc, a, bc, cc)
        for key in libs:
            if not takes(key, chunk):
                continue
            for o in shapes[chunk][4]:
                o.fill_(float("nan"))
            got = launch(key, chunk)
            torch.cuda.synchronize()
            err = [float((g.double() - w.double()).abs().max())
                   for g, w in zip(got, want)]
            over = [float(((g.double() - w.double()).abs()
                           / (2e-5 + 2e-5 * w.double().abs())).max())
                    for g, w in zip(got, want)]
            print(json.dumps({"check": chunk, "build": key[0],
                              "variant": key[1], "max_abs_err": err,
                              "err_over_bar": over}), flush=True)
            if key[1] in EXACT and max(over) > 1:
                return 1
        del want
    times = {key: {ch: [] for ch in shapes if takes(key, ch)}
             for key in libs}
    order = list(libs)
    for _ in range(rounds):
        for key in order + order[::-1]:
            for chunk in times[key]:
                times[key][chunk].append(cs.cuda_ms(
                    torch, lambda: launch(key, chunk), 10))
    for (tag, name), t in times.items():
        print(json.dumps({"build": tag, "variant": name, "ms": t}),
              flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
