"""Take the tensor-core attention body apart on one card: the shipped
``sq_flash_attention_tc`` beside variants of it with one part removed, to
see where its time goes, and beside the variant with a single bf16 product
of P, to see whether that one meets the bf16 bar.

    python3 tools/ab_attention.py [--rounds N]

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc.
Each variant is ``src/repro_torch/kernels/csrc/attention.cu`` with one
text edit of body 1, built with the port's nvcc flags into its own library
under ``build/ab_attention/`` (all in parallel) and called through ctypes:

- ``shipped``: the source as it is;
- ``one-product``: P V as one bf16 product (P_hi V alone);
- ``no-pv``: without the P V products (P still computed);
- ``no-qk``: without the Q K^T products (scores from a cheap stand-in);
- ``no-exp``: the softmax's expf replaced by a subtraction;
- ``no-reload``: K and V loaded once, never reloaded (stale tiles;
  each stage's mbarrier still completes, with no bytes).

Only ``shipped`` and ``one-product`` compute attention; the others are
timed, never checked. Those two are held, elementwise, to one bf16 rounding
of the float32 plain version (|got - want| <= ulp_bf16(|want|) + 1e-5) on
the bf16 cases of ``chip_smoke.py``'s phase 14 that take the tensor-core
body and on gemma2-2b's global and local layers (B=1, 8 heads of D=256,
S=8192); the tool prints, for each, the largest excess over ulp_bf16 and
the number of elements over the bar. Then every variant is timed at the
gemma2 shapes (global with the softcap off and at 50, local) on CUDA
events, 10 launches a reading, variants in turn and back (N rounds). One
JSON line per result; the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "attention.cu"
OUT = ROOT / "build" / "ab_attention"

PV = """        wgmma_rs(acc[p], ph[ks], db);
        wgmma_rs(acc[p], pl[ks], db);
"""
QK = """        if (p == 0 && kk == 0)
          wgmma_ss<0>(s, da, db);
        else
          wgmma_ss<1>(s, da, db);
"""
RELOAD = """      mbar_expect(bars + 8 * (st ^ 1), 2 * kTile);
      tma_tile<kD, kBK>(nx, &mk, bars + 8 * (st ^ 1), k0 + kBK, (int)bh);
      tma_tile<kD, kBK>(nx + kTile, &mv, bars + 8 * (st ^ 1), k0 + kBK,
                        (int)bh);
"""
#: variant -> [(text in body 1, its replacement)]
EDITS = {
    "shipped": [],
    "one-product": [(PV, "        wgmma_rs(acc[p], ph[ks], db);\n")],
    "no-pv": [(PV, "        acc[p][0] += __uint_as_float("
                   "ph[ks][0] ^ pl[ks][1] ^ (uint32_t)db);\n")],
    "no-qk": [(QK, "        s[4 * p + kk] += "
                   "__uint_as_float((uint32_t)(da ^ db));\n")],
    "no-exp": [("      s[e] = expf(s[e] - m[(e >> 1) & 1]);",
                "      s[e] = (s[e] - m[(e >> 1) & 1]);")],
    # the next stage's mbarrier still completes (no bytes expected), or
    # every thread would wait on it forever
    "no-reload": [(RELOAD, "      mbar_expect(bars + 8 * (st ^ 1), 0);\n")],
}
CHECKED = ("shipped", "one-product")


def variant_source(text: str, edits) -> str:
    a = text.index("namespace tc {")
    b = text.index("}  // namespace tc")
    body = text[a:b]
    for old, new in edits:
        if body.count(old) != 1:
            raise SystemExit(f"ab_attention: body 1 no longer holds {old!r}")
        body = body.replace(old, new)
    return text[:a] + body + text[b:]


def build_variants(build, argtypes) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    text = SRC.read_text()
    procs = {}
    for name, edits in EDITS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(text, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ab_attention: {name} failed to build:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).sq_flash_attention_tc
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def main(argv) -> int:
    rounds = 2
    if argv[:1] == ["--rounds"] and len(argv) == 2:
        rounds = int(argv[1])
    elif argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import attention as ta
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build_variants(build, ta._ARGS[ta.TC][1])
    stream = torch.cuda.current_stream().cuda_stream

    def run(fn, q, k, v, causal=True, window=None, softcap=None):
        b, h, sq, d = q.shape
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, sq, k.shape[2], d, 1.0 / math.sqrt(d), int(causal),
                int(window is not None), window or 0,
                int(softcap is not None), softcap or 0.0, stream)
        if rc:
            raise RuntimeError(f"launch failed with error {rc}")
        return out

    def over_bar(got, want32):
        a = want32.double().abs()
        _, e = torch.frexp(a)
        ulp = torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                          torch.zeros_like(a))
        excess = (got.double() - want32.double()).abs() - ulp
        return float(excess.max()), int((excess > 1e-5).sum())

    cases = []
    for i, (label, shape, kw) in enumerate(cs.ATTN_CASES):
        kw = {n: x for n, x in kw.items() if n not in ("bq", "bk")}
        b, h, sq, sk, d = shape
        if ta.plan(torch.bfloat16, b * h, sq, sk, d, True,
                   kw.get("causal", True), kw.get("window")).body == ta.TC:
            cases.append((label, cs._qkv(torch, shape, torch.bfloat16,
                                         70 + i), kw))
    g2 = cs.GEMMA2
    full = cs._qkv(torch, (1, g2["h"], g2["s"], g2["s"], g2["d"]),
                   torch.bfloat16, 81)
    gemma = {
        "global": dict(causal=True),
        "global softcap": dict(causal=True, softcap=g2["softcap"]),
        "local softcap": dict(causal=True, window=g2["window"],
                              softcap=g2["softcap"]),
    }
    cases += [(f"gemma2 {n}", full, kw) for n, kw in gemma.items()]
    for label, qkv, kw in cases:
        want32 = ta.attention_plain(*(t.float() for t in qkv), **kw)
        row = {"case": label}
        for name in CHECKED:
            row[name] = over_bar(run(fns[name], *qkv, **kw), want32)
        print(json.dumps({"check": row}), flush=True)
        del want32
        torch.cuda.empty_cache()

    times = {name: {n: [] for n in gemma} for name in fns}
    order = list(fns)
    for _ in range(rounds):
        for name in order + order[::-1]:
            for n, kw in gemma.items():
                times[name][n].append(cs.cuda_ms(
                    torch, lambda: run(fns[name], *full, **kw), 10))
    for name in fns:
        print(json.dumps({"variant": name, "ms": times[name]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
