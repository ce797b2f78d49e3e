"""Flash attention forward on the card: the CUDA wrapper and, beside it, its
plain PyTorch version.

``flash_attention`` replaces the Pallas ``src/repro/kernels/attention.py::
flash_attention`` (kernels in ``csrc/attention.cu``); ``attention_plain``
is the port of the reference's oracle ``kernels/ref.py::attention_ref``.
Both compute softmax attention over q (B, H, Sq, D) and k, v (B, H, Sk, D)
(kv heads already broadcast; there is no GQA) in float32, with an optional
causal mask, sliding window and logit softcap, and queries right-aligned
against the keys (query i at position i + Sk - Sq), so Sq = 1 decodes
against a long cache. Masked scores are -1e30, as in the reference: a row
that sees no key gets the mean of v. The output has q's dtype (float32 or
bfloat16).

A CPU tensor takes the plain version; a CUDA tensor launches one of three
kernel bodies or raises. ``plan`` picks the body from the shape alone, and
each counts its launches under its own name in ``build.LAUNCHES``:
``flash_attention[split]`` (decode: Sq <= 8, rows of 16 bytes, split over
the keys, the combine included), ``flash_attention[tc]`` (bf16 prefill on
the tensor cores, rows of 16 bytes) and ``flash_attention`` (everything
else: float32 prefill, FP32 FMA).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.kernels import build

FP32, TC, SPLIT = ("flash_attention", "flash_attention[tc]",
                   "flash_attention[split]")
for _name in (FP32, TC, SPLIT):
    build.LAUNCHES.setdefault(_name, 0)

#: the widest head the kernels' tiles take
MAX_D = 256
#: the most query rows the split body holds (its streamers keep every
#: row's accumulator)
SPLIT_MAX_ROWS = 8
#: CTAs the split grid aims for: four on each of an H100's 132 SMs
SPLIT_CTAS = 4 * 132
#: the fewest keys a split gets (where there are that many)
SPLIT_MIN_KEYS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# bh, sq, sk, d, scale, causal, has_window, window, has_softcap, softcap
_SHAPE = [_I, _I, _I, _I, _F, _I, _I, _I, _I, _F]
_ARGS = {
    FP32: ("sq_flash_attention", [_I, _P, _P, _P, _P, *_SHAPE, _P]),
    TC: ("sq_flash_attention_tc", [_P, _P, _P, _P, *_SHAPE, _P]),
    # ... kv_lo, kv_end, split_len, n_split, stream
    SPLIT: ("sq_flash_attention_split",
            [_I, _P, _P, _P, _P, _P, *_SHAPE, _I, _I, _I, _I, _P]),
}


@dataclass(frozen=True)
class Plan:
    """The body that runs (its launch-count name) and, for the split body,
    the keys [kv_lo, kv_end) it visits in ``n_split`` splits of
    ``split_len`` (the last may be shorter, none is empty)."""
    body: str
    n_split: int = 0
    split_len: int = 0
    kv_lo: int = 0
    kv_end: int = 0


def visible_keys(sq: int, sk: int, causal: bool,
                 window: Optional[int]) -> tuple:
    """[lo, end): the keys some query row sees, or every key when a row
    sees none (it then gets the mean of v over all Sk keys). Keys outside
    weigh exp(-1e30 - m) = 0 in every row."""
    lo, end = sk, 0
    for r in range(sq):
        qp = r + sk - sq
        r_lo = 0 if window is None else max(0, qp - window + 1)
        r_hi = min(sk - 1, qp) if causal else sk - 1
        if r_lo > r_hi:
            return 0, sk
        lo, end = min(lo, r_lo), max(end, r_hi + 1)
    return lo, end


def plan(dtype: torch.dtype, bh: int, sq: int, sk: int, d: int,
         aligned: bool, causal: bool = True,
         window: Optional[int] = None) -> Plan:
    """The body for this shape (``aligned``: q, k and v start on 16-byte
    boundaries). Rows of 16 bytes (D a multiple of 4 in float32, of 8 in
    bf16) and aligned take the split body at Sq <= ``SPLIT_MAX_ROWS``
    (a prefill CTA of 64 or 128 rows would leave nearly all of them idle,
    and its grid, one CTA a head, underfills the card at decode's BH),
    else, in bf16, the tensor-core body; the rest takes the FP32 body. The split
    count aims at ``SPLIT_CTAS`` CTAs with at least ``SPLIT_MIN_KEYS`` keys
    each."""
    vec = aligned and d % (16 // (4 if dtype == torch.float32 else 2)) == 0
    if vec and sq <= SPLIT_MAX_ROWS:
        lo, end = visible_keys(sq, sk, causal, window)
        keys = end - lo
        n = max(1, min(-(-SPLIT_CTAS // bh), -(-keys // SPLIT_MIN_KEYS)))
        split_len = -(-keys // n)
        return Plan(SPLIT, -(-keys // split_len), split_len, lo, end)
    if vec and dtype == torch.bfloat16:
        return Plan(TC)
    return Plan(FP32)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """The full-softmax attention of ``attention_ref``: float32 scores times
    1/sqrt(D), softcap, the masks at -1e30, softmax, then p @ v."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * scale.to(q.device)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _check(q, k, v, bq, bk):
    """Raise on what neither version takes (``bq`` and ``bk`` first cut to
    the lengths, as the reference does)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, H, S, D)")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tuple(k.shape) != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({b}, {h}, Sk, {d}) for q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must lie on one device")
    bq, bk = min(bq, sq), min(bk, sk)
    if bq < 1 or bk < 1 or sq % bq or sk % bk:
        raise ValueError(f"Sq={sq} and Sk={sk} must be positive multiples "
                         f"of bq={bq} and bk={bk}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Blocked online-softmax attention (causal, window, softcap); q (B, H,
    Sq, D), k and v (B, H, Sk, D), float32 or bfloat16 -> (B, H, Sq, D) in
    q's dtype. Sq and Sk must divide by ``bq`` and ``bk`` (each first cut to
    its length), as the reference asserts; the kernels tile by their own
    sizes whatever they are (``plan``)."""
    obs.inc("kernel.entry", op="flash_attention")
    _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    build.load_library("attention")
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got "
                         f"{q.device}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if d > MAX_D:
        raise ValueError(f"the kernel takes D <= {MAX_D}, got {d}")
    if b * h > 65535:
        raise ValueError(f"B*H = {b * h} exceeds the grid's 65535")
    if sq + sk >= 2 ** 30:
        raise ValueError(f"Sq + Sk = {sq + sk} must stay below 2^30")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if b * h == 0:
        return out
    # a window of Sk or more hides nothing, one of -(Sq + Sk) or less
    # everything: clamped there, the kernel's int32 positions cannot wrap
    win = None if window is None else max(-(sq + sk), min(int(window), sk))
    aligned = (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16 == 0
    p = plan(q.dtype, b * h, sq, sk, d, aligned, causal, win)
    shape = (b * h, sq, sk, d, 1.0 / math.sqrt(d), int(causal),
             int(win is not None), 0 if win is None else win,
             int(softcap is not None),
             0.0 if softcap is None else float(softcap))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    fn = build.c_function("attention", *_ARGS[p.body])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if p.body == TC:
            rc = fn(*ptrs, *shape, stream)
        elif p.body == SPLIT:
            # per (row, split): acc (D floats), then m and l (2 floats)
            ws = torch.empty(b * h * sq * p.n_split * (d + 2),
                             dtype=torch.float32, device=q.device)
            rc = fn(_DTYPES[q.dtype], *ptrs, ws.data_ptr(), *shape,
                    p.kv_lo, p.kv_end, p.split_len, p.n_split, stream)
        else:
            rc = fn(_DTYPES[q.dtype], *ptrs, *shape, stream)
    build.finish_launch(rc, p.body)
    return out
