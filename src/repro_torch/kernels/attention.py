"""Flash attention forward on the card: the CUDA wrapper and, beside it, its
plain PyTorch version.

``flash_attention`` replaces the Pallas ``src/repro/kernels/attention.py::
flash_attention`` (kernel ``sq_flash_attention`` in ``csrc/attention.cu``);
``attention_plain`` is the port of the reference's oracle
``kernels/ref.py::attention_ref``. Both compute softmax attention over q
(B, H, Sq, D) and k, v (B, H, Sk, D) (kv heads already broadcast; there is
no GQA) in float32, with an optional causal mask, sliding window and logit
softcap, and queries right-aligned against the keys (query i at position
i + Sk - Sq), so Sq = 1 decodes against a long cache. Masked scores are
-1e30, as in the reference: a row that sees no key gets the mean of v. The
output has q's dtype (float32 or bfloat16).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel's launches count in ``LAUNCHES['flash_attention']``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

build.LAUNCHES.setdefault("flash_attention", 0)

#: the widest head the kernel's shared-memory tiles take
MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# dtype, q, k, v, o, bh, sq, sk, d, scale, causal, has_window, window,
# has_softcap, softcap, stream
_ARGS = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _F, _P]


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
    its length), as the reference asserts; the kernel tiles by 64 rows
    whatever they are."""
    _check(q, k, v, bq, bk)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    fn = build.c_function("attention", "sq_flash_attention", _ARGS)
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
    win = 0 if window is None else max(-(sq + sk), min(int(window), sk))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out.data_ptr(), b * h, sq, sk, d, 1.0 / math.sqrt(d),
                int(causal), int(window is not None), win,
                int(softcap is not None),
                0.0 if softcap is None else float(softcap), stream)
    build.finish_launch(rc, "flash_attention")
    return out
