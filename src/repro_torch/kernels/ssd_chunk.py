"""The Mamba-2 SSD chunked scan on the card: the intra-chunk CUDA kernel
with, beside it, its plain PyTorch version, and the inter-chunk recurrence
in PyTorch.

``ssd_chunk_scan`` replaces the Pallas ``src/repro/kernels/ssd_chunk.py::
ssd_chunk_scan``: it pads the sequence to whole chunks, runs the
intra-chunk block (``ssd_chunk``: kernel ``sq_ssd_chunk`` in
``csrc/ssd_chunk.cu``, or ``ssd_chunk_plain`` for CPU tensors), then the
recurrence over chunks that carries the (B, H, P, N) state and the
off-diagonal term y_off, the same PyTorch code on both devices, as the
reference keeps it in XLA. B and C are shared by the heads (n_groups = 1);
everything is float32. Its oracle is ``models.ssm._ssd_chunked``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. The kernel's launches count in ``LAUNCHES['ssd_chunk_scan']``. On
the card the products run on the tensor cores (3xTF32), the geometry from
the pure ``ssd_plan``: a persistent grid over (chunk, head) units, each
unit's x staged whole in one CTA's shared memory, which bounds the chunk
(816 at P = 64; a longer one is refused).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import build

build.LAUNCHES.setdefault("ssd_chunk_scan", 0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x, dt, a, bm, cm, y, st, work, n_chunks, L, H, P, N, heads, ctas,
# x_buffers, warps, stream
_ARGS = [_P] * 8 + [_LL] + [_I] * 8 + [_P]

#: shared bytes an SM of an H100 holds, and what each CTA reserves of it
SM_SMEM, CTA_RESERVED = 233472, 1024
#: SMs of an H100
SMS = 132


class SsdPlan(NamedTuple):
    """The kernel's geometry for one call (``ssd_plan``): what the C entry
    takes, and the workspace's side."""
    rows: int          # Lp, the chunk padded to whole 16-row tiles
    heads: int         # (chunk, head) units one CTA takes at most
    ctas: int          # the persistent grid
    warps: int         # warps of a CTA: 16 an SM (two CTAs of 8, or one)
    x_buffers: int     # 2: the next unit's x staged during this one's work


def smem_bytes(chunk: int, p: int, heads: int, x_buffers: int) -> int:
    """Shared bytes of one CTA (``ssd_smem`` of the CUDA source): x_buffers
    of Lp rows of x (P padded to 32, plus 4) and of w, cs and dt of
    ``heads`` units, a ticket, and a done count and a ready flag a
    buffer."""
    lp = -(-chunk // 16) * 16
    xs = -(-p // 32) * 32 + 4
    return 4 * (x_buffers * lp * (xs + 1) + 2 * heads * lp + 1
                + 2 * x_buffers)


def ssd_plan(n_chunks: int, chunk: int, h: int, p: int) -> SsdPlan:
    """The grid for ``n_chunks`` chunks of ``chunk`` rows and ``h`` heads
    of width ``p``: two CTAs of 8 warps an SM where two x buffers fit them
    (the next unit's x staged while a unit runs), else one CTA of 16 warps
    with two x buffers, or with one; as many CTAs as are resident (at most
    one a unit), the units split evenly (``heads`` at most each), more
    CTAs than are resident only where a CTA's cs and dt would not fit.
    Raises where one x does not fit a CTA's shared memory."""
    if min(n_chunks, chunk, h, p) < 1:
        raise ValueError(f"empty SSD call: {n_chunks} chunks of {chunk}, "
                         f"{h} heads of {p}")
    units = n_chunks * h
    lp = -(-chunk // 16) * 16
    for per_sm, xb in ((2, 2), (1, 2), (1, 1)):
        budget = min(build.MAX_SMEM, SM_SMEM // per_sm - CTA_RESERVED)
        # the units whose cs and dt fit beside x_buffers of x
        room = (budget - smem_bytes(chunk, p, 0, xb)) // (8 * lp)
        if room >= 1:
            heads = min(-(-units // min(units, per_sm * SMS)), room)
            return SsdPlan(lp, heads, -(-units // heads), 16 // per_sm, xb)
    raise ValueError(
        f"a chunk of {chunk} at P={p} takes "
        f"{smem_bytes(chunk, p, 1, 1)} bytes of x, over one CTA's "
        f"{build.MAX_SMEM} of shared memory")


def ssd_chunk_plain(xc: torch.Tensor, dtc: torch.Tensor, a: torch.Tensor,
                    bc: torch.Tensor, cc: torch.Tensor):
    """The intra-chunk block of ``_ssd_chunk_kernel``: xc (C, L, H, P), dtc
    (C, L, H), a (H,), bc/cc (C, L, N) -> (y_diag (C, L, H, P), states
    (C, H, P, N)), float32."""
    x, dt, bm, cm = xc.float(), dtc.float(), bc.float(), cc.float()
    ll = x.shape[1]
    da_cs = torch.cumsum(dt * a.float()[None, None, :], dim=1)   # (C,L,H)
    cb = torch.einsum("cln,cmn->clm", cm, bm)                     # (C,L,L)
    cs = da_cs.permute(0, 2, 1)                                   # (C,H,L)
    seg = cs[..., :, None] - cs[..., None, :]                     # (C,H,L,L)
    tri = torch.ones((ll, ll), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(tri, torch.exp(seg), torch.zeros((), device=x.device))
    scores = cb[:, None] * decay * dt.permute(0, 2, 1)[:, :, None, :]
    y_diag = torch.einsum("chlm,cmhp->clhp", scores, x)
    w = torch.exp(da_cs[:, -1:, :] - da_cs) * dt                  # (C,L,H)
    states = torch.einsum("clhp,cln->chpn", x * w[..., None], bm)
    return y_diag, states


def _check_chunks(xc, dtc, a, bc, cc):
    if xc.dim() != 4:
        raise ValueError(f"xc must be (C, L, H, P), got {tuple(xc.shape)}")
    c, ll, h, _ = xc.shape
    n = bc.shape[-1]
    if tuple(dtc.shape) != (c, ll, h) or tuple(a.shape) != (h,) or \
            tuple(bc.shape) != (c, ll, n) or cc.shape != bc.shape:
        raise ValueError(
            f"dtc {tuple(dtc.shape)}, a {tuple(a.shape)}, bc "
            f"{tuple(bc.shape)} and cc {tuple(cc.shape)} do not match xc "
            f"{tuple(xc.shape)}")
    if len({t.device for t in (xc, dtc, a, bc, cc)}) != 1:
        raise ValueError("the inputs must lie on one device")


def ssd_chunk(xc: torch.Tensor, dtc: torch.Tensor, a: torch.Tensor,
              bc: torch.Tensor, cc: torch.Tensor):
    """The intra-chunk block: (y_diag, states) of ``ssd_chunk_plain``, by
    the kernel for CUDA tensors (taken as float32)."""
    _check_chunks(xc, dtc, a, bc, cc)
    if xc.device.type == "cpu":
        return ssd_chunk_plain(xc, dtc, a, bc, cc)
    c, ll, h, p = xc.shape
    n = bc.shape[-1]
    plan = ssd_plan(c, ll, h, p) if xc.numel() and n else None
    fn = build.c_function("ssd_chunk", "sq_ssd_chunk", _ARGS)
    if xc.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got "
                         f"{xc.device}")
    x, dt, av, bm, cm = (t.float().contiguous() for t in (xc, dtc, a, bc, cc))
    y = torch.empty_like(x)
    st = torch.empty((c, h, p, n), dtype=torch.float32, device=x.device)
    if plan is None:
        return y, st.zero_()
    work = torch.empty((c, plan.rows, plan.rows), dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), dt.data_ptr(), av.data_ptr(), bm.data_ptr(),
                cm.data_ptr(), y.data_ptr(), st.data_ptr(), work.data_ptr(),
                c, ll, h, p, n, plan.heads, plan.ctas, plan.x_buffers,
                plan.warps, stream)
    build.finish_launch(rc, "ssd_chunk_scan")
    return y, st


def to_chunks(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
              cm: torch.Tensor, chunk: int):
    """The intra-chunk inputs of a scan: x (B,S,H,P), dt (B,S,H) and bm, cm
    (B,S,N) zero-padded to whole chunks along S, then (B * chunks, chunk,
    ...)."""
    if x.dim() != 4 or bm.dim() != 3:
        raise ValueError("x must be (B, S, H, P) and bm, cm (B, S, N)")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    b, s, h, p = x.shape
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    return (x.reshape(b * nc, chunk, h, p), dt.reshape(b * nc, chunk, h),
            bm.reshape(b * nc, chunk, -1), cm.reshape(b * nc, chunk, -1))


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   bm: torch.Tensor, cm: torch.Tensor, *,
                   chunk: int = 128) -> torch.Tensor:
    """Full SSD scan: the intra-chunk kernel and the inter-chunk recurrence.
    x (B,S,H,P); dt (B,S,H) fp32 post-softplus; a (H,) negative; bm/cm
    (B,S,N) (n_groups=1). Returns (B,S,H,P) fp32."""
    obs.inc("kernel.entry", op="ssd_chunk_scan")
    b, s, h, p = x.shape
    n = bm.shape[-1]
    xc, dtc, bc, cc = to_chunks(x, dt, bm, cm, chunk)
    nc = xc.shape[0] // b
    y_diag, states = ssd_chunk(xc, dtc, a, bc, cc)

    # inter-chunk recurrence and the off-diagonal contribution
    y_diag = y_diag.reshape(b, nc, chunk, h, p)
    states = states.reshape(b, nc, h, p, n)
    da_cs = torch.cumsum(dtc.reshape(b, nc, chunk, h).float()
                         * a.float()[None, None, None, :], dim=2)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])                 # (b,nc,h)
    prev = torch.empty_like(states)                             # (b,nc,h,p,n)
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    cmr = cc.reshape(b, nc, chunk, n).float()
    y_off = torch.einsum("bcln,bchpn->bclhp", cmr, prev) \
        * torch.exp(da_cs)[..., None]
    return (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
