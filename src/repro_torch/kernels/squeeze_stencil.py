"""Block-level Squeeze stencil kernels: the CUDA wrappers and, beside each,
its plain PyTorch version.

  * ``stencil_step_blocks``      (v1) -- one step; the center and its 8
    Moore-neighbor blocks staged whole; replaces the Pallas
    ``squeeze_stencil.py::stencil_step_blocks``.
  * ``stencil_step_strips``      (v2) -- one step from the center and its
    halo strips, gathered before the launch by a kernel of their own
    (``gather_halo_strips``, one launch, counted under its name); replaces
    ``stencil_step_strips``.
    v1 and v2 run v4's warp body at k = 1 under ``micro_mask`` (v1 its
    nine blocks whole, v2 the centers and strips as two runs); ``step_plan``
    picks W and the warps, and ring weights that are not the rule's own (or
    windows over 32 cells) run the CTA body, counted as ``<name>[wide]``.
  * ``stencil_step_fused``       (v3) -- one step; replaces
    ``stencil_step_fused``. v4 at k = 1: ``fused_plan(..., k=1)`` picks
    its body, the warp body's instance compiled at k = 1 (``[wide]``, the
    CTA body, for windows over 32 cells or other ring weights).
  * ``stencil_step_fused_k``     (v4) -- k exact steps per launch on a
    depth-k window (1 <= k <= rho); replaces ``stencil_step_fused_k``.
    Windows of up to 32 cells a side run the warp body (a lane a window
    column, its cells in registers, 32 / W windows a warp); ``fused_plan``
    picks the body and its geometry, and wider windows (or ring weights
    that are not the rule's own) run the CTA body, counted as
    ``<name>[wide]``.
  * ``stencil_step_mxu_batched`` (v5) -- k exact steps of B simulations in
    one launch, the Moore aggregate as rank-1 banded products on the tensor
    cores (TF32 ``mma.sync``: one pass for the uint8 CA states, 3xTF32 for
    float32), a warp per pair of window slots, P slots per CTA work item;
    replaces ``stencil_step_mxu_batched``. ``mxu_plan`` picks the launch
    geometry by shape; windows wider than 8 cells run the kernel's wide
    instance, counted as ``<name>[wide]``.
  * ``stencil_step_fused_k_local`` and ``stencil_step_mxu_k_local`` -- v4
    and v5 over one shard's blocks, their halo given as four pieces
    assembled from the exchanged strips and their neighbors as an (nbl, 8)
    existence table (the distributed engine's compute); replace the
    reference's entries of the same names; the same bodies and launch
    names as v4 and v5.
  * ``stencil_step_mxu`` / ``stencil_step_mxu_k`` (v5 on one simulation)
    and ``life_step_blocks`` / ``_strips`` / ``_fused`` (v1-v3 with LIFE):
    the reference's single-state entries.

The kernels live in ``csrc/squeeze_stencil.cu``. A wrapper runs the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises (a failed build raises ``KernelBuildError``). Each
wrapper counts its launches in ``LAUNCHES``.

States are ``(B?, C?, n_blocks, rho, rho)``: the channel axis is present
iff ``workload.n_channels > 1``. v1-v4 take an optional leading batch
axis; ``stencil_step_mxu_batched`` requires it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compact import BlockLayout, halo_regions
from repro_torch.kernels import build
from repro_torch.workloads.base import (StencilWorkload, banded_operators,
                                        halo_needs)
from repro_torch.workloads.rules import LIFE, RULE_HEAT, RULE_TOTALISTIC

#: kernel name -> launches since the last ``reset_launches`` (shared by
#: every kernel wrapper module)
LAUNCHES = build.LAUNCHES
LAUNCHES.update(dict.fromkeys(
    ("stencil_step_blocks", "stencil_step_blocks[wide]",
     "stencil_step_strips", "stencil_step_strips[wide]",
     "gather_halo_strips", "stencil_step_fused", "stencil_step_fused[wide]",
     "stencil_step_fused_k", "stencil_step_fused_k[wide]",
     "stencil_step_mxu_batched", "stencil_step_mxu_batched[wide]",
     "stencil_step_fused_k_local", "stencil_step_fused_k_local[wide]",
     "stencil_step_mxu_k_local", "stencil_step_mxu_k_local[wide]"), 0))
reset_launches = build.reset_launches

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_RULE_ARGS = [_I, _I, _F, _F, _F, _F, _F, _F, _F, _P]
_SIGNATURES = {
    # rule, src, dst, nbr (v2: strips), micro_mask, nb, batch, rho, W,
    # warps (step_plan; W = 0 for the CTA body), ...
    "sq_stencil_step_blocks": [_I, _P, _P, _P, _P, _LL] + [_I] * 4
    + _RULE_ARGS,
    "sq_stencil_step_strips": [_I, _P, _P, _P, _P, _LL] + [_I] * 4
    + _RULE_ARGS,
    # src, strips, nbr, nb, rows, rho, element bytes, needs bits, stream
    "sq_gather_halo_strips": [_P, _P, _P, _LL] + [_I] * 4 + [_P],
    # rule, src, dst, nbr, window_mask(1), nb, batch, rho, W, warps
    # (fused_plan at k = 1; W = 0 for the CTA body), ...
    "sq_stencil_step_fused": [_I, _P, _P, _P, _P, _LL] + [_I] * 4
    + _RULE_ARGS,
    # ..., k, W, warps (fused_plan; W = 0 for the CTA body), ...
    "sq_stencil_step_fused_k": [_I, _P, _P, _P, _P, _LL] + [_I] * 5
    + _RULE_ARGS,
    # rule, src, dst, nbr, wmask, R, C, n_terms, nb, batch, rho, k, P,
    # nt, spw, warps, ...
    "sq_stencil_step_mxu": [_I, _P, _P, _P, _P, _P, _P, _I, _LL]
    + [_I] * 7 + _RULE_ARGS,
    # rule, src, dst, top, bot, west, east, existence, wmask, nbl, batch,
    # rho, k, W, warps, ...
    "sq_stencil_step_fused_k_local": [_I] + [_P] * 8 + [_LL] + [_I] * 5
    + _RULE_ARGS,
    # ... wmask, R, C, n_terms, nbl, batch, rho, k, P, nt, spw, warps, ...
    "sq_stencil_step_mxu_k_local": [_I] + [_P] * 10 + [_I, _LL]
    + [_I] * 7 + _RULE_ARGS,
}


def _c_function(fn: str):
    return build.c_function("squeeze_stencil", fn, _SIGNATURES[fn])


# ======================================================================
# shapes
# ======================================================================
def _as_batched(layout: BlockLayout, workload: StencilWorkload,
                state: torch.Tensor, batched: Optional[bool] = None):
    """View ``state`` as (B, C, nb, rho, rho); returns the view and
    whether the input had a batch axis."""
    rho, nb, nc = layout.rho, layout.n_blocks, workload.n_channels
    base = 3 + (nc > 1)
    if batched is None:
        batched = state.dim() == base + 1
    if state.dim() != base + batched or \
            tuple(state.shape[-3:]) != (nb, rho, rho) or \
            (nc > 1 and state.shape[-4] != nc):
        want = ("(B, " if batched else "(") + \
            (f"{nc}, " if nc > 1 else "") + f"{nb}, {rho}, {rho})"
        raise ValueError(f"state shape {tuple(state.shape)} does not match "
                         f"{want} for workload {workload.name!r}")
    s = state if batched else state[None]
    return (s if nc > 1 else s[:, None]), batched


def _unbatch(out5: torch.Tensor, workload: StencilWorkload, batched: bool):
    out = out5 if workload.n_channels > 1 else out5[:, 0]
    return out if batched else out[0]


# ======================================================================
# plain PyTorch versions (the CPU path, and the oracle on the card)
# ======================================================================
def block_step_k(layout: BlockLayout, x: torch.Tensor,
                 workload: StencilWorkload, k: int) -> torch.Tensor:
    """k exact steps of one simulation in plain PyTorch, x (C?, nb, rho,
    rho), any k >= 1: the ``block`` engine's step and, for k <= rho, the
    kernels' plain versions."""
    if k == 1:
        padded = layout.pad_with_halo(x)
        mask = layout.device_table("micro_mask", x.device)
        return workload.tile_rule(x, padded, mask).to(x.dtype)
    padded = layout.pad_with_halo_k(x, k)
    hmask = layout.device_table("halo_mask", x.device, k)
    return workload.tile_rule_k(padded, hmask, k).to(x.dtype)


def per_simulation(workload: StencilWorkload, fn, s5: torch.Tensor
                   ) -> torch.Tensor:
    """``fn`` of each simulation of ``s5`` (B, C, ...), which it gets as
    (C?, ...) (the channel axis only for a multi-channel workload),
    stacked back to (B, C, ...)."""
    if workload.n_channels > 1:
        return torch.stack([fn(x) for x in s5])
    return torch.stack([fn(x[0]) for x in s5])[:, None]


def _plain_batched(layout, state, workload, k, batched=None):
    s5, batched = _as_batched(layout, workload, state, batched)
    out = per_simulation(workload, lambda x: block_step_k(
        layout, x, workload, k), s5)
    return _unbatch(out, workload, batched)


def stencil_step_fused_plain(layout: BlockLayout, state: torch.Tensor,
                             workload: StencilWorkload = LIFE):
    """One step: Moore halo through the neighbor table, then the rule
    under ``micro_mask``."""
    return _plain_batched(layout, state, workload, 1)


#: v1 and v2 compute v3's function (the strips v2 leaves as zeros have
#: weight 0), so they share its plain version
stencil_step_blocks_plain = stencil_step_fused_plain
stencil_step_strips_plain = stencil_step_fused_plain


def stencil_step_fused_k_plain(layout: BlockLayout, state: torch.Tensor,
                               workload: StencilWorkload = LIFE, *,
                               k: int = 2):
    """k steps: depth-k halo through ``offset_table(k)``, then
    ``tile_rule_k`` under ``halo_mask(k)`` (gated at every substep)."""
    return _plain_batched(layout, state, workload, k)


def stencil_step_mxu_batched_plain(layout: BlockLayout, states: torch.Tensor,
                                   workload: StencilWorkload = LIFE, *,
                                   k: int = 1, p: Optional[int] = None):
    """k steps of B simulations; the result does not depend on ``p``."""
    del p
    return _plain_batched(layout, states, workload, k, batched=True)


def window_from_pieces(state: torch.Tensor, halo) -> torch.Tensor:
    """(..., n, rho+2k, rho+2k) windows from the centers (..., n, rho, rho)
    and the halo pieces (top, bot, west, east) of the local entries."""
    top, bot, west, east = halo
    return torch.cat([top, torch.cat([west, state, east], dim=-1), bot],
                     dim=-2)


def existence_window_mask(layout: BlockLayout, existence: torch.Tensor,
                          k: int) -> torch.Tensor:
    """(n, w, w) uint8: ``window_mask(k)`` with each halo region gated by
    the block's row of the (n, 8) existence table."""
    wm = layout.device_table("window_mask", existence.device, k)
    mask = wm.expand((existence.shape[0],) + wm.shape).clone()
    gate = (existence != 0).to(torch.uint8)
    for d, (ys, xs) in enumerate(halo_regions(layout.rho, k)):
        mask[:, ys, xs] *= gate[:, d, None, None]
    return mask


def stencil_step_fused_k_local_plain(layout: BlockLayout,
                                     state: torch.Tensor, halo,
                                     existence: torch.Tensor,
                                     workload: StencilWorkload = LIFE, *,
                                     k: int = 2) -> torch.Tensor:
    """k steps of one shard's blocks: the window assembled from the
    pieces, then ``tile_rule_k`` under the existence-gated window mask.
    state (B?, C, nbl, rho, rho), pieces with the same leading axes."""
    batched = state.dim() == 5
    s5 = state if batched else state[None]
    pieces = [h if batched else h[None] for h in halo]
    mask = existence_window_mask(layout, existence, k)
    out = per_simulation(workload, lambda x: workload.tile_rule_k(
        x, mask, k), window_from_pieces(s5, pieces)).to(state.dtype)
    return out if batched else out[0]


def stencil_step_mxu_k_local_plain(layout: BlockLayout, states: torch.Tensor,
                                   halo, existence: torch.Tensor,
                                   workload: StencilWorkload = LIFE, *,
                                   k: int = 2, p: Optional[int] = None
                                   ) -> torch.Tensor:
    """k steps of B simulations over one shard's blocks; the result does
    not depend on ``p``."""
    del p
    return stencil_step_fused_k_local_plain(layout, states, halo, existence,
                                            workload, k=k)


# ======================================================================
# v2 halo strips (a kernel of their own on the card; XLA's gathers in the
# reference)
# ======================================================================
def gather_halo_strips_plain(layout: BlockLayout, s: torch.Tensor,
                             needs=None) -> torch.Tensor:
    """(..., C, nb, 4, rho+2) halo strips of ``s`` (..., C, nb, rho, rho)
    by strip-level gathers through the neighbor table, in PyTorch. Rows: 0
    the top (NW's SE cell, N's bottom row, NE's SW cell), 1 the bottom
    (SW's NE cell, S's top row, SE's NW cell), 2 W's east column and 3 E's
    west column (the last two entries of rows 2-3 pad). ``needs`` (a
    ``halo_needs`` tuple) leaves the directions the workload never reads
    as zeros, ungathered."""
    need_n, need_s, need_w, need_e, need_nw, need_ne, need_sw, need_se = \
        needs if needs is not None else (True,) * 8
    table = layout.device_table("neighbor_table", s.device)  # ghost = nb

    def take(piece, d, need):
        """piece (..., nb, L) of every block, gathered at direction d's
        neighbors; a ghost reads the appended zero row."""
        if not need:
            return piece.new_zeros(piece.shape)
        padded = torch.cat([piece, piece.new_zeros(
            piece.shape[:-2] + (1, piece.shape[-1]))], dim=-2)
        return padded.index_select(-2, table[:, d])

    row_top = torch.cat([take(s[..., -1, -1:], 0, need_nw),
                         take(s[..., -1, :], 1, need_n),
                         take(s[..., -1, :1], 2, need_ne)], dim=-1)
    row_bot = torch.cat([take(s[..., 0, -1:], 5, need_sw),
                         take(s[..., 0, :], 6, need_s),
                         take(s[..., 0, :1], 7, need_se)], dim=-1)
    col_w = torch.nn.functional.pad(take(s[..., :, -1], 3, need_w), (0, 2))
    col_e = torch.nn.functional.pad(take(s[..., :, 0], 4, need_e), (0, 2))
    return torch.stack([row_top, row_bot, col_w, col_e], dim=-2)


#: the ``halo_needs`` entry (N, S, W, E, NW, NE, SW, SE) of each MOORE_DIRS
#: direction (NW, N, NE, W, E, SW, S, SE): the gather kernel reads
#: direction d where bit d of its ``needs`` is set
_NEED_OF_DIR = (4, 0, 5, 2, 3, 6, 1, 7)


def _gather_halo_strips(layout: BlockLayout, s: torch.Tensor,
                        needs=None) -> torch.Tensor:
    """``gather_halo_strips_plain``'s strips: for a CUDA tensor one launch
    of the gather kernel (any element of 1 or 4 bytes), counted as
    ``gather_halo_strips``; for a CPU tensor the plain version."""
    if s.device.type == "cpu":
        return gather_halo_strips_plain(layout, s, needs)
    fn = _c_function("sq_gather_halo_strips")
    rho, nb = layout.rho, layout.n_blocks
    if s.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got "
                         f"{s.device}")
    if s.dim() < 3 or tuple(s.shape[-3:]) != (nb, rho, rho):
        raise ValueError(f"state shape {tuple(s.shape)} does not match "
                         f"(..., {nb}, {rho}, {rho})")
    if s.element_size() not in (1, 4):
        raise TypeError(f"the strip gather moves elements of 1 or 4 bytes, "
                        f"got {s.dtype}")
    if not s.is_contiguous():
        raise ValueError("state must be contiguous")
    out = torch.empty(s.shape[:-2] + (4, rho + 2), dtype=s.dtype,
                      device=s.device)
    rows = s.numel() // (nb * rho * rho)
    if rows == 0:
        return out
    needs = needs if needs is not None else (True,) * 8
    bits = sum(1 << d for d, i in enumerate(_NEED_OF_DIR) if needs[i])
    table = layout.device_table("neighbor_table", s.device)
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        rc = fn(s.data_ptr(), out.data_ptr(), table.data_ptr(), nb, rows,
                rho, s.element_size(), bits, stream)
    build.finish_launch(rc, "gather_halo_strips")
    return out


def gather_halo_strips(layout: BlockLayout, state: torch.Tensor
                       ) -> torch.Tensor:
    """Single-channel entry point: (nb, rho, rho) -> (nb, 4, rho+2)."""
    obs.inc("kernel.entry", op="gather_halo_strips")
    return _gather_halo_strips(layout, state[None])[0]


# ======================================================================
# v5 operands
# ======================================================================
@functools.lru_cache(maxsize=64)
def _mxu_operators(workload: StencilWorkload, w: int):
    """(R, C), each (T, w, w) float32: the banded operators of the rank-1
    terms of the workload's weights over one w x w slot, so the Moore
    aggregate of a slot is ``sum_t R[t] @ X @ C[t].T``."""
    return banded_operators(workload.weight_factors, w, np.float32)


@functools.lru_cache(maxsize=64)
def _mxu_operators_on(workload: StencilWorkload, w: int, device: str):
    rm, cm = _mxu_operators(workload, w)
    return (torch.from_numpy(rm).to(device), torch.from_numpy(cm).to(device))


#: most warps of one v5 CTA (``kMxuWarps`` in the source)
MXU_WARPS = 8


class MxuPlan(NamedTuple):
    """The v5 launch geometry of one shape (``mxu_plan``)."""
    nt: int       # 8 x 8 tiles a window side: W = 8 nt >= w
    passes: int   # TF32 products per product: 1 (uint8) or 3 (float32)
    warps: int    # warps of a CTA
    spw: int      # window slots a warp: a pair, or one
    smem: int     # shared bytes of a CTA
    body: str     # '' (one tile) or '[wide]'


def mxu_plan(dtype: torch.dtype, n_channels: int, rho: int, k: int, p: int,
             pieces: bool = False) -> MxuPlan:
    """The launch geometry of v5 (``pieces=False``) or of its shard-local
    entry (``pieces=True``) for P slots of ``n_channels`` channels of
    ``dtype``: the window w = rho + 2k padded to W = 8 ceil(w / 8); one
    TF32 pass for uint8 CA states, three (3xTF32) for float32; a warp per
    pair of slots, up to ``MXU_WARPS`` warps; each warp with staging
    buffers (nine whole blocks, or the center and its four halo pieces, per
    slot and channel) and two W x W float32 window buffers per slot and
    channel. The body is the kernel's one-tile instance for W = 8 (two
    staging buffers: the next pair's loads fly while this pair computes),
    else its wide instance (``[wide]``, one).
    Where that exceeds a CTA's shared memory, fewer warps, then one slot a
    warp. Raises when nothing fits."""
    w = rho + 2 * k
    nt = -(-w // 8)
    body = "" if nt == 1 else "[wide]"
    esize = torch.empty((), dtype=dtype).element_size()
    slot = w * w if pieces else 9 * rho * rho

    def smem(warps, spw):
        stage = -(-spw * n_channels * slot * esize // 16) * 16
        return warps * ((1 if body else 2) * stage
                        + 2 * spw * n_channels * 256 * nt * nt)
    for spw in (2, 1):
        for warps in range(min(MXU_WARPS, -(-p // spw)), 0, -1):
            if smem(warps, spw) <= build.MAX_SMEM:
                return MxuPlan(nt, 3 if dtype == torch.float32 else 1, warps,
                               spw, smem(warps, spw), body)
    raise ValueError(f"a {w}x{w} window of {n_channels} channel(s) exceeds "
                     f"one CTA's {build.MAX_SMEM} bytes of shared memory "
                     f"({smem(1, 1)} bytes)")


# ======================================================================
# v4 and kernel 6 geometry
# ======================================================================
#: most warps of one CTA of the v4 warp body (``kWarpWarps`` in the source)
FUSED_WARPS = 8
#: threads of one CTA of the CTA body (``kThreads``), the cells of the
#: windows it holds (``kCellsPerCta``)
CTA_THREADS, CTA_CELLS = 256, 1024


class FusedPlan(NamedTuple):
    """The body and launch geometry of v4 or kernel 6 for one shape
    (``fused_plan``); the C entries take W and warps."""
    W: int        # lanes a window: a power of two >= w (0: the CTA body)
    windows: int  # windows a warp, 32 / W (a CTA's for the CTA body)
    warps: int    # warps a CTA
    smem: int     # shared bytes of a CTA
    body: str     # '' (the warp body) or '[wide]' (the CTA body)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _cta_plan(esize: int, n_channels: int, w: int,
              cta_extra: int) -> FusedPlan:
    """The CTA body's geometry for a window of w cells a side (``[wide]``):
    the windows of up to ``CTA_CELLS`` cells, two w^2 buffers of all
    channels each and ``cta_extra`` more elements a window and channel
    (v1's nine blocks), ids and mask, as ``launch_step`` lays them out."""
    ww = w * w
    g = max(1, CTA_CELLS // ww)
    smem = _round16(g * n_channels * (2 * ww + cta_extra) * esize) \
        + g * 9 * 4 + ww
    if smem > build.MAX_SMEM:
        raise ValueError(f"a {w}x{w} window of {n_channels} channel(s) "
                         f"exceeds one CTA's {build.MAX_SMEM} bytes of "
                         f"shared memory ({smem} bytes)")
    return FusedPlan(0, g, CTA_THREADS // 32, smem, "[wide]")


def _warp_plan(esize: int, n_channels: int, w: int, region) -> FusedPlan:
    """The warp body's geometry for a window of w <= 32 cells a side: W
    the power of two >= max(w, 8), G = 32 / W windows a warp, a warp's
    staging buffer each channel's region of ``region(G)`` elements, 16-byte
    aligned, and 16 zero bytes; the most warps (up to ``FUSED_WARPS``) that
    fit a CTA's shared memory."""
    big_w = 8 if w <= 8 else 16 if w <= 16 else 32
    g = 32 // big_w
    per_warp = n_channels * (_round16(region(g) * esize) + 16)
    warps = min(FUSED_WARPS, build.MAX_SMEM // per_warp)
    if warps < 1:
        raise ValueError(f"one group of {g} {w}x{w} window(s) of "
                         f"{n_channels} channel(s) exceeds one CTA's "
                         f"{build.MAX_SMEM} bytes of shared memory "
                         f"({per_warp} bytes)")
    return FusedPlan(big_w, g, warps, warps * per_warp, "")


def fused_plan(dtype: torch.dtype, n_channels: int, rho: int, k: int,
               pieces: bool = False, rule_form: bool = True) -> FusedPlan:
    """The body and launch geometry of v4 (``pieces=False``; v3 at k = 1)
    or of kernel 6 (``pieces=True``) for a window w = rho + 2k of
    ``n_channels`` channels of ``dtype``. For w <= 32 the warp body: W the
    power of two >= max(w, 8), so G = 32 / W = 4, 2 or 1 windows a warp; a
    warp-private staging
    buffer of one group's blocks, each channel's region (v4: the G centers
    and a slot for each window's 8 neighbor blocks, whole blocks; kernel 6:
    w^2 elements a window, its center and four halo pieces) 16-byte
    aligned and followed by 16 zero bytes; the most warps (up to
    ``FUSED_WARPS``) that fit a CTA's shared memory. Wider windows, and
    ring weights that are not the rule's own (``rule_form`` false, see
    ``_rule_form``: the warp body computes only that sum), run the CTA body
    (``[wide]``, W = 0): the windows of up to 1024 cells of a CTA's 256
    threads, two w^2 buffers of all channels each, ids and mask, as
    ``launch_step`` in the source lays them out. Raises when nothing
    fits."""
    w = rho + 2 * k
    esize = torch.empty((), dtype=dtype).element_size()
    if w > 32 or not rule_form:
        return _cta_plan(esize, n_channels, w, 0)
    return _warp_plan(esize, n_channels, w,
                      lambda g: g * w * w if pieces else 9 * g * rho * rho)


def step_plan(dtype: torch.dtype, n_channels: int, rho: int,
              strips: bool = False, rule_form: bool = True) -> FusedPlan:
    """The body and launch geometry of v1 (``strips=False``) or v2
    (``strips=True``): one step, a window w = rho + 2, on v4's warp body
    for w <= 32 (W, G and the warps as ``fused_plan`` picks them) with each
    channel's staging region v1's G centers and 8 G whole neighbor blocks
    (v4's), or v2's G centers, then (16-byte aligned) G strips of 4 w
    elements. Wider windows and ring weights that are not the rule's own
    run the CTA body (``[wide]``), whose shared memory also holds v1's nine
    blocks a window. Raises when nothing fits."""
    w, esize = rho + 2, torch.empty((), dtype=dtype).element_size()
    if w > 32 or not rule_form:
        return _cta_plan(esize, n_channels, w, 0 if strips else 9 * rho * rho)

    def region(g):
        if strips:   # strips_at() in the source
            return _round16(g * rho * rho * esize) // esize + 4 * g * w
        return 9 * g * rho * rho
    return _warp_plan(esize, n_channels, w, region)


def _rule_form(workload: StencilWorkload) -> bool:
    """Whether the workload's ring weights, as the float32 values the
    kernel takes, are the one aggregate sum the warp body compiles for its
    rule (``form_holds`` in the source): 1 on both rings for the CA rules,
    1 orthogonal and 0 diagonal for heat, both rings other than 0 and 1
    for Gray-Scott. Every shipped workload's are."""
    wd, wo = workload.ring_weights
    wd, wo, wc = (float(np.float32(x)) for x in (wd, wo, wo - wd))
    rule = _rule(workload)
    if rule == RULE_TOTALISTIC:
        return wd == 1 and wc == 0
    if rule == RULE_HEAT:
        return wd == 0 and wo == 1
    return wd not in (0, 1) and wc not in (0, 1)


def _fused_plan_for(layout: BlockLayout, state: torch.Tensor,
                    workload: StencilWorkload, k: int,
                    pieces: bool) -> FusedPlan:
    """``fused_plan`` for v4 or kernel 6 on ``state``, after checking the
    warp body's 32-bit geometry."""
    return _checked(layout, state, workload, fused_plan(
        state.dtype, workload.n_channels, layout.rho, k, pieces,
        _rule_form(workload)))


def _step_plan_for(layout: BlockLayout, state: torch.Tensor,
                   workload: StencilWorkload, strips: bool) -> FusedPlan:
    """``step_plan`` for v1 or v2 on ``state``, checked as v4's."""
    return _checked(layout, state, workload, step_plan(
        state.dtype, workload.n_channels, layout.rho, strips,
        _rule_form(workload)))


def _checked(layout: BlockLayout, state: torch.Tensor,
             workload: StencilWorkload, plan: FusedPlan) -> FusedPlan:
    """``plan``, after checking the warp body's 32-bit geometry."""
    if not plan.body:
        n = state.shape[-3]
        items = (state.numel() // (n * layout.rho ** 2)
                 // workload.n_channels) * -(-n // plan.windows)
        if n >= 2 ** 30 or items >= 2 ** 30:
            raise ValueError(f"{n} blocks in {items} groups exceed the "
                             "fused kernel's 32-bit geometry")
    return plan


# ======================================================================
# CUDA launches
# ======================================================================
def _rule_args(workload: StencilWorkload, stream: int):
    """The C arguments after the shapes: born, survive, p0..p3, the ring
    weights (diagonal, orthogonal, orthogonal - diagonal) and the
    stream."""
    params = workload.kernel_params()
    wd, wo = workload.ring_weights
    return [params["born"], params["survive"], *params["p"], wd, wo,
            wo - wd, stream]


def _check_cuda(state: torch.Tensor, workload: StencilWorkload,
                out: Optional[torch.Tensor]) -> torch.Tensor:
    if state.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got "
                         f"{state.device}")
    if state.dtype != workload.dtype:
        raise TypeError(f"workload {workload.name!r} steps "
                        f"{workload.dtype} states, got {state.dtype}")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    if out is None:
        return torch.empty_like(state)
    _check_out(state, out)
    return out


def _check_out(state: torch.Tensor, out: torch.Tensor) -> None:
    if out.shape != state.shape or out.dtype != state.dtype or \
            out.device != state.device or not out.is_contiguous():
        raise ValueError("out must be a contiguous tensor of the state's "
                         "shape, dtype and device")
    if out.data_ptr() == state.data_ptr():
        raise ValueError("out must not alias the state the kernel reads "
                         "its halos from")


def _launch_step(name, layout, state, workload, k, out, strips=None):
    """Launch v1 ('stencil_step_blocks'), v2 ('stencil_step_strips'; the
    strips are gathered here, by the gather kernel, unless given), v3 or v4
    on ``state`` with the body its plan picks, counted under its name."""
    fn = _c_function("sq_" + name)
    s5, _ = _as_batched(layout, workload, state)
    out = _check_cuda(state, workload, out)
    b = s5.shape[0]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    dev = state.device
    if name == "stencil_step_strips":
        if strips is None:
            strips = _gather_halo_strips(layout, s5,
                                         halo_needs(workload.weights2d))
        want = s5.shape[:3] + (4, layout.rho + 2)
        if strips.shape != want or strips.dtype != state.dtype or \
                strips.device != dev or not strips.is_contiguous():
            raise ValueError(f"strips must be a contiguous {tuple(want)} "
                             "tensor of the state's dtype and device")
        halo = strips
    else:
        halo = layout.device_table("neighbor_table", dev)
    if name.startswith("stencil_step_fused"):
        mask = layout.device_table("window_mask", dev, k)
    else:
        mask = layout.device_table("micro_mask", dev)
    args = [_rule(workload), state.data_ptr(), out.data_ptr(),
            halo.data_ptr(), mask.data_ptr(), layout.n_blocks, b, layout.rho]
    if name.startswith("stencil_step_fused"):   # v3 is v4 at k = 1
        plan = _fused_plan_for(layout, state, workload, k, False)
        args += [k] if name == "stencil_step_fused_k" else []
    else:
        plan = _step_plan_for(layout, state, workload,
                              name == "stencil_step_strips")
    args += [plan.W, plan.warps]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*args, *_rule_args(workload, stream))
    build.finish_launch(rc, name + plan.body)
    return out


def _rule(workload: StencilWorkload) -> int:
    return workload.kernel_params()["rule"]


def _check_k(layout: BlockLayout, k: int, what: str):
    if not 1 <= k <= layout.rho:
        raise ValueError(f"{what} needs 1 <= k <= rho={layout.rho}, got "
                         f"k={k} (use SqueezeBlockEngine.step_k for deeper "
                         "halos)")


def stencil_step_blocks(layout: BlockLayout, state: torch.Tensor,
                        workload: StencilWorkload = LIFE, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v1: one step, the center and its 8 Moore-neighbor blocks staged
    whole. ``state`` (B?, C?, nb, rho, rho) -> same; ``out`` as for v3."""
    obs.inc("kernel.entry", op="stencil_step_blocks")
    if state.device.type == "cpu":
        return _into(state, stencil_step_blocks_plain(layout, state,
                                                      workload), out)
    return _launch_step("stencil_step_blocks", layout, state, workload, 1,
                        out)


def stencil_step_strips(layout: BlockLayout, state: torch.Tensor,
                        workload: StencilWorkload = LIFE, *,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v2: one step from the center and its halo strips; the strips the
    workload reads (``halo_needs``) are gathered on the card first."""
    obs.inc("kernel.entry", op="stencil_step_strips")
    if state.device.type == "cpu":
        return _into(state, stencil_step_strips_plain(layout, state,
                                                      workload), out)
    return _launch_step("stencil_step_strips", layout, state, workload, 1,
                        out)


def life_step_blocks(layout: BlockLayout, state: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v1 game-of-life step."""
    return stencil_step_blocks(layout, state, LIFE, out=out)


def life_step_strips(layout: BlockLayout, state: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v2 game-of-life step."""
    return stencil_step_strips(layout, state, LIFE, out=out)


def life_step_fused(layout: BlockLayout, state: torch.Tensor, *,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v3 game-of-life step."""
    return stencil_step_fused(layout, state, LIFE, out=out)


def stencil_step_fused(layout: BlockLayout, state: torch.Tensor,
                       workload: StencilWorkload = LIFE, *,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v3: one step, v4 at k = 1. ``state`` (B?, C?, nb, rho, rho) -> same;
    ``out`` receives the result on the card (it must not alias
    ``state``)."""
    obs.inc("kernel.entry", op="stencil_step_fused")
    if state.device.type == "cpu":
        return _into(state, stencil_step_fused_plain(layout, state,
                                                     workload), out)
    return _launch_step("stencil_step_fused", layout, state, workload, 1, out)


def stencil_step_fused_k(layout: BlockLayout, state: torch.Tensor,
                         workload: StencilWorkload = LIFE, *, k: int = 2,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """v4: ``k`` exact steps in one launch, 1 <= k <= rho."""
    obs.inc("kernel.entry", op="stencil_step_fused_k")
    _check_k(layout, k, "the fused kernel")
    if state.device.type == "cpu":
        return _into(state, stencil_step_fused_k_plain(layout, state,
                                                       workload, k=k), out)
    return _launch_step("stencil_step_fused_k", layout, state, workload, k,
                        out)


def stencil_step_mxu_batched(layout: BlockLayout, states: torch.Tensor,
                             workload: StencilWorkload = LIFE, *, k: int = 1,
                             p: Optional[int] = None,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """v5: ``k`` exact steps of B simulations in one launch, in (B,
    n_macro) work items of P slots spread over a persistent grid (geometry
    from ``mxu_plan``); states (B, C?, nb, rho, rho) -> same. ``p``
    overrides the slots per CTA work item (None = ``layout.macro_tiles``
    default); the result does not depend on it."""
    obs.inc("kernel.entry", op="stencil_step_mxu_batched")
    _check_k(layout, k, "the mxu kernel")
    if states.device.type == "cpu":
        return _into(states, stencil_step_mxu_batched_plain(
            layout, states, workload, k=k, p=p), out)
    fn = _c_function("sq_stencil_step_mxu")
    s5, _ = _as_batched(layout, workload, states, batched=True)
    out = _check_cuda(states, workload, out)
    b = s5.shape[0]
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    p, n_macro, _ = layout.macro_tiles(k, p=p)
    dev = states.device
    rm, cm, plan = _mxu_operands(layout, workload, states, k, p, n_macro,
                                 pieces=False)
    nbr = layout.device_table("neighbor_table", dev)
    wmask = layout.device_table("window_mask", dev, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            _rule(workload), states.data_ptr(), out.data_ptr(),
            nbr.data_ptr(), wmask.data_ptr(), rm.data_ptr(), cm.data_ptr(),
            rm.shape[0], layout.n_blocks, b, layout.rho, k, p, plan.nt,
            plan.spw, plan.warps, *_rule_args(workload, stream))
    build.finish_launch(rc, "stencil_step_mxu_batched" + plan.body)
    return out


def stencil_step_mxu(layout: BlockLayout, state: torch.Tensor,
                     workload: StencilWorkload = LIFE, *,
                     p: Optional[int] = None) -> torch.Tensor:
    """One step of one simulation, v5: ``state`` (C?, nb, rho, rho) ->
    same; ``p`` as for ``stencil_step_mxu_batched``."""
    return stencil_step_mxu_batched(layout, state[None], workload, k=1,
                                    p=p)[0]


def stencil_step_mxu_k(layout: BlockLayout, state: torch.Tensor,
                       workload: StencilWorkload = LIFE, *, k: int = 2,
                       p: Optional[int] = None) -> torch.Tensor:
    """``k`` exact steps of one simulation in one v5 launch, 1 <= k <=
    rho: ``state`` (C?, nb, rho, rho) -> same."""
    return stencil_step_mxu_batched(layout, state[None], workload, k=k,
                                    p=p)[0]


def _mxu_operands(layout: BlockLayout, workload: StencilWorkload,
                  states: torch.Tensor, k: int, p: int, n_macro: int,
                  pieces: bool):
    """The banded operators on the states' device and the launch's
    ``mxu_plan``, after checking the grid."""
    w = layout.rho + 2 * k
    rm, cm = _mxu_operators_on(workload, w, str(states.device))
    if rm.shape[0] > 2:   # ring-uniform weights (_rule_args) have rank <= 2
        raise ValueError(f"the mxu kernel takes at most 2 rank-1 terms, got "
                         f"{rm.shape[0]}")
    if n_macro >= 2 ** 31:
        raise ValueError(f"{n_macro} macro-tiles exceed the grid")
    plan = mxu_plan(states.dtype, workload.n_channels, layout.rho, k, p,
                    pieces)
    return rm, cm, plan


# ======================================================================
# shard-local entries (the distributed engine's compute)
# ======================================================================
def _check_local(layout: BlockLayout, state: torch.Tensor, halo,
                 existence: torch.Tensor, workload: StencilWorkload, k: int,
                 out: Optional[torch.Tensor]):
    """Checks of a shard-local launch; returns (batch, nbl, out)."""
    out = _check_cuda(state, workload, out)
    rho, nc, w = layout.rho, workload.n_channels, layout.rho + 2 * k
    if state.dim() not in (4, 5) or state.shape[-4] != nc or \
            tuple(state.shape[-2:]) != (rho, rho):
        raise ValueError(f"state shape {tuple(state.shape)} does not match "
                         f"(B?, {nc}, nbl, {rho}, {rho})")
    lead = tuple(state.shape[:-2])
    for name, piece, tail in zip(("top", "bot", "west", "east"), halo,
                                 ((k, w), (k, w), (rho, k), (rho, k))):
        if tuple(piece.shape) != lead + tail or \
                piece.dtype != state.dtype or \
                piece.device != state.device or not piece.is_contiguous():
            raise ValueError(f"halo piece {name} must be a contiguous "
                             f"{lead + tail} tensor of the state's dtype "
                             "and device")
    nbl = state.shape[-3]
    if tuple(existence.shape) != (nbl, 8) or \
            existence.dtype != torch.int32 or \
            existence.device != state.device or \
            not existence.is_contiguous():
        raise ValueError(f"existence must be a contiguous ({nbl}, 8) int32 "
                         "tensor on the state's device")
    b = state.shape[0] if state.dim() == 5 else 1
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the grid's 65535")
    return b, nbl, out


def stencil_step_fused_k_local(layout: BlockLayout, state: torch.Tensor,
                               halo, existence: torch.Tensor,
                               workload: StencilWorkload = LIFE, *, k: int,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Shard-local v4: ``k`` exact steps of one shard's blocks in one
    launch. ``state`` (B?, C, nbl, rho, rho) (the channel axis always
    there); ``halo`` = (top, bot, west, east) with top/bot (B?, C, nbl, k,
    rho+2k) and west/east (B?, C, nbl, rho, k); ``existence`` (nbl, 8)
    int32 {0, 1} (padding blocks all zero)."""
    obs.inc("kernel.entry", op="stencil_step_fused_k_local")
    _check_k(layout, k, "the fused kernel")
    if state.device.type == "cpu":
        return _into(state, stencil_step_fused_k_local_plain(
            layout, state, halo, existence, workload, k=k), out)
    fn = _c_function("sq_stencil_step_fused_k_local")
    b, nbl, out = _check_local(layout, state, halo, existence, workload, k,
                               out)
    plan = _fused_plan_for(layout, state, workload, k, True)
    dev = state.device
    wmask = layout.device_table("window_mask", dev, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_rule(workload), state.data_ptr(), out.data_ptr(),
                *(h.data_ptr() for h in halo), existence.data_ptr(),
                wmask.data_ptr(), nbl, b, layout.rho, k, plan.W, plan.warps,
                *_rule_args(workload, stream))
    build.finish_launch(rc, "stencil_step_fused_k_local" + plan.body)
    return out


def stencil_step_mxu_k_local(layout: BlockLayout, states: torch.Tensor,
                             halo, existence: torch.Tensor,
                             workload: StencilWorkload = LIFE, *, k: int,
                             p: Optional[int] = None,
                             out: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Shard-local v5: ``k`` exact steps of B simulations over one shard's
    blocks in one launch, in work items packed with
    ``layout.macro_tiles_for(nbl, k, p)``. ``states`` (B, C, nbl, rho,
    rho), the pieces with the same (B, C) axes, ``existence`` (nbl, 8)."""
    obs.inc("kernel.entry", op="stencil_step_mxu_k_local")
    _check_k(layout, k, "the mxu kernel")
    if states.device.type == "cpu":
        return _into(states, stencil_step_mxu_k_local_plain(
            layout, states, halo, existence, workload, k=k, p=p), out)
    fn = _c_function("sq_stencil_step_mxu_k_local")
    if states.dim() != 5:
        raise ValueError("the mxu kernel takes (B, C, nbl, rho, rho) states")
    b, nbl, out = _check_local(layout, states, halo, existence, workload, k,
                               out)
    p, n_macro, _ = layout.macro_tiles_for(nbl, k, p=p)
    rm, cm, plan = _mxu_operands(layout, workload, states, k, p, n_macro,
                                 pieces=True)
    dev = states.device
    wmask = layout.device_table("window_mask", dev, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(_rule(workload), states.data_ptr(), out.data_ptr(),
                *(h.data_ptr() for h in halo), existence.data_ptr(),
                wmask.data_ptr(), rm.data_ptr(), cm.data_ptr(), rm.shape[0],
                nbl, b, layout.rho, k, p, plan.nt, plan.spw, plan.warps,
                *_rule_args(workload, stream))
    build.finish_launch(rc, "stencil_step_mxu_k_local" + plan.body)
    return out


def _into(state: torch.Tensor, result: torch.Tensor,
          out: Optional[torch.Tensor]):
    """The CPU path's ``out=``, with the same checks as on the card."""
    if out is None:
        return result
    _check_out(state, out)
    out.copy_(result)
    return out
