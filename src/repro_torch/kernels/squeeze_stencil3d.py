"""3D block-level Squeeze stencil kernels: the CUDA wrappers and, beside
each, its plain PyTorch version.

  * ``stencil3d_step_fused_k`` (3D v4) -- k exact steps per launch on a
    (rho+2k)^3 window, 1 <= k <= rho; replaces the Pallas
    ``squeeze_stencil3d.py::stencil3d_step_fused_k``.
  * ``stencil3d_step_mxu_k``   (3D v5) -- k exact steps per launch, the
    26-neighbor aggregate as z-slab banded products
    ``sum_dz sum_t R_t(dz) @ X[z+dz] @ C_t(dz)^T`` of the per-plane rank-1
    weight factors, P blocks per CTA; replaces ``stencil3d_step_mxu_k``.

The kernels live in ``csrc/squeeze_stencil3d.cu``. A wrapper runs the plain
version only for a tensor on the CPU; for a CUDA tensor it launches the
kernel or raises: a failed build raises ``KernelBuildError``, a bad shape,
dtype, workload or k raises ``ValueError`` or ``TypeError``. The body is
picked by shape before the launch, never after a failure (``fused3_plan``,
``mxu3_plan``; the C entries take the plan's W and windows a CTA and only
check them): for windows of w = rho + 2k <= 16 cells, the fused kernel runs
the column body (a thread a window column, its cells in registers) and the
banded kernel the tensor-core body (a warp a window plane, ``mma.sync``
TF32); wider windows, and weights the new bodies do not compute, run the
CTA body, counted as ``<name>[wide]``, or where its windows exceed one
CTA's shared memory its device-workspace variant (``window_variant``; the
same body over a bounded persistent grid), counted as ``<name>[global]``.
Each wrapper counts its launches in ``LAUNCHES`` under the body's name.

States are ``(B?, n_blocks, rho, rho, rho)`` (single-channel workloads
only, as the 3D engines); both kernels take the optional leading batch
axis.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compact3d import BlockLayout3D, halo_regions3
from repro_torch.kernels import build
from repro_torch.kernels.squeeze_stencil import _check_cuda, _into
from repro_torch.workloads.base import (MOORE3_DIRS, StencilWorkload,
                                        banded_operators,
                                        check_workload_ndim)
from repro_torch.workloads.rules import LIFE3D

#: kernel name -> launches since the last ``reset_launches``
LAUNCHES = build.LAUNCHES
LAUNCHES.update(dict.fromkeys((
    f"stencil3d_step_{kernel}_k{body}" for kernel in ("fused", "mxu")
    for body in ("", "[wide]", "[global]")), 0))
reset_launches = build.reset_launches

#: direction -> MOORE3_DIRS index (the neighbor table's column order)
DIR3_INDEX = {d: i for i, d in enumerate(MOORE3_DIRS)}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    # rule, src, dst, nbr, wmask, nb, batch, rho, k, W, G, born, survive,
    # alpha, degree, uniform, wu, weights (host), ws, n_ctas, stream
    "sq3_step_fused_k": [_I, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                         _I, _F, _F, _I, _F, _P, _P, _I, _P],
    # rule, src, dst, nbr, wmask, R, C, n_terms, t0, t1, nb, batch, rho, k,
    # P, W, born, survive, alpha, degree, ws, n_ctas, stream
    "sq3_step_mxu_k": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _I, _I,
                       _I, _I, _I, _I, _I, _F, _F, _P, _I, _P],
}
#: window cells one CTA of the fused kernel's CTA body holds (its G blocks)
_CELLS_PER_CTA = 4096
#: threads of a CTA of the column body (``kBodyThreads``): W^2 columns a
#: window, BODY_THREADS // W^2 windows a CTA
BODY_THREADS = 256
#: the widest window of the column and tensor-core bodies
BODY_MAX_W = 16
#: most operator groups of the tensor-core body (``kGroups``)
TC_GROUPS = 3


def _c_function(fn: str):
    return build.c_function("squeeze_stencil3d", fn, _SIGNATURES[fn])


# ======================================================================
# shapes
# ======================================================================
def check_workload3d(workload: StencilWorkload) -> None:
    """Raise unless the workload is single-channel and not bound to
    another dimension (the 3D engines' and kernels' condition)."""
    if workload.n_channels != 1:
        raise ValueError("3D engines support single-channel workloads only")
    check_workload_ndim(workload, 3)


def _check_shape(layout: BlockLayout3D, state: torch.Tensor) -> int:
    """The batch of ``state`` (1 without a batch axis)."""
    rho, nb = layout.rho, layout.n_blocks
    if state.dim() not in (4, 5) or \
            tuple(state.shape[-4:]) != (nb, rho, rho, rho):
        raise ValueError(f"state shape {tuple(state.shape)} does not match "
                         f"(B?, {nb}, {rho}, {rho}, {rho})")
    return state.shape[0] if state.dim() == 5 else 1


def _check_k(layout: BlockLayout3D, k: int, what: str) -> None:
    if not 1 <= k <= layout.rho:
        raise ValueError(f"{what} needs 1 <= k <= rho={layout.rho}, got "
                         f"k={k} (use Squeeze3DBlockEngine.step_k for "
                         "deeper halos)")


def smem_bytes(slots: int, w: int, n_terms: int, itemsize: int) -> int:
    """Shared bytes of one CTA of ``slots`` (w, w, w) windows: two state
    buffers, the mxu operators, the slot ids and the window mask (the
    layout ``smem3`` of the CUDA source computes)."""
    off = (2 * slots * w ** 3 * itemsize + 15) & ~15
    return off + 2 * n_terms * w * w * 4 + slots * 27 * 4 + w ** 3


def window_variant(layout: BlockLayout3D, workload: StencilWorkload, k: int,
                   kernel: str, p: Optional[int] = None) -> str:
    """Where ``kernel`` ('fused' or 'mxu', ``p`` its packing) holds the
    windows of ``workload`` at depth ``k``: 'global' where its plan runs
    the CTA body's workspace variant (a device workspace of
    ``build.PERSISTENT_CTAS`` CTAs' windows), else 'shared'."""
    _check_k(layout, k, f"the {kernel} 3D kernel")
    plan = fused3_plan_for(layout, workload, k) if kernel == "fused" \
        else mxu3_plan_for(layout, workload, k, p)
    return "global" if plan.body == "[global]" else "shared"


def _workspace(layout, slots, w, state, batch):
    """(workspace, its CTAs) of one launch of the CTA body's workspace
    variant: two buffers of ``slots`` windows a CTA, over at most
    ``build.PERSISTENT_CTAS`` CTAs."""
    n_ctas = min(build.PERSISTENT_CTAS, -(-layout.n_blocks // slots) * batch)
    ws = torch.empty(n_ctas * 2 * slots * w ** 3 * state.element_size(),
                     dtype=torch.uint8, device=state.device)
    return ws, n_ctas


def _cta_body(slots: int, w: int, n_terms: int, itemsize: int) -> str:
    """The CTA body a launch of ``slots`` windows runs: '[wide]', or
    '[global]' where its windows exceed one CTA's shared memory
    (``smem_bytes``)."""
    return "[wide]" if smem_bytes(slots, w, n_terms, itemsize) <= \
        build.MAX_SMEM else "[global]"


def weight_form(dtype: torch.dtype, weights) -> str:
    """The aggregate sum the column body computes for these 26 weights
    (MOORE3_DIRS order, as the float32 values the kernel takes), one per
    rule: 'uniform' for a uint8 state (the totalistic rules) with every
    weight 1, 'orth' for a float32 state (Heat) with the six faces 1 and
    the rest 0; '' for any other set (no shipped workload has one)."""
    w = [float(np.float32(x)) for x in weights]
    if dtype == torch.uint8 and w == [1.0] * 26:
        return "uniform"
    faces = [float(sum(map(abs, d)) == 1) for d in MOORE3_DIRS]
    if dtype == torch.float32 and w == faces:
        return "orth"
    return ""


class Fused3Plan(NamedTuple):
    """The body of the fused 3D kernel for one shape (``fused3_plan``); the
    C entry takes W and windows."""
    W: int        # columns a window side: 16 or 8 (0: the CTA body)
    windows: int  # windows a CTA (the CTA body's G blocks)
    body: str     # '' (column body), '[wide]' (CTA body), '[global]'


def fused3_plan(dtype: torch.dtype, rho: int, k: int, weights,
                n_blocks: int) -> Fused3Plan:
    """The body of the fused 3D kernel for a window w = rho + 2k of
    ``dtype`` states with these 26 weights over ``n_blocks`` blocks: the
    column body where w <= 16 and the weights have the rule's own form
    (``weight_form``), W = 8 (four windows a CTA) for w <= 8, else W = 16
    (one); else the CTA body over G = 4096 // w^3 blocks a CTA (at least
    one, at most ``n_blocks``), '[wide]', or '[global]' where its windows
    exceed one CTA's shared memory."""
    w = rho + 2 * k
    if w <= BODY_MAX_W and weight_form(dtype, weights):
        big_w = 8 if w <= 8 else 16
        return Fused3Plan(big_w, BODY_THREADS // big_w ** 2, "")
    g = max(1, min(n_blocks, _CELLS_PER_CTA // w ** 3))
    return Fused3Plan(0, g, _cta_body(g, w, 0, _itemsize(dtype)))


class Mxu3Plan(NamedTuple):
    """The body of the banded 3D kernel for one shape (``mxu3_plan``); the
    C entry takes W and windows (its P)."""
    W: int        # plane side of the tensor-core body: 16 (0: CTA body)
    windows: int  # windows a CTA (the CTA body's P slots)
    body: str     # '' (tensor-core body), '[wide]' (CTA body), '[global]'


def mxu3_plan(dtype: torch.dtype, rho: int, k: int, dzs, symmetric: bool,
              p: int) -> Mxu3Plan:
    """The body of the banded 3D kernel for a window w = rho + 2k of
    ``dtype`` states whose rank-1 terms lie at the z shifts ``dzs``
    (``mxu3_operators``; ``symmetric``: ``mxu3_symmetric``, the one dz = -1
    term's operators equal the one dz = +1 term's), ``p`` the CTA body's
    slots a CTA. The tensor-core body where w <= 16 and the terms are
    symmetric and make at most three groups (the pair one group, on X[z -
    1] + X[z + 1], and each dz = 0 term one): one window a CTA; else the
    CTA body over ``p`` slots, '[wide]', or '[global]' where its windows
    exceed one CTA's shared memory. The result never depends on ``p``."""
    w = rho + 2 * k
    if w <= BODY_MAX_W and symmetric and len(dzs) - 1 <= TC_GROUPS:
        return Mxu3Plan(16, 1, "")
    return Mxu3Plan(0, p, _cta_body(p, w, len(dzs), _itemsize(dtype)))


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ======================================================================
# plain PyTorch versions (the CPU path, and the oracle on the card)
# ======================================================================
def gather_halo3_k(layout: BlockLayout3D, s: torch.Tensor, k: int):
    """The six face slabs of the depth-k window frame of every block of
    ``s`` (..., nb, rho, rho, rho), gathered through the neighbor table
    (k <= rho, so every piece comes from one Moore neighbor; a ghost reads
    the appended zero slab):

      zlo/zhi (..., nb, k, w, w)     -- full-xy z faces, edges and corners
                                        included (w = rho + 2k);
      ylo/yhi (..., nb, rho, k, w)   -- center-z y faces, x edges included;
      xlo/xhi (..., nb, rho, rho, k) -- center x faces.
    """
    rho = layout.rho
    table = layout.device_table("neighbor_table", s.device).long()

    def take(piece, d):
        padded = torch.cat([piece, piece.new_zeros(
            piece.shape[:-4] + (1,) + piece.shape[-3:])], dim=-4)
        return padded.index_select(padded.dim() - 4,
                                   table[:, DIR3_INDEX[d]])

    src = {-1: slice(rho - k, rho), 0: slice(None), 1: slice(0, k)}

    def zface(dz):
        return torch.cat([
            torch.cat([take(s[..., src[dz], src[dy], src[dx]], (dx, dy, dz))
                       for dx in (-1, 0, 1)], dim=-1)
            for dy in (-1, 0, 1)], dim=-2)

    def yface(dy):
        return torch.cat([take(s[..., :, src[dy], src[dx]], (dx, dy, 0))
                          for dx in (-1, 0, 1)], dim=-1)

    return (zface(-1), zface(1), yface(-1), yface(1),
            take(s[..., :, :, rho - k:], (-1, 0, 0)),
            take(s[..., :, :, :k], (1, 0, 0)))


def assemble_window(c, zlo, zhi, ylo, yhi, xlo, xhi, k: int):
    """(..., rho, rho, rho) centers and the six face slabs -> (..., w, w, w)
    windows."""
    rho = c.shape[-1]
    w = rho + 2 * k
    out = c.new_zeros(c.shape[:-3] + (w, w, w))
    mid = slice(k, k + rho)
    out[..., mid, mid, mid] = c
    out[..., :k, :, :] = zlo
    out[..., w - k:, :, :] = zhi
    out[..., mid, :k, :] = ylo
    out[..., mid, w - k:, :] = yhi
    out[..., mid, mid, :k] = xlo
    out[..., mid, mid, w - k:] = xhi
    return out


def window_masks(layout: BlockLayout3D, k: int, device) -> torch.Tensor:
    """(nb, w, w, w) uint8 occupancy of every block's window:
    ``window_mask(k)`` gated per ``halo_regions3`` region by the block's
    existence row (equal to ``halo_mask(k)`` for k <= rho)."""
    w = layout.rho + 2 * k
    wm = layout.device_table("window_mask", device, k)
    ex = layout.device_table("existence_table", device).to(torch.uint8)
    mask = wm.expand(layout.n_blocks, w, w, w).clone()
    for d, (zs, ys, xs) in enumerate(halo_regions3(layout.rho, k)):
        mask[:, zs, ys, xs] *= ex[:, d, None, None, None]
    return mask


def _windows(layout: BlockLayout3D, state: torch.Tensor, k: int):
    return assemble_window(state, *gather_halo3_k(layout, state, k), k)


def stencil3d_step_fused_k_plain(layout: BlockLayout3D, state: torch.Tensor,
                                 workload: StencilWorkload = LIFE3D, *,
                                 k: int = 2) -> torch.Tensor:
    """k steps: the six face slabs through the neighbor table, the window
    assembled, then ``tile_rule_k(ndim=3)`` under ``window_masks``."""
    mask = window_masks(layout, k, state.device)
    return workload.tile_rule_k(_windows(layout, state, k), mask, k,
                                ndim=3).to(state.dtype)


@functools.lru_cache(maxsize=64)
def mxu3_operators(workload: StencilWorkload, w: int):
    """(R, C, dzs): per rank-1 term of each nonzero z-plane of the weight
    tensor, the banded (w, w) row operator ``R[t]`` and column operator
    ``C[t]`` (float32) and the term's z shift, ordered by dz, so that the
    aggregate of slab z is ``sum_t R[t] @ X[z + dzs[t]] @ C[t].T``."""
    rms, cms, dzs = [], [], []
    for dz in (-1, 0, 1):
        terms = workload.weight_factors3[dz + 1]
        if not terms:
            continue
        rm, cm = banded_operators(terms, w, np.float32)
        rms.extend(rm)
        cms.extend(cm)
        dzs.extend([dz] * len(terms))
    return np.stack(rms), np.stack(cms), tuple(dzs)


@functools.lru_cache(maxsize=64)
def mxu3_symmetric(workload: StencilWorkload, w: int) -> bool:
    """Whether the workload has one term at dz = -1 and one at dz = +1 with
    equal operators (LIFE3D: the band of ones; HEAT3D: the identity): the
    tensor-core body then multiplies X[z - 1] + X[z + 1] once."""
    rm, cm, dzs = mxu3_operators(workload, w)
    return dzs.count(-1) == 1 and dzs.count(1) == 1 and \
        np.array_equal(rm[0], rm[-1]) and np.array_equal(cm[0], cm[-1])


@functools.lru_cache(maxsize=64)
def _mxu3_operators_on(workload: StencilWorkload, w: int, device: str):
    rm, cm, dzs = mxu3_operators(workload, w)
    return (torch.from_numpy(rm).to(device), torch.from_numpy(cm).to(device),
            dzs)


def zshift(x: torch.Tensor, dz: int) -> torch.Tensor:
    """out[..., z, :, :] = x[..., z + dz, :, :], zero past the window."""
    if dz == 0:
        return x
    pad = x.new_zeros(x.shape[:-3] + (1,) + x.shape[-2:])
    if dz > 0:
        return torch.cat([x[..., 1:, :, :], pad], dim=-3)
    return torch.cat([pad, x[..., :-1, :, :]], dim=-3)


def stencil3d_step_mxu_k_plain(layout: BlockLayout3D, state: torch.Tensor,
                               workload: StencilWorkload = LIFE3D, *,
                               k: int = 1, p: Optional[int] = None
                               ) -> torch.Tensor:
    """k steps with the aggregate as float32 banded products over the
    whole window, rounded to the nearest integer for integer workloads;
    the result does not depend on ``p``."""
    del p
    rho = layout.rho
    w = rho + 2 * k
    rm, cm, dzs = _mxu3_operators_on(workload, w, str(state.device))
    mask = window_masks(layout, k, state.device)
    cur = _windows(layout, state, k)
    integer = not workload.agg_dtype.is_floating_point
    for _ in range(k):
        x = cur.to(torch.float32)
        agg = torch.zeros_like(x)
        for t, dz in enumerate(dzs):
            agg = agg + torch.matmul(torch.matmul(rm[t], zshift(x, dz)),
                                     cm[t].T)
        agg = agg.round().to(workload.agg_dtype) if integer else \
            agg.to(workload.agg_dtype)
        cur = workload.apply(cur, agg, mask).to(state.dtype)
    mid = slice(k, k + rho)
    return cur[..., mid, mid, mid].contiguous()


# ======================================================================
# CUDA launches
# ======================================================================
def fused3_plan_for(layout: BlockLayout3D, workload: StencilWorkload,
                    k: int) -> Fused3Plan:
    """``fused3_plan`` for the fused kernel on ``layout`` at depth k."""
    return fused3_plan(workload.dtype, layout.rho, k, workload.weights3d,
                       layout.n_blocks)


def mxu3_plan_for(layout: BlockLayout3D, workload: StencilWorkload, k: int,
                  p: Optional[int] = None) -> Mxu3Plan:
    """``mxu3_plan`` for the banded kernel on ``layout`` at depth k, the CTA
    body's P from ``layout.macro_tiles(k, p)``."""
    w = layout.rho + 2 * k
    return mxu3_plan(workload.dtype, layout.rho, k,
                     mxu3_operators(workload, w)[2],
                     mxu3_symmetric(workload, w),
                     layout.macro_tiles(k, p=p)[0])


def _rule_params(workload: StencilWorkload):
    params = workload.kernel_params()
    return params["rule"], params["born"], params["survive"], \
        float(params["p"][0]), float(params["p"][1])


def stencil3d_step_fused_k(layout: BlockLayout3D, state: torch.Tensor,
                           workload: StencilWorkload = LIFE3D, *, k: int = 2,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """3D v4: ``k`` exact steps in one launch, 1 <= k <= rho. ``state``
    (B?, nb, rho, rho, rho) -> same; ``out`` receives the result on the
    card (it must not alias ``state``)."""
    obs.inc("kernel.entry", op="stencil3d_step_fused_k")
    check_workload3d(workload)
    _check_k(layout, k, "the fused 3D kernel")
    batch = _check_shape(layout, state)
    if state.device.type == "cpu":
        return _into(state, stencil3d_step_fused_k_plain(layout, state,
                                                         workload, k=k), out)
    fn = _c_function("sq3_step_fused_k")
    out = _check_cuda(state, workload, out)
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535")
    plan = fused3_plan_for(layout, workload, k)
    ws, n_ctas = _workspace(layout, plan.windows, layout.rho + 2 * k, state,
                            batch) if plan.body == "[global]" else (None, 0)
    weights = workload.weights3d
    uniform = len(set(weights)) == 1 and weights[0] != 0
    host_w = (ctypes.c_float * 26)(*weights)
    dev = state.device
    nbr = layout.device_table("neighbor_table", dev)
    wmask = layout.device_table("window_mask", dev, k)
    rule, born, survive, alpha, degree = _rule_params(workload)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(rule, state.data_ptr(), out.data_ptr(), nbr.data_ptr(),
                wmask.data_ptr(), layout.n_blocks, batch, layout.rho, k,
                plan.W, plan.windows, born, survive, alpha, degree,
                int(uniform), float(weights[0]), ctypes.addressof(host_w),
                None if ws is None else ws.data_ptr(), n_ctas, stream)
    build.finish_launch(rc, "stencil3d_step_fused_k" + plan.body)
    return out


def stencil3d_step_mxu_k(layout: BlockLayout3D, state: torch.Tensor,
                         workload: StencilWorkload = LIFE3D, *, k: int = 1,
                         p: Optional[int] = None,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3D v5: ``k`` exact steps in one launch over P-block CTAs (``p``
    overrides ``layout.macro_tiles``'s P; the result does not depend on
    it). ``state`` (B?, nb, rho, rho, rho) -> same."""
    obs.inc("kernel.entry", op="stencil3d_step_mxu_k")
    check_workload3d(workload)
    _check_k(layout, k, "the mxu 3D kernel")
    batch = _check_shape(layout, state)
    if state.device.type == "cpu":
        return _into(state, stencil3d_step_mxu_k_plain(
            layout, state, workload, k=k, p=p), out)
    fn = _c_function("sq3_step_mxu_k")
    out = _check_cuda(state, workload, out)
    if batch > 65535:
        raise ValueError(f"batch {batch} exceeds the grid's 65535")
    plan = mxu3_plan_for(layout, workload, k, p)
    ws, n_ctas = _workspace(layout, plan.windows, layout.rho + 2 * k, state,
                            batch) if plan.body == "[global]" else (None, 0)
    rm, cm, dzs = _mxu3_operators_on(workload, layout.rho + 2 * k,
                                     str(state.device))
    t0, t1 = dzs.count(-1), dzs.count(-1) + dzs.count(0)
    dev = state.device
    nbr = layout.device_table("neighbor_table", dev)
    wmask = layout.device_table("window_mask", dev, k)
    rule, born, survive, alpha, degree = _rule_params(workload)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(rule, state.data_ptr(), out.data_ptr(), nbr.data_ptr(),
                wmask.data_ptr(), rm.data_ptr(), cm.data_ptr(), len(dzs), t0,
                t1, layout.n_blocks, batch, layout.rho, k, plan.windows,
                plan.W, born, survive, alpha, degree,
                None if ws is None else ws.data_ptr(), n_ctas, stream)
    build.finish_launch(rc, "stencil3d_step_mxu_k" + plan.body)
    return out
