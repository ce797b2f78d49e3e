"""The ``StencilWorkload`` abstraction: what the engines simulate (2D and
3D).

A workload bundles everything rule-specific so that the engines and the
CUDA kernels stay rule-agnostic:

  * ``dtype`` / ``agg_dtype``  -- cell state and accumulation dtypes;
  * ``n_channels``             -- 1 (scalar field) or C (Gray-Scott's
                                 (U, V) pair); multi-channel states carry a
                                 leading channel axis: (C, *spatial);
  * ``weight(offset)``         -- per-direction neighbor weight, (dx, dy)
                                 or (dx, dy, dz); a 0 weight means the
                                 direction is never read;
  * ``apply(center, agg, mask)`` -- the update rule, given the weighted
                                 neighbor aggregate; ``mask`` is the {0,1}
                                 occupancy or None when every cell is real;
  * ``init(generator, shape, device)`` -- the initial-state distribution
                                 over the unmasked spatial domain.

Out-of-fractal and hole neighbors contribute 0 to the aggregate: dead cells
for CA rules, Dirichlet-0 boundaries for the PDE rules.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

#: Moore neighborhood directions (dx, dy), y growing downward.
MOORE_DIRS: Tuple[Tuple[int, int], ...] = (
    (-1, -1), (0, -1), (1, -1),
    (-1, 0), (1, 0),
    (-1, 1), (0, 1), (1, 1),
)

#: 3D Moore neighborhood (dx, dy, dz), raster-ordered (dz slowest, dx
#: fastest), so the 26 directions line up with the 3D halo regions as
#: MOORE_DIRS does with the 2D ones.
MOORE3_DIRS: Tuple[Tuple[int, int, int], ...] = tuple(
    (dx, dy, dz)
    for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    if (dx, dy, dz) != (0, 0, 0))


class StencilWorkload:
    """Base class; concrete workloads are frozen dataclasses (hashable, so a
    workload can key the runner's engine cache)."""

    name: str = "abstract"
    n_channels: int = 1
    #: spatial dimensionality the rule is defined for (None = any)
    ndim = None
    dtype = torch.uint8
    agg_dtype = torch.int32

    def weight(self, offset) -> float:
        return 1

    def apply(self, center: torch.Tensor, agg: torch.Tensor, mask):
        """Next state from (center, weighted neighbor aggregate); holes are
        zeroed when ``mask`` is given. ``center``/``agg`` carry a leading
        channel axis iff n_channels > 1."""
        raise NotImplementedError

    def init(self, generator: torch.Generator, shape, device):
        """Initial state over spatial ``shape`` ((C, *shape) if C > 1)."""
        raise NotImplementedError

    @property
    def weights2d(self):
        """Weights over the 2D Moore directions, MOORE_DIRS order."""
        return tuple(self.weight(d) for d in MOORE_DIRS)

    @property
    def weights3x3(self) -> np.ndarray:
        """The neighbor weights as a 3x3 float64 matrix indexed
        ``[dy+1, dx+1]`` (center weight 0)."""
        w = np.zeros((3, 3), np.float64)
        for dx, dy in MOORE_DIRS:
            w[dy + 1, dx + 1] = self.weight((dx, dy))
        return w

    @property
    def weights3d(self):
        """Weights over the 26 3D Moore directions, MOORE3_DIRS order."""
        return tuple(self.weight(d) for d in MOORE3_DIRS)

    @property
    def weights3x3x3(self) -> np.ndarray:
        """The 3D neighbor weights as a (3, 3, 3) float64 tensor indexed
        ``[dz+1, dy+1, dx+1]`` (center weight 0)."""
        w = np.zeros((3, 3, 3), np.float64)
        for dx, dy, dz in MOORE3_DIRS:
            w[dz + 1, dy + 1, dx + 1] = self.weight((dx, dy, dz))
        return w

    @functools.cached_property
    def weight_factors3(self):
        """Per z-plane (dz = -1, 0, +1) rank-1 decompositions of
        ``weights3x3x3`` (empty for an all-zero plane): the operands of the
        3D mxu kernel, whose aggregate of slab z is
        ``sum_dz sum_t R_t(dz) @ X[z+dz] @ C_t(dz)^T``."""
        return tuple(svd_rank1_terms(plane) if plane.any() else ()
                     for plane in self.weights3x3x3)

    @property
    def ring_weights(self) -> Tuple[float, float]:
        """(w_diag, w_orth) of a ring-uniform weight set -- the form the
        CUDA kernels take; raises for any other set."""
        split = _moore_split(self.weights2d)
        if split is None:
            raise ValueError(
                f"workload {self.name!r} has weights that are not uniform "
                "per Moore ring")
        return split

    @functools.cached_property
    def weight_factors(self):
        """Rank-1 decomposition of ``weights3x3``: <= 3 ``(row, col)``
        pairs with ``sum_i outer(row_i, col_i) == weights3x3``; the banded
        operands of the v5 kernel (see ``svd_rank1_terms``)."""
        return svd_rank1_terms(self.weights3x3)

    def tile_rule(self, center, padded, mask):
        """One update on a halo-padded tile: ``center`` (C?, h, w),
        ``padded`` (C?, h+2, w+2)."""
        agg = weighted_moore_agg(padded, self.weights2d, self.agg_dtype)
        return self.apply(center, agg, mask)

    def tile_rule_k(self, padded, halo_mask, k: int, ndim: int = 2):
        """``k`` fused updates on a depth-``k`` padded tile: each substep
        updates the current window's interior and the window shrinks by one
        ring, so the (C?, h, w) core advances ``k`` exact steps.
        ``halo_mask`` (trailing (h+2k, w+2k) axes) is re-applied at every
        substep on a matching shrinking crop, so holes and ghost cells of
        the halo stay zero mid-flight, not only at the final write.
        ``ndim=3`` runs the same discipline on a (d+2k, h+2k, w+2k) volume
        over the 26-direction aggregate."""
        crop = (Ellipsis,) + (slice(1, -1),) * ndim
        agg_of = weighted_moore_agg if ndim == 2 else weighted_moore_agg3
        weights = self.weights2d if ndim == 2 else self.weights3d
        cur = padded
        for _ in range(k):
            center = cur[crop]
            agg = agg_of(cur, weights, self.agg_dtype)
            if halo_mask is not None:
                halo_mask = halo_mask[crop]
            cur = self.apply(center, agg, halo_mask)
        return cur

    def masked(self, state, mask):
        return state if mask is None else state * mask.to(state.dtype)


def halo_needs(weights) -> Tuple[bool, ...]:
    """(need_n, need_s, need_w, need_e, need_nw, need_ne, need_sw, need_se)
    for one radius-1 Moore update with the given ``weights2d``: a corner is
    read only by its diagonal, an edge strip by its orthogonal and both
    adjacent diagonals."""
    w = dict(zip(MOORE_DIRS, weights))
    need_nw, need_ne = w[(-1, -1)] != 0, w[(1, -1)] != 0
    need_sw, need_se = w[(-1, 1)] != 0, w[(1, 1)] != 0
    need_n = need_nw or need_ne or w[(0, -1)] != 0
    need_s = need_sw or need_se or w[(0, 1)] != 0
    need_w = need_nw or need_sw or w[(-1, 0)] != 0
    need_e = need_ne or need_se or w[(1, 0)] != 0
    return (need_n, need_s, need_w, need_e,
            need_nw, need_ne, need_sw, need_se)


def svd_rank1_terms(weights3x3: np.ndarray, tol: float = 1e-9):
    """Decompose a 3x3 weight matrix into <= 3 rank-1 ``(row, col)`` terms
    by SVD, ``sqrt(sigma_i)`` folded into each factor; singular values
    below ``tol * sigma_max`` are dropped, and the reconstruction is
    verified (a weight set the terms cannot represent raises)."""
    w = np.asarray(weights3x3, np.float64)
    if w.shape != (3, 3):
        raise ValueError(f"need a 3x3 weight matrix, got {w.shape}")
    u, s, vh = np.linalg.svd(w)
    keep = s > (tol * s[0] if s[0] > 0 else tol)
    terms = tuple(
        (tuple(float(x) for x in u[:, i] * np.sqrt(s[i])),
         tuple(float(x) for x in vh[i, :] * np.sqrt(s[i])))
        for i in range(3) if keep[i])
    recon = np.zeros((3, 3), np.float64)
    for row, col in terms:
        recon += np.outer(row, col)
    if not np.allclose(recon, w, rtol=0, atol=1e-12):
        raise ValueError(
            f"rank-1 SVD terms do not reconstruct the weight matrix "
            f"exactly (max err {np.abs(recon - w).max():.3e})")
    return terms


def banded_operators(terms, window: int, dtype=np.float32):
    """Banded contraction matrices over a ``window x window`` tile: ``R``
    (T, window, window) with ``R[t, y, y+dy] = row_t[dy+1]`` and ``C`` with
    ``C[t, x, x+dx] = col_t[dx+1]``, so ``R[t] @ X @ C[t].T`` sums
    ``row_t[dy+1] * col_t[dx+1] * X[y+dy, x+dx]`` over the 3x3 offsets
    (border rows/cols get truncated bands)."""
    tm = np.zeros((len(terms), window, window), dtype)
    cm = np.zeros((len(terms), window, window), dtype)
    for t, (row, col) in enumerate(terms):
        for y in range(window):
            for d in (-1, 0, 1):
                if 0 <= y + d < window:
                    tm[t, y, y + d] = row[d + 1]
                    cm[t, y, y + d] = col[d + 1]
    return tm, cm


def check_workload_ndim(workload: StencilWorkload, ndim: int):
    """Raise if a workload is bound to an engine of another spatial
    dimensionality."""
    if workload.ndim is not None and workload.ndim != ndim:
        raise ValueError(
            f"workload {workload.name!r} is {workload.ndim}D-only; "
            f"engine is {ndim}D")


def _scaled(x, wt, agg_dtype):
    """``x * wt`` with ``wt`` rounded to ``agg_dtype`` first; unit weights
    skip the multiply (keeps integer CA aggregates exact)."""
    if wt == 1:
        return x
    return x * torch.tensor(wt, dtype=agg_dtype, device=x.device)


def weighted_gather_agg(dirs, weights, gather, shape, agg_dtype, device):
    """Weighted neighbor aggregate from a per-direction ``gather(offset)``
    callback; zero-weight directions are never gathered."""
    agg = torch.zeros(shape, dtype=agg_dtype, device=device)
    for d, wt in zip(dirs, weights):
        if wt == 0:
            continue
        agg = agg + _scaled(gather(d).to(agg_dtype), wt, agg_dtype)
    return agg


def _moore_split(weights):
    """(w_diag, w_orth) when the Moore weights are uniform per ring (all
    shipped workloads), else None."""
    w = dict(zip(MOORE_DIRS, weights))
    diag = {w[(-1, -1)], w[(1, -1)], w[(-1, 1)], w[(1, 1)]}
    orth = {w[(0, -1)], w[(-1, 0)], w[(1, 0)], w[(0, 1)]}
    if len(diag) == 1 and len(orth) == 1:
        return diag.pop(), orth.pop()
    return None


def weighted_moore_agg(padded, weights, agg_dtype):
    """Weighted 8-neighbor aggregate from a (+1)-padded tensor: (..., H+2,
    W+2) -> (..., H, W); leading axes broadcast through.

    Ring-uniform weight sets with a nonzero diagonal take the separable
    path (row partial sums, then column sums, minus the center, plus a
    cross correction when the rings differ), summed in the same order as
    the reference; every other set sums the nonzero directions in
    MOORE_DIRS order.
    """
    h, w = padded.shape[-2] - 2, padded.shape[-1] - 2
    split = _moore_split(weights)
    if split is not None and split[0] != 0:
        wd, wo = split
        x = padded.to(agg_dtype)
        rows = x[..., 0:h, :] + x[..., 1:h + 1, :] + x[..., 2:h + 2, :]
        sum9 = rows[..., 0:w] + rows[..., 1:w + 1] + rows[..., 2:w + 2]
        agg = _scaled(sum9 - x[..., 1:h + 1, 1:w + 1], wd, agg_dtype)
        if wo != wd:
            cross = (x[..., 0:h, 1:w + 1] + x[..., 1:h + 1, 0:w]
                     + x[..., 1:h + 1, 2:w + 2] + x[..., 2:h + 2, 1:w + 1])
            agg = agg + _scaled(cross, wo - wd, agg_dtype)
        return agg
    agg = torch.zeros(padded.shape[:-2] + (h, w), dtype=agg_dtype,
                      device=padded.device)
    for (dx, dy), wt in zip(MOORE_DIRS, weights):
        if wt == 0:
            continue
        sl = padded[..., 1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]
        agg = agg + _scaled(sl.to(agg_dtype), wt, agg_dtype)
    return agg


def weighted_moore_agg3(padded, weights, agg_dtype):
    """Weighted 26-neighbor aggregate from a (+1)-padded 3D tensor: (...,
    D+2, H+2, W+2) -> (..., D, H, W); leading axes broadcast through.

    A uniform nonzero weight set (the totalistic rules) takes the separable
    path, in the reference's order: the z pass, then the y pass over the
    padded x extent, then the x pass, minus the center, then the weight.
    Every other set (HEAT3D's 6-point Laplacian) sums the nonzero
    directions in MOORE3_DIRS order from zero.
    """
    d, h, w = (padded.shape[-3] - 2, padded.shape[-2] - 2,
               padded.shape[-1] - 2)
    uniq = set(weights)
    if len(uniq) == 1 and 0 not in uniq:
        x = padded.to(agg_dtype)
        slabs = x[..., 0:d, :, :] + x[..., 1:d + 1, :, :] \
            + x[..., 2:d + 2, :, :]
        rows = slabs[..., 0:h, :] + slabs[..., 1:h + 1, :] \
            + slabs[..., 2:h + 2, :]
        sum27 = rows[..., 0:w] + rows[..., 1:w + 1] + rows[..., 2:w + 2]
        return _scaled(sum27 - x[..., 1:d + 1, 1:h + 1, 1:w + 1],
                       uniq.pop(), agg_dtype)
    agg = torch.zeros(padded.shape[:-3] + (d, h, w), dtype=agg_dtype,
                      device=padded.device)
    for (dx, dy, dz), wt in zip(MOORE3_DIRS, weights):
        if wt == 0:
            continue
        sl = padded[..., 1 + dz:d + 1 + dz, 1 + dy:h + 1 + dy,
                    1 + dx:w + 1 + dx]
        agg = agg + _scaled(sl.to(agg_dtype), wt, agg_dtype)
    return agg
