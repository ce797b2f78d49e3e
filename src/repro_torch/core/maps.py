"""The two Squeeze space maps: lambda(w) (compact -> expanded) and nu(w)
(expanded -> compact), paper Sections 3.3 and 3.4.

Conventions (paper Section 3.4): origin (0,0) at the upper-left of both the
expanded domain (side n = s**r) and the compact domain (k^floor(r/2) rows x
k^ceil(r/2) cols); x grows right, y grows down. Odd levels mu = 1,3,5,...
are the base-k digits of the compact x, even levels those of y; an expanded
coordinate's level-mu replica slot is its base-s digit mu-1 per axis.

Two implementations per map:
  * ``*_scalar`` -- pure-python ints, the executable spec;
  * ``lambda_map`` / ``nu_map`` / ``is_fractal`` / ``nu_with_membership``
    -- vectorised over integer arrays. They take numpy arrays (the host
    table builds in ``core/compact.py``) or torch tensors (on any device)
    and return the same kind they were given.

``nu_weight_matrix`` and ``lambda_weight_matrix`` are the constant operands
of the paper's tensor-core encoding of the maps (Eqs. 15-16), and
``nu_map_matmul`` / ``lambda_map_matmul`` that encoding as one float32
product (the reference's "MXU form"): exact while every result is below
2**24. The CUDA map kernels (``kernels/nu_map.py``, ``kernels/lambda_map.py``)
sum in integers instead and are held to ``nu_with_membership`` and
``lambda_map``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.fractals import NBBFractal


# ======================================================================
# scalar references (executable spec)
# ======================================================================
def lambda_map_scalar(frac: NBBFractal, r: int, cx: int, cy: int
                      ) -> Tuple[int, int]:
    """Paper Eqs. 2-5: compact (cx, cy) -> expanded (ex, ey)."""
    ex = ey = 0
    for mu in range(1, r + 1):
        w = cx if (mu % 2 == 1) else cy
        beta = (w // frac.k ** ((mu - 1) // 2)) % frac.k
        tx, ty = frac.positions[beta]
        ex += tx * frac.s ** (mu - 1)
        ey += ty * frac.s ** (mu - 1)
    return ex, ey


def nu_map_scalar(frac: NBBFractal, r: int, ex: int, ey: int
                  ) -> Tuple[int, int]:
    """Paper Eqs. 6-13: expanded (ex, ey) -> compact (cx, cy). Hole
    codes clamp to 0, as in the vectorised path."""
    cx = cy = 0
    for mu in range(1, r + 1):
        tx = (ex // frac.s ** (mu - 1)) % frac.s
        ty = (ey // frac.s ** (mu - 1)) % frac.s
        code = max(int(frac.h_nu[ty, tx]), 0)
        delta = frac.k ** ((mu - 1) // 2)
        if mu % 2 == 1:
            cx += code * delta
        else:
            cy += code * delta
    return cx, cy


def is_fractal_scalar(frac: NBBFractal, r: int, ex: int, ey: int) -> bool:
    if not (0 <= ex < frac.s ** r and 0 <= ey < frac.s ** r):
        return False
    for mu in range(1, r + 1):
        tx = (ex // frac.s ** (mu - 1)) % frac.s
        ty = (ey // frac.s ** (mu - 1)) % frac.s
        if frac.h_nu[ty, tx] < 0:
            return False
    return True


# ======================================================================
# vectorised maps (numpy arrays or torch tensors)
# ======================================================================
def _lut(table: np.ndarray, like):
    """``table`` as the array kind of ``like`` (same device for torch)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(table, dtype=torch.int64, device=like.device)
    return table.astype(np.int64)


def _as_int(a):
    if isinstance(a, torch.Tensor):
        return a.to(torch.int64)
    return np.asarray(a).astype(np.int64)


def _to_int32(a):
    return a.to(torch.int32) if isinstance(a, torch.Tensor) \
        else a.astype(np.int32)


def _clip(a, lo: int, hi: int):
    return a.clamp(lo, hi) if isinstance(a, torch.Tensor) \
        else np.clip(a, lo, hi)


def lambda_map(frac: NBBFractal, r: int, cx, cy):
    """Vectorised lambda(w): int32 (ex, ey) of the compact (cx, cy)."""
    h = _lut(frac.h_lambda, cx)  # (k, 2)
    cx, cy = _as_int(cx), _as_int(cy)
    ex = cx * 0
    ey = cy * 0
    for mu in range(1, r + 1):
        w = cx if (mu % 2 == 1) else cy
        beta = (w // (frac.k ** ((mu - 1) // 2))) % frac.k
        scale = frac.s ** (mu - 1)
        ex = ex + h[beta, 0] * scale
        ey = ey + h[beta, 1] * scale
    return _to_int32(ex), _to_int32(ey)


def _nu_digits(frac: NBBFractal, r: int, ex, ey):
    """Per-level replica codes H_nu[theta_mu] (holes -1), a list of r
    int64 arrays shaped like ``ex``."""
    hn = _lut(frac.h_nu, ex)  # (s, s) indexed [y, x]
    ex, ey = _as_int(ex), _as_int(ey)
    codes = []
    for mu in range(1, r + 1):
        scale = frac.s ** (mu - 1)
        codes.append(hn[(ey // scale) % frac.s, (ex // scale) % frac.s])
    return codes


def _nu_from_digits(frac: NBBFractal, codes, like):
    """int32 (cx, cy) from the codes, shaped like ``like`` (r = 0, no
    codes: zeros)."""
    cx = cy = _as_int(like) * 0
    for mu, code in enumerate(codes, start=1):
        delta = frac.k ** ((mu - 1) // 2)
        code = code * (code >= 0)
        if mu % 2 == 1:
            cx = cx + code * delta
        else:
            cy = cy + code * delta
    return _to_int32(cx), _to_int32(cy)


def _membership(frac: NBBFractal, r: int, ex, ey, codes):
    n = frac.s ** r
    valid = (ex >= 0) & (ex < n) & (ey >= 0) & (ey < n)
    for code in codes:
        valid = valid & (code >= 0)
    return valid


def nu_map(frac: NBBFractal, r: int, ex, ey):
    """Vectorised nu(w): int32 (cx, cy); hole codes clamp to 0."""
    return _nu_from_digits(frac, _nu_digits(frac, r, ex, ey), ex)


def is_fractal(frac: NBBFractal, r: int, ex, ey):
    """Vectorised fractal membership of expanded coordinates."""
    n = frac.s ** r
    codes = _nu_digits(frac, r, _clip(ex, 0, n - 1), _clip(ey, 0, n - 1))
    return _membership(frac, r, ex, ey, codes)


def nu_with_membership(frac: NBBFractal, r: int, ex, ey):
    """Fused nu(w) + membership from one digit pass: (cx, cy, valid)."""
    n = frac.s ** r
    codes = _nu_digits(frac, r, _clip(ex, 0, n - 1), _clip(ey, 0, n - 1))
    cx, cy = _nu_from_digits(frac, codes, ex)
    return cx, cy, _membership(frac, r, ex, ey, codes)


# ======================================================================
# constant operands of the tensor-core encoding (paper Section 3.6)
# ======================================================================
def nu_weights(frac: NBBFractal, r: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-level nu weights as two (r,) float32 vectors: k^floor((mu-1)/2)
    routed to x for odd mu, to y for even mu."""
    wx = np.zeros((r,), np.float32)
    wy = np.zeros((r,), np.float32)
    for mu in range(1, r + 1):
        delta = float(frac.k ** ((mu - 1) // 2))
        if mu % 2 == 1:
            wx[mu - 1] = delta
        else:
            wy[mu - 1] = delta
    return wx, wy


def nu_weight_matrix(frac: NBBFractal, r: int) -> np.ndarray:
    """(r, 2) float32: replica codes (N, r) @ W -> (cx, cy)."""
    wx, wy = nu_weights(frac, r)
    return np.stack([wx, wy], axis=1)


def lambda_weight_matrix(frac: NBBFractal, r: int) -> np.ndarray:
    """(2r, 2) float32 block-diagonal weights: [tau_x codes | tau_y
    codes] (N, 2r) @ W -> (ex, ey)."""
    w = np.zeros((2 * r, 2), np.float32)
    for mu in range(1, r + 1):
        w[mu - 1, 0] = float(frac.s ** (mu - 1))
        w[r + mu - 1, 1] = float(frac.s ** (mu - 1))
    return w


def _matmul_ints(codes, w: np.ndarray):
    """(codes (..., L) float32) @ (w (L, 2)) -> two int32 arrays."""
    if isinstance(codes, torch.Tensor):
        out = codes @ torch.from_numpy(w).to(codes.device)
        return out[..., 0].to(torch.int32), out[..., 1].to(torch.int32)
    out = codes @ w
    return out[..., 0].astype(np.int32), out[..., 1].astype(np.int32)


def _stack_f32(cols):
    if isinstance(cols[0], torch.Tensor):
        return torch.stack(cols, dim=-1).to(torch.float32)
    return np.stack(cols, axis=-1).astype(np.float32)


def nu_map_matmul(frac: NBBFractal, r: int, ex, ey):
    """nu(w) as one float32 product: replica codes (..., r), holes as 0,
    @ ``nu_weight_matrix`` (r, 2) -> int32 (cx, cy). No clipping, as in
    the reference; exact while cx, cy < 2**24."""
    codes = [c * (c >= 0) for c in _nu_digits(frac, r, ex, ey)]
    return _matmul_ints(_stack_f32(codes), nu_weight_matrix(frac, r))


def lambda_codes(frac: NBBFractal, r: int, cx, cy):
    """(..., 2r) float32: the per-level tau_x offsets of beta_mu, then the
    tau_y ones."""
    h = _lut(frac.h_lambda, cx)  # (k, 2)
    cx, cy = _as_int(cx), _as_int(cy)
    tx, ty = [], []
    for mu in range(1, r + 1):
        w = cx if (mu % 2 == 1) else cy
        beta = (w // (frac.k ** ((mu - 1) // 2))) % frac.k
        tx.append(h[beta, 0])
        ty.append(h[beta, 1])
    return _stack_f32(tx + ty)


def lambda_map_matmul(frac: NBBFractal, r: int, cx, cy):
    """lambda(w) as one float32 product: ``lambda_codes`` (..., 2r) @
    ``lambda_weight_matrix`` (2r, 2) -> int32 (ex, ey); exact while ex,
    ey < 2**24."""
    return _matmul_ints(lambda_codes(frac, r, cx, cy),
                        lambda_weight_matrix(frac, r))
