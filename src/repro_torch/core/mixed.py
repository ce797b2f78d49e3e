"""Mixed-level NBB fractals — the paper's §5 future work: "build arbitrary
fractal structures by combining different NBB fractals at each scale
level".

A MixedFractal is a bottom-up sequence of per-level generators
``levels = (F_1, ..., F_r)`` (level mu replicates with F_mu's slot set).
All NBB-class properties generalise with mixed radices:

  * side   n   = prod(s_mu), volume V = prod(k_mu);
  * compact domain: level mu's base-k_mu digit goes to axis x for odd mu,
    y for even mu (the paper's alternation), with mixed-radix place values
    Delta_mu = prod of k of earlier SAME-AXIS levels;
  * lambda/nu are the same offset accumulations with per-level (k, s, H).

The uniform case (all levels equal) reduces exactly to ``core/maps.py``.
The maps take numpy arrays or torch tensors (on any device) and return
the kind they were given, as ``core/maps.py``'s do.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

from repro_torch.core.fractals import NBBFractal
from repro_torch.core.maps import _as_int, _clip, _lut, _to_int32


@dataclasses.dataclass(frozen=True)
class MixedFractal:
    """levels[mu-1] is the generator applied at scale level mu (bottom-up:
    levels[0] is the finest replication)."""

    name: str
    levels: Tuple[NBBFractal, ...]

    @property
    def r(self) -> int:
        return len(self.levels)

    @property
    def side(self) -> int:
        n = 1
        for f in self.levels:
            n *= f.s
        return n

    @property
    def volume(self) -> int:
        v = 1
        for f in self.levels:
            v *= f.k
        return v

    def compact_dims(self) -> Tuple[int, int]:
        rows = cols = 1
        for mu, f in enumerate(self.levels, start=1):
            if mu % 2 == 1:
                cols *= f.k
            else:
                rows *= f.k
        return rows, cols

    @functools.cached_property
    def _scales(self):
        """Per-level expanded place value prod(s_nu, nu<mu) and per-axis
        compact place values."""
        e_scale, x_place, y_place = [], [], []
        es, xp, yp = 1, 1, 1
        for mu, f in enumerate(self.levels, start=1):
            e_scale.append(es)
            es *= f.s
            if mu % 2 == 1:
                x_place.append(xp)
                y_place.append(None)
                xp *= f.k
            else:
                x_place.append(None)
                y_place.append(yp)
                yp *= f.k
        return e_scale, x_place, y_place

    def mask(self) -> np.ndarray:
        m = np.ones((1, 1), np.uint8)
        for f in self.levels:
            m = np.kron(f.replica_grid, m)
        return m

    # ------------------------------------------------------------- the maps
    def lambda_map(self, cx, cy):
        """int32 (ex, ey) of the compact (cx, cy)."""
        e_scale, x_place, y_place = self._scales
        like = cx
        cx, cy = _as_int(cx), _as_int(cy)
        ex = cx * 0
        ey = cy * 0
        for mu, f in enumerate(self.levels, start=1):
            if mu % 2 == 1:
                beta = (cx // x_place[mu - 1]) % f.k
            else:
                beta = (cy // y_place[mu - 1]) % f.k
            tau = _lut(f.h_lambda, like)[beta]
            ex = ex + tau[..., 0] * e_scale[mu - 1]
            ey = ey + tau[..., 1] * e_scale[mu - 1]
        return _to_int32(ex), _to_int32(ey)

    def nu_map(self, ex, ey):
        """-> (cx, cy, valid): int32 compact coordinates and membership."""
        e_scale, x_place, y_place = self._scales
        n = self.side
        like = ex
        ex, ey = _as_int(ex), _as_int(ey)
        inb = (ex >= 0) & (ex < n) & (ey >= 0) & (ey < n)
        exc = _clip(ex, 0, n - 1)
        eyc = _clip(ey, 0, n - 1)
        cx = exc * 0
        cy = eyc * 0
        valid = inb
        for mu, f in enumerate(self.levels, start=1):
            tx = (exc // e_scale[mu - 1]) % f.s
            ty = (eyc // e_scale[mu - 1]) % f.s
            code = _lut(f.h_nu, like)[ty, tx]
            valid = valid & (code >= 0)
            code = _clip(code, 0, f.k)
            if mu % 2 == 1:
                cx = cx + code * x_place[mu - 1]
            else:
                cy = cy + code * y_place[mu - 1]
        return _to_int32(cx), _to_int32(cy), valid

    def mrf(self) -> float:
        return float(self.side) ** 2 / float(self.volume)
