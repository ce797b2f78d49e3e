"""3D NBB fractals and the lambda3/nu3 space maps (the paper's Section 5
extension to three dimensions; numpy only at import, its own copy so the
port never imports the JAX package).

A 3D NBB fractal F^{k,s} places k replicas on slots of an s x s x s grid.
Compact packing cycles the axes: level mu contributes its base-k digit to
axis (mu-1) mod 3 (x, y, z in turn), at digit position (mu-1) // 3. The
compact box is k^ceil(r/3) x k^ceil((r-1)/3) x k^floor(r/3) and holds
exactly k^r cells.

The maps are vectorised over integer arrays: they take numpy arrays (the
host table builds of ``core/compact3d.py``) or torch tensors (on any
device) and return the kind they were given, int32. The reference has no
kernel for them; plain tensor code is their port.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.maps import _as_int, _clip, _lut, _to_int32

Coord3 = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class NBBFractal3D:
    """A 3D NBB fractal family, independent of scale level."""

    name: str
    s: int
    positions: Tuple[Coord3, ...]  # (x, y, z) slots; order = enumeration

    def __post_init__(self):
        seen = set()
        for pos in self.positions:
            if len(pos) != 3 or not all(0 <= c < self.s for c in pos):
                raise ValueError(f"{self.name}: slot {pos} outside "
                                 f"[0,{self.s})^3")
            if pos in seen:
                raise ValueError(f"{self.name}: duplicate slot {pos}")
            seen.add(pos)

    @property
    def k(self) -> int:
        return len(self.positions)

    def side(self, r: int) -> int:
        return self.s ** r

    def volume(self, r: int) -> int:
        return self.k ** r

    def compact_dims(self, r: int) -> Tuple[int, int, int]:
        """(nx, ny, nz): axis a holds the digits of levels a+1, a+4, ..."""
        return tuple(self.k ** ((r - a + 2) // 3) for a in range(3))

    def mrf(self, r: int) -> float:
        """Memory reduction against the s^3r bounding volume."""
        return float(self.s ** (3 * r)) / float(self.k ** r)

    @functools.cached_property
    def h_lambda(self) -> np.ndarray:
        """(k, 3) int32: replica index -> (x, y, z) slot."""
        return np.asarray(self.positions, dtype=np.int32)

    @functools.cached_property
    def h_nu(self) -> np.ndarray:
        """(s, s, s) int32 indexed [z, y, x] -> replica id, -1 for holes."""
        t = np.full((self.s,) * 3, -1, dtype=np.int32)
        for i, (x, y, z) in enumerate(self.positions):
            t[z, y, x] = i
        return t

    def mask(self, r: int) -> np.ndarray:
        """(n, n, n) uint8 occupancy, [z, y, x], by self-similarity."""
        g = (self.h_nu >= 0).astype(np.uint8)
        m = np.ones((1, 1, 1), np.uint8)
        for _ in range(r):
            m = np.kron(g, m)
        return m


# ---------------------------------------------------------------- the maps
def lambda3_map(frac: NBBFractal3D, r: int, cx, cy, cz):
    """Compact (cx, cy, cz) -> expanded int32 (ex, ey, ez)."""
    h = _lut(frac.h_lambda, cx)  # (k, 3)
    comp = [_as_int(cx), _as_int(cy), _as_int(cz)]
    out = [c * 0 for c in comp]
    for mu in range(1, r + 1):
        axis, digit = (mu - 1) % 3, (mu - 1) // 3
        beta = (comp[axis] // (frac.k ** digit)) % frac.k
        scale = frac.s ** (mu - 1)
        for a in range(3):
            out[a] = out[a] + h[beta, a] * scale
    return tuple(_to_int32(o) for o in out)


def _nu3_codes(frac: NBBFractal3D, r: int, ex, ey, ez):
    """Per level mu, the replica code of the level-mu slot (-1 = hole)."""
    hn = _lut(frac.h_nu, ex)
    e = [_as_int(ex), _as_int(ey), _as_int(ez)]
    codes = []
    for mu in range(1, r + 1):
        scale = frac.s ** (mu - 1)
        tx, ty, tz = ((a // scale) % frac.s for a in e)
        codes.append(hn[tz, ty, tx])
    return codes


def nu3_map(frac: NBBFractal3D, r: int, ex, ey, ez):
    """Expanded -> compact int32 (cx, cy, cz); the inverse of lambda3 on
    fractal cells (hole codes clamp to 0)."""
    out = [_as_int(ex) * 0 for _ in range(3)]
    for mu, code in enumerate(_nu3_codes(frac, r, ex, ey, ez), start=1):
        code = code.clamp(min=0) if isinstance(code, torch.Tensor) \
            else np.maximum(code, 0)
        axis = (mu - 1) % 3
        out[axis] = out[axis] + code * frac.k ** ((mu - 1) // 3)
    return tuple(_to_int32(o) for o in out)


def is_fractal3(frac: NBBFractal3D, r: int, ex, ey, ez):
    """Boolean membership of expanded (ex, ey, ez), False out of bounds."""
    n = frac.side(r)
    e = [_as_int(a) for a in (ex, ey, ez)]
    inb = (e[0] >= 0) & (e[0] < n) & (e[1] >= 0) & (e[1] < n) \
        & (e[2] >= 0) & (e[2] < n)
    for code in _nu3_codes(frac, r, *(_clip(a, 0, n - 1) for a in e)):
        inb = inb & (code >= 0)
    return inb


def nu3_with_membership(frac: NBBFractal3D, r: int, ex, ey, ez):
    """(cx, cy, cz, valid): ``nu3_map`` of the coordinates clipped into
    the volume, and ``is_fractal3``."""
    n = frac.side(r)
    clipped = [_clip(_as_int(a), 0, n - 1) for a in (ex, ey, ez)]
    return (*nu3_map(frac, r, *clipped), is_fractal3(frac, r, ex, ey, ez))


# ---------------------------------------------------------------- registry
def _cube_except(s: int, holes) -> Tuple[Coord3, ...]:
    hs = set(holes)
    return tuple((x, y, z) for z in range(s) for y in range(s)
                 for x in range(s) if (x, y, z) not in hs)


#: Menger sponge F^{20,3}: 3x3x3 minus the 6 face centers and the center.
MENGER = NBBFractal3D(
    "menger", s=3,
    positions=_cube_except(3, [(1, 1, 1), (0, 1, 1), (2, 1, 1),
                               (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)]))

#: Discrete Sierpinski tetrahedron F^{4,2} (cube-corner embedding).
SIERPINSKI3D = NBBFractal3D(
    "sierpinski3d", s=2,
    positions=((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)))

REGISTRY3D: Dict[str, NBBFractal3D] = {f.name: f
                                       for f in (MENGER, SIERPINSKI3D)}
