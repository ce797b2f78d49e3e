"""NBB (Non-overlapping Bounding-Box) fractal definitions (PyTorch port;
numpy only, its own copy so the port never imports the JAX package).

A member of the NBB class ``F_n^{k,s}`` is fully described by:
  * ``s``  — linear scaling factor per level (the transition function embeds
             the current fractal in an ``s x s`` grid of slots),
  * ``positions`` — the ``k`` occupied slots, as (x, y) pairs with
             ``0 <= x, y < s``; origin at the upper-left, y growing downward
             (paper Section 3.4 convention).

The order of ``positions`` *is* the replica enumeration: ``H_lambda[i]``
returns the slot of replica ``i`` and ``H_nu[slot]`` returns ``i``.

Level ``r`` facts (paper Eq. 1 and Section 3.1):
  * expanded side        n      = s**r
  * volume (cell count)  V      = k**r
  * compact domain       rows x cols = k**floor(r/2) x k**ceil(r/2)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import numpy as np

Coord = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class NBBFractal:
    """An NBB fractal family, independent of scale level."""

    name: str
    s: int
    positions: Tuple[Coord, ...]  # (x, y) slots, order = replica enumeration

    def __post_init__(self):
        if self.s < 2:
            raise ValueError(f"scaling factor s must be >= 2, got {self.s}")
        seen = set()
        for (x, y) in self.positions:
            if not (0 <= x < self.s and 0 <= y < self.s):
                raise ValueError(
                    f"{self.name}: slot ({x},{y}) outside [0,{self.s})^2")
            if (x, y) in seen:
                raise ValueError(f"{self.name}: duplicate slot ({x},{y})")
            seen.add((x, y))
        if not (1 <= self.k <= self.s * self.s):
            raise ValueError(f"{self.name}: invalid replica count k={self.k}")

    # ------------------------------------------------------------------ basic
    @property
    def k(self) -> int:
        return len(self.positions)

    def side(self, r: int) -> int:
        """Expanded embedding side n = s**r."""
        return self.s ** r

    def volume(self, r: int) -> int:
        """Number of fractal cells V = k**r (paper Eq. 1)."""
        return self.k ** r

    def level_of_side(self, n: int) -> int:
        """r = log_s(n); n must be an exact power of s."""
        r = int(round(np.log(n) / np.log(self.s)))
        if self.s ** r != n:
            raise ValueError(
                f"{self.name}: n={n} is not a power of s={self.s}")
        return r

    def compact_dims(self, r: int) -> Tuple[int, int]:
        """(rows, cols) of the compact rectangle = k^floor(r/2) x k^ceil(r/2).

        Odd levels pack into x (cols), even levels into y (rows) — matching
        lambda's beta_mu digit convention (paper Eq. 5 / Section 3.1).
        """
        return self.k ** (r // 2), self.k ** ((r + 1) // 2)

    def mrf(self, r: int) -> float:
        """Theoretical memory-reduction-factor vs bounding box (paper 3.7)."""
        return float(self.s ** (2 * r)) / float(self.k ** r)

    # ------------------------------------------------------------ replica LUTs
    @functools.cached_property
    def h_lambda(self) -> np.ndarray:
        """(k, 2) int32: replica index -> (tau_x, tau_y) slot (paper Eq. 4)."""
        return np.asarray(self.positions, dtype=np.int32)

    @functools.cached_property
    def h_nu(self) -> np.ndarray:
        """(s, s) int32 indexed [y, x]: slot -> replica index, -1 for holes
        (paper Section 3.4's H_nu lookup)."""
        table = np.full((self.s, self.s), -1, dtype=np.int32)
        for i, (x, y) in enumerate(self.positions):
            table[y, x] = i
        return table

    @functools.cached_property
    def replica_grid(self) -> np.ndarray:
        """(s, s) uint8 occupancy indexed [y, x]."""
        return (self.h_nu >= 0).astype(np.uint8)

    # ------------------------------------------------------------------- masks
    def mask(self, r: int) -> np.ndarray:
        """(n, n) uint8 occupancy of the expanded embedding at level r.

        Built by self-similarity: mask_r = kron(replica_grid, mask_{r-1}).
        """
        m = np.ones((1, 1), dtype=np.uint8)
        for _ in range(r):
            m = np.kron(self.replica_grid, m)
        return m


# -------------------------------------------------------------- registry
def _rowmajor_except(s: int, holes: Tuple[Coord, ...]) -> Tuple[Coord, ...]:
    hole_set = set(holes)
    return tuple((x, y) for y in range(s) for x in range(s)
                 if (x, y) not in hole_set)


#: The paper's Sierpinski triangle F^{3,2}: replicas top (0,0), middle (0,1),
#: right (1,1) — enumeration chosen so H_nu[(x,y)] == x + y (paper Eq. 22).
SIERPINSKI = NBBFractal("sierpinski", s=2, positions=((0, 0), (0, 1), (1, 1)))

#: Sierpinski carpet F^{8,3} (paper Fig. 1): 3x3 minus the center.
CARPET = NBBFractal("carpet", s=3, positions=_rowmajor_except(3, ((1, 1),)))

#: Vicsek F^{5,3} (paper Fig. 5): plus-shape.
VICSEK = NBBFractal(
    "vicsek", s=3, positions=((1, 0), (0, 1), (1, 1), (2, 1), (1, 2)))

#: "Empty bottles" F^{7,3} (paper Fig. 2). The exact slot layout is not given
#: in the text; any 7-of-9 layout is a valid member of the class — we pick a
#: bottle-ish one (3x3 minus the two upper corners).
EMPTY_BOTTLES = NBBFractal(
    "empty_bottles", s=3, positions=_rowmajor_except(3, ((0, 0), (2, 0))))

#: "Chandelier" (paper Fig. 11); layout not specified — 3x3 minus center
#: column's top+middle, hanging-lamp shape.
CHANDELIER = NBBFractal(
    "chandelier", s=3, positions=_rowmajor_except(3, ((1, 0), (0, 1))))

REGISTRY: Dict[str, NBBFractal] = {
    f.name: f for f in (SIERPINSKI, CARPET, VICSEK, EMPTY_BOTTLES, CHANDELIER)
}


def get_fractal(name: str) -> NBBFractal:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown fractal {name!r}; known: {sorted(REGISTRY)}") from None
