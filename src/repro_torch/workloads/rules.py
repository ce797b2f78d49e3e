"""Concrete stencil workloads.

  * ``TotalisticCA``  -- outer-totalistic CA with born/survive count sets,
                        over the Moore neighborhood of any dimension;
                        ``LIFE`` (B3/S23), ``HIGHLIFE`` (B36/S23), ``SEEDS``,
                        and ``LIFE3D`` (B6/S5-7) for the 3D engines.
  * ``HeatDiffusion`` -- float32 Jacobi iteration of the heat equation with
                        Dirichlet-0 holes (orthogonal Laplacian); ``HEAT``
                        in 2D, ``HEAT3D`` (degree 6) in 3D.
  * ``GrayScott``     -- 2-channel float32 Gray-Scott reaction-diffusion
                        (normalized 9-point Laplacian).

Each rule exports the plain parameters its CUDA kernel takes
(``kernel_params``): the born/survive sets as 27-bit masks, ``alpha`` and
``degree`` for Heat, ``du``, ``dv``, ``feed`` and ``kill`` for Gray-Scott,
and the ring weights of ``weights3x3``. Frozen dataclasses: hashable, so a
workload keys the runner's engine cache.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet

import torch

from repro_torch.workloads.base import StencilWorkload

#: rule ids shared with kernels/csrc/squeeze_stencil.cu
RULE_TOTALISTIC, RULE_HEAT, RULE_GRAY_SCOTT = 0, 1, 2


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


#: the largest Moore neighbor count: 26 in 3D (8 in 2D)
MAX_COUNT = 26


def life_rule(alive: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """Conway B3/S23 on a state and its neighbor counts, uint8 out (the
    paper's Section 4 rule)."""
    born = neighbors == 3
    survive = (alive > 0) & (neighbors == 2)
    return (born | survive).to(torch.uint8)


def count_mask(counts: FrozenSet[int]) -> int:
    """A neighbor-count set as a 27-bit mask (bit c set iff c in counts)."""
    if any(not 0 <= c <= MAX_COUNT for c in counts):
        raise ValueError(f"Moore neighbor counts lie in [0, {MAX_COUNT}], "
                         f"got {sorted(counts)}")
    return sum(1 << c for c in counts)


@dataclasses.dataclass(frozen=True)
class TotalisticCA(StencilWorkload):
    """A dead cell is born when its live-neighbor count is in ``born``; a
    live cell survives when it is in ``survive``."""

    name: str = "life"
    born: FrozenSet[int] = frozenset({3})
    survive: FrozenSet[int] = frozenset({2, 3})

    @property
    def born_mask(self) -> int:
        return count_mask(self.born)

    @property
    def survive_mask(self) -> int:
        return count_mask(self.survive)

    def kernel_params(self) -> Dict:
        return dict(rule=RULE_TOTALISTIC, born=self.born_mask,
                    survive=self.survive_mask, p=(0.0, 0.0, 0.0, 0.0))

    def apply(self, center, agg, mask):
        survive = torch.isin(agg, torch.tensor(sorted(self.survive),
                                               dtype=agg.dtype,
                                               device=agg.device))
        born = torch.isin(agg, torch.tensor(sorted(self.born),
                                            dtype=agg.dtype,
                                            device=agg.device))
        nxt = torch.where(center > 0, survive, born).to(torch.uint8)
        return self.masked(nxt, mask)

    def init(self, generator, shape, device):
        return torch.randint(0, 2, tuple(shape), generator=generator,
                             device=device, dtype=torch.uint8)


@dataclasses.dataclass(frozen=True)
class HeatDiffusion(StencilWorkload):
    """Explicit Jacobi step u += alpha * (agg - degree * u), Dirichlet-0
    holes; orthogonal neighbors weigh 1, diagonals 0 (never read)."""

    name: str = "heat"
    alpha: float = 0.2
    degree: int = 4

    dtype = torch.float32
    agg_dtype = torch.float32

    @property
    def ndim(self):
        return self.degree // 2

    def weight(self, offset):
        return 1 if sum(abs(d) for d in offset) == 1 else 0

    def kernel_params(self) -> Dict:
        return dict(rule=RULE_HEAT, born=0, survive=0,
                    p=(self.alpha, float(self.degree), 0.0, 0.0))

    def apply(self, center, agg, mask):
        u = center.to(torch.float32)
        nxt = u + _f32(self.alpha, u) * (agg - _f32(self.degree, u) * u)
        return self.masked(nxt, mask)

    def init(self, generator, shape, device):
        return torch.rand(tuple(shape), generator=generator, device=device,
                          dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class GrayScott(StencilWorkload):
    """Gray-Scott reaction-diffusion, channels (U, V):

        u' = u + du * lap(u) - u v^2 + feed (1 - u)
        v' = v + dv * lap(v) + u v^2 - (feed + kill) v

    with lap = agg - u over weights 0.2 orthogonal, 0.05 diagonal."""

    name: str = "gray-scott"
    du: float = 1.0
    dv: float = 0.5
    feed: float = 0.055
    kill: float = 0.062

    n_channels = 2
    ndim = 2
    dtype = torch.float32
    agg_dtype = torch.float32

    def weight(self, offset):
        if len(offset) != 2:
            raise ValueError("GrayScott is a 2D workload")
        return 0.2 if sum(abs(d) for d in offset) == 1 else 0.05

    def kernel_params(self) -> Dict:
        return dict(rule=RULE_GRAY_SCOTT, born=0, survive=0,
                    p=(self.du, self.dv, self.feed, self.feed + self.kill))

    def apply(self, center, agg, mask):
        u, v = center[0].to(torch.float32), center[1].to(torch.float32)
        lap_u = agg[0] - u
        lap_v = agg[1] - v
        uvv = u * v * v
        nu = u + _f32(self.du, u) * lap_u - uvv \
            + _f32(self.feed, u) * (1.0 - u)
        nv = v + _f32(self.dv, v) * lap_v + uvv \
            - _f32(self.feed + self.kill, v) * v
        return self.masked(torch.stack([nu, nv]), mask)

    def init(self, generator, shape, device):
        seeds = (torch.rand(tuple(shape), generator=generator,
                            device=device) < 0.02).to(torch.float32)
        return torch.stack([1.0 - 0.5 * seeds, 0.25 * seeds])


LIFE = TotalisticCA()
HIGHLIFE = TotalisticCA(name="highlife", born=frozenset({3, 6}),
                        survive=frozenset({2, 3}))
SEEDS = TotalisticCA(name="seeds", born=frozenset({2}),
                     survive=frozenset())
HEAT = HeatDiffusion()
GRAY_SCOTT = GrayScott()
LIFE3D = TotalisticCA(name="life3d", born=frozenset({6}),
                      survive=frozenset({5, 6, 7}))
HEAT3D = HeatDiffusion(name="heat3d", alpha=0.125, degree=6)

#: name -> workload registry of the 2D engines
WORKLOADS = {w.name: w for w in (LIFE, HIGHLIFE, SEEDS, HEAT, GRAY_SCOTT)}

#: name -> the 3D-only workloads (the 3D engines also take the totalistic
#: rules of ``WORKLOADS``)
WORKLOADS3D = {w.name: w for w in (LIFE3D, HEAT3D)}


def get_workload(name: str) -> StencilWorkload:
    """The registry workload of this name, 2D or 3D."""
    wl = WORKLOADS.get(name) or WORKLOADS3D.get(name)
    if wl is None:
        raise KeyError(f"unknown workload {name!r}; "
                       f"have {sorted(WORKLOADS) + sorted(WORKLOADS3D)}")
    return wl
