"""Baseline fractal engines the paper compares against (Section 4):

  * ``BBEngine``     -- the expanded bounding-box approach: grid and memory
                        are the full n x n embedding (paper's approach 1).
  * ``LambdaEngine`` -- Navarro et al. [7]: one unit of work per fractal
                        cell, placed by lambda (the lambda kernel, once per
                        engine), over expanded memory (approach 2).

Only fractal cells carry state or count as neighbors; multi-channel
workloads carry a leading channel axis, state (C, n, n). The steps are
plain PyTorch, as the reference's baselines are plain XLA.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from repro_torch.core.compact import compact_meshgrid
from repro_torch.core.fractals import NBBFractal
from repro_torch.kernels import lambda_map as lm
from repro_torch.workloads.base import (MOORE_DIRS, StencilWorkload,
                                        check_workload_ndim,
                                        weighted_gather_agg,
                                        weighted_moore_agg)
from repro_torch.workloads.rules import LIFE, life_rule  # noqa: F401

#: bytes of int32/f32 aggregate one BB row band may hold: bounds the
#: temporaries of a step at the paper's r=16 (65536^2 cells)
_BAND_BYTES = 1 << 30


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


@dataclasses.dataclass(frozen=True)
class BBEngine:
    """Expanded grid + expanded memory (the classic approach)."""

    frac: NBBFractal
    r: int
    workload: StencilWorkload = LIFE
    device: str = "cuda"

    def __post_init__(self):
        check_workload_ndim(self.workload, 2)

    @functools.cached_property
    def mask(self) -> torch.Tensor:
        """(n, n) uint8 occupancy, built on the device by self-similarity
        (kron of the replica grid, r times)."""
        grid = torch.as_tensor(self.frac.replica_grid, device=self.device)
        m = torch.ones((1, 1), dtype=torch.uint8, device=self.device)
        for _ in range(self.r):
            m = torch.kron(grid, m)
        return m

    def init_random(self, seed: int) -> torch.Tensor:
        n = self.frac.side(self.r)
        field = self.workload.init(_generator(seed, self.device), (n, n),
                                   self.device)
        return field * self.mask.to(field.dtype)

    def step(self, state: torch.Tensor) -> torch.Tensor:
        """One step, in row bands so the aggregate's temporaries stay under
        ``_BAND_BYTES`` at any size."""
        wl, n = self.workload, state.shape[-1]
        rows = max(1, _BAND_BYTES // (4 * n * wl.n_channels))
        out = torch.empty_like(state)
        for y0 in range(0, n, rows):
            y1 = min(n, y0 + rows)
            band = state[..., max(0, y0 - 1):min(n, y1 + 1), :]
            padded = F.pad(band, (1, 1, int(y0 == 0), int(y1 == n)))
            agg = weighted_moore_agg(padded, wl.weights2d, wl.agg_dtype)
            out[..., y0:y1, :] = wl.apply(state[..., y0:y1, :], agg,
                                          self.mask[y0:y1]).to(state.dtype)
        return out

    def run(self, state: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            state = self.step(state)
        return state

    def memory_bytes(self, dtype_size: int = 1) -> int:
        n = self.frac.side(self.r)
        return self.workload.n_channels * n * n * dtype_size


@dataclasses.dataclass(frozen=True)
class LambdaEngine:
    """Compact grid (via lambda), expanded memory -- Navarro et al. [7]."""

    frac: NBBFractal
    r: int
    workload: StencilWorkload = LIFE
    device: str = "cuda"

    def __post_init__(self):
        check_workload_ndim(self.workload, 2)

    def init_random(self, seed: int) -> torch.Tensor:
        return BBEngine(self.frac, self.r, self.workload,
                        self.device).init_random(seed)

    @functools.cached_property
    def _coords(self):
        """(ex, ey) of every compact cell: one lambda kernel launch."""
        cx, cy = compact_meshgrid(self.frac, self.r, self.device)
        ex, ey = lm.lambda_map_tc(self.frac, self.r, cx, cy)
        return ex.long(), ey.long()

    def step(self, state: torch.Tensor) -> torch.Tensor:
        wl = self.workload
        ex, ey = self._coords
        padded = F.pad(state, (1, 1, 1, 1))
        agg = weighted_gather_agg(
            MOORE_DIRS, wl.weights2d,
            lambda d: padded[..., ey + 1 + d[1], ex + 1 + d[0]],
            state.shape[:-2] + ex.shape, wl.agg_dtype, state.device)
        nxt = torch.zeros_like(state)
        nxt[..., ey, ex] = wl.apply(state[..., ey, ex], agg,
                                    None).to(state.dtype)
        return nxt

    def run(self, state: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            state = self.step(state)
        return state

    def memory_bytes(self, dtype_size: int = 1) -> int:
        n = self.frac.side(self.r)
        return self.workload.n_channels * n * n * dtype_size
