"""3D compact stencil engines over 3D NBB fractals (the Menger sponge,
the Sierpinski tetrahedron), the paper's Section 5 extension:

  * ``BB3DEngine``             -- the expanded bounding volume, O(n^3)
    memory (kind ``bb3d``).
  * ``Squeeze3DEngine``        -- per-cell compact engine (kind ``cell3d``):
    one lambda3 per cell, one nu3 + membership per neighbor, computed once
    per engine as a flat int32 gather index per direction the workload
    reads (26 for LIFE3D: 4 bytes a cell and direction, 6.7 GB at Menger
    r=6), where the reference recomputes the maps every step.
  * ``Squeeze3DBlockEngine``   -- block-level Squeeze in plain PyTorch over
    ``BlockLayout3D`` (kind ``block3d``): halo gather through the layout's
    tables, then the dense in-cube rule; ``step_k`` takes any k >= 1,
    deeper than rho too (multi-ring offset tables).
  * ``Squeeze3DKernelEngine``  -- the block engine stepped by the CUDA
    kernels of ``kernels/squeeze_stencil3d.py`` (CPU tensors take their
    plain versions): variant ``fused`` (kind ``cuda-3d``) or ``mxu`` (kind
    ``cuda-3d-mxu``); k <= rho; native leading batch axis.

Every engine takes a single-channel ``StencilWorkload`` over the 26-cell
Moore neighborhood (default ``LIFE3D``; ``HEAT3D`` and the dimension-free
totalistic rules too); holes and out-of-bounds neighbors contribute 0.
Cell states are (nz, ny, nx) compact, block states (n_blocks, rho, rho,
rho), BB states (n, n, n), all indexed [z, y, x].
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import fractals3d as f3
from repro_torch.core.baselines import _generator
from repro_torch.core.compact3d import (BlockLayout3D, compact_meshgrid3,
                                        compact_to_expanded3)
from repro_torch.core.stencil import _BlockEngine, _KernelEngine
from repro_torch.kernels import squeeze_stencil3d as k3
from repro_torch.workloads.base import (MOORE3_DIRS, StencilWorkload,
                                        weighted_gather_agg,
                                        weighted_moore_agg3)
from repro_torch.workloads.rules import LIFE3D


def life3_rule(alive: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """3D life B6/S5-7, uint8 out."""
    born = neighbors == 6
    survive = (alive > 0) & (neighbors >= 5) & (neighbors <= 7)
    return (born | survive).to(torch.uint8)




@dataclasses.dataclass(frozen=True)
class BB3DEngine:
    """Expanded bounding volume and memory (the classic approach)."""

    frac: f3.NBBFractal3D
    r: int
    workload: StencilWorkload = LIFE3D
    device: str = "cuda"

    def __post_init__(self):
        k3.check_workload3d(self.workload)

    @functools.cached_property
    def mask(self) -> torch.Tensor:
        """(n, n, n) uint8 occupancy, built on the device by
        self-similarity."""
        grid = torch.as_tensor(self.frac.h_nu >= 0, dtype=torch.uint8,
                               device=self.device)
        m = torch.ones((1, 1, 1), dtype=torch.uint8, device=self.device)
        for _ in range(self.r):
            m = torch.kron(grid, m)
        return m

    def init_random(self, seed: int) -> torch.Tensor:
        n = self.frac.side(self.r)
        field = self.workload.init(_generator(seed, self.device), (n, n, n),
                                   self.device)
        return field * self.mask.to(field.dtype)

    def step(self, state: torch.Tensor) -> torch.Tensor:
        wl = self.workload
        agg = weighted_moore_agg3(F.pad(state, (1,) * 6), wl.weights3d,
                                  wl.agg_dtype)
        return wl.apply(state, agg, self.mask).to(state.dtype)

    def run(self, state: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            state = self.step(state)
        return state

    def memory_bytes(self, dtype_size: int = 1) -> int:
        return self.frac.side(self.r) ** 3 * dtype_size


@dataclasses.dataclass(frozen=True)
class Squeeze3DEngine:
    """Compact 3D engine at cell granularity: O(k^r) state memory."""

    frac: f3.NBBFractal3D
    r: int
    workload: StencilWorkload = LIFE3D
    device: str = "cuda"

    def __post_init__(self):
        k3.check_workload3d(self.workload)

    def init_random(self, seed: int) -> torch.Tensor:
        nx, ny, nz = self.frac.compact_dims(self.r)
        return self.workload.init(_generator(seed, self.device),
                                  (nz, ny, nx), self.device)

    def to_expanded(self, state: torch.Tensor) -> torch.Tensor:
        return compact_to_expanded3(self.frac, self.r, state)

    @functools.cached_property
    def _gathers(self):
        """Per direction the workload reads: the flat int32 compact index
        of every cell's neighbor (one lambda3 per cell, one nu3 +
        membership per neighbor), ``volume`` -- an appended zero -- where
        the neighbor is a hole or out of bounds."""
        frac, r = self.frac, self.r
        nx, ny, _ = frac.compact_dims(r)
        ex, ey, ez = (a.long() for a in f3.lambda3_map(
            frac, r, *compact_meshgrid3(frac, r, self.device)))
        ghost = frac.volume(r)
        out = {}
        for d, wt in zip(MOORE3_DIRS, self.workload.weights3d):
            if wt == 0:
                continue
            cx, cy, cz, valid = f3.nu3_with_membership(
                frac, r, ex + d[0], ey + d[1], ez + d[2])
            flat = (cz.long() * ny + cy) * nx + cx
            out[d] = torch.where(valid, flat, ghost).to(torch.int32) \
                .reshape(-1)
        return out

    def step(self, state: torch.Tensor) -> torch.Tensor:
        wl = self.workload
        gathers = self._gathers
        flat = torch.cat([state.reshape(-1), state.new_zeros(1)])
        agg = weighted_gather_agg(
            MOORE3_DIRS, wl.weights3d,
            lambda d: flat.index_select(0, gathers[d]).view(state.shape),
            state.shape, wl.agg_dtype, state.device)
        return wl.apply(state, agg, None).to(state.dtype)

    def run(self, state: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            state = self.step(state)
        return state

    def memory_bytes(self, dtype_size: int = 1) -> int:
        return self.frac.volume(self.r) * dtype_size


def block3d_step_k(layout: BlockLayout3D, x: torch.Tensor,
                   workload: StencilWorkload, k: int) -> torch.Tensor:
    """k exact steps in plain PyTorch from one depth-k halo, any k >= 1:
    the ``block3d`` engine's step."""
    padded = layout.pad_with_halo_k(x, k)
    if k == 1:
        agg = weighted_moore_agg3(padded, workload.weights3d,
                                  workload.agg_dtype)
        mask = layout.device_table("micro_mask", x.device)
        return workload.apply(x, agg, mask).to(x.dtype)
    hmask = layout.device_table("halo_mask", x.device, k)
    return workload.tile_rule_k(padded, hmask, k, ndim=3).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Squeeze3DBlockEngine(_BlockEngine):
    """3D block-level Squeeze in plain PyTorch."""

    layout: BlockLayout3D
    workload: StencilWorkload = LIFE3D
    fusion_k: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        k3.check_workload3d(self.workload)
        if self.fusion_k is not None and self.fusion_k < 1:
            raise ValueError(f"fusion_k must be >= 1, got {self.fusion_k}")

    def step(self, state: torch.Tensor) -> torch.Tensor:
        return block3d_step_k(self.layout, state, self.workload, 1)

    def step_k(self, state: torch.Tensor, k: int) -> torch.Tensor:
        """k exact steps from one depth-k halo (any k >= 1)."""
        return block3d_step_k(self.layout, state, self.workload, k)


@dataclasses.dataclass(frozen=True)
class Squeeze3DKernelEngine(_KernelEngine):
    """3D block-level Squeeze stepped by the CUDA kernels (CPU tensors
    take their plain versions): ``variant`` 'fused' (3D v4) or 'mxu' (3D
    v5); ``step`` is the k = 1 launch of the same kernel. ``fusion_k``
    must stay <= rho (one block ring); ``macro_p`` overrides the mxu
    kernel's blocks per CTA."""

    layout: BlockLayout3D
    workload: StencilWorkload = LIFE3D
    variant: str = "fused"
    fusion_k: Optional[int] = None
    macro_p: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.variant not in ("fused", "mxu"):
            raise ValueError(f"unknown 3D kernel variant {self.variant!r}")
        k3.check_workload3d(self.workload)
        if self.fusion_k is not None and not (
                1 <= self.fusion_k <= self.layout.rho):
            raise ValueError(
                f"kernel fusion_k must be in [1, rho={self.layout.rho}], "
                f"got {self.fusion_k}")
        if self.macro_p is not None and self.variant != "mxu":
            raise ValueError("macro_p only applies to the 'mxu' variant")

    def step_k(self, state, k: int, out=None):
        """k exact steps in one launch (k <= rho)."""
        if self.variant == "mxu":
            return k3.stencil3d_step_mxu_k(self.layout, state,
                                           self.workload, k=k,
                                           p=self.macro_p, out=out)
        return k3.stencil3d_step_fused_k(self.layout, state, self.workload,
                                         k=k, out=out)
