"""Block-level Squeeze in three dimensions: the 2D ``BlockLayout`` of
``core/compact.py`` over the lambda3/nu3 maps of ``core/fractals3d.py``.

With ``rho = s**m`` the 3D fractal is a level-``r_b`` fractal of blocks
(``r_b = r - m``); each block stores a rho^3 expanded micro-fractal cube
(the same occupancy ``micro_mask`` in every block). Block state is
``(B?, n_blocks, rho, rho, rho)`` indexed ``[b, z, y, x]`` with block id
``(bz * ny + by) * nx + bx`` over the compact block box ``(nx, ny, nz) =
compact_dims(r_b)``. Cross-block neighbor access goes through static
tables built once on the host with vectorised numpy (one lambda3 per block,
one nu3 per block and offset, all offsets in one pass) and uploaded once
per device (``device_table``). The depth-k halo geometry (offset tables
exact past holes, window and halo masks, ``pad_with_halo_k``) mirrors the
2D layout method for method.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fractals3d as f3
from repro_torch.core.compact import LayoutTables
from repro_torch.workloads.base import MOORE3_DIRS

#: window cells one 3D mxu CTA holds by default (P slots of (rho+2k)^3
#: cells): 4 a thread at 1024 threads, so its shared memory (a float32
#: product buffer and the state, 8 bytes a cell for HEAT3D) stays at 32 KB
#: plus the operators. rho=9 windows (2197 cells at k=2, 3375 at k=3) take
#: one slot; rho=3 windows (125-729 cells) take 5-32.
MXU3_CELLS_PER_CTA = 4096


def halo_regions3(rho: int, k: int):
    """The 26 (zs, ys, xs) window slices of the depth-k halo frame, in
    MOORE3_DIRS order: region d belongs to the neighbor block in direction
    d, whose existence gates the window mask there."""
    w = rho + 2 * k
    sl = {-1: slice(0, k), 0: slice(k, k + rho), 1: slice(k + rho, w)}
    return tuple((sl[dz], sl[dy], sl[dx]) for (dx, dy, dz) in MOORE3_DIRS)


def compact_meshgrid3(frac: f3.NBBFractal3D, r: int, device=None):
    """(cx, cy, cz) int32 tensors of shape (nz, ny, nx) covering the
    compact box."""
    nx, ny, nz = frac.compact_dims(r)
    cz, cy, cx = torch.meshgrid(
        *(torch.arange(n, dtype=torch.int32, device=device)
          for n in (nz, ny, nx)), indexing="ij")
    return cx, cy, cz


def _expanded_flat(frac: f3.NBBFractal3D, r: int, device) -> torch.Tensor:
    """(nz, ny, nx) int64 flat expanded index of every compact cell."""
    n = frac.side(r)
    ex, ey, ez = (a.long() for a in f3.lambda3_map(
        frac, r, *compact_meshgrid3(frac, r, device)))
    return (ez * n + ey) * n + ex


def compact_to_expanded3(frac: f3.NBBFractal3D, r: int,
                         state_c: torch.Tensor) -> torch.Tensor:
    """Scatter a compact (..., nz, ny, nx) state into its (..., n, n, n)
    expanded embedding (holes 0)."""
    n = frac.side(r)
    lead = state_c.shape[:-3]
    out = state_c.new_zeros(lead + (n ** 3,))
    out[..., _expanded_flat(frac, r, state_c.device)] = state_c
    return out.reshape(lead + (n, n, n))


def expanded_to_compact3(frac: f3.NBBFractal3D, r: int,
                         state_e: torch.Tensor) -> torch.Tensor:
    """Gather the fractal cells of an expanded state into compact form."""
    flat = state_e.reshape(state_e.shape[:-3] + (-1,))
    return flat[..., _expanded_flat(frac, r, state_e.device)]


@dataclasses.dataclass(frozen=True)
class BlockLayout3D(LayoutTables):
    """Static geometry of a 3D block-level Squeeze decomposition."""

    frac: f3.NBBFractal3D
    r: int
    m: int  # rho = s**m

    def __post_init__(self):
        if not (0 <= self.m <= self.r):
            raise ValueError(f"need 0 <= m <= r, got m={self.m}, r={self.r}")

    @property
    def rho(self) -> int:
        return self.frac.s ** self.m

    @property
    def r_b(self) -> int:
        return self.r - self.m

    @property
    def block_dims(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) of the compact block box."""
        return self.frac.compact_dims(self.r_b)

    @property
    def n_blocks(self) -> int:
        return self.frac.volume(self.r_b)

    @property
    def ghost(self) -> int:
        """Sentinel block id of out-of-fractal neighbors."""
        return self.n_blocks

    # ------------------------------------------------------- host tables
    @functools.cached_property
    def micro_mask(self) -> np.ndarray:
        """(rho, rho, rho) uint8 occupancy of the level-m micro-fractal,
        [z, y, x]."""
        return self.frac.mask(self.m)

    @functools.cached_property
    def block_coords(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Flat (n_blocks,) int32 compact block coordinates (bx, by, bz),
        id-ordered (z-major raster)."""
        nx, ny, _ = self.block_dims
        ids = np.arange(self.n_blocks, dtype=np.int64)
        return ((ids % nx).astype(np.int32),
                ((ids // nx) % ny).astype(np.int32),
                (ids // (nx * ny)).astype(np.int32))

    @functools.cached_property
    def _block_origin_blocks(self):
        """Block-level expanded coordinates (ex, ey, ez) of every block."""
        return f3.lambda3_map(self.frac, self.r_b, *self.block_coords)

    @functools.cached_property
    def block_origin_expanded(self) -> np.ndarray:
        """(n_blocks, 3) int32 cell-level expanded origin (x, y, z)."""
        return np.stack(self._block_origin_blocks, axis=1) * self.rho

    def _map_offsets_to_table(self, offsets) -> np.ndarray:
        """(n_blocks, len(offsets)) int32 compact block id per block offset,
        every offset in one vectorised nu3 pass; out-of-fractal blocks get
        the ``ghost`` sentinel."""
        off = np.asarray(offsets, dtype=np.int64)  # (n_off, 3)
        ex, ey, ez = (a.astype(np.int64)[:, None] + off[None, :, i]
                      for i, a in enumerate(self._block_origin_blocks))
        cx, cy, cz, valid = f3.nu3_with_membership(self.frac, self.r_b, ex,
                                                   ey, ez)
        nx, ny, _ = self.block_dims
        ids = (cz.astype(np.int64) * ny + cy) * nx + cx
        return np.where(valid, ids, self.ghost).astype(np.int32)

    @functools.cached_property
    def neighbor_table(self) -> np.ndarray:
        """(n_blocks, 26) int32 compact block id per Moore direction."""
        return self._map_offsets_to_table(MOORE3_DIRS)

    @functools.cached_property
    def existence_table(self) -> np.ndarray:
        """(n_blocks, 26) int32 {0,1}: 1 where the Moore neighbor block is a
        real fractal block (``neighbor_table != ghost``)."""
        return (self.neighbor_table != self.ghost).astype(np.int32)

    # ---------------------------------------------------- depth-k halos
    def halo_block_radius(self, k: int) -> int:
        """Radius in blocks of the depth-``k`` cell halo (1 while k <=
        rho)."""
        if k < 1:
            raise ValueError(f"halo depth must be >= 1, got {k}")
        return math.ceil(k / self.rho)

    def halo_offsets(self, k: int) -> Tuple[Tuple[int, int, int], ...]:
        """Block offsets (bdx, bdy, bdz) whose cubes meet the depth-``k``
        window, raster-ordered; equals ``MOORE3_DIRS`` when k <= rho."""
        kb = self.halo_block_radius(k)
        return tuple((dx, dy, dz)
                     for dz in range(-kb, kb + 1)
                     for dy in range(-kb, kb + 1)
                     for dx in range(-kb, kb + 1)
                     if (dx, dy, dz) != (0, 0, 0))

    def offset_table(self, k: int) -> np.ndarray:
        """(n_blocks, len(halo_offsets(k))) int32 compact block id per
        offset, each resolved directly through the maps (never composed
        through a ghost, so real blocks beyond a hole stay reachable)."""
        def build():
            if self.halo_block_radius(k) == 1:
                return self.neighbor_table
            return self._map_offsets_to_table(self.halo_offsets(k))
        return self._memo(("offset_table", self.halo_block_radius(k)),
                          build)

    def _halo_region(self, k: int, bdx: int, bdy: int, bdz: int):
        """((z0, z1, y0, y1, x0, x1) in the window, the matching bounds in
        the neighbor cube) of the overlap of the cube at block offset
        (bdx, bdy, bdz) with the (rho+2k)^3 window."""
        rho = self.rho
        w = rho + 2 * k

        def axis(bd):
            o = k + bd * rho
            lo, hi = max(o, 0), min(o + rho, w)
            return lo, hi, lo - o, hi - o

        zyx = [axis(bd) for bd in (bdz, bdy, bdx)]
        dst = tuple(v for lo, hi, _, _ in zyx for v in (lo, hi))
        src = tuple(v for _, _, lo, hi in zyx for v in (lo, hi))
        return dst, src

    def window_mask(self, k: int) -> np.ndarray:
        """(rho+2k,)^3 uint8 periodic extension of ``micro_mask``: the
        window occupancy before ghost gating."""
        def build():
            idx = np.arange(-k, self.rho + k) % self.rho
            return self.micro_mask[np.ix_(idx, idx, idx)]
        return self._memo(("window_mask", k), build)

    def halo_mask(self, k: int) -> np.ndarray:
        """(n_blocks, rho+2k, rho+2k, rho+2k) uint8 occupancy of each
        block's depth-``k`` window: ``window_mask`` with the regions of
        ghost neighbor blocks zeroed. Only the plain ``block3d`` engine
        reads it (n_blocks (rho+2k)^3 bytes: 540 MB at Menger r=6, m=2,
        k=3); the kernels and their plain versions rebuild it per block
        from ``window_mask`` and ``existence_table``."""
        def build():
            w = self.rho + 2 * k
            table = self.offset_table(k)
            full = np.broadcast_to(self.window_mask(k),
                                   (self.n_blocks, w, w, w)).copy()
            for oi, off in enumerate(self.halo_offsets(k)):
                (z0, z1, y0, y1, x0, x1), _ = self._halo_region(k, *off)
                full[table[:, oi] == self.ghost, z0:z1, y0:y1, x0:x1] = 0
            return full
        return self._memo(("halo_mask", k), build)

    # ------------------------------------------- mxu macro-tile packing
    def macro_tiles(self, k: int, p: Optional[int] = None
                    ) -> Tuple[int, int, int]:
        """``(P, n_macro, nb_pad)`` of the 3D mxu kernel: P blocks (each a
        (rho+2k)^3 slot) per CTA. The default P fills
        ``MXU3_CELLS_PER_CTA`` window cells and is rebalanced to
        ``ceil(n_blocks / n_macro)``; an explicit ``p`` is taken as is
        (clamped to [1, n_blocks])."""
        return self.macro_tiles_for(self.n_blocks, k, p)

    def macro_tiles_for(self, nb: int, k: int, p: Optional[int] = None
                        ) -> Tuple[int, int, int]:
        """``macro_tiles`` for an arbitrary block count ``nb``."""
        if k < 1:
            raise ValueError(f"halo depth must be >= 1, got {k}")
        if p is not None:
            if p < 1:
                raise ValueError(f"macro-tile packing must be >= 1, got {p}")
            p = min(p, nb)
            n_macro = -(-nb // p)
            return p, n_macro, n_macro * p
        w = self.rho + 2 * k
        p = max(1, min(MXU3_CELLS_PER_CTA // w ** 3, nb))
        n_macro = -(-nb // p)
        p = -(-nb // n_macro)
        return p, n_macro, n_macro * p

    def existence_padded(self, k: int, p: Optional[int] = None
                         ) -> np.ndarray:
        """(nb_pad, 26) int32 ``existence_table`` zero-padded to the mxu
        slot count: padding slots have no real neighbors."""
        def build():
            _, _, nb_pad = self.macro_tiles(k, p=p)
            pad = np.zeros((nb_pad - self.n_blocks, 26), np.int32)
            return np.concatenate([self.existence_table, pad], axis=0)
        return self._memo(("existence_padded", k, p), build)

    # ------------------------------------------------------ conversions
    def _flat_cells(self, device) -> torch.Tensor:
        """(n_blocks, rho, rho, rho) int64 flat expanded index
        ``(z * n + y) * n + x`` of every block cell."""
        n = self.frac.side(self.r)
        org = self.device_table("block_origin_expanded", device).long()
        ar = torch.arange(self.rho, device=device)
        ax = org[:, 0, None, None, None] + ar[None, None, None, :]
        ay = org[:, 1, None, None, None] + ar[None, None, :, None]
        az = org[:, 2, None, None, None] + ar[None, :, None, None]
        return (az * n + ay) * n + ax

    def to_expanded(self, state_b: torch.Tensor) -> torch.Tensor:
        """(..., n_blocks, rho, rho, rho) block state -> (..., n, n, n)
        expanded embedding (holes 0)."""
        n = self.frac.side(self.r)
        lead = state_b.shape[:-4]
        out = state_b.new_zeros(lead + (n ** 3,))
        out[..., self._flat_cells(state_b.device)] = state_b
        return out.reshape(lead + (n, n, n))

    def from_expanded(self, state_e: torch.Tensor) -> torch.Tensor:
        """(..., n, n, n) expanded embedding -> (..., n_blocks, rho, rho,
        rho), holes of the micro-fractal zeroed."""
        flat = state_e.reshape(state_e.shape[:-3] + (-1,))
        mask = self.device_table("micro_mask", state_e.device)
        return flat[..., self._flat_cells(state_e.device)] * \
            mask.to(state_e.dtype)

    def pad_with_halo_k(self, state_b: torch.Tensor, k: int) -> torch.Tensor:
        """(..., n_blocks, (rho+2k)^3) windows with depth-``k`` halos: per
        block offset only the overlap slab of the neighbor cube is
        gathered through ``offset_table(k)``; ghost ids index an appended
        zero slab, so out-of-fractal reads are zero at every depth."""
        if k < 1:
            raise ValueError(f"halo depth must be >= 1, got {k}")
        rho = self.rho
        w = rho + 2 * k
        table = self.device_table("offset_table", state_b.device, k).long()
        out = state_b.new_zeros(state_b.shape[:-3] + (w, w, w))
        out[..., k:k + rho, k:k + rho, k:k + rho] = state_b
        for oi, off in enumerate(self.halo_offsets(k)):
            (z0, z1, y0, y1, x0, x1), (sz0, sz1, sy0, sy1, sx0, sx1) = \
                self._halo_region(k, *off)
            slab = state_b[..., sz0:sz1, sy0:sy1, sx0:sx1]
            slab = torch.cat([slab, slab.new_zeros(
                slab.shape[:-4] + (1,) + slab.shape[-3:])], dim=-4)
            out[..., z0:z1, y0:y1, x0:x1] = slab.index_select(
                slab.dim() - 4, table[:, oi])
        return out

    def memory_bytes(self, dtype_size: int = 1) -> int:
        """Block-level state bytes, the micro-fractal's holes included."""
        return self.n_blocks * self.rho ** 3 * dtype_size


@functools.lru_cache(maxsize=4)
def shared_layout3d(frac: f3.NBBFractal3D, r: int, m: int) -> BlockLayout3D:
    """One ``BlockLayout3D`` per (fractal, r, m) for every engine built by
    ``make_engine``, so engines of one configuration share its host tables
    and device copies; the last four configurations are kept."""
    return BlockLayout3D(frac, r, m)
