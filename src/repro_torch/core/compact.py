"""Compact-domain layout helpers and block-level Squeeze (paper Section 3.5).

Cell level: the compact state is a dense ``(rows, cols)`` tensor,
``rows = k^floor(r/2)``, ``cols = k^ceil(r/2)``; entry ``[cy, cx]`` is the
fractal cell with compact coordinate ``(cx, cy)``.

Block level: with ``rho = s**m`` the fractal is a level-``r_b`` fractal of
blocks (``r_b = r - m``); each block stores a rho x rho expanded
micro-fractal tile (the same occupancy ``micro_mask`` in every block).
Block state is ``(C?, n_blocks, rho, rho)`` with block id
``by * cols_b + bx``. Cross-block neighbor access goes through static block
tables built once on the host with vectorised numpy from the paper's maps
(one lambda per block, one nu per block and offset); each table is
uploaded once per device and cached on the layout (``device_table``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import maps
from repro_torch.core.fractals import NBBFractal
from repro_torch.workloads.base import MOORE_DIRS

#: window cells one v5 CTA holds (P slots of (rho+2k)^2 cells): 4 cells a
#: thread at 256 threads, and at most ~48 KB of shared memory for a
#: 2-channel f32 state with its two f32 work buffers
MXU_CELLS_PER_CTA = 1024


def halo_regions(rho: int, k: int):
    """The 8 (ys, xs) window slices of the depth-k halo frame, in
    MOORE_DIRS order (NW, N, NE, W, E, SW, S, SE)."""
    w = rho + 2 * k
    lo, mid, hi = slice(0, k), slice(k, k + rho), slice(k + rho, w)
    return ((lo, lo), (lo, mid), (lo, hi), (mid, lo), (mid, hi),
            (hi, lo), (hi, mid), (hi, hi))


def compact_meshgrid(frac: NBBFractal, r: int, device=None):
    """(cx, cy) int32 tensors of shape (rows, cols) covering the compact
    domain."""
    rows, cols = frac.compact_dims(r)
    cy, cx = torch.meshgrid(
        torch.arange(rows, dtype=torch.int32, device=device),
        torch.arange(cols, dtype=torch.int32, device=device), indexing="ij")
    return cx, cy


def compact_to_expanded(frac: NBBFractal, r: int, state_c: torch.Tensor):
    """Scatter a compact state into its (n, n) expanded embedding (holes
    0); leading channel axes pass through."""
    n = frac.side(r)
    cx, cy = compact_meshgrid(frac, r, state_c.device)
    ex, ey = maps.lambda_map(frac, r, cx, cy)
    out = state_c.new_zeros(state_c.shape[:-2] + (n, n))
    out[..., ey.long(), ex.long()] = state_c
    return out


def expanded_to_compact(frac: NBBFractal, r: int, state_e: torch.Tensor):
    """Gather an expanded state into compact form (fractal cells only)."""
    cx, cy = compact_meshgrid(frac, r, state_e.device)
    ex, ey = maps.lambda_map(frac, r, cx, cy)
    return state_e[..., ey.long(), ex.long()]


class LayoutTables:
    """The memo the 2D and 3D block layouts keep their depth-k host tables
    and device copies in (dies with the layout, so the runner's LRU can
    free it)."""

    @functools.cached_property
    def _cache(self) -> dict:
        return {}

    def _memo(self, key, build):
        cache = self._cache
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def device_table(self, name: str, device, *args) -> torch.Tensor:
        """The host table ``name`` (an attribute, or a method called with
        ``args``) uploaded once per device and cached on the layout."""
        device = torch.device(device)

        def build():
            host = getattr(self, name)
            host = host(*args) if callable(host) else host
            return torch.from_numpy(np.ascontiguousarray(host)).to(device)
        return self._memo(("device", name, args, str(device)), build)


@dataclasses.dataclass(frozen=True)
class BlockLayout(LayoutTables):
    """Static geometry of a block-level Squeeze decomposition."""

    frac: NBBFractal
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
    def block_dims(self) -> Tuple[int, int]:
        """(rows_b, cols_b) of the compact block domain."""
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
        """(rho, rho) uint8 occupancy of the level-m micro-fractal."""
        return self.frac.mask(self.m)

    @functools.cached_property
    def block_coords(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flat (n_blocks,) int32 compact block coordinates (bx, by)."""
        rows_b, cols_b = self.block_dims
        ids = np.arange(rows_b * cols_b, dtype=np.int64)
        return ((ids % cols_b).astype(np.int32),
                (ids // cols_b).astype(np.int32))

    @functools.cached_property
    def _block_origin_blocks(self) -> Tuple[np.ndarray, np.ndarray]:
        """Block-level expanded coordinates (ex, ey) of every block."""
        return maps.lambda_map(self.frac, self.r_b, *self.block_coords)

    @functools.cached_property
    def block_origin_expanded(self) -> np.ndarray:
        """(n_blocks, 2) int32 cell-level expanded origin (x, y)."""
        ex, ey = self._block_origin_blocks
        return np.stack([ex, ey], axis=1) * self.rho

    def _map_offsets_to_table(self, offsets) -> np.ndarray:
        """(n_blocks, len(offsets)) int32 compact block id per block offset;
        out-of-fractal blocks get the ``ghost`` sentinel."""
        ex, ey = self._block_origin_blocks
        _, cols_b = self.block_dims
        table = np.empty((self.n_blocks, len(offsets)), dtype=np.int32)
        for d, (dx, dy) in enumerate(offsets):
            cx, cy, valid = maps.nu_with_membership(
                self.frac, self.r_b, ex.astype(np.int64) + dx,
                ey.astype(np.int64) + dy)
            ids = cy.astype(np.int64) * cols_b + cx
            table[:, d] = np.where(valid, ids, self.ghost)
        return table

    @functools.cached_property
    def neighbor_table(self) -> np.ndarray:
        """(n_blocks, 8) int32 compact block id per Moore direction."""
        return self._map_offsets_to_table(MOORE_DIRS)

    @functools.cached_property
    def existence_table(self) -> np.ndarray:
        """(n_blocks, 8) int32 {0,1}: 1 where the Moore neighbor block is a
        real fractal block (``neighbor_table != ghost``)."""
        return (self.neighbor_table != self.ghost).astype(np.int32)

    # ---------------------------------------------------- depth-k halos
    def halo_block_radius(self, k: int) -> int:
        """Radius in blocks of the depth-``k`` cell halo."""
        if k < 1:
            raise ValueError(f"halo depth must be >= 1, got {k}")
        return math.ceil(k / self.rho)

    def halo_offsets(self, k: int) -> Tuple[Tuple[int, int], ...]:
        """Block offsets whose tiles meet the depth-``k`` window,
        raster-ordered; equals ``MOORE_DIRS`` when k <= rho."""
        kb = self.halo_block_radius(k)
        return tuple((dx, dy)
                     for dy in range(-kb, kb + 1)
                     for dx in range(-kb, kb + 1)
                     if (dx, dy) != (0, 0))

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

    def _halo_region(self, k: int, bdx: int, bdy: int):
        """((dy0, dy1, dx0, dx1) in the window, (sy0, sy1, sx0, sx1) in the
        neighbor tile) of the overlap of the tile at block offset (bdx,
        bdy) with the (rho+2k)^2 window."""
        rho = self.rho
        w = rho + 2 * k
        x0, y0 = k + bdx * rho, k + bdy * rho
        dx0, dx1 = max(x0, 0), min(x0 + rho, w)
        dy0, dy1 = max(y0, 0), min(y0 + rho, w)
        return (dy0, dy1, dx0, dx1), (dy0 - y0, dy1 - y0, dx0 - x0, dx1 - x0)

    def window_mask(self, k: int) -> np.ndarray:
        """(rho+2k, rho+2k) uint8 periodic extension of ``micro_mask``: the
        window occupancy before ghost gating."""
        def build():
            idx = np.arange(-k, self.rho + k) % self.rho
            return self.micro_mask[np.ix_(idx, idx)]
        return self._memo(("window_mask", k), build)

    def halo_mask(self, k: int) -> np.ndarray:
        """(n_blocks, rho+2k, rho+2k) uint8 occupancy of each block's
        depth-``k`` window: ``window_mask`` with the regions of ghost
        neighbor blocks zeroed."""
        def build():
            w = self.rho + 2 * k
            table = self.offset_table(k)
            full = np.broadcast_to(self.window_mask(k),
                                   (self.n_blocks, w, w)).copy()
            for oi, (bdx, bdy) in enumerate(self.halo_offsets(k)):
                (dy0, dy1, dx0, dx1), _ = self._halo_region(k, bdx, bdy)
                full[table[:, oi] == self.ghost, dy0:dy1, dx0:dx1] = 0
            return full
        return self._memo(("halo_mask", k), build)

    # ----------------------------------------------- v5 macro-tile packing
    def macro_tiles(self, k: int, p: Optional[int] = None
                    ) -> Tuple[int, int, int]:
        """``(P, n_macro, nb_pad)`` of the v5 kernel: P compact blocks (each
        a (rho+2k)^2 slot) per CTA, ``n_macro = ceil(n_blocks / P)`` CTAs
        per simulation, ``nb_pad = n_macro * P``. The default P fills
        ``MXU_CELLS_PER_CTA`` window cells and is then rebalanced down to
        ``ceil(n_blocks / n_macro)`` (fewer padding slots, same CTA count);
        an explicit ``p`` is taken as is (clamped to [1, n_blocks])."""
        return self.macro_tiles_for(self.n_blocks, k, p)

    def macro_tiles_for(self, nb: int, k: int, p: Optional[int] = None
                        ) -> Tuple[int, int, int]:
        """``macro_tiles`` for any block count ``nb``: the distributed
        engine packs each shard's local blocks into their own CTAs."""
        if k < 1:
            raise ValueError(f"halo depth must be >= 1, got {k}")
        if p is not None:
            if p < 1:
                raise ValueError(f"macro-tile packing must be >= 1, got {p}")
            p = min(p, nb)
            n_macro = -(-nb // p)
            return p, n_macro, n_macro * p
        w = self.rho + 2 * k
        p = max(1, min(MXU_CELLS_PER_CTA // (w * w), nb))
        n_macro = -(-nb // p)
        p = -(-nb // n_macro)
        return p, n_macro, n_macro * p

    # ------------------------------------------- depth-k exchange strips
    # The distributed engine ships edge bands, never whole blocks: per
    # block the top/bottom k rows and the west/east k columns (transposed,
    # so all four stack to (4, k, rho)). The corners of a depth-k halo are
    # sub-slices of the top/bottom bands (k <= rho).
    def pack_edge_strips(self, state: torch.Tensor, k: int) -> torch.Tensor:
        """(L, nb, rho, rho) -> (L, nb, 4, k, rho) edge bands: 0 the top k
        rows, 1 the bottom k rows, 2 the west k columns and 3 the east k
        columns (both transposed)."""
        rho = self.rho
        if not 1 <= k <= rho:
            raise ValueError(f"need 1 <= k <= rho={rho}, got k={k}")
        return torch.stack([state[..., :k, :], state[..., rho - k:, :],
                            state[..., :k].transpose(-1, -2),
                            state[..., rho - k:].transpose(-1, -2)], dim=-3)

    def halo_from_strips_k(self, strips: torch.Tensor, table: torch.Tensor,
                           k: int):
        """Depth-``k`` halo pieces from packed edge strips: ``strips`` (L,
        ns, 4, k, rho) over any superset of blocks (with a zero row the
        ghosts of ``table`` point at), ``table`` (nb_sel, 8) int row
        indices per Moore direction. Returns ``(top, bot, west, east)``:
        top/bot (L, nb_sel, k, rho+2k) with the diagonal corners,
        west/east (L, nb_sel, rho, k)."""
        rho = self.rho

        def band(d, row, cols=slice(None)):  # (L, nb_sel, k, |cols|)
            return strips[:, :, row, :, cols].index_select(1, table[:, d])

        # MOORE_DIRS order: NW 0, N 1, NE 2, W 3, E 4, SW 5, S 6, SE 7
        top = torch.cat([band(0, 1, slice(rho - k, None)), band(1, 1),
                         band(2, 1, slice(None, k))], dim=-1)
        bot = torch.cat([band(5, 0, slice(rho - k, None)), band(6, 0),
                         band(7, 0, slice(None, k))], dim=-1)
        west = band(3, 3).transpose(-1, -2)   # W neighbor's east columns
        east = band(4, 2).transpose(-1, -2)   # E neighbor's west columns
        return top, bot, west, east

    def strip_decomposition(self, n_shards: int) -> "StripDecomposition":
        """The expanded-row strip decomposition over ``n_shards`` shards
        (one build per shard count; see ``StripDecomposition``)."""
        return self._memo(("strip_decomposition", n_shards),
                          lambda: StripDecomposition(self, n_shards))

    def existence_padded(self, k: int, p: Optional[int] = None
                         ) -> np.ndarray:
        """(nb_pad, 8) int32 ``existence_table`` zero-padded to the v5 slot
        count: padding slots have no real neighbors."""
        def build():
            _, _, nb_pad = self.macro_tiles(k, p=p)
            pad = np.zeros((nb_pad - self.n_blocks, 8), np.int32)
            return np.concatenate([self.existence_table, pad], axis=0)
        return self._memo(("existence_padded", k, p), build)

    # ------------------------------------------------------ conversions
    def _cell_coords(self, device):
        """(ay, ax) int64 (n_blocks, rho, rho) expanded coordinates of
        every block cell."""
        org = self.device_table("block_origin_expanded", device).long()
        ar = torch.arange(self.rho, device=device)
        ax = org[:, 0, None, None] + ar[None, None, :]
        ay = org[:, 1, None, None] + ar[None, :, None]
        return ay, ax

    def to_expanded(self, state_b: torch.Tensor) -> torch.Tensor:
        """(..., n_blocks, rho, rho) block state -> (..., n, n) expanded
        embedding."""
        n = self.frac.side(self.r)
        ay, ax = self._cell_coords(state_b.device)
        out = state_b.new_zeros(state_b.shape[:-3] + (n, n))
        out[..., ay, ax] = state_b
        return out

    def from_expanded(self, state_e: torch.Tensor) -> torch.Tensor:
        """(..., n, n) expanded embedding -> (..., n_blocks, rho, rho)."""
        ay, ax = self._cell_coords(state_e.device)
        mask = self.device_table("micro_mask", state_e.device)
        return state_e[..., ay, ax] * mask.to(state_e.dtype)

    def pad_with_halo(self, state_b: torch.Tensor) -> torch.Tensor:
        """(..., n_blocks, rho+2, rho+2) tiles with Moore halos."""
        return self.pad_with_halo_k(state_b, 1)

    def pad_with_halo_k(self, state_b: torch.Tensor, k: int) -> torch.Tensor:
        """(..., n_blocks, rho+2k, rho+2k) tiles with depth-``k`` halos: per
        block offset only the overlap strip of the neighbor tile is
        gathered through ``offset_table(k)``; ghost ids index an appended
        zero strip, so out-of-fractal reads are zero at every depth."""
        if k < 1:
            raise ValueError(f"halo depth must be >= 1, got {k}")
        rho, nb = self.rho, self.n_blocks
        w = rho + 2 * k
        table = self.device_table("offset_table", state_b.device, k).long()
        out = state_b.new_zeros(state_b.shape[:-2] + (w, w))
        out[..., k:k + rho, k:k + rho] = state_b
        for oi, (bdx, bdy) in enumerate(self.halo_offsets(k)):
            (dy0, dy1, dx0, dx1), (sy0, sy1, sx0, sx1) = \
                self._halo_region(k, bdx, bdy)
            strip = state_b[..., sy0:sy1, sx0:sx1]
            strip = torch.cat([strip, strip.new_zeros(
                strip.shape[:-3] + (1,) + strip.shape[-2:])], dim=-3)
            out[..., dy0:dy1, dx0:dx1] = strip.index_select(
                strip.dim() - 3, table[:, oi])
        return out

    def memory_bytes(self, dtype_size: int = 1) -> int:
        """Squeeze block-level state bytes (paper Table 2's nu column)."""
        return self.n_blocks * self.rho * self.rho * dtype_size


def _balanced_contiguous_partition(counts: np.ndarray, n_groups: int
                                   ) -> list:
    """Split ``counts`` into ``n_groups`` contiguous nonempty groups with
    the least largest sum (binary search on the capacity, greedy fill);
    returns the half-open ranges [(a0, b0), ...]. A loop over rows, not
    blocks."""
    n = len(counts)
    if n < n_groups:
        raise ValueError(f"cannot split {n} rows into {n_groups} nonempty "
                         "groups")
    counts = [int(c) for c in counts]

    def bounds_for(cap):
        """Greedy fill under ``cap``, leaving enough rows for the groups
        still to come; None when infeasible."""
        out, start, acc, g = [], 0, 0, n_groups
        for i, c in enumerate(counts):
            if i > start and (acc + c > cap or n - i == g - 1):
                out.append((start, i))
                start, acc, g = i, 0, g - 1
            acc += c
            if acc > cap and i > start:
                return None
        out.append((start, n))
        return out if len(out) == n_groups and acc <= cap else None

    lo, hi = max(counts), sum(counts)
    while lo < hi:
        mid = (lo + hi) // 2
        if bounds_for(mid) is None:
            lo = mid + 1
        else:
            hi = mid
    return bounds_for(lo)


def _sorted_by_shard(shard: np.ndarray, local: np.ndarray, n_shards: int,
                     nbl: int):
    """The distinct (shard, local) pairs, sorted, as one sorted key array
    and the start of each shard's run in it."""
    keys = np.unique(shard.astype(np.int64) * (nbl + 1) + local)
    starts = np.searchsorted(keys, np.arange(n_shards + 1,
                                             dtype=np.int64) * (nbl + 1))
    return keys, starts


@dataclasses.dataclass(frozen=True)
class StripDecomposition:
    """Block -> shard assignment by expanded-space block rows.

    Blocks are ordered by their expanded block row ``ey`` (then ``ex``),
    and each shard owns a contiguous range of whole occupied rows,
    balanced by block count. Rows are never split, so every Moore neighbor
    of a block lives on its own shard or on one of the two next to it:
    the exchange is two neighbor shifts of the strips each neighbor needs.
    ``valid`` is False when there are fewer occupied rows than shards (the
    engine then falls back to the gather exchange).

    Native layout: shard ``s`` owns rows ``[s*nb_local, (s+1)*nb_local)``,
    its real blocks first (row-major), then dead padding. ``perm[i]`` is
    the compact id of native row ``i`` (-1 when dead).

    Routing (``nb_local`` = nbl is the zero-strip sentinel everywhere):

    * ``send_prev_idx`` / ``send_next_idx`` (n_shards, ms_prev/ms_next):
      the local blocks whose edge bands the prev/next shard needs, sorted;
    * ``table`` (n_shards, nbl, 8): each local block's Moore neighbors in
      combined strip coordinates -- [0, nbl) local, nbl the zero row,
      [nbl+1, nbl+1+ms_next) received from the prev shard (its send_next
      buffer), then ms_prev slots received from the next shard;
    * ``interior_idx`` / ``boundary_idx``: the local slots whose halo is
      all local, and those that read a received strip.

    Every table equals the reference's bit for bit; it is built with
    vectorised numpy (one sort and a few ``unique``/``searchsorted``
    passes), not a loop over blocks.
    """

    layout: BlockLayout
    n_shards: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"need n_shards >= 1, got {self.n_shards}")
        self._build()

    def _set(self, **kw):
        for name, val in kw.items():
            object.__setattr__(self, name, val)

    def _build(self) -> None:
        layout, ns = self.layout, self.n_shards
        nb, rho = layout.n_blocks, layout.rho
        org = layout.block_origin_expanded
        ex, ey = org[:, 0] // rho, org[:, 1] // rho
        rows, row_of, counts = np.unique(ey, return_inverse=True,
                                         return_counts=True)
        if len(rows) < ns:
            self._set(valid=False, nb_local=0, nb_padded=0, perm=None,
                      shard_of=None, local_of=None)
            return
        bounds = _balanced_contiguous_partition(counts, ns)
        row_shard = np.repeat(np.arange(ns, dtype=np.int32),
                              [b - a for a, b in bounds])
        shard_of = row_shard[row_of.reshape(-1)]
        nbl = int(max(counts[a:b].sum() for a, b in bounds))
        order = np.lexsort((ex, ey))          # row-major, shard by shard
        first = np.searchsorted(shard_of[order], np.arange(ns))
        local_of = np.empty(nb, np.int32)
        local_of[order] = np.arange(nb) - first[shard_of[order]]
        perm = np.full(ns * nbl, -1, np.int32)
        perm[shard_of.astype(np.int64) * nbl + local_of] = \
            np.arange(nb, dtype=np.int32)
        self._set(valid=True, nb_local=nbl, nb_padded=ns * nbl, perm=perm,
                  shard_of=shard_of, local_of=local_of)
        self._build_routing()

    def _build_routing(self) -> None:
        layout, nbl, ns = self.layout, self.nb_local, self.n_shards
        nbr = layout.neighbor_table
        g, d = np.nonzero(nbr != layout.ghost)   # every real (block, dir)
        ng = nbr[g, d]
        s, so = self.shard_of[g], self.shard_of[ng]
        li, lo = self.local_of[g], self.local_of[ng]
        delta = so.astype(np.int64) - s
        if np.abs(delta).max(initial=0) > 1:
            bad = int(np.flatnonzero(np.abs(delta) > 1)[0])
            raise AssertionError(
                f"strip decomposition broke: blocks {g[bad]}->{ng[bad]} "
                f"span shards {s[bad]}->{so[bad]}")
        # a strip read from shard s+1 is in s+1's send_prev list, one
        # read from s-1 in s-1's send_next list
        up, down = delta == 1, delta == -1
        prev_keys, prev_at = _sorted_by_shard(so[up], lo[up], ns, nbl)
        next_keys, next_at = _sorted_by_shard(so[down], lo[down], ns, nbl)
        n_prev, n_next = np.diff(prev_at), np.diff(next_at)
        ms_prev = max(1, int(n_prev.max()))
        ms_next = max(1, int(n_next.max()))

        def pad(keys, at, width):
            out = np.full((ns, width), nbl, np.int32)
            for sh in range(ns):
                run = keys[at[sh]:at[sh + 1]] - sh * (nbl + 1)
                out[sh, :len(run)] = run
            return out

        def slot(keys, at, shard, local):
            key = shard.astype(np.int64) * (nbl + 1) + local
            return np.searchsorted(keys, key) - at[shard]

        table = np.full((ns, nbl, 8), nbl, np.int32)
        col = np.where(delta == 0, lo, 0).astype(np.int64)
        col[down] = nbl + 1 + slot(next_keys, next_at, so[down], lo[down])
        col[up] = nbl + 1 + ms_next + slot(prev_keys, prev_at, so[up],
                                           lo[up])
        table[s, li, d] = col
        remote = np.zeros((ns, nbl), bool)
        remote[s[delta != 0], li[delta != 0]] = True
        interior = [np.flatnonzero(~remote[sh]) for sh in range(ns)]
        boundary = [np.flatnonzero(remote[sh]) for sh in range(ns)]

        def pad_lists(lists):
            out = np.full((ns, max(1, max(len(x) for x in lists))), nbl,
                          np.int32)
            for sh, x in enumerate(lists):
                out[sh, :len(x)] = x
            return out

        self._set(
            ms_prev=ms_prev, ms_next=ms_next,
            send_prev_idx=pad(prev_keys, prev_at, ms_prev),
            send_next_idx=pad(next_keys, next_at, ms_next),
            table=table,
            interior_idx=pad_lists(interior),
            boundary_idx=pad_lists(boundary),
            n_interior=np.array([len(x) for x in interior], np.int32),
            n_boundary=np.array([len(x) for x in boundary], np.int32),
            real_sends=int((n_next[:ns - 1] > 0).sum()
                           + (n_prev[1:] > 0).sum()))

    def pack_edge_strips_for(self, strips_z: torch.Tensor, neighbor: str,
                             shard: int = 0) -> torch.Tensor:
        """The send buffer of ``shard`` for its 'prev' or 'next' neighbor
        out of its zero-row-appended strips (L, nb_local+1, 4, k, rho)."""
        idx = (self.send_prev_idx if neighbor == "prev"
               else self.send_next_idx)[shard]
        return strips_z.index_select(
            1, torch.from_numpy(idx).to(strips_z.device))

    def slot_bytes(self, k: int, itemsize: int) -> int:
        """Bytes of one strip slot: the four depth-k bands of one block."""
        return 4 * k * self.layout.rho * itemsize

    def wire_bytes_per_exchange(self, k: int, itemsize: int,
                                batch: int = 1) -> int:
        """Bytes one depth-k p2p exchange moves between all adjacent shard
        pairs (both shifts, with their padded buffers)."""
        slots = (self.ms_prev + self.ms_next) * (self.n_shards - 1)
        return batch * slots * self.slot_bytes(k, itemsize)

    def wire_bytes_per_device_per_exchange(self, k: int, itemsize: int,
                                           batch: int = 1) -> int:
        """Bytes an interior shard receives per exchange: flat in the
        shard count."""
        return (batch * (self.ms_prev + self.ms_next)
                * self.slot_bytes(k, itemsize))


@functools.lru_cache(maxsize=4)
def shared_layout(frac: NBBFractal, r: int, m: int) -> BlockLayout:
    """One ``BlockLayout`` per (fractal, r, m) for every engine built by
    ``make_engine``, so engines of one configuration share its host tables
    and device copies (at the paper's r=16 the neighbor table alone is
    153 MB); the last four configurations are kept."""
    return BlockLayout(frac, r, m)
