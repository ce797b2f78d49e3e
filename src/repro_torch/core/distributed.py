"""Block-level Squeeze sharded over several devices: the strip halo exchange
and the shard-local v4 and v5 kernels (kinds 'dist-block', 'dist-fused'
and 'dist-mxu').

One process drives every shard, as the reference's single controller drives
every shard of its mesh. A shard is one contiguous tensor ``(B?, C?,
nb_local, rho, rho)`` on its own ``torch.device``, and the engine's state is
the plain tuple of them -- the counterpart of a block-sharded ``jax.Array``,
whose addressable shards are exactly these. A device may repeat: on one
card every shard sits on ``cuda:0`` and the exchange is on-device copies; on
several cards the shards spread over them and the exchange is peer copies;
on the CPU every shard is a CPU tensor.

One fused launch advances ``k`` exact steps with one exchange of edge
strips (``BlockLayout.pack_edge_strips``: the top/bottom k rows and
west/east k columns of each block, never the state itself):

``'p2p'`` (what ``'auto'`` picks when the decomposition is valid) -- the
``StripDecomposition`` gives each shard a contiguous range of expanded block
rows, so a block's Moore neighbors live on its own shard or the two next to
it. Each shard packs its strips, the two neighbor transfers start on a side
stream, and the whole local domain is computed from local strips only (the
interior-view table sends every remote read to the zero row) while they are
in flight. Then the boundary blocks are recomputed from the local and
received strips and patched in (compute-all-then-patch).

``'gather'`` -- every shard's strips are gathered into one replicated
buffer on each device, and every shard runs its blocks from it. It needs no
decomposition, so it covers meshes with fewer occupied rows than shards.

Compute backends: ``'jnp'`` the plain PyTorch window path under the halo
mask (the reference's XLA path), ``'fused'`` the shard-local v4 kernel,
``'mxu'`` the shard-local v5 kernel. The kernels gate each halo region by
the block's existence row and keep the periodic center mask, so their
result is multiplied by the center of the halo mask, which is zero for the
padding blocks (without it Gray-Scott's feed term would raise a dead
block's U from zero).

``run(state, steps)`` takes floor(steps/k) launches of depth k plus one
remainder launch of depth steps % k, between two engine-owned buffers; the
input is never written.
``exchange_stats()`` accounts every launch as the reference does, and
``transfer_counts()`` counts the transfers the engine issued: one strip
gather per gather launch; two neighbor shifts per p2p launch, each one send
per adjacent shard pair.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compact import BlockLayout, StripDecomposition
from repro_torch.core.device import resolve_device
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.tuning.spec import EXCHANGES
from repro_torch.workloads.base import StencilWorkload, check_workload_ndim
from repro_torch.workloads.rules import LIFE

#: shard-local compute backends: the plain window path, the v4 kernel, the
#: v5 kernel
COMPUTES = ("jnp", "fused", "mxu")

State = Tuple[torch.Tensor, ...]


def shard_devices(n_shards: Optional[int] = None, device=None
                  ) -> Tuple[torch.device, ...]:
    """One device per shard. ``device=None`` is the card (raising without
    CUDA). On ``cuda`` without an index the shards go round the visible
    cards, one shard per card by default; a device with an index, or the
    CPU, holds every shard (one by default)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        n = count if n_shards is None else n_shards
        devices = tuple(torch.device("cuda", i % count) for i in range(n))
    else:
        devices = (dev,) * (1 if n_shards is None else n_shards)
    if not devices:
        raise ValueError(f"need n_shards >= 1, got {n_shards}")
    return devices


@dataclasses.dataclass
class ExchangeStats:
    """Halo-exchange accounting: every launch issues one exchange, a strip
    gather on the gather path, two neighbor shifts on the p2p path."""

    steps: int = 0            # simulated steps advanced
    collectives: int = 0      # halo exchanges issued (one per launch)
    bytes_gathered: int = 0   # replicated strip-buffer bytes (gather)
    bytes_permuted: int = 0   # neighbor strip bytes moved (p2p)
    neighbor_sends: int = 0   # directed shard -> shard strip sends (p2p)

    @property
    def exchanged_bytes(self) -> int:
        return self.bytes_gathered + self.bytes_permuted

    @property
    def collectives_per_step(self) -> float:
        return self.collectives / max(self.steps, 1)

    @property
    def bytes_per_step(self) -> float:
        return self.exchanged_bytes / max(self.steps, 1)


@dataclasses.dataclass(frozen=True)
class DistributedSqueezeEngine:
    """Block-level Squeeze over ``len(devices)`` shards (see the module
    docstring). ``fusion_k`` is the launch depth of ``run`` (None = the
    single-device heuristic), at most rho; ``macro_p`` the v5 slots per
    CTA ('mxu' only; None = the per-shard default)."""

    layout: BlockLayout
    devices: Tuple[torch.device, ...]
    workload: StencilWorkload = LIFE
    compute: str = "jnp"
    fusion_k: Optional[int] = None
    exchange: str = "auto"
    macro_p: Optional[int] = None

    def __post_init__(self):
        if self.compute not in COMPUTES:
            raise ValueError(f"unknown compute {self.compute!r}; have "
                             f"{COMPUTES}")
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; have "
                             f"{EXCHANGES}")
        check_workload_ndim(self.workload, 2)
        if not self.devices:
            raise ValueError("need at least one shard device")
        object.__setattr__(self, "devices",
                           tuple(torch.device(d) for d in self.devices))
        if self.fusion_k is not None and not (
                1 <= self.fusion_k <= self.layout.rho):
            raise ValueError(
                f"distributed fusion_k must be in [1, rho="
                f"{self.layout.rho}], got {self.fusion_k} (the strip "
                "exchange covers one block ring)")
        if self.macro_p is not None and self.compute != "mxu":
            raise ValueError("macro_p only applies to the 'mxu' compute, "
                             f"got compute={self.compute!r}")
        if self.exchange == "p2p" and not self.decomp.valid:
            raise ValueError(
                f"exchange='p2p' needs >= {self.n_shards} occupied "
                "expanded block rows (the strip decomposition is "
                "degenerate on this mesh); use exchange='auto' or 'gather'")
        object.__setattr__(self, "_stats", ExchangeStats())
        object.__setattr__(self, "_transfers", dict.fromkeys(
            ("all_gather", "permute", "send"), 0))

    # ------------------------------------------------------------ geometry
    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first shard's device (states are assembled there)."""
        return self.devices[0]

    @functools.cached_property
    def decomp(self) -> StripDecomposition:
        return self.layout.strip_decomposition(self.n_shards)

    @functools.cached_property
    def exchange_mode(self) -> str:
        """The resolved exchange: 'auto' is p2p when the decomposition is
        valid, else gather."""
        if self.exchange != "auto":
            return self.exchange
        return "p2p" if self.decomp.valid else "gather"

    @property
    def nb_padded(self) -> int:
        if self.exchange_mode == "p2p":
            return self.decomp.nb_padded
        ns = self.n_shards
        return -(-self.layout.n_blocks // ns) * ns

    @property
    def nb_local(self) -> int:
        return self.nb_padded // self.n_shards

    @property
    def effective_fusion_k(self) -> int:
        if self.fusion_k is not None:
            return self.fusion_k
        from repro_torch.core.stencil import default_fusion_k
        return default_fusion_k(self.layout.rho)

    # ----------------------------------------------------------- accounting
    @property
    def _itemsize(self) -> int:
        return torch.empty((), dtype=self.workload.dtype).element_size()

    def strip_bytes(self, k: int, batch: int = 1) -> int:
        """Bytes of the replicated strip buffer of one depth-k gather."""
        return (batch * self.workload.n_channels * self.nb_padded
                * 4 * k * self.layout.rho * self._itemsize)

    def permute_bytes(self, k: int, batch: int = 1) -> int:
        """Bytes one depth-k p2p exchange moves (both shifts, every
        adjacent shard pair)."""
        return self.decomp.wire_bytes_per_exchange(
            k, self._itemsize, batch * self.workload.n_channels)

    def wire_bytes_per_device(self, k: int, batch: int = 1) -> int:
        """Bytes one shard receives per depth-k exchange: flat in the shard
        count on the p2p path, everyone else's strips on the gather
        path."""
        if self.exchange_mode == "p2p":
            return self.decomp.wire_bytes_per_device_per_exchange(
                k, self._itemsize, batch * self.workload.n_channels)
        return (batch * self.workload.n_channels
                * (self.nb_padded - self.nb_local)
                * 4 * k * self.layout.rho * self._itemsize)

    def exchange_stats(self) -> ExchangeStats:
        return dataclasses.replace(self._stats)

    def transfer_counts(self) -> Dict[str, int]:
        """Transfers issued: strip gathers, neighbor shifts and the
        shard -> shard sends of those shifts."""
        return dict(self._transfers)

    def reset_exchange_stats(self) -> None:
        object.__setattr__(self, "_stats", ExchangeStats())
        for key in self._transfers:
            self._transfers[key] = 0

    def _account(self, k: int, batch: int) -> None:
        st = self._stats
        if self.exchange_mode == "p2p":
            gathered = 0
            permuted = self.permute_bytes(k, batch)
            sends = 2 * (self.n_shards - 1)
        else:
            gathered = self.strip_bytes(k, batch)
            permuted = sends = 0
        st.bytes_gathered += gathered
        st.bytes_permuted += permuted
        st.neighbor_sends += sends
        st.steps += k
        st.collectives += 1
        if obs.enabled():
            # the same accounting on the telemetry registry, labeled by
            # the compute backend
            obs.inc("dist.steps", k, compute=self.compute)
            obs.inc("dist.collectives", compute=self.compute)
            obs.inc("dist.bytes_gathered", gathered, compute=self.compute)
            obs.inc("dist.bytes_permuted", permuted, compute=self.compute)
            obs.inc("dist.neighbor_sends", sends, compute=self.compute)
            obs.inc("engine.fused_launches", engine=type(self).__name__,
                    variant=self.compute)

    def memory_bytes(self, dtype_size: Optional[int] = None) -> int:
        """All shards' state bytes, padding blocks included."""
        if dtype_size is None:
            dtype_size = self._itemsize
        return (self.workload.n_channels * self.nb_padded
                * self.layout.rho ** 2 * dtype_size)

    # ------------------------------------------------------------ state I/O
    @functools.cached_property
    def _native_src(self) -> np.ndarray:
        """(nb_padded,) compact block id of each native row; dead rows
        point at the appended zero block (id n_blocks)."""
        nb = self.layout.n_blocks
        if self.exchange_mode == "p2p":
            perm = self.decomp.perm
            return np.where(perm >= 0, perm, nb).astype(np.int64)
        return np.minimum(np.arange(self.nb_padded), nb)

    @functools.cached_property
    def _dense_src(self) -> np.ndarray:
        """(n_blocks,) native row of each compact block id."""
        nb = self.layout.n_blocks
        if self.exchange_mode == "p2p":
            d = self.decomp
            return d.shard_of.astype(np.int64) * d.nb_local + d.local_of
        return np.arange(nb)

    def _index(self, host: np.ndarray, device) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(host)).to(device)

    def from_dense(self, dense) -> State:
        """(B?, C?, n_blocks, rho, rho) compact-order state (tensor or
        numpy) -> the engine's shards, in native order with the padding
        blocks zero, each on its device."""
        if not isinstance(dense, torch.Tensor):
            dense = torch.from_numpy(np.ascontiguousarray(dense))
        dense = dense.to(self.device, self.workload.dtype)
        zero = dense.new_zeros(dense.shape[:-3] + (1,) + dense.shape[-2:])
        dense_z = torch.cat([dense, zero], dim=-3)
        nbl = self.nb_local
        return tuple(
            dense_z.index_select(-3, self._index(
                self._native_src[s * nbl:(s + 1) * nbl], self.device))
            .to(dev).contiguous()
            for s, dev in enumerate(self.devices))

    def to_dense(self, state: State) -> torch.Tensor:
        """The shards -> the (B?, C?, n_blocks, rho, rho) compact-order
        state on the first shard's device."""
        native = torch.cat([s.to(self.device) for s in state], dim=-3)
        return native.index_select(-3, self._index(self._dense_src,
                                                   self.device))

    def init_random(self, seed: int) -> State:
        """The single-device engines' initial state of ``seed``, sharded."""
        from repro_torch.core.stencil import SqueezeBlockEngine
        eng = SqueezeBlockEngine(self.layout, self.workload,
                                 device=self.device)
        return self.from_dense(eng.init_random(seed))

    def init_batch(self, seeds: Sequence[int]) -> State:
        """(B, C?, nb_local, rho, rho) shards of B initial states."""
        from repro_torch.core.stencil import SqueezeBlockEngine
        eng = SqueezeBlockEngine(self.layout, self.workload,
                                 device=self.device)
        return self.from_dense(torch.stack([eng.init_random(int(s))
                                            for s in seeds]))

    def dead_mask(self) -> np.ndarray:
        """(nb_padded, rho, rho) uint8 in native order: 1 where every valid
        state is zero (holes of real blocks, every cell of a padding
        block)."""
        lay = self.layout
        hole = (1 - lay.micro_mask).astype(np.uint8)
        dead = np.concatenate(
            [np.broadcast_to(hole, (lay.n_blocks,) + hole.shape),
             np.ones((1,) + hole.shape, np.uint8)], axis=0)
        return np.ascontiguousarray(dead[self._native_src])

    def to_expanded(self, state: State) -> torch.Tensor:
        """(B?, C?, n, n) expanded embedding."""
        return self.layout.to_expanded(self.to_dense(state))

    # ------------------------------------------------ canonical 5D states
    def _canon(self, state: State) -> Tuple[State, bool]:
        """The shards viewed as (B, C, nb_local, rho, rho), and whether
        they had a batch axis."""
        if len(state) != self.n_shards:
            raise ValueError(f"state has {len(state)} shards, the engine "
                             f"{self.n_shards}")
        chan = self.workload.n_channels > 1
        base = 4 if chan else 3
        want = (self.nb_local, self.layout.rho, self.layout.rho)
        ndim = state[0].dim()
        if ndim not in (base, base + 1):
            raise ValueError(
                f"bad state rank {ndim} for workload "
                f"{self.workload.name!r} (expected {base} or {base + 1})")
        for s, dev in zip(state, self.devices):
            if s.dim() != ndim or tuple(s.shape[-3:]) != want or \
                    s.device != dev or s.dtype != self.workload.dtype:
                raise ValueError(
                    f"a shard must be a {self.workload.dtype} tensor of "
                    f"trailing shape {want} on its device {dev}, got "
                    f"{tuple(s.shape)} {s.dtype} on {s.device}")
        batched = ndim == base + 1
        if not batched:
            state = tuple(s[None] for s in state)
        return tuple(s if chan else s[:, None] for s in state), batched

    def _uncanon(self, s5: State, batched: bool) -> State:
        chan = self.workload.n_channels > 1
        return tuple((s if chan else s[:, 0]) if batched
                     else (s[0] if chan else s[0, 0]) for s in s5)

    # -------------------------------------------------- per-shard operands
    @functools.cached_property
    def _cache(self) -> dict:
        return {}

    def _operands(self, k: int):
        """Per shard, on its device, the static operands of a depth-k
        launch, built once. Both modes: ``center`` (n, rho, rho) the center
        of the halo mask (micro_mask, zero for padding blocks),
        ``existence`` (n, 8) int32 and, for the 'jnp' compute, ``mask`` (n,
        w, w) the halo mask with zero rows for padding blocks. Gather:
        ``table`` (nbl, 8) strip rows of the replicated buffer (ghosts ->
        its zero row nb_padded). P2p: ``table_int`` (nbl, 8), the
        interior-view table (every remote read -> the zero row nbl), and
        for the boundary pass the rows ``bnd_*`` of the padded boundary
        list (sentinel rows all dead), ``bnd_src`` the clamped rows to read
        and ``bnd_dst`` the real rows to patch; ``send_prev``/``send_next``
        the rows each neighbor needs."""
        key = ("operands", self.exchange_mode, k)
        if key in self._cache:
            return self._cache[key]
        lay, nbl, nb = self.layout, self.nb_local, self.layout.n_blocks
        src = self._native_src
        alive = np.append(np.ones(nb, np.uint8), np.uint8(0))[src]
        center = alive[:, None, None] * lay.micro_mask[None]
        existence = np.concatenate(
            [lay.existence_table, np.zeros((1, 8), np.int32)])[src]
        mask = None
        if self.compute == "jnp":
            w = lay.rho + 2 * k
            mask = np.concatenate([lay.halo_mask(k),
                                   np.zeros((1, w, w), np.uint8)])[src]
        if self.exchange_mode == "p2p":
            d = self.decomp
            table = d.table.reshape(self.nb_padded, 8)
        else:
            table = np.concatenate(
                [lay.neighbor_table,
                 np.full((self.nb_padded - nb, 8), lay.ghost, np.int32)])
            table = np.where(table == lay.ghost, np.int32(self.nb_padded),
                             table)
        ops = []
        for s, dev in enumerate(self.devices):
            rows = slice(s * nbl, (s + 1) * nbl)
            host = dict(center=center[rows], existence=existence[rows])
            if mask is not None:
                host["mask"] = mask[rows]
            if self.exchange_mode == "p2p":
                bi = d.boundary_idx[s]
                n_bnd = int(d.n_boundary[s])
                # the sentinel row nbl: dead, its table at the zero row
                for name in [n for n in ("center", "existence", "mask")
                             if n in host]:
                    ext = np.concatenate([host[name],
                                          np.zeros_like(host[name][:1])])
                    host["bnd_" + name] = ext[bi]
                table_z = np.concatenate([table[rows],
                                          np.full((1, 8), nbl, np.int32)])
                host.update(
                    table_int=np.minimum(table[rows], np.int32(nbl)),
                    bnd_table=table_z[bi],
                    bnd_src=np.minimum(bi, nbl - 1).astype(np.int64),
                    bnd_dst=bi[:n_bnd].astype(np.int64),
                    send_prev=d.send_prev_idx[s].astype(np.int64),
                    send_next=d.send_next_idx[s].astype(np.int64))
            else:
                host["table"] = table[rows]
            ops.append({n: self._index(v, dev) for n, v in host.items()})
        self._cache[key] = ops
        return ops

    # --------------------------------------------------- shard-local compute
    def _compute_k(self, s5: torch.Tensor, halo, ops: dict, prefix: str,
                   k: int, out: Optional[torch.Tensor]) -> torch.Tensor:
        """k substeps of one set of blocks: ``s5`` (B, C, n, rho, rho),
        ``halo`` its pieces, the operands ``ops[prefix + name]``."""
        existence = ops[prefix + "existence"]
        if self.compute == "jnp":
            wl, mask = self.workload, ops[prefix + "mask"]
            res = sk.per_simulation(wl, lambda x: wl.tile_rule_k(
                x, mask, k), sk.window_from_pieces(s5, halo)).to(s5.dtype)
            return res if out is None else out.copy_(res)
        if self.compute == "mxu":
            res = sk.stencil_step_mxu_k_local(
                self.layout, s5, halo, existence, self.workload, k=k,
                p=self.macro_p, out=out)
        else:
            res = sk.stencil_step_fused_k_local(
                self.layout, s5, halo, existence, self.workload, k=k,
                out=out)
        # keeps padding blocks dead: their center mask rows are zero
        return res.mul_(ops[prefix + "center"])

    def _halo(self, strips: torch.Tensor, table: torch.Tensor, b: int,
              k: int):
        """Pieces (B, C, n, ...) of the rows of ``table`` out of a (B * C,
        rows, 4, k, rho) strip buffer."""
        nc = strips.shape[0] // b
        return tuple(h.reshape((b, nc) + h.shape[1:]).contiguous()
                     for h in self.layout.halo_from_strips_k(strips, table,
                                                             k))

    def _pack(self, s5: torch.Tensor, k: int, rows: int, at: int = 0,
              buf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Write the edge strips of ``s5`` (B, C, nbl, rho, rho) into rows
        [at, at + nbl) of a (B * C, rows, 4, k, rho) buffer (allocated when
        not given)."""
        b, nc, nbl, rho, _ = s5.shape
        if buf is None:
            buf = s5.new_empty((b * nc, rows, 4, k, rho))
        flat = s5.reshape(b * nc, nbl, rho, rho)
        buf[:, at:at + nbl] = self.layout.pack_edge_strips(flat, k)
        return buf

    def _pack_local(self, s5: torch.Tensor, k: int, rows: int
                    ) -> torch.Tensor:
        """A p2p shard's strip buffer of ``rows`` rows: its own strips in
        [0, nbl), then the zero row nbl that remote reads of the interior
        pass hit."""
        buf = self._pack(s5, k, rows)
        buf[:, self.nb_local].zero_()
        return buf

    def _gather_strips(self, cur: State, k: int) -> dict:
        """Every shard's strips in one replicated (B * C, nb_padded + 1, 4,
        k, rho) buffer per device, its last row zero (what ghosts read)."""
        nbl, nbp = self.nb_local, self.nb_padded
        bufs = {}
        for s, (s5, dev) in enumerate(zip(cur, self.devices)):
            if dev not in bufs:
                bufs[dev] = self._pack(s5, k, nbp + 1, s * nbl)
                bufs[dev][:, nbp].zero_()
            else:
                self._pack(s5, k, nbp + 1, s * nbl, bufs[dev])
        for dev, buf in bufs.items():   # the other devices' strips
            for s, other in enumerate(self.devices):
                if other != dev:
                    rows = slice(s * nbl, (s + 1) * nbl)
                    buf[:, rows].copy_(bufs[other][:, rows],
                                       non_blocking=True)
        return bufs

    def _launch_gather(self, cur: State, out: State, k: int) -> None:
        """One gather-mode launch: the replicated strip buffer on every
        device, then every shard's blocks from it."""
        ops = self._operands(k)
        b = cur[0].shape[0]
        bufs = self._gather_strips(cur, k)
        self._transfers["all_gather"] += 1
        for s, dev in enumerate(self.devices):
            halo = self._halo(bufs[dev], ops[s]["table"], b, k)
            self._compute_k(cur[s], halo, ops[s], "", k, out[s])

    def _side_streams(self):
        """One side stream per CUDA device of the shards (for the p2p
        transfers), created once."""
        if "side" not in self._cache:
            self._cache["side"] = {dev: torch.cuda.Stream(dev)
                                   for dev in set(self.devices)
                                   if dev.type == "cuda"}
        return self._cache["side"]

    def _launch_p2p(self, cur: State, out: State, k: int) -> None:
        """One p2p launch: pack, start the two neighbor shifts on side
        streams, compute every shard's whole domain from local strips
        meanwhile, then recompute the boundary blocks from the combined
        local + received strips and patch them in.

        A shard's strip buffer holds the combined coordinates of the
        decomposition's table: [0, nbl) local, nbl zero, then ms_next slots
        received from the prev shard and ms_prev from the next one."""
        ops = self._operands(k)
        d, ns, nbl = self.decomp, self.n_shards, self.nb_local
        b = cur[0].shape[0]
        rows = nbl + 1 + d.ms_next + d.ms_prev
        from_prev = slice(nbl + 1, nbl + 1 + d.ms_next)
        from_next = slice(nbl + 1 + d.ms_next, rows)
        strips = [self._pack_local(s5, k, rows) for s5 in cur]
        sends = []   # (source shard, send buffer, target shard, its slots)
        for s in range(ns):
            if s == 0:
                strips[s][:, from_prev].zero_()
            if s == ns - 1:
                strips[s][:, from_next].zero_()
            if s + 1 < ns:
                sends.append((s + 1, strips[s].index_select(
                    1, ops[s]["send_next"]), from_prev))
            if s > 0:
                sends.append((s - 1, strips[s].index_select(
                    1, ops[s]["send_prev"]), from_next))
        side = self._side_streams()
        for stream in side.values():   # the buffers are packed
            stream.wait_stream(torch.cuda.current_stream(stream.device))
        for target, buf, slots in sends:
            with self._on_side(side, buf.device, self.devices[target]):
                strips[target][:, slots].copy_(buf, non_blocking=True)
            self._transfers["send"] += 1
        self._transfers["permute"] += 2 if ns > 1 else 0
        for s in range(ns):   # interior pass, overlapping the transfers
            halo = self._halo(strips[s], ops[s]["table_int"], b, k)
            self._compute_k(cur[s], halo, ops[s], "", k, out[s])
        for stream in side.values():
            torch.cuda.current_stream(stream.device).wait_stream(stream)
        for s in range(ns):   # boundary pass, patched in
            o = ops[s]
            halo = self._halo(strips[s], o["bnd_table"], b, k)
            bnd = self._compute_k(cur[s].index_select(2, o["bnd_src"]),
                                  halo, o, "bnd_", k, None)
            n_bnd = o["bnd_dst"].shape[0]
            out[s].index_copy_(2, o["bnd_dst"], bnd[:, :, :n_bnd])
        del sends   # the send buffers live until the transfers are done

    @staticmethod
    def _on_side(side, *devices):
        """The side streams of ``devices`` made current (CPU: nothing)."""
        stack = contextlib.ExitStack()
        for dev in dict.fromkeys(devices):
            if dev in side:
                stack.enter_context(torch.cuda.stream(side[dev]))
        return stack

    def _launch(self, cur: State, out: State, k: int) -> State:
        if not 1 <= k <= self.layout.rho:
            raise ValueError(f"need 1 <= k <= rho={self.layout.rho}, got "
                             f"k={k}")
        if self.exchange_mode == "p2p":
            self._launch_p2p(cur, out, k)
        else:
            self._launch_gather(cur, out, k)
        self._account(k, cur[0].shape[0])
        return out

    # ------------------------------------------------------------ public API
    def step_k(self, state: State, k: int) -> State:
        """``k`` exact steps in one launch: one exchange of depth-k strips,
        then k shard-local substeps (1 <= k <= rho)."""
        s5, batched = self._canon(state)
        out = tuple(torch.empty_like(s) for s in s5)
        return self._uncanon(self._launch(s5, out, k), batched)

    def step(self, state: State) -> State:
        return self.step_k(state, 1)

    def local_inputs(self, state: State, k: int, shard: int = 0):
        """What kernel 6 or 7 gets in ``shard``'s whole-domain pass of a
        depth-k launch: its state (B, C, nb_local, rho, rho), the halo
        pieces (top, bot, west, east) and the existence table (nb_local,
        8). P2p: the interior pass, every remote read a zero; gather: the
        pass over the replicated strip buffer."""
        s5 = self._canon(state)[0]
        ops = self._operands(k)[shard]
        b = s5[0].shape[0]
        if self.exchange_mode == "p2p":
            strips = self._pack_local(s5[shard], k, self.nb_local + 1)
            table = ops["table_int"]
        else:
            strips = self._gather_strips(s5, k)[self.devices[shard]]
            table = ops["table"]
        return s5[shard], self._halo(strips, table, b, k), ops["existence"]

    def run(self, state: State, steps: int) -> State:
        """floor(steps/k) launches of depth k plus one of depth steps % k,
        ping-ponging between two engine-owned buffers; ``state`` is never
        written."""
        steps = int(steps)
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        s5, batched = self._canon(state)
        if steps == 0:
            return state
        k = self.effective_fusion_k
        depths = [k] * (steps // k) + ([steps % k] if steps % k else [])
        bufs = [tuple(torch.empty_like(s) for s in s5) for _ in range(2)]
        cur = s5
        with obs.span("dist.run", compute=self.compute, steps=steps, k=k,
                      batch=s5[0].shape[0]):
            for i, depth in enumerate(depths):
                cur = self._launch(cur, bufs[i % 2], depth)
        return self._uncanon(cur, batched)


def make_distributed_engine(layout: BlockLayout, devices=None,
                            n_shards: Optional[int] = None, device=None,
                            workload: StencilWorkload = LIFE,
                            compute: str = "jnp",
                            fusion_k: Optional[int] = None,
                            exchange: str = "auto",
                            macro_p: Optional[int] = None
                            ) -> DistributedSqueezeEngine:
    """The engine over ``devices`` (one per shard), or over ``n_shards``
    shards placed by ``shard_devices(n_shards, device)``: by default one
    shard per visible card."""
    if devices is None:
        devices = shard_devices(n_shards, device)
    return DistributedSqueezeEngine(layout, tuple(devices), workload,
                                    compute, fusion_k, exchange, macro_p)
