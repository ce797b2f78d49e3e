"""Squeeze engines: stencil simulation entirely in compact space (paper
Sections 3.2-3.5).

  * ``SqueezeCellEngine``   -- per-cell Squeeze: one lambda per cell, one nu
    + membership per neighbor (index tensors built once per engine by the
    map kernels).
  * ``SqueezeBlockEngine``  -- block-level Squeeze in plain PyTorch (the
    ``block`` kind): halo gather through the layout's tables, then the
    dense in-tile rule. ``step_k`` takes any k >= 1, deeper than rho too.
  * ``SqueezeKernelEngine`` -- block-level Squeeze stepped by the CUDA
    kernels: variant ``blocks``, ``strips`` or ``fused`` (``step`` is v1,
    v2 or v3, ``step_k`` v4; kinds ``cuda-blocks``, ``cuda-strips`` (alias
    ``cuda``) and ``cuda-fused``) or ``mxu`` (v5 for both and for native
    batches; kind ``cuda-mxu``).
  * the kinds ``dist-block``, ``dist-fused`` and ``dist-mxu`` --
    ``core/distributed.py``: the block axis sharded over several devices,
    with the strip halo exchange and the shard-local v4 and v5 kernels.

Every engine takes a ``StencilWorkload``; multi-channel workloads carry a
leading channel axis (cell state (C, rows, cols), block state (C,
n_blocks, rho, rho)). ``run(state, steps)`` of the block engines takes
floor(steps/k) fused k-step launches plus steps % k single steps, k from
``fusion_k`` or the ``default_fusion_k`` heuristic. The kernel engine
steps between two buffers it owns (ping-pong), so a kernel never writes
the buffer it reads halos from and the input is never written.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.core.baselines import BBEngine, LambdaEngine, _generator
from repro_torch.core.compact import (BlockLayout, compact_meshgrid,
                                      compact_to_expanded, shared_layout)
from repro_torch.core.device import resolve_device
from repro_torch.core.fractals import NBBFractal
from repro_torch.kernels import lambda_map as lm
from repro_torch.kernels import nu_map as nm
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.tuning.spec import (ACTIVE_TABLE, KINDS, REFERENCE_KINDS,
                                     EngineSpec)
from repro_torch.workloads.base import (MOORE_DIRS, StencilWorkload,
                                        check_workload_ndim,
                                        weighted_gather_agg)
from repro_torch.workloads.rules import LIFE

__all__ = ["KINDS", "REFERENCE_KINDS", "SqueezeBlockEngine",
           "SqueezeCellEngine", "SqueezeKernelEngine", "default_fusion_k",
           "make_engine"]


def default_fusion_k(rho: int) -> int:
    """Static temporal-fusion depth for a rho x rho block tile: no fusion
    below rho = 2, depth 3 from rho = 8, else 2 (always <= rho)."""
    if rho < 2:
        return 1
    return 3 if rho >= 8 else 2


@dataclasses.dataclass(frozen=True)
class SqueezeCellEngine:
    """Compact-space engine at cell granularity (thread-level Squeeze)."""

    frac: NBBFractal
    r: int
    workload: StencilWorkload = LIFE
    device: str = "cuda"

    def __post_init__(self):
        check_workload_ndim(self.workload, 2)

    def init_random(self, seed: int) -> torch.Tensor:
        rows, cols = self.frac.compact_dims(self.r)
        return self.workload.init(_generator(seed, self.device),
                                  (rows, cols), self.device)

    def to_expanded(self, state: torch.Tensor) -> torch.Tensor:
        return compact_to_expanded(self.frac, self.r, state)

    @functools.cached_property
    def _gathers(self):
        """Per Moore direction: (ny, nx, valid) of every compact cell's
        neighbor -- one lambda per cell, one fused nu + membership per
        neighbor, computed once (one lambda and 8 nu kernel launches)."""
        cx, cy = compact_meshgrid(self.frac, self.r, self.device)
        ex, ey = lm.lambda_map_tc(self.frac, self.r, cx, cy)
        out = {}
        for d in MOORE_DIRS:
            nx, ny, valid = nm.nu_map_tc(self.frac, self.r, ex + d[0],
                                         ey + d[1])
            out[d] = (ny.long(), nx.long(), valid)
        return out

    def step(self, state: torch.Tensor) -> torch.Tensor:
        wl = self.workload
        gathers = self._gathers

        zero = state.new_zeros(())

        def gather(d):
            ny, nx, valid = gathers[d]
            return torch.where(valid, state[..., ny, nx], zero)

        agg = weighted_gather_agg(MOORE_DIRS, wl.weights2d, gather,
                                  state.shape, wl.agg_dtype, state.device)
        return wl.apply(state, agg, None).to(state.dtype)

    def run(self, state: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            state = self.step(state)
        return state

    def memory_bytes(self, dtype_size: int = 1) -> int:
        rows, cols = self.frac.compact_dims(self.r)
        return self.workload.n_channels * rows * cols * dtype_size


class _BlockEngine:
    """What the block engines (2D and 3D) share: the layout, the init,
    conversions, the fusion depth and the plain ``run``. Hosts define
    ``layout``, ``workload``, ``fusion_k``, ``device``, ``step`` and
    ``step_k``."""

    @property
    def frac(self):
        return self.layout.frac

    @property
    def r(self) -> int:
        return self.layout.r

    @property
    def effective_fusion_k(self) -> int:
        if self.fusion_k is not None:
            return self.fusion_k
        return default_fusion_k(self.layout.rho)

    def init_random(self, seed: int) -> torch.Tensor:
        """A state drawn on the device from the workload's distribution,
        holes zeroed."""
        lay = self.layout
        field = self.workload.init(_generator(seed, self.device),
                                   (lay.n_blocks,) + lay.micro_mask.shape,
                                   self.device)
        mask = lay.device_table("micro_mask", self.device)
        return field * mask.to(field.dtype)

    def to_expanded(self, state: torch.Tensor) -> torch.Tensor:
        return self.layout.to_expanded(state)

    def memory_bytes(self, dtype_size: int = 1) -> int:
        return self.workload.n_channels * self.layout.memory_bytes(dtype_size)

    def _count_run(self, steps: int) -> None:
        """With telemetry on: the run, its steps, fused launches and
        single steps, labeled by engine class and kernel variant."""
        if not obs.enabled():
            return
        k = self.effective_fusion_k
        lbl = dict(engine=type(self).__name__,
                   variant=getattr(self, "variant", ""))
        obs.inc("engine.runs", **lbl)
        obs.inc("engine.steps", steps, **lbl)
        if k > 1:
            obs.inc("engine.fused_launches", steps // k, **lbl)
            obs.inc("engine.single_steps", steps % k, **lbl)
        else:
            obs.inc("engine.single_steps", steps, **lbl)

    def run(self, state: torch.Tensor, steps: int) -> torch.Tensor:
        """floor(steps/k) fused k-step calls plus steps % k single
        steps."""
        self._count_run(steps)
        k = self.effective_fusion_k
        if k > 1:
            for _ in range(steps // k):
                state = self.step_k(state, k)
            steps %= k
        for _ in range(steps):
            state = self.step(state)
        return state


class _KernelEngine(_BlockEngine):
    """What the kernel engines (2D and 3D) share: ``step`` is the k = 1
    launch of ``step_k(state, k, out)``, and ``run`` ping-pongs."""

    def step(self, state, out=None):
        """One step (of one simulation or of a leading batch axis)."""
        return self.step_k(state, 1, out=out)

    def run(self, state, steps: int):
        """floor(steps/k) k-step launches plus steps % k single steps,
        ping-ponging between two engine-owned buffers; ``state`` is never
        written. A leading batch axis is stepped natively."""
        self._count_run(steps)
        k = self.effective_fusion_k
        if steps == 0:
            return state
        bufs = (torch.empty_like(state), torch.empty_like(state))
        cur = state
        for i, kk in enumerate([k] * (steps // k) + [1] * (steps % k)):
            cur = self.step_k(cur, kk, out=bufs[i % 2])
        return cur


@dataclasses.dataclass(frozen=True)
class SqueezeBlockEngine(_BlockEngine):
    """Block-level Squeeze in plain PyTorch (paper Section 3.5)."""

    layout: BlockLayout
    workload: StencilWorkload = LIFE
    fusion_k: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        check_workload_ndim(self.workload, 2)
        if self.fusion_k is not None and self.fusion_k < 1:
            raise ValueError(f"fusion_k must be >= 1, got {self.fusion_k}")

    def step(self, state: torch.Tensor) -> torch.Tensor:
        return sk.block_step_k(self.layout, state, self.workload, 1)

    def step_k(self, state: torch.Tensor, k: int) -> torch.Tensor:
        """k exact steps from one depth-k halo (any k >= 1)."""
        return sk.block_step_k(self.layout, state, self.workload, k)


#: kernel-engine variant -> its one-step kernel (v1, v2, v3)
_SINGLE_STEP = {"blocks": sk.stencil_step_blocks,
                "strips": sk.stencil_step_strips,
                "fused": sk.stencil_step_fused}


@dataclasses.dataclass(frozen=True)
class SqueezeKernelEngine(_KernelEngine):
    """Block-level Squeeze stepped by the CUDA kernels (CPU tensors take
    the kernels' plain versions). ``variant`` 'blocks', 'strips' or
    'fused': ``step`` is v1, v2 or v3 and ``step_k`` v4; 'mxu': v5 for
    both, and native batches over its (B, n_macro) grid. ``fusion_k`` must
    stay <= rho (one block ring); ``macro_p`` overrides the v5 slots per
    CTA."""

    layout: BlockLayout
    workload: StencilWorkload = LIFE
    variant: str = "fused"
    fusion_k: Optional[int] = None
    macro_p: Optional[int] = None
    device: str = "cuda"

    def __post_init__(self):
        if self.variant not in _SINGLE_STEP and self.variant != "mxu":
            raise ValueError(f"unknown kernel variant {self.variant!r}")
        check_workload_ndim(self.workload, 2)
        if self.fusion_k is not None and not (
                1 <= self.fusion_k <= self.layout.rho):
            raise ValueError(
                f"kernel fusion_k must be in [1, rho={self.layout.rho}], "
                f"got {self.fusion_k}")
        if self.macro_p is not None and self.variant != "mxu":
            raise ValueError("macro_p only applies to the 'mxu' variant")

    def step_k(self, state, k: int, out=None):
        """k exact steps in one launch (k <= rho): v5 for 'mxu'; otherwise
        the variant's single-step kernel for k = 1 and v4 for k > 1."""
        if self.variant == "mxu":
            single = state.dim() == 3 + (self.workload.n_channels > 1)
            if single:
                return self.step_k_batched(
                    state[None], k, out=None if out is None
                    else out[None])[0]
            return self.step_k_batched(state, k, out=out)
        if k == 1:
            return _SINGLE_STEP[self.variant](self.layout, state,
                                              self.workload, out=out)
        return sk.stencil_step_fused_k(self.layout, state, self.workload,
                                       k=k, out=out)

    @property
    def supports_native_batch(self) -> bool:
        """True when B simulations step through one (B, n_macro) grid."""
        return self.variant == "mxu"

    def step_batched(self, states, out=None):
        return self.step_k_batched(states, 1, out=out)

    def step_k_batched(self, states, k: int, out=None):
        """k exact steps of B simulations, states (B, C?, nb, rho, rho),
        in one v5 launch ('mxu' variant only)."""
        if not self.supports_native_batch:
            raise ValueError(f"native batching needs variant='mxu', got "
                             f"{self.variant!r}")
        return sk.stencil_step_mxu_batched(self.layout, states,
                                           self.workload, k=k,
                                           p=self.macro_p, out=out)


#: dist kind -> the distributed engine's shard-local compute
_DIST_COMPUTE = {"dist-block": "jnp", "dist-fused": "fused",
                 "dist-mxu": "mxu"}


def make_engine(kind, frac=None, r: Optional[int] = None, m: int = 0,
                workload: Optional[StencilWorkload] = None,
                fusion_k: Optional[int] = None,
                macro_p: Optional[int] = None, device=None,
                exchange: str = "auto", n_shards: Optional[int] = None,
                table=ACTIVE_TABLE):
    """Engine factory: ``make_engine(spec)`` with an ``EngineSpec``, or
    ``make_engine(kind, frac, r, m=..., workload=...)``.

    kind: 'bb' | 'lambda' | 'cell' | 'block' | 'cuda-blocks' |
    'cuda-strips' | 'cuda-fused' | 'cuda-mxu', and the alias 'cuda' =
    'cuda-strips' (``REFERENCE_KINDS`` names the reference kind of each);
    in 3D, with an ``NBBFractal3D`` and a single-channel 3D workload
    (LIFE3D, HEAT3D, or a totalistic rule): 'bb3d' | 'cell3d' | 'block3d'
    | 'cuda-3d' (the fused 3D kernel) | 'cuda-3d-mxu' (the z-slab banded
    3D kernel); 'dist-block' | 'dist-fused' | 'dist-mxu', the distributed
    engine (``core/distributed.py``) over ``n_shards`` shards placed by
    ``shard_devices`` (default one per visible card; on the CPU pass
    ``n_shards``), with ``exchange`` 'auto' | 'p2p' | 'gather'.
    The spec is normalized first (alias rewritten; fusion depth, MXU
    packing and exchange resolved, explicit > tuning-table hit >
    heuristic); ``table=None`` pins it to the heuristics (no table
    consult), a ``TuningTable`` replaces the active one.
    ``frac``/``workload`` objects may be passed with a spec to supply
    custom ones. ``device=None`` means the card, and raises when CUDA is
    missing; pass ``device="cpu"`` for the CPU.
    """
    if isinstance(kind, EngineSpec):
        spec = kind
    else:
        if frac is None or r is None:
            raise TypeError("make_engine(kind, frac, r, ...) needs a fractal "
                            "and r")
        spec = EngineSpec.from_args(kind, frac, r, m, workload, fusion_k,
                                    macro_p, exchange, n_shards)
    norm = spec.normalize(table=table)
    frac = frac if frac is not None else norm.build_frac()
    workload = workload if workload is not None else norm.build_workload()
    engine = _make_engine(norm, frac, workload, device)
    if obs.enabled():
        obs.inc("engine.builds", kind=norm.kind)
        obs.set_gauge("engine.memory_bytes", engine.memory_bytes(
            dtype_size=workload.dtype.itemsize), kind=norm.kind)
    return engine


def _make_engine(norm: EngineSpec, frac, workload: StencilWorkload, device):
    if norm.is_dist:
        from repro_torch.core.distributed import make_distributed_engine
        return make_distributed_engine(
            shared_layout(frac, norm.r, norm.m), n_shards=norm.n_shards,
            device=device, workload=workload,
            compute=_DIST_COMPUTE[norm.kind], fusion_k=norm.fusion_k,
            exchange=norm.exchange, macro_p=norm.macro_p)
    dev = str(resolve_device(device))
    kind, r, m = norm.kind, norm.r, norm.m
    if norm.is_3d:
        from repro_torch.core import stencil3d as s3
        from repro_torch.core.compact3d import shared_layout3d
        if kind == "bb3d":
            return s3.BB3DEngine(frac, r, workload, dev)
        if kind == "cell3d":
            return s3.Squeeze3DEngine(frac, r, workload, dev)
        if kind == "block3d":
            return s3.Squeeze3DBlockEngine(shared_layout3d(frac, r, m),
                                           workload, fusion_k=norm.fusion_k,
                                           device=dev)
        return s3.Squeeze3DKernelEngine(
            shared_layout3d(frac, r, m), workload,
            variant="mxu" if norm.is_mxu else "fused",
            fusion_k=norm.fusion_k, macro_p=norm.macro_p, device=dev)
    if kind == "bb":
        return BBEngine(frac, r, workload, dev)
    if kind == "lambda":
        return LambdaEngine(frac, r, workload, dev)
    if kind == "cell":
        return SqueezeCellEngine(frac, r, workload, dev)
    if kind == "block":
        return SqueezeBlockEngine(shared_layout(frac, r, m), workload,
                                  fusion_k=norm.fusion_k, device=dev)
    return SqueezeKernelEngine(shared_layout(frac, r, m), workload,
                               variant=kind[len("cuda-"):],
                               fusion_k=norm.fusion_k,
                               macro_p=norm.macro_p, device=dev)
