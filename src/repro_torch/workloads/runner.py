"""Batched simulation runtime: many independent simulations over a small
set of static configurations.

  * an LRU cache of engines keyed by the NORMALIZED ``EngineSpec`` (the
    runner's one normalization path), thread-safe, with one build per key
    even under concurrent misses;
  * ``run`` takes floor(steps/k) fused k-step launches plus a steps % k
    single-step remainder over a leading batch axis: 'cuda-mxu' steps the
    batch natively through the v5 kernel's (B, n_macro) grid, the other
    kernel kinds (the 3D ones too) through their kernels' batch grid axis;
    the plain kinds step each simulation in turn.

The dist kinds ('dist-block', 'dist-fused', 'dist-mxu') shard one
fractal's BLOCK axis over several devices: their states are the engine's
tuple of shards, each with the leading batch axis, and the runner hands
them to the engine's own ``run`` (one strip exchange per launch for the
whole batch). They take their ``exchange`` and shard count from an
``EngineSpec``. ``place_batch`` instead spreads whole simulations of any
other kind over devices (the BATCH axis); each part is then a batch of
its own, stepped by ``step``/``run`` on its device.

The runner is dimension-agnostic: the 3D kinds ('bb3d', 'cell3d',
'block3d', 'cuda-3d', 'cuda-3d-mxu') take states with 3D trailing axes --
(B, nz, ny, nx) cell states, (B, n_blocks, rho, rho, rho) block states,
(B, n, n, n) BB states -- and their fusion depth is part of the cache key,
as in 2D.

Every public method takes an ``EngineSpec`` first -- ``run(spec, states,
steps)`` -- or the argument list ``run(kind, frac, r, states, steps, ...)``.
The runner's ``device`` follows the port's rule: ``None`` is the card.
``default_runner()`` is the process-wide runner on the card (a serving
process wants one cache).

With telemetry on (``repro_torch.obs``) the runner records the
reference's series: ``runner.cache.{hit,miss,evict,invalidate}``,
``runner.build`` (labeled by kind, workload and k), and per ``run`` the
``runner.run`` span, ``runner.runs`` and the ``runner.run.seconds``,
``runner.batch_size`` and ``runner.steps`` histograms. ``run`` returns
once the kernels are launched, so ``runner.run.seconds`` is host time,
as the reference's is dispatch time.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.device import resolve_device
from repro_torch.tuning.spec import EngineSpec
from repro_torch.workloads.base import StencilWorkload
from repro_torch.workloads.rules import LIFE


def _steps_batches(engine) -> bool:
    """True for the kernel engines (2D and 3D) and the distributed engine,
    which step a leading batch axis in one launch; the plain engines step
    one simulation at a time."""
    from repro_torch.core.distributed import DistributedSqueezeEngine
    from repro_torch.core.stencil import SqueezeKernelEngine
    from repro_torch.core.stencil3d import Squeeze3DKernelEngine
    return isinstance(engine, (SqueezeKernelEngine, Squeeze3DKernelEngine,
                               DistributedSqueezeEngine))


@dataclasses.dataclass
class RunnerStats:
    builds: int = 0     # engines constructed (cache misses)
    evictions: int = 0


@dataclasses.dataclass(frozen=True)
class _Resolved:
    spec: EngineSpec          # normalized: the cache key
    frac: object
    workload: StencilWorkload


class BatchedRunner:
    """LRU cache of engines keyed by normalized ``EngineSpec``; lookups
    hold a lock, a cold build runs outside it behind a per-key event."""

    def __init__(self, capacity: int = 16, device=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.device = resolve_device(device)
        self.stats = RunnerStats()
        self._cache: "OrderedDict[EngineSpec, object]" = OrderedDict()
        self._lock = threading.RLock()
        self._building: Dict[EngineSpec, threading.Event] = {}

    # ------------------------------------------------------------- cache
    def _resolve(self, kind, frac=None, r: Optional[int] = None, m: int = 0,
                 workload: Optional[StencilWorkload] = None,
                 k: Optional[int] = None,
                 macro_p: Optional[int] = None) -> _Resolved:
        if isinstance(kind, EngineSpec):
            norm = kind.normalize()
            return _Resolved(
                norm, frac if frac is not None else norm.build_frac(),
                workload if workload is not None
                else norm.build_workload())
        workload = LIFE if workload is None else workload
        spec = EngineSpec.from_args(kind, frac, r, m, workload, fusion_k=k,
                                    macro_p=macro_p)
        return _Resolved(spec.normalize(), frac, workload)

    def _get(self, res: _Resolved):
        key = res.spec
        while True:
            with self._lock:
                engine = self._cache.get(key)
                if engine is not None:
                    self._cache.move_to_end(key)
                    obs.inc("runner.cache.hit", kind=key.kind)
                    return engine
                ev = self._building.get(key)
                if ev is None:
                    self._building[key] = threading.Event()
                    break
            ev.wait()
        try:
            from repro_torch.core.stencil import make_engine
            obs.inc("runner.cache.miss", kind=key.kind)
            obs.inc("runner.build", kind=key.kind, workload=key.workload,
                    k=key.fusion_k)
            # the key is normalized already: build with the table off, so
            # a runner call consults it once (in ``_resolve``), not twice
            engine = make_engine(key, frac=res.frac, workload=res.workload,
                                 device=self.device, table=None)
            with self._lock:
                self._cache[key] = engine
                self.stats.builds += 1
                if len(self._cache) > self.capacity:
                    self._cache.popitem(last=False)
                    self.stats.evictions += 1
                    obs.inc("runner.cache.evict")
            return engine
        finally:
            with self._lock:
                self._building.pop(key).set()

    def engine_for(self, kind, frac=None, r=None, m=0, workload=None,
                   k=None, macro_p=None):
        """The cached single-simulation engine of this configuration."""
        return self._get(self._resolve(kind, frac, r, m, workload, k,
                                       macro_p))

    def is_cached(self, kind, frac=None, r=None, m=0, workload=None, k=None,
                  macro_p=None) -> bool:
        """Whether this configuration is a warm cache hit now (no build, no
        LRU touch). Takes a spec or the argument list."""
        res = self._resolve(kind, frac, r, m, workload, k, macro_p)
        with self._lock:
            return res.spec in self._cache

    def invalidate(self, kind, frac=None, r=None, m=0, workload=None,
                   k=None, macro_p=None) -> bool:
        """Drop this configuration's engine, if cached, so the next call
        builds it anew; True when one was dropped."""
        res = self._resolve(kind, frac, r, m, workload, k, macro_p)
        with self._lock:
            dropped = self._cache.pop(res.spec, None) is not None
        if dropped:
            obs.inc("runner.cache.invalidate", kind=res.spec.kind)
        return dropped

    def cache_size(self) -> int:
        return len(self._cache)

    @staticmethod
    def place_batch(states: torch.Tensor, devices) -> Tuple[torch.Tensor,
                                                             ...]:
        """Spread a batch of whole simulations over ``devices`` along the
        BATCH axis (no halo traffic: the placement for many small
        fractals); one contiguous part per device, each stepped by
        ``step``/``run`` as a batch of its own. For one fractal too large
        for a device, use the dist kinds, which shard the BLOCK axis."""
        parts = torch.tensor_split(states, len(devices))
        return tuple(p.to(torch.device(d)).contiguous()
                     for p, d in zip(parts, devices))

    # ------------------------------------------------------- batched API
    def init_batch(self, kind, frac=None, r=None, seeds=None, m=0,
                   workload=None) -> torch.Tensor:
        """(B, *state_shape) initial states, one per seed.
        Spec form: ``init_batch(spec, seeds)``."""
        if isinstance(kind, EngineSpec) and seeds is None:
            seeds, frac = frac, None
        engine = self._get(self._resolve(kind, frac, r, m, workload))
        if _is_dist(engine):
            return engine.init_batch(seeds)
        return torch.stack([engine.init_random(int(s)) for s in seeds])

    def step(self, kind, frac=None, r=None, states=None, m=0,
             workload=None) -> torch.Tensor:
        """One step of B simulations. Spec form: ``step(spec, states)``."""
        if isinstance(kind, EngineSpec) and states is None:
            states, frac = frac, None
        engine = self._get(self._resolve(kind, frac, r, m, workload))
        if _steps_batches(engine):
            return engine.step(states)
        return torch.stack([engine.step(s) for s in states])

    def run(self, kind, frac=None, r=None, states=None, steps=None, m=0,
            workload=None, k=None, macro_p=None) -> torch.Tensor:
        """``steps`` steps of B simulations (see module docstring).
        Spec form: ``run(spec, states, steps)``."""
        if isinstance(kind, EngineSpec) and states is None:
            states, steps, frac, r = frac, r, None, None
        t0 = time.perf_counter() if obs.enabled() else None
        res = self._resolve(kind, frac, r, m, workload, k, macro_p)
        engine = self._get(res)
        label, steps = res.spec.kind, int(steps)
        with obs.span("runner.run", kind=label, steps=steps):
            if _steps_batches(engine):
                out = engine.run(states, steps)
            else:
                out = torch.stack([engine.run(s, steps) for s in states])
        if t0 is not None:
            obs.observe("runner.run.seconds", time.perf_counter() - t0,
                        kind=label)
            batch = (states[0] if isinstance(states, tuple)
                     else states).shape[0]
            obs.observe("runner.batch_size", int(batch), kind=label)
            obs.observe("runner.steps", steps, kind=label)
            obs.inc("runner.runs", kind=label)
        return out

    def to_expanded(self, kind, frac=None, r=None, states=None, m=0,
                    workload=None) -> torch.Tensor:
        """(B, C?, n, n) or (B, n, n, n) expanded embedding of B states.
        Spec form: ``to_expanded(spec, states)``."""
        if isinstance(kind, EngineSpec) and states is None:
            states, frac = frac, None
        engine = self._get(self._resolve(kind, frac, r, m, workload))
        if not hasattr(engine, "to_expanded"):
            return states  # BB and lambda states are already expanded
        if _is_dist(engine):
            return engine.to_expanded(states)
        return torch.stack([engine.to_expanded(s) for s in states])


def _is_dist(engine) -> bool:
    from repro_torch.core.distributed import DistributedSqueezeEngine
    return isinstance(engine, DistributedSqueezeEngine)


#: the process-wide runner (a serving process wants one engine cache)
_DEFAULT: Optional[BatchedRunner] = None
_DEFAULT_LOCK = threading.Lock()


def default_runner() -> BatchedRunner:
    """The process-wide ``BatchedRunner`` on the card, built at first
    call (raises without CUDA, as ``BatchedRunner()`` does)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = BatchedRunner()
        return _DEFAULT
