"""Elastic fault-tolerant distributed execution.

:class:`ElasticDistributedRunner` wraps a
:class:`~repro_torch.core.distributed.DistributedSqueezeEngine` in the
recovery state machine of the reference's ``core/elastic.py``:

    detect -> retry -> restore -> reshard -> degraded-mode

* **detect** — every fused launch (one strip exchange + k shard-local
  substeps) runs under a wall-clock timeout (the launch-level analogue
  of the serving layer's hang threshold; cold shapes get the compile
  grace, which covers the kernels' build at first use), waits for the
  cards before it counts as done, and every launched state passes a
  post-launch integrity check: cells the occupancy mask says are dead —
  fractal holes, padding blocks — must be zero (the mask discipline
  guarantees it), so a corrupted halo band / edge strip surfaces as
  :class:`~repro_torch.runtime.fault.HaloCorruptionError`;
* **retry** — transient failures (a shard's exception, a detected
  corruption) sleep a deterministically-jittered exponential backoff
  (:func:`~repro_torch.runtime.fault.backoff_delays`) and re-launch from
  the newest intact checkpoint, up to ``max_retries`` per failure streak;
* **restore** — checkpoints are *sharded* and *shard-count
  independent*: the unpadded dense compact state, split per shard with
  one crc32 per chunk (``CheckpointManager.save_sharded``), crash-atomic,
  and reassembled by ``restore`` under any shard count. A damaged newest
  step falls back to the previous intact one; with no checkpoint yet,
  recovery recomputes from the stashed initial state — bit-exact either
  way for CA workloads;
* **reshard** — an unrecoverable shard loss
  (:class:`~repro_torch.runtime.fault.DeviceLostError`) drops the lost
  shard's device from the device list, halves the shard count (8 -> 4,
  4 -> 2), rebuilds the engine (every per-shard table is derived again
  from the new count: the strip decomposition, the padding, the halo
  tables), restores the newest intact checkpoint into the new shards
  (``from_dense``) and continues;
* **degraded-mode** — the run finishes on fewer shards
  (``stats.degraded``), still bit-exact: the compact state does not
  depend on the shard count.

The device list plays the reference's mesh: one ``torch.device`` a
shard, and it may repeat a device (four shards on ``cuda:0`` on one
card, eight CPU shards in the tests). A hang (stalled exchange / wedged
launch) additionally rebuilds the engine *in place* on the same devices
before restoring.

Telemetry (``repro_torch.obs``): ``dist.failures{kind=...}``,
``dist.retries``, ``dist.reshards`` counters, a ``dist.recovery_seconds``
histogram and the ``elastic.run`` span; the same numbers are always on
:attr:`ElasticDistributedRunner.stats`. Chaos hooks
(:meth:`~repro_torch.runtime.fault.FaultInjector.in_launch` /
:meth:`~repro_torch.runtime.fault.FaultInjector.corrupt_halo` /
:meth:`~repro_torch.runtime.fault.FaultInjector.on_checkpoint`) fire the
shard-aware fault matrix.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)
from repro_torch.core.compact import BlockLayout
from repro_torch.core.device import synchronize
from repro_torch.core.distributed import (DistributedSqueezeEngine,
                                          shard_devices)
from repro_torch.runtime.fault import (DeviceLostError, FaultInjector,
                                       HaloCorruptionError,
                                       PreemptionHandler, SimulatedFailure,
                                       Watchdog, backoff_delays)
from repro_torch.workloads.base import StencilWorkload
from repro_torch.workloads.rules import LIFE


class _LaunchHang(RuntimeError):
    """Internal: a fused launch exceeded its wall-clock bound and was
    abandoned (the stalled-collective failure class)."""


@dataclasses.dataclass
class ElasticStats:
    """Always-on recovery accounting of one runner (the telemetry
    registry mirrors it when ``SQUEEZE_TELEMETRY`` is enabled)."""

    steps_done: int = 0
    launches: int = 0          # successful fused launches
    failures: int = 0          # detected faults (any class)
    retries: int = 0           # backoff-and-restore cycles
    hangs: int = 0             # launches abandoned on timeout
    reshards: int = 0          # elastic shard-count halvings
    restores: int = 0          # checkpoint restores
    checkpoints: int = 0       # sharded checkpoints written
    recoveries: int = 0        # failure streaks that healed
    recovery_seconds: List[float] = dataclasses.field(
        default_factory=list)
    degraded: bool = False     # finished on fewer shards
    preempted: bool = False    # stopped early on SIGTERM

    @property
    def max_recovery_s(self) -> float:
        return max(self.recovery_seconds, default=0.0)


class ElasticDistributedRunner:
    """Supervised distributed stepping: fused launches with timeout +
    retry + sharded-checkpoint restore + elastic reshard (module
    docstring has the state machine).

    Parameters mirror ``make_distributed_engine`` plus the recovery
    knobs: ``devices`` is the shard device list (one entry a shard,
    repeats allowed); ``devices=None`` places ``n_shards`` shards with
    ``shard_devices(n_shards, device)`` (the card by default, one shard a
    visible card). ``min_devices`` floors the elastic reshard (a loss
    that cannot shrink below it re-raises). ``ckpt_every`` (simulated
    steps) of 0 disables checkpointing — recovery then recomputes from
    the initial state.
    ``launch_timeout_s=None`` disables the hang watchdog (faults still
    retry). ``verify_state=False`` skips the post-launch integrity
    check (and with it halo-corruption detection).
    """

    def __init__(self, layout: BlockLayout,
                 devices: Optional[Sequence] = None,
                 n_shards: Optional[int] = None, device=None,
                 workload: StencilWorkload = LIFE, compute: str = "jnp",
                 fusion_k: Optional[int] = None,
                 exchange: str = "auto",
                 min_devices: int = 1,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 keep: int = 3,
                 launch_timeout_s: Optional[float] = None,
                 compile_grace_s: float = 60.0, max_retries: int = 3,
                 backoff_base_s: float = 0.02,
                 backoff_cap_s: float = 0.5, backoff_seed: int = 0,
                 verify_state: bool = True,
                 injector: Optional[FaultInjector] = None,
                 preemption: Optional[PreemptionHandler] = None):
        self.layout = layout
        self.devices = list(devices if devices is not None
                            else shard_devices(n_shards, device))
        if not self.devices:
            raise ValueError("need at least one device")
        if not (1 <= min_devices <= len(self.devices)):
            raise ValueError(
                f"min_devices must be in [1, {len(self.devices)}], "
                f"got {min_devices}")
        self.workload = workload
        self.compute = compute
        self.fusion_k = fusion_k
        self.exchange = exchange
        self.min_devices = min_devices
        self.ckpt_every = int(ckpt_every)
        self.mgr = (CheckpointManager(ckpt_dir, keep=keep)
                    if ckpt_dir else None)
        self.launch_timeout_s = launch_timeout_s
        self.compile_grace_s = compile_grace_s
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.backoff_seed = backoff_seed
        self.verify_state = verify_state
        self.injector = injector
        self.preemption = preemption
        self.watchdog = Watchdog(name="elastic",
                                 hang_threshold_s=launch_timeout_s)
        self.stats = ElasticStats()
        self._executor: Optional[ThreadPoolExecutor] = None
        self._launch_idx = 0        # dispatch attempts (the chaos clock)
        self._base_dense: Optional[np.ndarray] = None
        self.engine: DistributedSqueezeEngine = None  # _build_engine
        self._build_engine()

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None

    def __enter__(self) -> "ElasticDistributedRunner":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def n_shards(self) -> int:
        return self.engine.n_shards

    def _build_engine(self) -> None:
        """(Re)build the engine on the current device list. A fresh
        frozen instance derives every per-shard table again for the
        current shard count — this is both the hang-restart path (same
        devices, new operands and buffers) and the elastic reshard path
        (fewer shards, new padding/ghost tables)."""
        self.engine = DistributedSqueezeEngine(
            self.layout, tuple(self.devices), self.workload, self.compute,
            self.fusion_k, self.exchange)
        dead = self.engine.dead_mask()
        nbl = self.engine.nb_local
        self._dead = tuple(
            torch.from_numpy(dead[i * nbl:(i + 1) * nbl]).to(
                dev, self.workload.dtype)
            for i, dev in enumerate(self.devices))

    # ------------------------------------------------------------- helpers
    def _pool(self) -> ThreadPoolExecutor:
        if self._executor is None:
            # + slack: a hang-abandoned thread keeps its slot busy
            # until its sleep/step returns
            self._executor = ThreadPoolExecutor(
                max_workers=4, thread_name_prefix="elastic")
        return self._executor

    def _dense_host(self, state) -> np.ndarray:
        return self.engine.to_dense(state).cpu().numpy()

    def _checkpoint(self, state, done: int, force: bool = False) -> None:
        if self.mgr is None:
            return
        if not force and (self.ckpt_every <= 0
                          or done % self.ckpt_every != 0):
            return
        dense = self._dense_host(state)
        path = self.mgr.save_sharded(
            done, {"state": dense}, n_shards=self.engine.n_shards,
            axis=dense.ndim - 3)
        self.stats.checkpoints += 1
        if self.injector is not None:
            self.injector.on_checkpoint("dist", path, self._launch_idx)

    def _to_boundary(self, done: int) -> int:
        if self.mgr is None or self.ckpt_every <= 0:
            return 1 << 30
        return self.ckpt_every - done % self.ckpt_every

    def _recover(self, count_retry: bool = True):
        """(state, done): the newest intact checkpoint restored into
        the CURRENT engine's shards, else the stashed initial state."""
        eng = self.engine
        if count_retry:
            self.stats.retries += 1
            obs.inc("dist.retries")
        if self.mgr is not None and self.mgr.all_steps():
            like = {"state": np.zeros(self._base_dense.shape,
                                      self._base_dense.dtype)}
            try:
                step, tree = self.mgr.restore_with_fallback(like)
                self.stats.restores += 1
                return eng.from_dense(tree["state"]), int(step)
            except (CheckpointCorruptError, FileNotFoundError,
                    KeyError, ValueError):
                pass  # unusable checkpoint family: recompute from t=0
        return eng.from_dense(self._base_dense), 0

    def _reshard(self, err: DeviceLostError) -> bool:
        """Shrink after an unrecoverable shard loss: drop the lost
        shard's device, halve the shard count (floored at
        ``min_devices``), rebuild the engine. False when already at the
        floor (the loss is terminal)."""
        n = len(self.devices)
        n_new = max(self.min_devices, n // 2)
        if n_new >= n:
            return False
        lost = getattr(err, "shard", 0) % n
        survivors = [d for i, d in enumerate(self.devices) if i != lost]
        self.devices = survivors[:n_new]
        self._build_engine()
        self.stats.reshards += 1
        self.stats.degraded = True
        obs.inc("dist.reshards")
        return True

    def _timed_launch(self, state, seg: int, warm: set):
        """One fused launch under the wall-clock bound. The chaos
        ``in_launch`` hook runs inside the timed region (a stalled
        launch really blocks it); on timeout the thread is abandoned
        and ``_LaunchHang`` raised."""
        launch = self._launch_idx
        self._launch_idx += 1

        def work():
            if self.injector is not None:
                self.injector.in_launch(launch)
            out = self.engine.step_k(state, seg)
            synchronize(out)
            return out

        if self.launch_timeout_s is None:
            out = work()
        else:
            key = (seg, self.engine.n_shards, tuple(state[0].shape))
            timeout = (self.launch_timeout_s if key in warm
                       else max(self.launch_timeout_s,
                                self.compile_grace_s))
            self.watchdog.start_step()
            fut = self._pool().submit(work)
            try:
                out = fut.result(timeout=timeout)
            except _FuturesTimeout:
                raise _LaunchHang(
                    f"launch {launch} exceeded {timeout:.3f}s") from None
            self.watchdog.end_step()
            warm.add(key)

        # post-launch chaos (halo/strip corruption) + integrity check
        if self.injector is not None:
            out, _ = self.injector.corrupt_halo(launch, out)
        if self.verify_state and any(
                bool(((s * dead) != 0).any())
                for s, dead in zip(out, self._dead)):
            raise HaloCorruptionError(
                f"launch {launch}: dead cells came back nonzero "
                "(corrupted halo band / edge strip)")
        return out

    def _note_failure(self, kind: str) -> None:
        self.stats.failures += 1
        obs.inc("dist.failures", kind=kind)

    # ------------------------------------------------------------- public
    def run(self, steps: int, state=None, seed: int = 0):
        """Advance ``steps`` simulated steps with full recovery,
        returning the final engine-native state (the tuple of shards).
        ``state`` may be any rank the engine accepts (single or
        batched); omitted it is seeded via ``init_random(seed)``. If the
        checkpoint directory already holds steps (a preempted run),
        execution RESUMES from the newest intact one."""
        steps = int(steps)
        if state is None:
            state = self.engine.init_random(int(seed))
        self._base_dense = self._dense_host(state)
        done = 0
        attempt = 0            # failures since last success
        delays = None          # backoff schedule of this streak
        t_fail: Optional[float] = None
        warm: set = set()
        if self.mgr is not None and self.mgr.all_steps():
            # resume a preempted/restarted run (not a failure retry)
            state, done = self._recover(count_retry=False)
        with obs.span("elastic.run", compute=self.compute, steps=steps,
                      shards=self.engine.n_shards):
            while done < steps:
                if (self.preemption is not None
                        and self.preemption.requested):
                    self._checkpoint(state, done, force=True)
                    self.stats.preempted = True
                    break
                k = self.engine.effective_fusion_k
                seg = min(k, steps - done, self._to_boundary(done))
                try:
                    out = self._timed_launch(state, seg, warm)
                except DeviceLostError as e:
                    self._note_failure("device_loss")
                    t_fail = t_fail or time.monotonic()
                    if not self._reshard(e):
                        raise  # already at min_devices: terminal
                    warm.clear()
                    state, done = self._recover()
                    continue
                except _LaunchHang:
                    self.watchdog.flag_hang()
                    self.stats.hangs += 1
                    self._note_failure("hang")
                    t_fail = t_fail or time.monotonic()
                    attempt += 1
                    if attempt > self.max_retries:
                        raise
                    # kill + restart: a fresh engine on the same
                    # devices, then restore
                    self._build_engine()
                    warm.clear()
                    delays = delays or backoff_delays(
                        self.backoff_base_s, self.backoff_cap_s,
                        seed=self.backoff_seed)
                    time.sleep(next(delays))
                    state, done = self._recover()
                    continue
                except SimulatedFailure as e:
                    kind = ("halo_corrupt"
                            if isinstance(e, HaloCorruptionError)
                            else "exception")
                    self._note_failure(kind)
                    t_fail = t_fail or time.monotonic()
                    attempt += 1
                    if attempt > self.max_retries:
                        raise
                    delays = delays or backoff_delays(
                        self.backoff_base_s, self.backoff_cap_s,
                        seed=self.backoff_seed)
                    time.sleep(next(delays))
                    state, done = self._recover()
                    continue
                # -------------------------------------------- success
                state = out
                done += seg
                self.stats.launches += 1
                self.stats.steps_done = done
                if t_fail is not None:
                    dt = time.monotonic() - t_fail
                    self.stats.recoveries += 1
                    self.stats.recovery_seconds.append(dt)
                    obs.observe("dist.recovery_seconds", dt)
                    t_fail = None
                attempt, delays = 0, None
                self._checkpoint(state, done)
        self.stats.steps_done = done
        return state
