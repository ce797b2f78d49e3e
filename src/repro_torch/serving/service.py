"""Async continuous-batching fractal-simulation service.

The "millions of users" story made concrete: heterogeneous jobs
``(fractal, r, workload, steps, snapshot cadence)`` arrive on an
asyncio front door, pass admission control, and are bucketed by their
engine-compatibility key onto the :class:`BatchedRunner`'s engine LRU —
requests sharing a bucket batch into ONE batched run of the bucket's
engine, whose kernels step the leading batch axis (the warm path), cold
engine builds are bounded by a semaphore, and new requests join a
running batch at segment boundaries (continuous batching: nobody waits
for a full drain). This is the reference's ``serving/service.py`` on the
port's runner: the same state machine, counters and results.

Execution is segment-at-a-time: each launch advances every row by
``seg`` steps (the minimum distance to any row's next event — snapshot
boundary, completion, or the ``max_segment_steps`` cap) through
``runner.run``, and waits for the card (``torch.cuda.synchronize``) in
the timed worker, so the watchdog times device work, not only the
launches. Between segments the service checks deadlines
(timeout/cancel), preemption, and the chaos hooks.

Fault tolerance (the point):

  * a segment that raises (e.g. an injected in-step exception) is
    retried with exponential backoff + deterministic jitter; every row
    is rebuilt from its newest intact checkpoint (or recomputed from
    its seed), so a retry is bit-exact for CA workloads;
  * a segment that exceeds the watchdog hang threshold is abandoned,
    the engine is evicted from the runner LRU
    (``runner.invalidate`` — kill + restart), and the batch recovers
    from checkpoints exactly as above;
  * SIGTERM preemption (via :class:`PreemptionHandler`) drains the
    in-flight segment, checkpoints every active row, resolves them
    ``preempted`` and sheds the queue — resubmitting the same rid
    resumes from the checkpoint;
  * a corrupted/truncated checkpoint is caught by the manager's crc32
    verification and falls back to the previous intact step
    (``restore_with_fallback``);
  * sustained failure trips the circuit breaker: admission rejects
    with retry-after instead of letting the queue collapse;
  * ``dist-*`` engine kinds ride the same state machine: their rows
    checkpoint the shard-independent dense compact state as *sharded*
    checkpoints (``save_sharded`` — per-shard leaves, one crc32 each)
    and restore through ``engine.from_dense`` (re-padded + re-sharded
    for the engine's current shard count), so the service survives
    distributed faults — and a checkpoint written under one shard count
    restores under another. Their states are the engine's tuple of
    shards; a batch stacks each shard.

Every transition lands on the telemetry registry:
``serve.{admitted,rejected,completed,failed,timeouts,preempted,
retries,restarts,recoveries,batches,segments,joins,checkpoints}``
counters, ``serve.{latency,queue_wait,recovery}_seconds`` +
``serve.{batch_size,segment_steps}`` histograms, and
``serve.{queue_depth,inflight,breaker_open}`` gauges.
"""
from __future__ import annotations

import asyncio
import dataclasses
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Deque, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)
from repro_torch.core.device import synchronize
from repro_torch.runtime.fault import (FaultInjector, PreemptionHandler,
                                       Watchdog, backoff_delays)
from repro_torch.serving.types import (AdmissionError, CircuitBreaker,
                                       ServiceConfig, SimRequest, SimResult)
from repro_torch.workloads.runner import BatchedRunner


def _stack(states):
    """One batch of row states: a stacked tensor, or for the dist kinds
    the tuple of each shard stacked."""
    if isinstance(states[0], tuple):
        return tuple(torch.stack(shard) for shard in zip(*states))
    return torch.stack(states)


def _row_of(out, i: int):
    """Row ``i`` of a batched state (a tensor or a tuple of shards)."""
    if isinstance(out, tuple):
        return tuple(shard[i] for shard in out)
    return out[i]


@dataclasses.dataclass
class _Pending:
    req: SimRequest
    future: asyncio.Future
    t_submit: float
    retries: int = 0
    recoveries: int = 0


@dataclasses.dataclass
class _Row:
    """One active request inside a bucket batch."""

    pending: _Pending
    state: object                  # engine-native compact state (tensor
                                   # or, for dist kinds, tuple of shards)
    done: int                      # completed steps
    mgr: Optional[CheckpointManager]
    t_start: float
    snapshots: Dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    #: set synchronously by _finish_row — the bucket loop filters on
    #: this, not on future.done(), because worker-thread resolution
    #: lands on the loop asynchronously (call_soon_threadsafe)
    resolved: bool = False

    @property
    def req(self) -> SimRequest:
        return self.pending.req

    def next_event(self, cap: int) -> int:
        """Steps to this row's next boundary (completion or snapshot)."""
        left = self.req.steps - self.done
        if self.req.snapshot_every:
            to_snap = (self.req.snapshot_every
                       - self.done % self.req.snapshot_every)
            left = min(left, to_snap)
        return max(1, min(left, cap))


class FractalService:
    """See module docstring. Construct, then either drive the asyncio
    API (``await start()`` / ``await submit(req)`` / ``await stop()``)
    or hand a whole list to the sync facade ``serve(requests)``."""

    def __init__(self, config: Optional[ServiceConfig] = None,
                 runner: Optional[BatchedRunner] = None,
                 injector: Optional[FaultInjector] = None):
        self.config = config or ServiceConfig()
        self.runner = runner or BatchedRunner()
        self.injector = injector
        cfg = self.config
        self.breaker = CircuitBreaker(cfg.breaker_threshold,
                                      cfg.breaker_cooldown_s)
        self.watchdog = Watchdog(name="serve",
                                 hang_threshold_s=cfg.hang_threshold_s)
        self.preemption: Optional[PreemptionHandler] = None
        self._pending: Dict[Tuple, Deque[_Pending]] = {}
        self._running: Set[Tuple] = set()
        self._tasks: Set[asyncio.Task] = set()
        self._queued = 0
        self._segments = 0
        self._started = False
        self._stopping = False
        self._draining = False
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        self._compile_sem: Optional[asyncio.Semaphore] = None

    # ------------------------------------------------------------ lifecycle
    async def start(self, install_signals: bool = False) -> None:
        """Bind to the running loop. ``install_signals=True`` traps
        SIGTERM/SIGUSR1 for preemption draining (restored on stop)."""
        if self._started:
            return
        self._loop = asyncio.get_running_loop()
        # + slack beyond max_inflight: a hang-abandoned worker thread
        # keeps its slot busy until its sleep/step returns
        self._executor = ThreadPoolExecutor(
            max_workers=self.config.max_inflight + 4,
            thread_name_prefix="serve")
        self._compile_sem = asyncio.Semaphore(
            self.config.compile_concurrency)
        self.preemption = PreemptionHandler(install=install_signals)
        if self.injector is not None and self.injector.handler is None:
            self.injector.handler = self.preemption
        self._started = True
        self._stopping = False
        self._draining = False

    async def stop(self) -> None:
        """Drain: wait for in-flight buckets (which consume the queue),
        then shed anything still pending and release resources."""
        self._stopping = True
        while self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
            # a gather of tasks that are all done completes without
            # yielding (Python 3.12): yield, so that their done callbacks,
            # which drop them from ``_tasks``, run
            await asyncio.sleep(0)
        self._shed_all("preempted" if self._preempted() else "rejected")
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
        if self.preemption is not None:
            self.preemption.uninstall()
        self._started = False

    def _preempted(self) -> bool:
        return self.preemption is not None and self.preemption.requested

    # ------------------------------------------------------------ admission
    def _admit(self, req: SimRequest) -> None:
        cfg = self.config
        if self._stopping or self._draining or self._preempted():
            obs.inc("serve.rejected", reason="draining")
            raise AdmissionError("draining", cfg.retry_after_s)
        if not self.breaker.allow():
            obs.inc("serve.rejected", reason="breaker_open")
            obs.set_gauge("serve.breaker_open", 1)
            raise AdmissionError("breaker_open",
                                 max(self.breaker.retry_after(),
                                     cfg.retry_after_s))
        if self._queued >= cfg.max_queue:
            obs.inc("serve.rejected", reason="queue_full")
            raise AdmissionError("queue_full", cfg.retry_after_s)
        obs.inc("serve.admitted", kind=req.kind)

    async def submit(self, req: SimRequest) -> SimResult:
        """Admit + enqueue ``req`` and await its result. Raises
        :class:`AdmissionError` when shed at the door."""
        if not self._started:
            raise RuntimeError("service not started")
        self._admit(req)
        fut = self._loop.create_future()
        p = _Pending(req, fut, time.monotonic())
        self._pending.setdefault(req.bucket, deque()).append(p)
        self._queued += 1
        obs.set_gauge("serve.queue_depth", self._queued)
        self._maybe_launch()
        return await fut

    async def _submit_safe(self, req: SimRequest) -> SimResult:
        try:
            return await self.submit(req)
        except AdmissionError as e:
            return SimResult(rid=req.rid, status="rejected",
                             retry_after_s=e.retry_after_s,
                             error=e.reason)

    def serve(self, requests: List[SimRequest],
              install_signals: bool = False) -> List[SimResult]:
        """Sync facade: start, submit everything, drain, stop.
        Admission rejections come back as ``rejected`` results."""
        async def go():
            await self.start(install_signals=install_signals)
            try:
                return await asyncio.gather(
                    *(self._submit_safe(r) for r in requests))
            finally:
                await self.stop()
        return asyncio.run(go())

    # ----------------------------------------------------------- scheduling
    def _maybe_launch(self) -> None:
        """Start bucket tasks for queued work while inflight slots are
        free (called on submit and on task completion; runs on the
        loop, so checks are race-free)."""
        if self._stopping and not self._queued:
            return
        for bucket, q in list(self._pending.items()):
            if not q or bucket in self._running:
                continue
            if len(self._running) >= self.config.max_inflight:
                break
            self._running.add(bucket)
            task = self._loop.create_task(self._run_bucket(bucket))
            self._tasks.add(task)
            task.add_done_callback(self._on_task_done(bucket))
            obs.set_gauge("serve.inflight", len(self._running))

    def _on_task_done(self, bucket):
        def cb(task: asyncio.Task) -> None:
            self._tasks.discard(task)
            self._running.discard(bucket)
            obs.set_gauge("serve.inflight", len(self._running))
            if not task.cancelled() and task.exception() is not None:
                # a bucket-task bug must not strand its queued peers
                self._shed_bucket(bucket, "failed",
                                  error=repr(task.exception()))
            self._maybe_launch()
        return cb

    # ---------------------------------------------------------- bucket loop
    async def _run_bucket(self, bucket) -> None:
        # the bucket IS the normalized EngineSpec — the runner accepts
        # it directly; a representative request supplies the live
        # frac/workload objects (registry-invisible customs included)
        q0 = self._pending.get(bucket)
        if not q0:
            return  # shed between scheduling and task start
        rep = q0[0].req
        kind = bucket.kind
        cfg = self.config
        run_in = self._loop.run_in_executor

        # bounded cold build: only misses pay the semaphore
        if not self.runner.is_cached(bucket, frac=rep.frac,
                                     workload=rep.workload):
            async with self._compile_sem:
                await run_in(self._executor,
                             lambda: self.runner.engine_for(
                                 bucket, frac=rep.frac,
                                 workload=rep.workload))

        rows: List[_Row] = []
        attempt = 0                      # failures since last success
        delays = None                    # backoff schedule of this streak
        t_fail: Optional[float] = None   # recovery-time clock
        warm: Set[int] = set()           # batch sizes already launched
        obs.inc("serve.batches", kind=kind)

        while True:
            # -- continuous joining at the segment boundary
            q = self._pending.get(bucket)
            while q and len(rows) < cfg.max_batch:
                p = q.popleft()
                self._queued -= 1
                obs.set_gauge("serve.queue_depth", self._queued)
                obs.inc("serve.joins", kind=kind)
                row = await run_in(
                    self._executor, lambda p=p: self._load_row(p))
                if row.done >= row.req.steps:
                    # restored past its own step count (a finished job
                    # resubmitted): complete without stepping
                    await run_in(self._executor,
                                 lambda row=row: self._finish_row(
                                     row, "ok",
                                     host_state=self._host_state(
                                         row.req, row.state)))
                else:
                    rows.append(row)
                q = self._pending.get(bucket)
            if not rows:
                return  # checked synchronously after last await: no race

            # -- chaos boundary hook + preemption drain
            if self.injector is not None:
                self.injector.at_boundary(self._segments)
            if self._preempted():
                self._draining = True
                await run_in(self._executor,
                             lambda: self._drain_rows(rows))
                self._shed_all("preempted")
                return

            # -- deadlines (checked between launches; a segment is the
            #    cancellation granularity, as with any running kernel)
            now = time.monotonic()
            for row in rows:
                deadline = (row.req.deadline_s
                            if row.req.deadline_s is not None
                            else cfg.default_deadline_s)
                if now - row.pending.t_submit > deadline:
                    self._finish_row(row, "timeout")
            rows = [r_ for r_ in rows if not r_.resolved]
            if not rows:
                continue

            # -- one segment: advance every row by seg steps
            seg = min(row.next_event(cfg.max_segment_steps)
                      for row in rows)
            seg_idx = self._segments
            self._segments += 1
            obs.inc("serve.segments", kind=kind)
            obs.observe("serve.segment_steps", seg, kind=kind)
            obs.observe("serve.batch_size", len(rows), kind=kind)
            states = _stack([row.state for row in rows])

            def work(states=states, seg=seg, seg_idx=seg_idx):
                if self.injector is not None:
                    self.injector.in_step(seg_idx)
                out = self.runner.run(bucket, states=states, steps=seg,
                                      frac=rep.frac,
                                      workload=rep.workload)
                synchronize(out)
                return out

            # a batch shape this bucket has not launched yet may pay the
            # kernels' build and the engine's device tables on this call —
            # give it the compile grace so that never reads as a hang
            # (steady state gets the tight threshold back)
            timeout = (cfg.hang_threshold_s if len(rows) in warm
                       else max(cfg.hang_threshold_s,
                                cfg.compile_grace_s))
            self.watchdog.start_step()
            try:
                out = await asyncio.wait_for(
                    run_in(self._executor, work), timeout=timeout)
            except asyncio.TimeoutError:
                # hang: abandon the stuck thread, kill + restart the
                # engine, recover the batch from checkpoints
                self.watchdog.flag_hang()
                obs.inc("serve.restarts", kind=kind)
                self.runner.invalidate(bucket, frac=rep.frac,
                                       workload=rep.workload)
                warm.clear()  # the restarted engine rebuilds its tables
                t_fail = t_fail or time.monotonic()
                attempt += 1
                rows, delays = await self._retry_or_fail(
                    rows, attempt, delays, "hang")
                if rows is None:
                    return
                continue
            except Exception as e:
                obs.inc("serve.retries", kind=kind)
                t_fail = t_fail or time.monotonic()
                attempt += 1
                rows, delays = await self._retry_or_fail(
                    rows, attempt, delays, repr(e))
                if rows is None:
                    return
                continue
            self.watchdog.end_step()
            warm.add(len(rows))
            self.breaker.record_success()
            obs.set_gauge("serve.breaker_open", 0)
            if t_fail is not None:
                obs.observe("serve.recovery_seconds",
                            time.monotonic() - t_fail, kind=kind)
                obs.inc("serve.recoveries", kind=kind)
                for row in rows:
                    row.pending.recoveries += 1
                t_fail = None
            attempt, delays = 0, None

            # -- unstack, snapshot/checkpoint, complete
            for i, row in enumerate(rows):
                row.state = _row_of(out, i)
                row.done += seg
            await run_in(self._executor,
                         lambda: self._after_segment(rows, seg_idx))
            rows = [r_ for r_ in rows if not r_.resolved]

    # ------------------------------------------------------ failure handling
    async def _retry_or_fail(self, rows: List[_Row], attempt: int,
                             delays, reason: str):
        """Common recovery path for hangs and in-step failures: breaker
        accounting, bounded retries, jittered backoff, and a row rebuild
        from the newest intact checkpoints. Returns ``(rows, delays)``
        or ``(None, None)`` once the batch is resolved failed."""
        cfg = self.config
        self.breaker.record_failure()
        if self.breaker.state != "closed":
            obs.set_gauge("serve.breaker_open", 1)
        for row in rows:
            row.pending.retries += 1
        if attempt > cfg.max_retries:
            for row in rows:
                self._finish_row(row, "failed",
                                 error=f"retries exhausted: {reason}")
            return None, None
        if delays is None:
            delays = backoff_delays(cfg.backoff_base_s,
                                    cfg.backoff_cap_s,
                                    seed=cfg.backoff_seed)
        await asyncio.sleep(next(delays))
        rebuilt = await self._loop.run_in_executor(
            self._executor,
            lambda: [self._reload_row(row) for row in rows])
        return rebuilt, delays

    def _reload_row(self, row: _Row) -> _Row:
        """Recovery rebuild: back to the newest intact checkpoint (or
        the seed). Worker thread."""
        state, done, _ = self._restore_state(row.req)
        row.state, row.done = state, done
        return row

    # -------------------------------------------------------- rows / state
    def _mgr_for(self, rid: str) -> Optional[CheckpointManager]:
        if not self.config.ckpt_dir:
            return None
        return CheckpointManager(
            os.path.join(self.config.ckpt_dir, rid),
            keep=self.config.keep_checkpoints)

    def _engine_of(self, req: SimRequest):
        return self.runner.engine_for(req.bucket, frac=req.frac,
                                      workload=req.workload)

    @staticmethod
    def _is_dist(req: SimRequest) -> bool:
        return req.kind.startswith("dist-")

    def _host_state(self, req: SimRequest, state) -> np.ndarray:
        """Host copy of a row's state for results, snapshots and
        checkpoints. Distributed rows strip the engine's padding
        blocks first: the user-facing (and checkpointed) artifact is
        the shard-independent dense compact state, so a checkpoint
        written under one shard count restores under any other."""
        if self._is_dist(req):
            state = self._engine_of(req).to_dense(state)
        return state.cpu().numpy()

    def _save_row(self, row: "_Row", host: np.ndarray) -> str:
        """Checkpoint one row (worker thread). Distributed rows write
        sharded checkpoints — per-shard leaves with one crc32 each,
        restorable under a different shard count (the elastic path)."""
        req = row.req
        if self._is_dist(req):
            eng = self._engine_of(req)
            return row.mgr.save_sharded(
                row.done, {"state": host}, n_shards=eng.n_shards,
                axis=host.ndim - 3)
        return row.mgr.save(row.done, {"state": host})

    def _restore_state(self, req: SimRequest):
        """(state, done, mgr): the newest intact checkpoint if one
        exists, else the seeded initial state. Worker thread.
        Distributed checkpoints hold the dense state and re-enter the
        engine via ``from_dense`` (re-padded + re-sharded for the
        engine's current shard count)."""
        engine = self._engine_of(req)
        init = engine.init_random(req.seed)
        mgr = self._mgr_for(req.rid)
        dist = self._is_dist(req)
        if mgr is not None and mgr.all_steps():
            like = {"state": engine.to_dense(init) if dist else init}
            try:
                step, tree = mgr.restore_with_fallback(like)
                state = (engine.from_dense(tree["state"]) if dist
                         else torch.as_tensor(tree["state"],
                                              device=self.runner.device))
                return state, int(step), mgr
            except (CheckpointCorruptError, KeyError, ValueError):
                pass  # unusable checkpoint family: recompute from seed
        return init, 0, mgr

    def _load_row(self, p: _Pending) -> _Row:
        state, done, mgr = self._restore_state(p.req)
        return _Row(pending=p, state=state, done=done, mgr=mgr,
                    t_start=time.monotonic())

    def _after_segment(self, rows: List[_Row], seg_idx: int) -> None:
        """Snapshot/checkpoint boundaries + completions. Worker thread
        (device-to-host copies + disk I/O); future resolution hops to the
        loop."""
        for row in rows:
            req = row.req
            finished = row.done >= req.steps
            at_snap = (req.snapshot_every
                       and row.done % req.snapshot_every == 0)
            if not (finished or at_snap):
                continue
            host = self._host_state(req, row.state)
            if at_snap and not finished:
                row.snapshots[row.done] = host
            if row.mgr is not None:
                path = self._save_row(row, host)
                obs.inc("serve.checkpoints")
                if self.injector is not None:
                    self.injector.on_checkpoint(req.rid, path, seg_idx)
            if finished:
                self._finish_row(row, "ok", host_state=host)

    def _drain_rows(self, rows: List[_Row]) -> None:
        """Preemption: checkpoint every active row at its current step,
        then resolve it ``preempted``. Worker thread."""
        for row in rows:
            host = self._host_state(row.req, row.state)
            if row.mgr is not None:
                self._save_row(row, host)
                obs.inc("serve.checkpoints")
            self._finish_row(row, "preempted", host_state=host)

    # ------------------------------------------------------------- results
    def _finish_row(self, row: _Row, status: str,
                    host_state: Optional[np.ndarray] = None,
                    error: Optional[str] = None) -> None:
        if row.resolved:
            return
        row.resolved = True
        p = row.pending
        now = time.monotonic()
        res = SimResult(
            rid=p.req.rid, status=status, state=host_state,
            snapshots=sorted(row.snapshots.items()),
            steps_done=row.done, latency_s=now - p.t_submit,
            queue_wait_s=row.t_start - p.t_submit,
            retries=p.retries, recoveries=p.recoveries, error=error)
        self._count_outcome(status, p.req.kind)
        obs.observe("serve.latency_seconds", res.latency_s,
                    kind=p.req.kind, status=status)
        obs.observe("serve.queue_wait_seconds", res.queue_wait_s,
                    kind=p.req.kind)
        self._set_result(p.future, res)

    _OUTCOMES = {"ok": "serve.completed", "failed": "serve.failed",
                 "timeout": "serve.timeouts",
                 "preempted": "serve.preempted",
                 "rejected": "serve.shed"}

    def _count_outcome(self, status: str, kind: str) -> None:
        obs.inc(self._OUTCOMES.get(status, "serve.other"), kind=kind)

    def _set_result(self, fut: asyncio.Future, res: SimResult) -> None:
        """Resolve a future from any thread."""
        def do():
            if not fut.done():
                fut.set_result(res)
        if self._loop is not None:
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            if running is self._loop:
                do()
            else:
                self._loop.call_soon_threadsafe(do)

    def _shed_bucket(self, bucket, status: str,
                     error: Optional[str] = None) -> None:
        q = self._pending.get(bucket)
        while q:
            p = q.popleft()
            self._queued -= 1
            self._count_outcome(status, p.req.kind)
            self._set_result(p.future, SimResult(
                rid=p.req.rid, status=status, steps_done=0,
                latency_s=time.monotonic() - p.t_submit, error=error,
                retry_after_s=self.config.retry_after_s))
        obs.set_gauge("serve.queue_depth", self._queued)

    def _shed_all(self, status: str) -> None:
        for bucket in list(self._pending):
            self._shed_bucket(bucket, status)
