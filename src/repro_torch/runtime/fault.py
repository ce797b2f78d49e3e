"""Fault-tolerance runtime: step watchdog (straggler + hang detection),
preemption handling, a restart supervisor with backoff, and the chaos
harness that proves all of it works (the reference's ``runtime/fault.py``,
on the port's ``obs``).

At 1000+ nodes the failure model is: frequent single-host preemptions
(handled by checkpoint/restart — the supervisor here), slow hosts
(watchdog surfaces p95 outliers so the scheduler can cordon them), hung
kernels (watchdog hang threshold -> engine restart), and rare corrupt
saves (caught by the manager's per-leaf checksums, which fall back to
the previous intact step). ``FaultInjector`` turns each of those
failure classes into a *scriptable* event so the serving layer
(``repro_torch.serving``) can be exercised against the full chaos
matrix. The shard-aware kinds (per-shard exception, stalled fused
launch, device loss, corrupted halo band, damaged distributed
checkpoint) extend the same plan format to the elastic distributed
runner (``repro_torch.core.elastic``).

Accounting lives on the telemetry registry (``repro_torch.obs``): the
watchdog's step times land in a ``watchdog.step_seconds`` histogram
(one labeled series per watchdog — the bespoke ring buffer of samples
is gone), straggler fires count ``watchdog.stragglers``, hang fires
count ``watchdog.hangs``, and the restart supervisor counts
``fault.restarts``. These record regardless of the
``SQUEEZE_TELEMETRY`` toggle: constructing a watchdog or a supervisor
IS the opt-in, and both are control-flow state (the straggler median
and the give-up bound read them back), not optional telemetry.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import random
import signal
import threading
import time
from typing import (Callable, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.obs import Histogram, default_registry


class SimulatedFailure(RuntimeError):
    """Raised by tests / chaos hooks to emulate a mid-run crash."""


class InjectedFault(SimulatedFailure):
    """A fault raised by :class:`FaultInjector` (transient by contract:
    supervisors retry it)."""


class DeviceLostError(SimulatedFailure):
    """A shard's device is gone (injected by the chaos harness;
    unrecoverable on the current shards by contract — the elastic runner
    responds by resharding onto fewer devices)."""

    def __init__(self, msg: str, shard: int = 0):
        super().__init__(msg)
        self.shard = shard


class HaloCorruptionError(SimulatedFailure):
    """A post-launch state integrity check failed: cells the occupancy
    mask says are dead (fractal holes, padding blocks) came back
    nonzero — the signature of a damaged halo band / edge strip.
    Transient: supervisors restore the newest intact checkpoint."""


#: distinct default label per Watchdog instance, so two watchdogs (e.g.
#: successive train() calls in one process) never mix their step-time
#: distributions — the straggler median must see only its own steps
_WD_IDS = itertools.count()


@dataclasses.dataclass
class Watchdog:
    """Tracks step wall-times; flags stragglers beyond k x median and
    carries the hang threshold a supervisor enforces.

    Samples live in the ``watchdog.step_seconds`` histogram on the
    default registry (``.histogram`` — exported by obs.report(), JSONL
    and Prometheus like every other metric); the straggler threshold
    uses its bucket-interpolated p50. ``name`` labels the series
    (default: a fresh ``wd<N>`` per instance).

    Stragglers are detected *post hoc* (the step returned, just
    slowly). A hang never returns, so it cannot be detected here — the
    supervisor must bound the step's wall time externally
    (``asyncio.wait_for`` in the serving layer) using
    ``hang_threshold_s`` and report the kill via :meth:`flag_hang`.
    """
    straggler_factor: float = 3.0
    name: Optional[str] = None
    min_samples: int = 5
    #: wall-time bound a supervisor applies to one step/segment; None
    #: disables hang detection (nothing in this class sleeps or waits)
    hang_threshold_s: Optional[float] = None
    _t0: Optional[float] = None
    stragglers: int = 0
    hangs: int = 0

    def __post_init__(self):
        if self.name is None:
            self.name = f"wd{next(_WD_IDS)}"

    @property
    def histogram(self) -> Histogram:
        """The step-time samples (seconds) of this watchdog."""
        return default_registry().histogram("watchdog.step_seconds",
                                            watchdog=self.name)

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> float:
        dt = time.monotonic() - self._t0
        h = self.histogram
        h.record(dt)
        if (h.count > self.min_samples
                and dt > self.straggler_factor * h.percentile(0.5)):
            self.stragglers += 1
            default_registry().counter("watchdog.stragglers",
                                       watchdog=self.name).inc()
        return dt

    def flag_hang(self) -> None:
        """Record a supervisor-detected hang (the step exceeded
        ``hang_threshold_s`` and was abandoned/killed)."""
        self.hangs += 1
        default_registry().counter("watchdog.hangs",
                                   watchdog=self.name).inc()

    @property
    def median(self) -> float:
        return self.histogram.percentile(0.5)


class PreemptionHandler:
    """SIGTERM -> request a final checkpoint and a clean exit.

    Installing replaces the process's SIGTERM/SIGUSR1 handlers; the
    originals are kept and restored by :meth:`uninstall` (also the
    context-manager exit), so a scoped handler — one serve() call, one
    test — cannot leak its trap into the rest of the process.

    Handlers NEST: when the serving layer has one installed and an
    elastic distributed run installs another, the inner handler chains
    delivery to the saved outer handler (both see the signal), and
    :meth:`uninstall` restores a signal only while this instance's trap
    is still the live one — an out-of-order uninstall (outer first)
    leaves the inner trap untouched instead of clobbering it (the outer
    instance forfeits its restore; the inner's eventual uninstall
    re-installs the outer's trap function, which is harmless: it only
    sets a flag on the already-dismissed outer instance).
    """

    _SIGNALS = (signal.SIGTERM, signal.SIGUSR1)

    def __init__(self, install: bool = True):
        self.requested = False
        # ONE bound-method object: `self._handler` creates a fresh
        # bound method per attribute access, so the is-our-trap-live
        # identity check in uninstall() needs a stable reference
        self._trap = self._handler
        self._previous: List[Tuple[int, object]] = []
        if install:
            self.install()

    def install(self) -> None:
        if self._previous:
            return  # already installed
        for sig in self._SIGNALS:
            try:
                prev = signal.signal(sig, self._trap)
            except ValueError:
                break  # not the main thread (tests)
            self._previous.append((sig, prev))

    def uninstall(self) -> None:
        """Restore the signal handlers that were active before
        :meth:`install` (no-op if never installed). A signal whose live
        handler is no longer ours (a nested handler installed on top)
        is left alone — see the class docstring."""
        while self._previous:
            sig, prev = self._previous.pop()
            try:
                if signal.getsignal(sig) is not self._trap:
                    continue  # nested handler on top: don't clobber it
                signal.signal(sig, prev)
            except (ValueError, TypeError):
                pass

    def __enter__(self) -> "PreemptionHandler":
        return self

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    def _handler(self, signum, frame):
        self.requested = True
        # chain to the handler we displaced so an outer
        # PreemptionHandler (or any user trap) also sees the signal
        for sig, prev in self._previous:
            if sig == signum and callable(prev):
                prev(signum, frame)
                break

    def request(self):  # programmatic (tests / chaos)
        self.requested = True


# --------------------------------------------------------------- backoff
def backoff_delays(base_s: float = 0.05, cap_s: float = 1.0,
                   factor: float = 2.0, seed: int = 0
                   ) -> Iterator[float]:
    """Exponential backoff with deterministic full jitter.

    Yields ``uniform(base/2, base) * factor**attempt`` capped at
    ``cap_s``, from a private ``random.Random(seed)`` — two supervisors
    with the same seed sleep the same schedule (testable), two with
    different seeds decorrelate (no thundering-herd retry alignment).
    """
    rng = random.Random(seed)
    attempt = 0
    while True:
        raw = min(cap_s, base_s * (factor ** attempt))
        yield raw * (0.5 + 0.5 * rng.random())
        attempt += 1


def run_with_restarts(make_run: Callable[[], int], max_restarts: int = 3,
                      backoff_base_s: float = 0.05,
                      backoff_cap_s: float = 1.0,
                      backoff_seed: int = 0,
                      max_elapsed_s: Optional[float] = None,
                      _sleep: Callable[[float], None] = time.sleep) -> int:
    """Supervisor: call ``make_run`` (which resumes from the latest
    checkpoint internally) until it returns, restarting on failures.

    Returns the final step. ``make_run`` must be idempotent-from-
    checkpoint — with the stateless data pipeline and bit-exact restore
    this makes the whole trajectory restart-invariant (tested).

    Each restart sleeps an exponentially growing, deterministically
    jittered delay (:func:`backoff_delays`; ``backoff_base_s=0``
    restarts immediately). Gives up — re-raising the failure — after
    ``max_restarts`` restarts or once ``max_elapsed_s`` of wall time
    has passed (whichever comes first), so a crash-looping job cannot
    hold its resources forever.

    Restarts count on the default registry's ``fault.restarts`` counter
    (the process-lifetime total a supervisor dashboard wants); the
    per-invocation give-up bound is the delta against the counter value
    at entry. ``_sleep`` is injectable so tests can assert the delay
    schedule without waiting it out."""
    counter = default_registry().counter("fault.restarts")
    start = counter.value
    t0 = time.monotonic()
    delays = backoff_delays(backoff_base_s, backoff_cap_s,
                            seed=backoff_seed)
    while True:
        try:
            return make_run()
        except SimulatedFailure:
            counter.inc()
            if counter.value - start > max_restarts:
                raise
            if (max_elapsed_s is not None
                    and time.monotonic() - t0 >= max_elapsed_s):
                raise
            delay = next(delays)
            if delay > 0:
                _sleep(delay)


# --------------------------------------------------------- chaos harness
@dataclasses.dataclass
class Fault:
    """One scheduled fault. ``at_segment`` indexes the supervisor's
    monotone event counter — the service's global segment counter, or
    the elastic distributed runner's launch counter — so a chaos plan
    is reproducible run to run.

    Serving-layer kinds:
      * ``exception``  — raise :class:`InjectedFault` in the worker
        thread right before the segment's launches (the in-step crash
        class);
      * ``stall``      — sleep ``stall_s`` in the worker thread (past
        the watchdog hang threshold -> supervisor kills + restarts the
        engine);
      * ``preempt``    — deliver SIGTERM (``via_signal=True``, needs an
        installed handler) or call ``handler.request()`` directly: the
        service drains in-flight batches, checkpoints, sheds the rest;
      * ``corrupt``    — flip bytes in the newest checkpoint leaf of
        ``target_rid`` (or the next checkpoint saved) so the next
        restore must fall back to the previous intact step;
      * ``truncate``   — same, but truncate the leaf file instead.

    Shard-aware (distributed) kinds, fired at the elastic runner's
    :meth:`FaultInjector.in_launch` / :meth:`FaultInjector.corrupt_halo`
    hooks:
      * ``shard_exception`` — raise :class:`InjectedFault` on shard
        ``shard`` right before a fused launch (transient: the runner
        restores the newest intact checkpoint and retries);
      * ``shard_stall``     — sleep ``stall_s`` inside the launch (past
        the launch timeout -> the runner abandons the launch, rebuilds
        the engine, restores, retries);
      * ``device_loss``     — raise :class:`DeviceLostError` for shard
        ``shard`` (unrecoverable on the current shards: the runner
        performs an elastic reshard onto fewer devices);
      * ``halo_corrupt``    — poison the edge bands of shard ``shard``'s
        block tiles in the freshly-launched state (``band_rows`` rows
        per tile; 0 = the whole tile), simulating a damaged halo strip
        gather. Detection relies on the mask-discipline invariant
        (fractal-hole and padding cells must stay zero), which
        whole-tile poison always violates for a true fractal;
      * ``strip_drop``      — a neighbor strip send from shard ``shard``
        is lost in flight, aborting the p2p exchange: raises
        :class:`InjectedFault` at the launch hook (transient — the
        runner restores the newest intact checkpoint and relaunches,
        re-issuing the permutes);
      * ``strip_corrupt``   — a RECEIVED neighbor strip was damaged on
        the wire: poisons the top and bottom ``band_rows`` rows (the
        rows a neighbor's edge strip feeds; 0 = depth 1) of shard
        ``shard``'s tiles post-launch. Caught by the same dead-cell
        integrity check as ``halo_corrupt`` -> checkpoint restore,
        bit-exact on either exchange path.
    """

    kind: str
    at_segment: int = 0
    stall_s: float = 0.0
    via_signal: bool = False
    target_rid: Optional[str] = None
    shard: int = 0
    band_rows: int = 0
    fired: bool = False

    _KINDS = ("exception", "stall", "preempt", "corrupt", "truncate",
              "shard_exception", "shard_stall", "device_loss",
              "halo_corrupt", "strip_drop", "strip_corrupt")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {self._KINDS}")


class FaultInjector:
    """Chaos harness: a scripted plan of :class:`Fault`\\ s fired at the
    serving layer's and the elastic distributed runner's hook points.

    The service calls three hooks:

      * :meth:`in_step` — from the WORKER thread, immediately before a
        segment's dispatch (exception / stall fire here, so a stall
        really does block the step the watchdog is timing);
      * :meth:`at_boundary` — from the scheduler, between segments
        (preempt fires here; a real SIGTERM round-trips through the
        installed :class:`PreemptionHandler`);
      * :meth:`on_checkpoint` — after every durable checkpoint save
        (corrupt / truncate damage the just-written files on disk).

    The elastic distributed runner adds two (its launch counter plays
    the role of the segment index):

      * :meth:`in_launch` — right before a fused launch's dispatch
        (shard_stall / device_loss / shard_exception fire here);
      * :meth:`corrupt_halo` — on the shards of a freshly launched
        state (halo_corrupt poisons one shard's tiles).

    Every fired fault appends ``(segment, kind, detail)`` to ``.log``
    and counts ``chaos.injected{kind=...}`` on the default registry, so
    a chaos run's injected-vs-recovered arithmetic is checkable from
    telemetry alone.

    Thread safety: hooks fire concurrently from the serving layer's
    executor threads (and the elastic runner's launch threads). The
    fire-once claim — scan for due faults, mark them fired, log, count
    — is atomic under an internal lock, so a fault scheduled once fires
    exactly once no matter how many threads hit its hook in the same
    segment. Side effects (sleeping, raising, damaging files) run
    outside the lock.
    """

    def __init__(self, faults: Sequence[Fault] = (),
                 handler: Optional[PreemptionHandler] = None):
        self.faults = list(faults)
        self.handler = handler
        self.log: List[Tuple[int, str, str]] = []
        self._lock = threading.Lock()

    def _claim(self, segment: int, kinds: Tuple[str, ...],
               pred: Optional[Callable[[Fault], bool]] = None
               ) -> List[Fault]:
        """Atomically claim (mark fired) every due fault of ``kinds``.
        The caller records and executes each claimed fault's effect
        outside the lock."""
        with self._lock:
            due = [f for f in self.faults
                   if not f.fired and f.kind in kinds
                   and f.at_segment <= segment
                   and (pred is None or pred(f))]
            for f in due:
                f.fired = True
            return due

    def _record(self, fault: Fault, segment: int,
                detail: str = "") -> None:
        with self._lock:
            self.log.append((segment, fault.kind, detail))
        default_registry().counter("chaos.injected",
                                   kind=fault.kind).inc()

    # ------------------------------------------------------------- hooks
    def in_step(self, segment: int) -> None:
        """Worker-thread hook, right before the segment's dispatch."""
        for f in self._claim(segment, ("stall",)):
            self._record(f, segment, f"stall {f.stall_s}s")
            time.sleep(f.stall_s)
        for f in self._claim(segment, ("exception",)):
            self._record(f, segment, "raise")
            raise InjectedFault(
                f"injected in-step failure at segment {segment}")

    def at_boundary(self, segment: int) -> None:
        """Scheduler hook, between segments (main thread)."""
        for f in self._claim(segment, ("preempt",)):
            self._record(f, segment,
                         "SIGTERM" if f.via_signal else "request()")
            if f.via_signal:
                os.kill(os.getpid(), signal.SIGTERM)
            elif self.handler is not None:
                self.handler.request()
            else:
                raise RuntimeError(
                    "preempt fault needs via_signal=True or a handler")

    def on_checkpoint(self, rid: str, path: str, segment: int = 0) -> None:
        """Post-save hook: damage the files of the checkpoint at
        ``path`` (a ``step_XXXXXXXX`` directory)."""
        pred = (lambda f: f.target_rid is None or f.target_rid == rid)
        for f in self._claim(segment, ("corrupt", "truncate"), pred):
            n = damage_checkpoint(path, mode=f.kind)
            self._record(f, segment, f"{f.kind} {n} file(s) in {path}")

    # ------------------------------------------- distributed chaos hooks
    def in_launch(self, launch: int) -> None:
        """Elastic-runner hook, right before a fused launch's dispatch
        (runs inside the launch thread, so a stall really blocks the
        launch the timeout watchdog is bounding)."""
        for f in self._claim(launch, ("shard_stall",)):
            self._record(f, launch, f"stall {f.stall_s}s")
            time.sleep(f.stall_s)
        for f in self._claim(launch, ("device_loss",)):
            self._record(f, launch, f"device lost on shard {f.shard}")
            raise DeviceLostError(
                f"injected device loss on shard {f.shard} "
                f"at launch {launch}", shard=f.shard)
        for f in self._claim(launch, ("shard_exception",)):
            self._record(f, launch, f"raise on shard {f.shard}")
            raise InjectedFault(
                f"injected shard failure on shard {f.shard} "
                f"at launch {launch}")
        for f in self._claim(launch, ("strip_drop",)):
            self._record(f, launch,
                         f"dropped neighbor strip from shard {f.shard}")
            raise InjectedFault(
                f"injected dropped neighbor-strip send from shard "
                f"{f.shard} at launch {launch}: halo exchange aborted")

    def corrupt_halo(self, launch: int, shards):
        """Post-launch hook: poison the edge bands of the due faults'
        target shards in the distributed engine's freshly launched tuple
        of shard tensors (last three axes (nb_local, rho, rho)). Returns
        ``(shards, poisoned)`` — the original tuple untouched when no
        halo_corrupt fault is due; a target past the last shard poisons
        nothing."""
        due = self._claim(launch, ("halo_corrupt", "strip_corrupt"))
        if not due:
            return shards, False
        shards = list(shards)
        for f in due:
            if f.shard >= len(shards):
                self._record(f, launch, f"no shard {f.shard}")
                continue
            blocks = shards[f.shard].clone()
            if f.kind == "strip_corrupt":
                # a damaged neighbor strip feeds the receiving blocks'
                # outermost rows: poison both row bands of the shard
                rows = max(1, f.band_rows)
                blocks[..., :rows, :] = 127
                blocks[..., -rows:, :] = 127
                detail = (f"poisoned {rows} strip band row(s) of "
                          f"shard {f.shard}'s tiles")
            else:
                rows = f.band_rows if f.band_rows > 0 \
                    else blocks.shape[-2]
                blocks[..., :rows, :] = 127
                detail = (f"poisoned {rows} row(s) of shard "
                          f"{f.shard}'s tiles")
            shards[f.shard] = blocks
            self._record(f, launch, detail)
        return tuple(shards), True

    # ----------------------------------------------------------- queries
    def pending(self) -> List[Fault]:
        with self._lock:
            return [f for f in self.faults if not f.fired]

    def all_fired(self) -> bool:
        return not self.pending()


def damage_checkpoint(path: str, mode: str = "corrupt") -> int:
    """Corrupt (bit-flip) or truncate every ``.npy`` leaf under the
    checkpoint directory ``path``. Returns the number of files damaged.
    Used by the chaos harness and directly by tests."""
    damaged = 0
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".npy"):
            continue
        fp = os.path.join(path, fn)
        if mode == "truncate":
            size = os.path.getsize(fp)
            with open(fp, "r+b") as f:
                f.truncate(max(0, size // 2))
        else:
            with open(fp, "r+b") as f:
                f.seek(-1, os.SEEK_END)
                last = f.read(1)
                f.seek(-1, os.SEEK_END)
                f.write(bytes([last[0] ^ 0xFF]))
        damaged += 1
    return damaged
