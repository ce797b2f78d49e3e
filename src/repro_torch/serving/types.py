"""Request/response types, service configuration, admission control and
the circuit breaker for the fractal-simulation service.

Kept free of ``service.py``'s asyncio machinery so tests can construct
and inspect these without touching the event loop.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import TYPE_CHECKING, Any, Hashable, List, Optional, Tuple

from repro_torch.workloads.base import StencilWorkload
from repro_torch.workloads.rules import LIFE

if TYPE_CHECKING:  # annotation-only
    from repro_torch.tuning.spec import EngineSpec

_RIDS = itertools.count()


def _next_rid() -> str:
    return f"req{next(_RIDS)}"


@dataclasses.dataclass
class SimRequest:
    """One fractal-simulation job.

    ``rid`` doubles as the durable identity: a request resubmitted with
    the same ``rid`` after a preemption resumes from its newest intact
    checkpoint instead of step 0. ``snapshot_every`` is both the
    user-visible yield cadence and the recovery granularity (a fault
    loses at most ``snapshot_every`` steps of recompute).
    ``n_shards`` is the shard count of a ``dist-*`` kind (None: one shard
    per visible card), a field the reference lacks: its dist kinds take
    every device of the process's mesh.
    """

    frac: Hashable                     # NBBFractal (hashable)
    r: int
    steps: int
    workload: StencilWorkload = LIFE
    m: int = 0
    kind: str = "block"
    k: Optional[int] = None            # fusion depth (None = heuristic)
    seed: int = 0
    snapshot_every: int = 0            # 0 = final state only
    deadline_s: Optional[float] = None
    n_shards: Optional[int] = None
    rid: str = dataclasses.field(default_factory=_next_rid)

    def __post_init__(self):
        if self.steps < 1:
            raise ValueError("steps must be >= 1")
        if self.snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0")

    @property
    def bucket(self) -> "EngineSpec":
        """Engine-compatibility key: the NORMALIZED
        :class:`repro_torch.tuning.spec.EngineSpec` of this request — the
        same object the BatchedRunner LRU keys on, so requests batch
        together exactly when they would share one engine (alias kinds,
        an explicit ``k`` equal to the resolved default, etc. all
        collapse). Computed once per request (the tuning-table consult
        and its ``engine.tune.*`` counter happen at first access);
        mutating the identity fields afterwards does not re-bucket."""
        b = self.__dict__.get("_bucket")
        if b is None:
            from repro_torch.tuning.spec import EngineSpec
            b = EngineSpec.from_args(
                self.kind, self.frac, self.r, self.m, self.workload,
                fusion_k=self.k, n_shards=self.n_shards).normalize()
            self.__dict__["_bucket"] = b
        return b


@dataclasses.dataclass
class SimResult:
    """Outcome of one request. ``status``:

    ``ok``        — ran to ``steps`` (``state`` is the final compact
                    state, host-side);
    ``timeout``   — deadline expired at a segment boundary;
    ``failed``    — retries exhausted on a persistent failure;
    ``preempted`` — drained mid-run (checkpointed at ``steps_done``;
                    resubmit with the same rid to resume);
    ``rejected``  — admission refused (queue full / breaker open /
                    draining); ``retry_after_s`` hints when to come
                    back.
    """

    rid: str
    status: str = "ok"
    state: Optional[Any] = None
    snapshots: List[Tuple[int, Any]] = dataclasses.field(
        default_factory=list)
    steps_done: int = 0
    latency_s: float = 0.0
    queue_wait_s: float = 0.0
    retries: int = 0
    recoveries: int = 0
    retry_after_s: Optional[float] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class AdmissionError(RuntimeError):
    """Raised by ``submit`` when a request is shed at the door
    (queue full, circuit breaker open, or the service is draining).
    Carries ``retry_after_s`` — reject-with-retry-after, not collapse."""

    def __init__(self, reason: str, retry_after_s: float):
        super().__init__(
            f"admission refused ({reason}); retry after "
            f"{retry_after_s:.2f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class ServiceConfig:
    """Knobs of :class:`repro_torch.serving.FractalService`."""

    # ---- admission / queueing
    max_queue: int = 64            # queued-but-unscheduled bound
    max_batch: int = 8             # rows per bucket batch
    max_inflight: int = 2          # concurrently running bucket batches
    compile_concurrency: int = 1   # concurrent cold engine builds
    default_deadline_s: float = 60.0
    retry_after_s: float = 0.5     # hint on queue-full rejections
    # ---- segments (continuous-batching granularity)
    max_segment_steps: int = 64    # hang-detection granularity bound
    # ---- retries / backoff on transient failures
    max_retries: int = 3
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 0.5
    backoff_seed: int = 0
    # ---- watchdog (hang detection on one segment's wall time)
    hang_threshold_s: float = 10.0
    #: wall-time allowance when a segment's batch shape has not run
    #: before (the first launch of a bucket pays the kernels' build at
    #: first use and the engine's device tables, which dwarf steady-state
    #: segments and must not read as a hang); also applies to the first
    #: launch after an engine restart (tables built again)
    compile_grace_s: float = 60.0
    # ---- circuit breaker
    breaker_threshold: int = 5     # consecutive failures to open
    breaker_cooldown_s: float = 1.0
    # ---- durability
    ckpt_dir: Optional[str] = None  # None: no durable snapshots
    keep_checkpoints: int = 3


class CircuitBreaker:
    """Consecutive-failure breaker: closed -> open after ``threshold``
    failures in a row; open sheds load for ``cooldown_s``; the first
    probe after cooldown (half-open) closes it on success or re-opens
    on failure. Time source injectable for tests."""

    def __init__(self, threshold: int = 5, cooldown_s: float = 1.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._half_open = False

    @property
    def state(self) -> str:
        if self._opened_at is None:
            return "half-open" if self._half_open else "closed"
        if self._clock() - self._opened_at >= self.cooldown_s:
            return "half-open"
        return "open"

    def allow(self) -> bool:
        """Admission check. In half-open, admits (the probe)."""
        s = self.state
        if s == "open":
            return False
        if s == "half-open" and self._opened_at is not None:
            # transition open -> half-open happens on first probe
            self._opened_at = None
            self._half_open = True
        return True

    def retry_after(self) -> float:
        if self._opened_at is None:
            return 0.0
        return max(0.0, self.cooldown_s
                   - (self._clock() - self._opened_at))

    def record_failure(self) -> None:
        self._failures += 1
        if self._half_open or self._failures >= self.threshold:
            self._opened_at = self._clock()
            self._half_open = False
            self._failures = 0

    def record_success(self) -> None:
        self._failures = 0
        self._half_open = False
        self._opened_at = None
