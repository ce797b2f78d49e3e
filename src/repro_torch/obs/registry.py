"""Metrics substrate: counters, gauges, bucketed histograms, and the
process-wide default ``MetricsRegistry`` (the reference's
``obs/registry.py``, kept name for name so both packages export the same
text for the same calls).

Design constraints:

  * dependency-free — stdlib only;
  * label-aware — a metric's identity is ``(name, sorted labels)``, so
    ``registry.counter("runner.cache.hit", kind="block")`` and the same
    name with ``kind="dist-fused"`` are distinct series, exactly as in
    Prometheus;
  * cheap when disabled — the enabled flag lives HERE (module state,
    initialized from ``SQUEEZE_TELEMETRY``) and the gated helpers in
    ``repro_torch.obs`` are a bool check + early return, so instrumented
    hot paths cost one function call when telemetry is off;
  * thread-safe — the checkpoint manager records from its async writer
    thread and the service from its worker threads; every mutation takes
    the owning registry's lock.

Histograms are bucketed (default: powers of two spanning ~1us .. ~1e9,
so one bucket family serves seconds, batch sizes, step counts and byte
volumes); ``percentile`` interpolates linearly inside the landing
bucket and clamps to the observed min/max.
"""
from __future__ import annotations

import bisect
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

#: label set folded into a metric's identity: sorted (key, value) pairs,
#: values stringified (JSON/Prometheus exporters need strings anyway)
Labels = Tuple[Tuple[str, str], ...]

#: default histogram bucket upper bounds: powers of two from 2^-20
#: (~1e-6 — microsecond latencies land mid-range) to 2^30 (~1e9 —
#: byte volumes and big step counts still resolve); +Inf is implicit
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(
    float(2.0 ** i) for i in range(-20, 31))


def _labels_key(labels: Dict[str, object]) -> Labels:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared identity plumbing of the three metric types."""

    __slots__ = ("name", "labels", "_lock")
    kind = "?"

    def __init__(self, name: str, labels: Labels,
                 lock: threading.RLock):
        self.name = name
        self.labels = labels
        self._lock = lock

    @property
    def labels_dict(self) -> Dict[str, str]:
        return dict(self.labels)

    def _head(self) -> dict:
        return {"type": self.kind, "name": self.name,
                "labels": self.labels_dict}


class Counter(_Metric):
    """Monotonically increasing count (int or float increments)."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self.value = 0

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n

    def reset(self) -> None:
        with self._lock:
            self.value = 0

    def snapshot(self) -> dict:
        return dict(self._head(), value=self.value)


class Gauge(_Metric):
    """Last-written value (set/add semantics)."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self.value = 0

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def add(self, dv) -> None:
        with self._lock:
            self.value += dv

    def reset(self) -> None:
        with self._lock:
            self.value = 0

    def snapshot(self) -> dict:
        return dict(self._head(), value=self.value)


class Histogram(_Metric):
    """Bucketed distribution: fixed upper bounds + an overflow bucket.

    ``bucket_counts[i]`` counts samples with ``bounds[i-1] < v <=
    bounds[i]`` (the last slot is the +Inf overflow); ``count``/``sum``/
    ``min``/``max`` track the exact aggregate alongside.
    """

    __slots__ = ("bounds", "bucket_counts", "count", "sum", "min", "max")
    kind = "histogram"

    def __init__(self, name, labels, lock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, labels, lock)
        bounds = tuple(sorted(buckets)) if buckets else DEFAULT_BUCKETS
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        self.bucket_counts = [0] * (len(bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None

    def record(self, v) -> None:
        v = float(v)
        with self._lock:
            self.bucket_counts[bisect.bisect_left(self.bounds, v)] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Bucket-interpolated q-quantile (q in [0, 1]), clamped to the
        observed [min, max] — exact enough for p50/p95 straggler logic
        without keeping samples."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            cum = 0.0
            for i, c in enumerate(self.bucket_counts):
                if not c:
                    continue
                if cum + c >= target:
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    hi = (self.bounds[i] if i < len(self.bounds)
                          else self.max)
                    frac = (target - cum) / c
                    v = lo + (hi - lo) * frac
                    return min(max(v, self.min), self.max)
                cum += c
            return self.max

    def reset(self) -> None:
        with self._lock:
            self.bucket_counts = [0] * (len(self.bounds) + 1)
            self.count = 0
            self.sum = 0.0
            self.min = None
            self.max = None

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                self._head(), count=self.count, sum=self.sum,
                min=self.min, max=self.max, bounds=list(self.bounds),
                bucket_counts=list(self.bucket_counts))


class MetricsRegistry:
    """Get-or-create registry of labeled metrics.

    ``counter``/``gauge``/``histogram`` return the existing instance for
    an already-seen ``(name, labels)`` (so call sites never cache metric
    handles unless they are hot); requesting an existing name with a
    different metric type raises. ``reset`` zeroes every metric in place
    — handles stay valid, which is what the test-suite fixtures and
    long-lived engines need.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: "OrderedDict[Tuple[str, Labels], _Metric]" = \
            OrderedDict()

    def _get_or_create(self, cls, name: str, labels: Dict[str, object],
                       **kw) -> _Metric:
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, key[1], self._lock, **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r}{dict(key[1])} already registered "
                    f"as {m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels,
                                   buckets=buckets)

    # ------------------------------------------------------------ queries
    def get(self, name: str, **labels) -> Optional[_Metric]:
        """The metric at ``(name, labels)``, or None (never creates)."""
        return self._metrics.get((name, _labels_key(labels)))

    def value(self, name: str, **labels):
        """Counter/gauge value at ``(name, labels)``; None if absent."""
        m = self.get(name, **labels)
        return getattr(m, "value", None) if m is not None else None

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """JSON-able dump grouped by metric type."""
        out = {"counters": [], "gauges": [], "histograms": []}
        for m in self.metrics():
            out[m.kind + "s"].append(m.snapshot())
        return out

    def reset(self) -> None:
        """Zero every metric in place (handles stay valid)."""
        for m in self.metrics():
            m.reset()


# --------------------------------------------------------- process state
#: falsy spellings of SQUEEZE_TELEMETRY (anything else enables)
_FALSY = ("", "0", "off", "false", "no", "none")


def parse_env(value: Optional[str]) -> bool:
    """SQUEEZE_TELEMETRY semantics: unset/0/off/false/no/none disable;
    any other value (1/on/comma-separated flags) enables."""
    return (value or "").strip().lower() not in _FALSY


_ENABLED: bool = parse_env(os.environ.get("SQUEEZE_TELEMETRY"))
_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def enabled() -> bool:
    """Is telemetry collection on? (The single gate every instrumented
    call site checks — see ``repro_torch.obs``.)"""
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def disable() -> None:
    enable(False)


def default_registry() -> MetricsRegistry:
    """The process-wide registry (a serving process wants exactly one)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT
