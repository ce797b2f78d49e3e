"""Unified telemetry for the Squeeze port: metrics, spans, exporters.

One import serves every instrumented call site::

    from repro_torch import obs

    obs.inc("runner.cache.hit", kind="block")       # counter
    obs.set_gauge("engine.memory_bytes", n, kind=k) # gauge
    obs.observe("runner.run.seconds", dt, kind=k)   # histogram sample
    with obs.span("runner.run", kind=k):            # wall-time tree
        ...

Collection is OPT-IN: the ``SQUEEZE_TELEMETRY`` environment variable
("", "0", "off", "false", "no", "none" -> disabled; anything else ->
enabled) or ``obs.enable()`` / ``obs.disable()`` at runtime. When
disabled, every helper above is a bool check + early return and
``span`` returns a shared null context manager.

Everything lands on the process-wide ``default_registry()`` (pass
``registry=`` to the exporters for a private one). Read it back with
``obs.report()`` (pretty table), ``obs.to_jsonl()`` / ``write_jsonl``
(event log, round-trips via ``load_jsonl``), ``obs.to_prometheus()``
(scrape text), or ``obs.chrome_trace()`` / ``write_chrome_trace``
(span trees for chrome://tracing / Perfetto; every span also enters a
``torch.profiler.record_function``, so it shows on a profiler capture).
The names, labels, buckets and export text are the reference package's.

``SQUEEZE_TELEMETRY_DUMP=<path>`` registers an atexit hook that writes
the final JSONL snapshot.

What the instrumented modules record (the reference's names):

  * ``workloads/runner.py``: ``runner.cache.{hit,miss,evict,invalidate}``,
    ``runner.build``, ``runner.runs``, the ``runner.run`` span and the
    ``runner.run.seconds`` (host time of the call, which returns before
    the card finishes), ``runner.batch_size`` and ``runner.steps``
    histograms;
  * ``core/stencil.py``: ``engine.{builds,runs,steps,fused_launches,
    single_steps}`` and the ``engine.memory_bytes`` gauge;
  * ``core/distributed.py``: ``dist.{collectives,bytes_gathered,
    bytes_permuted,neighbor_sends,steps}``, ``engine.fused_launches`` and
    the ``dist.run`` span;
  * every kernel wrapper: ``kernel.entry{op=...}``, one a call;
  * ``tuning/table.py``: ``engine.tune.{hit,miss,fallback}``, one a table
    consult of ``EngineSpec.normalize()``;
  * ``checkpoint/``, ``runtime/fault.py``, ``serving/`` and
    ``core/elastic.py``: the ``checkpoint.*``, ``watchdog.*``,
    ``fault.restarts``, ``chaos.injected``, ``serve.*`` and ``dist.*``
    recovery series.

Three reference series have no counterpart, because they count what only
``jax.jit`` and buffer donation do: ``runner.trace`` and ``engine.trace``
(retraces) and ``runner.donated_runs`` / ``engine.donated_runs``.
"""
from __future__ import annotations

import atexit
import os
import time
from contextlib import contextmanager

from repro_torch.obs.registry import (  # noqa: F401  (public re-exports)
    DEFAULT_BUCKETS, Counter, Gauge, Histogram, MetricsRegistry,
    default_registry, disable, enable, enabled, parse_env)
from repro_torch.obs.trace import (  # noqa: F401
    Span, chrome_trace, current_span, reset_spans, spans,
    write_chrome_trace)
from repro_torch.obs.export import (  # noqa: F401
    load_jsonl, report, to_jsonl, to_prometheus, write_jsonl)


# ------------------------------------------------- gated fast-path helpers
def inc(name: str, n=1, **labels) -> None:
    """Increment a counter on the default registry (no-op if disabled)."""
    if enabled():
        default_registry().counter(name, **labels).inc(n)


def set_gauge(name: str, value, **labels) -> None:
    """Set a gauge on the default registry (no-op if disabled)."""
    if enabled():
        default_registry().gauge(name, **labels).set(value)


def observe(name: str, value, **labels) -> None:
    """Record a histogram sample on the default registry (no-op if
    disabled)."""
    if enabled():
        default_registry().histogram(name, **labels).record(value)


class _NullCtx:
    """Shared no-op context manager: the disabled-mode ``span``/``timed``
    return value (no allocation on the hot path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullCtx()


def span(name: str, **attrs):
    """A live ``Span`` when telemetry is enabled, the shared null
    context manager otherwise."""
    if not enabled():
        return _NULL
    return Span(name, attrs)


class _Timed:
    __slots__ = ("_name", "_labels", "_t0")

    def __init__(self, name, labels):
        self._name = name
        self._labels = labels

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        default_registry().histogram(
            self._name, **self._labels).record(
                time.perf_counter() - self._t0)
        return False


def timed(name: str, **labels):
    """Context manager recording elapsed seconds into a histogram
    (no-op if disabled)."""
    if not enabled():
        return _NULL
    return _Timed(name, labels)


def reset() -> None:
    """Zero every default-registry metric in place and drop completed
    spans (metric handles stay valid — safe mid-run)."""
    default_registry().reset()
    reset_spans()


@contextmanager
def enabled_scope(on: bool = True):
    """Temporarily force telemetry on/off (tests; restores on exit)."""
    prev = enabled()
    enable(on)
    try:
        yield default_registry()
    finally:
        enable(prev)


# ------------------------------------------------------------ atexit dump
_DUMP_PATH = os.environ.get("SQUEEZE_TELEMETRY_DUMP")
if _DUMP_PATH:  # pragma: no cover - exercised in subprocesses
    def _dump_at_exit(path=_DUMP_PATH):
        try:
            write_jsonl(path)
        except Exception:
            pass  # never fail interpreter shutdown over telemetry

    atexit.register(_dump_at_exit)
