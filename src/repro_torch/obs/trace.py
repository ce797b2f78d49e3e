"""Wall-time span trees + Chrome-trace/Perfetto export.

``Span`` is a context manager recording ``perf_counter`` wall time; the
per-thread span stack links nested spans into a tree, and completed ROOT
spans accumulate in a bounded module buffer (``spans()``) from which
``chrome_trace()`` emits the Chrome ``traceEvents`` JSON that
chrome://tracing and Perfetto load directly.

Every span also enters a ``torch.profiler.record_function`` of its name,
so Squeeze spans show up on the timeline of a ``torch.profiler`` capture
on the card, beside the kernels they launch.

The *gated* entry point is ``repro_torch.obs.span`` — it returns a shared
null context manager when telemetry is disabled, so tracing costs one
bool check on disabled hot paths. Constructing a ``Span`` directly is
always live.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Tuple

from torch.profiler import record_function

#: completed root spans kept for export (bounded: a long-lived serving
#: process must not leak spans — oldest roots are dropped past the cap)
MAX_ROOT_SPANS = 4096

_roots: List["Span"] = []
_roots_lock = threading.Lock()
_local = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class Span:
    """One timed region; nests via the per-thread span stack."""

    __slots__ = ("name", "attrs", "t0_us", "dur_us", "children",
                 "_tid", "_ann")

    def __init__(self, name: str, attrs: Optional[dict] = None):
        self.name = name
        self.attrs = dict(attrs or {})
        self.t0_us: float = 0.0
        self.dur_us: float = 0.0
        self.children: List["Span"] = []
        self._tid = threading.get_ident()
        self._ann = None

    def __enter__(self) -> "Span":
        self._ann = record_function(self.name)
        self._ann.__enter__()
        _stack().append(self)
        self.t0_us = time.perf_counter() * 1e6
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_us = time.perf_counter() * 1e6 - self.t0_us
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        if self._ann is not None:
            self._ann.__exit__(*exc)
            self._ann = None
        if st:
            st[-1].children.append(self)
        else:
            with _roots_lock:
                _roots.append(self)
                if len(_roots) > MAX_ROOT_SPANS:
                    del _roots[: len(_roots) - MAX_ROOT_SPANS]
        return False

    # ------------------------------------------------------------- export
    def walk(self):
        """Depth-first iteration over this span and its subtree."""
        yield self
        for c in self.children:
            yield from c.walk()

    def snapshot(self) -> dict:
        return {"type": "span", "name": self.name, "attrs": self.attrs,
                "ts_us": self.t0_us, "dur_us": self.dur_us,
                "children": [c.snapshot() for c in self.children]}


def current_span() -> Optional[Span]:
    """The innermost open span on this thread (None outside any span)."""
    st = _stack()
    return st[-1] if st else None


def spans() -> Tuple[Span, ...]:
    """Completed root spans, oldest first."""
    with _roots_lock:
        return tuple(_roots)


def reset_spans() -> None:
    with _roots_lock:
        _roots.clear()


def chrome_trace() -> dict:
    """Chrome ``traceEvents`` JSON (complete 'X' events, us timestamps)
    — load in chrome://tracing or ui.perfetto.dev."""
    pid = os.getpid()
    events = []
    for root in spans():
        for s in root.walk():
            events.append({
                "name": s.name, "ph": "X", "pid": pid, "tid": s._tid,
                "ts": s.t0_us, "dur": s.dur_us, "args": s.attrs,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(), f)
    return path
