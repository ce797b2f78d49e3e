"""Exporters for the telemetry registry: JSONL event log, Prometheus
text format, and the human ``report()`` table.

  * JSONL — one JSON object per line (counters/gauges/histograms, then
    completed span trees). ``load_jsonl`` round-trips the metrics back
    into a fresh ``MetricsRegistry`` (asserted by the tests), so the
    event log doubles as a snapshot format.
  * Prometheus — ``# TYPE``-annotated text exposition (histograms as
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count``), scrapeable
    as-is.
  * ``report()`` — one aligned row per metric (counters/gauges: value;
    histograms: count / mean / p50 / p95 / max), the "where did this
    run spend its time, bytes and collectives" answer in one call.
"""
from __future__ import annotations

import json
import re
from typing import List, Optional

from repro_torch.obs import trace as _trace
from repro_torch.obs.registry import (Histogram, MetricsRegistry,
                                default_registry)

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _reg(registry: Optional[MetricsRegistry]) -> MetricsRegistry:
    return default_registry() if registry is None else registry


# ------------------------------------------------------------------ JSONL
def to_jsonl(registry: Optional[MetricsRegistry] = None,
             include_spans: bool = True) -> str:
    """One JSON object per line: every metric snapshot, then every
    completed root span tree."""
    lines = [json.dumps(m.snapshot(), sort_keys=True)
             for m in _reg(registry).metrics()]
    if include_spans:
        lines += [json.dumps(s.snapshot(), sort_keys=True)
                  for s in _trace.spans()]
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(path: str,
                registry: Optional[MetricsRegistry] = None,
                include_spans: bool = True) -> str:
    with open(path, "w") as f:
        f.write(to_jsonl(registry, include_spans=include_spans))
    return path


def load_jsonl(text: str) -> MetricsRegistry:
    """Rebuild a registry from a JSONL dump (span lines are ignored —
    spans are events, not state). Metric values round-trip exactly."""
    reg = MetricsRegistry()
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        d = json.loads(line)
        kind, labels = d.get("type"), d.get("labels", {})
        if kind == "counter":
            reg.counter(d["name"], **labels).inc(d["value"])
        elif kind == "gauge":
            reg.gauge(d["name"], **labels).set(d["value"])
        elif kind == "histogram":
            h = reg.histogram(d["name"], buckets=d["bounds"], **labels)
            h.bucket_counts = list(d["bucket_counts"])
            h.count = d["count"]
            h.sum = d["sum"]
            h.min = d["min"]
            h.max = d["max"]
    return reg


# ------------------------------------------------------------- Prometheus
def _prom_name(name: str, prefix: str) -> str:
    return prefix + _PROM_BAD.sub("_", name)


def _prom_labels(labels: dict, extra: str = "") -> str:
    parts = [f'{_PROM_BAD.sub("_", k)}="{v}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def to_prometheus(registry: Optional[MetricsRegistry] = None,
                  prefix: str = "squeeze_") -> str:
    """Prometheus text exposition of every metric in the registry."""
    out: List[str] = []
    seen_types = set()
    for m in _reg(registry).metrics():
        name = _prom_name(m.name, prefix)
        if name not in seen_types:
            seen_types.add(name)
            out.append(f"# TYPE {name} {m.kind}")
        if isinstance(m, Histogram):
            cum = 0
            snap = m.snapshot()
            for le, c in zip(list(snap["bounds"]) + ["+Inf"],
                             snap["bucket_counts"]):
                cum += c
                out.append(f"{name}_bucket"
                           + _prom_labels(m.labels_dict, f'le="{le}"')
                           + f" {cum}")
            out.append(f"{name}_sum{_prom_labels(m.labels_dict)}"
                       f" {snap['sum']}")
            out.append(f"{name}_count{_prom_labels(m.labels_dict)}"
                       f" {snap['count']}")
        else:
            out.append(f"{name}{_prom_labels(m.labels_dict)} {m.value}")
    return "\n".join(out) + ("\n" if out else "")


# ----------------------------------------------------------------- report
def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def report(registry: Optional[MetricsRegistry] = None) -> str:
    """Aligned text table of every metric, sorted by name — counters and
    gauges as one value, histograms as count/mean/p50/p95/max."""
    rows = []
    for m in sorted(_reg(registry).metrics(),
                    key=lambda m: (m.name, m.labels)):
        series = m.name + (
            "{" + ",".join(f"{k}={v}" for k, v in m.labels) + "}"
            if m.labels else "")
        if isinstance(m, Histogram):
            val = (f"count={m.count} mean={_fmt(m.mean)} "
                   f"p50={_fmt(m.percentile(0.5))} "
                   f"p95={_fmt(m.percentile(0.95))} max={_fmt(m.max)}")
        else:
            val = _fmt(m.value)
        rows.append((m.kind, series, val))
    if not rows:
        return "(telemetry: no metrics recorded)"
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    return "\n".join(f"{k:<{w0}}  {s:<{w1}}  {v}" for k, s, v in rows)
