"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``: the same calls give the same export text (JSONL,
Prometheus, ``report``, the Chrome trace less its clock fields), the
runner records the same series call for call, and the port's own wiring
(engines, the distributed engine, the kernel wrappers, the watchdog,
restarts and checkpoints) counts what it ran.

Every test runs against reset default registries of both packages with
collection on, restoring the ambient enabled flags after.
"""
import json

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import fractals as rf
from repro.workloads import rules as rrules
from repro.workloads.runner import BatchedRunner as RefRunner
from repro_torch import obs
from repro_torch.core import fractals as tf
from repro_torch.core.compact import BlockLayout
from repro_torch.core.distributed import make_distributed_engine
from repro_torch.core.stencil import make_engine
from repro_torch.workloads import rules as trules
from repro_torch.workloads.runner import BatchedRunner

FRAC, RFRAC = tf.SIERPINSKI, rf.SIERPINSKI


@pytest.fixture
def reg():
    """Both default registries reset, telemetry on; yields the port's."""
    prev = (obs.enabled(), robs.enabled())
    for o in (obs, robs):
        o.enable(True)
        o.reset()
    try:
        yield obs.default_registry()
    finally:
        for o, was in zip((obs, robs), prev):
            o.reset()
            o.enable(was)


def _record(o, registry):
    """One script of metric calls, run on either package."""
    c = registry.counter("runner.cache.hit", kind="block")
    c.inc()
    c.inc(3)
    registry.counter("runner.cache.hit", kind="dist-fused").inc(2)
    registry.counter("c", y=2, x=1).inc(0.5)
    g = registry.gauge("engine.memory_bytes", kind="block")
    g.set(7)
    g.add(-2)
    registry.gauge("serve.queue_depth").set(2.5)
    h = registry.histogram("runner.run.seconds", kind="block")
    for v in (1e-7, 0.25, 0.5, 3.0, 1e12):
        h.record(v)
    registry.histogram("lat", buckets=(1.0, 10.0, 100.0)).record(42)
    registry.histogram("empty")


SCRIPTS = {
    "metrics": _record,
    "empty": lambda o, registry: None,
    "one counter": lambda o, registry: registry.counter("x").inc(),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
@pytest.mark.parametrize("exporter", ["jsonl", "prometheus", "report"])
def test_export_text_equals_reference(reg, script, exporter):
    mine, ref = obs.MetricsRegistry(), robs.MetricsRegistry()
    SCRIPTS[script](obs, mine)
    SCRIPTS[script](robs, ref)
    if exporter == "jsonl":
        got = obs.to_jsonl(mine, include_spans=False)
        want = robs.to_jsonl(ref, include_spans=False)
    elif exporter == "prometheus":
        got, want = obs.to_prometheus(mine), robs.to_prometheus(ref)
    else:
        got, want = obs.report(mine), robs.report(ref)
    assert got == want


def test_jsonl_round_trips_across_packages(reg):
    mine, ref = obs.MetricsRegistry(), robs.MetricsRegistry()
    _record(obs, mine)
    _record(robs, ref)
    assert obs.load_jsonl(robs.to_jsonl(ref)).snapshot() == mine.snapshot()
    assert robs.load_jsonl(obs.to_jsonl(mine)).snapshot() == ref.snapshot()


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.95, 1.0])
def test_histogram_percentiles_equal_reference(reg, q):
    mine = obs.MetricsRegistry().histogram("h")
    ref = robs.MetricsRegistry().histogram("h")
    for v in np.random.default_rng(0).lognormal(0, 3, 200):
        mine.record(v)
        ref.record(v)
    assert mine.percentile(q) == ref.percentile(q)


def test_chrome_trace_equals_reference_less_clocks(reg):
    def spans(o):
        o.reset_spans()
        with o.Span("outer", {"kind": "x"}):
            with o.Span("inner", {"steps": 3}):
                pass
            with o.Span("second"):
                pass
        events = o.chrome_trace()["traceEvents"]
        return [{k: v for k, v in e.items()
                 if k not in ("ts", "dur", "pid", "tid")} for e in events]
    assert spans(obs) == spans(robs)
    json.dumps(obs.chrome_trace())
    assert [c.name for c in obs.spans()[-1].children] == ["inner", "second"]


def test_span_shows_in_a_profiler_capture(reg):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("runner.run", kind="block"):
            torch.ones(4).sum()
    assert "runner.run" in {e.name for e in prof.events()}


def test_disabled_helpers_are_noops(reg):
    obs.enable(False)
    obs.inc("noop.c")
    obs.set_gauge("noop.g", 1)
    obs.observe("noop.h", 1.0)
    with obs.span("noop.s") as sp:
        assert sp is None
    with obs.timed("noop.t") as t:
        assert t is None
    assert all(reg.get(n) is None
               for n in ("noop.c", "noop.g", "noop.h", "noop.t"))
    assert obs.spans() == ()


def test_enabled_scope_and_env_parsing_match_reference(reg):
    obs.enable(False)
    with obs.enabled_scope():
        assert obs.enabled()
        obs.inc("c")
        with obs.timed("t.seconds", kind="x"):
            pass
    assert not obs.enabled() and reg.value("c") == 1
    assert reg.get("t.seconds", kind="x").count == 1
    for text in ("", "0", "off", "false", "no", "none", "OFF", None, "1",
                 "true", "yes", "on", "anything", " No "):
        assert obs.parse_env(text) == robs.parse_env(text), text


def test_type_collision_raises(reg):
    reg.counter("m")
    with pytest.raises(ValueError):
        reg.gauge("m")


def _series(registry):
    """Every ``runner.*`` series but the traces, the engine builds and
    memory gauges, and the ``engine.tune.*`` table consults: counters and
    gauges by value, histograms by count, sum (but the seconds), min and
    max."""
    out = {}
    for m in registry.metrics():
        if not (m.name.startswith(("runner.", "engine.tune.")) or m.name in (
                "engine.builds", "engine.memory_bytes")) or \
                m.name == "runner.trace":
            continue
        if m.name.startswith("engine.tune.") and m.value == 0:
            # reset() keeps a series at 0, and the table consults of
            # earlier tests in this process left each package other kinds
            continue
        key = (m.name, m.labels)
        if m.kind == "histogram":
            out[key] = ((m.count,) if m.name.endswith(".seconds")
                        else (m.count, m.sum, m.min, m.max))
        else:
            out[key] = m.value
    return out


def _drive(runner, frac, wls):
    """One script of runner calls, run on either package: misses, hits,
    a capacity-1 eviction, an invalidation, one not cached."""
    life, high = wls
    states = runner.init_batch("block", frac, 4, seeds=range(2), m=1,
                               workload=life)
    runner.run("block", frac, 4, states, steps=2, m=1, workload=life)
    runner.run("block", frac, 4, states, steps=5, m=1, workload=life)
    runner.engine_for("block", frac, 4, m=1, workload=life)
    runner.init_batch("block", frac, 4, seeds=[3], m=1, workload=high)
    runner.invalidate("block", frac, 4, m=1, workload=high)
    runner.invalidate("block", frac, 4, m=1, workload=life)


def test_runner_counters_match_reference_call_for_call(reg, monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # the reference's heuristic k
    _drive(BatchedRunner(capacity=1, device="cpu"), FRAC,
           (trules.LIFE, trules.HIGHLIFE))
    _drive(RefRunner(capacity=1), RFRAC, (rrules.LIFE, rrules.HIGHLIFE))
    mine = _series(reg)
    assert mine == _series(robs.default_registry())
    assert mine[("runner.cache.evict", ())] == 1
    assert mine[("runner.build", (("k", "2"), ("kind", "block"),
                                  ("workload", "life")))] == 1
    assert mine[("runner.runs", (("kind", "block"),))] == 2
    assert mine[("runner.cache.hit", (("kind", "block"),))] == 3
    assert mine[("runner.cache.invalidate", (("kind", "block"),))] == 1
    assert mine[("engine.builds", (("kind", "block"),))] == 2
    # one table consult a runner call (off: a fallback), none a build
    assert mine[("engine.tune.fallback", (("kind", "block"),))] == 7


def test_runner_spans_and_histograms(reg):
    runner = BatchedRunner(device="cpu")
    states = runner.init_batch("cuda-fused", FRAC, 4, [0, 1, 2], m=1)
    runner.run("cuda-fused", FRAC, 4, states, 5, m=1)
    assert reg.get("runner.batch_size", kind="cuda-fused").max == 3
    assert reg.get("runner.steps", kind="cuda-fused").sum == 5
    assert obs.spans()[-1].name == "runner.run"
    assert obs.spans()[-1].attrs == {"kind": "cuda-fused", "steps": 5}


@pytest.mark.parametrize("kind", ["block", "cuda-fused", "cuda-mxu"])
def test_engine_counters(reg, kind):
    """The block engines count as the reference's fused-stepping engines:
    one run of 7 steps at k=3 is 2 fused launches and 1 single step; the
    build counts once with its memory gauge."""
    eng = make_engine(kind, FRAC, 4, 2, workload=trules.LIFE, fusion_k=3,
                      device="cpu")
    assert reg.value("engine.builds", kind=kind) == 1
    assert reg.value("engine.memory_bytes", kind=kind) == \
        eng.memory_bytes(dtype_size=1) > 0
    eng.run(eng.init_random(0), 7)
    lbl = dict(engine=type(eng).__name__,
               variant=getattr(eng, "variant", ""))
    assert reg.value("engine.runs", **lbl) == 1
    assert reg.value("engine.steps", **lbl) == 7
    assert reg.value("engine.fused_launches", **lbl) == 2
    assert reg.value("engine.single_steps", **lbl) == 1


@pytest.mark.parametrize("exchange", ["p2p", "gather"])
def test_distributed_counters_match_exchange_stats(reg, exchange):
    eng = make_distributed_engine(BlockLayout(FRAC, 5, 2), n_shards=3,
                                  device="cpu", workload=trules.LIFE,
                                  compute="fused", fusion_k=2,
                                  exchange=exchange)
    eng.run(eng.init_random(0), 5)   # ceil(5/2) = 3 exchanges
    st = eng.exchange_stats()
    assert st.collectives == 3
    for name, want in (("dist.collectives", st.collectives),
                       ("dist.bytes_gathered", st.bytes_gathered),
                       ("dist.bytes_permuted", st.bytes_permuted),
                       ("dist.neighbor_sends", st.neighbor_sends),
                       ("dist.steps", 5)):
        assert reg.value(name, compute="fused") == want, name
    assert reg.value("engine.fused_launches",
                     engine="DistributedSqueezeEngine", variant="fused") == 3
    assert reg.value("kernel.entry", op="stencil_step_fused_k_local") >= 3
    root = obs.spans()[-1]
    assert root.name == "dist.run" and root.attrs["k"] == 2


def test_kernel_entry_counts_each_wrapper_call(reg):
    eng = make_engine("cuda-fused", FRAC, 4, 2, workload=trules.LIFE,
                      fusion_k=2, device="cpu")
    eng.run(eng.init_random(0), 7)     # 3 v4 launches and one v3 step
    assert reg.value("kernel.entry", op="stencil_step_fused_k") == 3
    assert reg.value("kernel.entry", op="stencil_step_fused") == 1
    cell = make_engine("cell", FRAC, 4, workload=trules.LIFE, device="cpu")
    cell.run(cell.init_random(0), 1)   # one lambda, 8 nu
    assert reg.value("kernel.entry", op="lambda_map_tc") == 1
    assert reg.value("kernel.entry", op="nu_map_tc") == 8


def test_watchdog_restarts_and_checkpoint_counters(reg, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.fault import (SimulatedFailure, Watchdog,
                                           run_with_restarts)
    a, b = Watchdog(min_samples=3), Watchdog()
    for _ in range(6):
        a.start_step()
        a.end_step()
    assert a.name != b.name and a.histogram.count == 6
    assert b.histogram.count == 0
    assert reg.get("watchdog.step_seconds", watchdog=a.name).count == 6
    calls = {"n": 0}

    def make_run():
        calls["n"] += 1
        if calls["n"] < 3:
            raise SimulatedFailure("boom")
        return 42
    assert run_with_restarts(make_run, max_restarts=3,
                             backoff_base_s=0) == 42
    assert reg.value("fault.restarts") == 2
    mgr = CheckpointManager(str(tmp_path / "ck"))
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    mgr.save(3, tree)
    mgr.restore(tree)
    assert reg.value("checkpoint.saves") == 1
    assert reg.value("checkpoint.restores") == 1
    assert reg.value("checkpoint.bytes") == 32
    assert reg.get("checkpoint.save_seconds").count == 1
    assert reg.get("checkpoint.restore_seconds").count == 1
