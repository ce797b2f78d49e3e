"""The port's fault-tolerant simulation service against the reference's:
the same requests give equal final states and snapshots (CA exactly,
HEAT within rtol=atol=1e-5), served clean and under each chaos fault
(in-step exception, a stall past the hang threshold, a corrupt or
truncated checkpoint followed by a crash, preemption then resumption).

The reference seeds its states with jax's generator and the port with
torch's, so every request starts from a step-0 checkpoint of a numpy
state, which both services restore (through each other's checkpoint
format). The port runs its ``block``, ``cuda-fused`` (the kernels' plain
versions on the CPU) and ``dist-fused`` kinds; the reference its
``block`` kind. Then the port's own admission, deadline, breaker and
bucketing behaviour.
"""
import asyncio

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.core import fractals as rf
from repro.runtime import fault as rfault
from repro.serving import (FractalService as RefService,
                           ServiceConfig as RefConfig,
                           SimRequest as RefRequest)
from repro.workloads import rules as rrules
from repro_torch import obs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import fractals as tf
from repro_torch.core.compact import BlockLayout
from repro_torch.runtime.fault import Fault, FaultInjector
from repro_torch.serving import (AdmissionError, CircuitBreaker,
                                 FractalService, ServiceConfig, SimRequest)
from repro_torch.workloads import BatchedRunner
from repro_torch.workloads import rules as trules

R, M, STEPS, SNAP = 4, 1, 12, 4
#: (seed, workload) of the requests: three LIFE rows share a bucket
ROWS = [(0, "life"), (1, "life"), (2, "life"), (3, "heat")]
FAULTS = {
    "none": [],
    "exception": [Fault("exception", at_segment=1)],
    "stall": [Fault("stall", at_segment=1, stall_s=0.3)],
    "corrupt": [Fault("corrupt", at_segment=1),
                Fault("exception", at_segment=2)],
    "truncate": [Fault("truncate", at_segment=1),
                 Fault("exception", at_segment=2)],
    "preempt": [Fault("preempt", at_segment=2)],
}


def _inits():
    lay = BlockLayout(tf.SIERPINSKI, R, M)
    rng = np.random.default_rng(42)
    shape = (lay.n_blocks, lay.rho, lay.rho)
    out = {}
    for seed, wl in ROWS:
        x = (rng.integers(0, 2, shape).astype(np.uint8) if wl == "life"
             else rng.random(shape).astype(np.float32))
        out[seed] = x * lay.micro_mask.astype(x.dtype)
    return out


INITS = _inits()


def _seed(mgr_cls, root, prefix):
    for seed, _ in ROWS:
        mgr_cls(str(root / f"{prefix}-{seed}")).save(
            0, {"state": INITS[seed]})


def _cfg(cls, root, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_cap_s", 0.05)
    kw.setdefault("hang_threshold_s", 0.1)
    kw.setdefault("compile_grace_s", 0.1)
    return cls(ckpt_dir=str(root), **kw)


def _by_seed(results):
    return {int(r.rid.rsplit("-", 1)[1]): r for r in results}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{seed: SimResult} of the reference's block service, clean; its
    chaos run (exception, corrupt + crash) must give the same."""
    out = []
    for faults in ([], [rfault.Fault("corrupt", at_segment=1),
                        rfault.Fault("exception", at_segment=2)]):
        root = tmp_path_factory.mktemp("ref")
        _seed(RefManager, root, "ref")
        svc = RefService(_cfg(RefConfig, root, hang_threshold_s=30.0,
                              compile_grace_s=60.0),
                         injector=rfault.FaultInjector(faults))
        out.append(_by_seed(svc.serve([
            RefRequest(frac=rf.SIERPINSKI, r=R, m=M, steps=STEPS, seed=s,
                       workload=rrules.WORKLOADS[wl], snapshot_every=SNAP,
                       rid=f"ref-{s}") for s, wl in ROWS])))
    clean, chaos = out
    for seed, _ in ROWS:
        assert clean[seed].ok and chaos[seed].ok
        _assert_equal(chaos[seed], clean[seed], seed)
    return clean


def _assert_equal(got, want, seed, resumed=False):
    """Equal final states and snapshots; a resumed request has the
    snapshots after its resumption only."""
    close = (np.testing.assert_array_equal if ROWS[seed][1] == "life"
             else lambda a, b: np.testing.assert_allclose(
                 a, b, rtol=1e-5, atol=1e-5))
    assert got.steps_done == want.steps_done == STEPS
    close(np.asarray(got.state), np.asarray(want.state))
    steps = [s for s, _ in got.snapshots]
    wanted = dict(want.snapshots)
    assert steps == [s for s in wanted if not resumed or s in steps]
    assert steps or resumed
    for s, a in got.snapshots:
        close(np.asarray(a), np.asarray(wanted[s]))


def _port_requests(kind, prefix):
    return [SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=STEPS, seed=s,
                       workload=trules.WORKLOADS[wl], snapshot_every=SNAP,
                       kind=kind, n_shards=3 if kind == "dist-fused"
                       else None, rid=f"{prefix}-{s}") for s, wl in ROWS]


CASES = [(kind, fault) for kind in ("block", "cuda-fused")
         for fault in sorted(FAULTS)] + \
    [("dist-fused", "none"), ("dist-fused", "exception"),
     ("dist-fused", "stall")]


@pytest.mark.parametrize("kind,fault", CASES)
def test_service_equals_reference(tmp_path, reference, kind, fault):
    _seed(CheckpointManager, tmp_path, "port")
    runner = BatchedRunner(device="cpu")
    inj = FaultInjector([Fault(f.kind, f.at_segment, f.stall_s)
                         for f in FAULTS[fault]])
    with obs.enabled_scope(True) as reg:
        obs.reset()
        res = _by_seed(FractalService(_cfg(ServiceConfig, tmp_path), runner,
                                      injector=inj).serve(
            _port_requests(kind, "port")))
        assert inj.all_fired()
        injected = {k: reg.value("chaos.injected", kind=k) or 0
                    for k in ("exception", "stall")}
        retries = sum(reg.value("serve.retries", kind=k) or 0
                      for k in (kind,))
        restarts = reg.value("serve.restarts", kind=kind) or 0
    if fault == "preempt":
        # a bucket drained before its first segment is preempted at 0
        assert all(r.status == "preempted" and r.steps_done < STEPS
                   for r in res.values())
        assert any(r.steps_done for r in res.values())
        res = _by_seed(FractalService(_cfg(ServiceConfig, tmp_path),
                                      runner).serve(
            _port_requests(kind, "port")))
    assert retries >= injected["exception"]
    assert restarts >= injected["stall"]
    for seed, _ in ROWS:
        assert res[seed].ok, (seed, res[seed].status, res[seed].error)
        _assert_equal(res[seed], reference[seed], seed,
                      resumed=fault == "preempt")


def test_snapshots_and_checkpoints_restore_in_the_reference(tmp_path,
                                                            reference):
    """The port's per-request checkpoints are the reference's format: the
    reference's manager restores the port's newest step of every row."""
    _seed(CheckpointManager, tmp_path, "port")
    reqs = _port_requests("cuda-fused", "port")
    FractalService(_cfg(ServiceConfig, tmp_path),
                   BatchedRunner(device="cpu")).serve(reqs)
    for seed, _ in ROWS:
        mgr = RefManager(str(tmp_path / f"port-{seed}"))
        assert mgr.latest_step() == STEPS
        back = mgr.restore({"state": INITS[seed]})["state"]
        np.testing.assert_array_equal(back, reference[seed].state) \
            if ROWS[seed][1] == "life" else np.testing.assert_allclose(
                back, reference[seed].state, rtol=1e-5, atol=1e-5)


def test_requests_join_and_share_one_engine(tmp_path):
    """A request submitted while its bucket runs joins at a segment
    boundary; the aliases 'cuda' and 'cuda-strips' are one bucket."""
    runner = BatchedRunner(device="cpu")
    eng = runner.engine_for("cuda-strips", tf.SIERPINSKI, R, m=M)

    async def go():
        svc = FractalService(ServiceConfig(max_batch=8, max_segment_steps=2,
                                           hang_threshold_s=30.0), runner)
        await svc.start()
        try:
            first = asyncio.ensure_future(svc.submit(SimRequest(
                frac=tf.SIERPINSKI, r=R, m=M, steps=40, seed=0,
                kind="cuda", rid="join-0")))
            await asyncio.sleep(0.05)
            late = await svc.submit(SimRequest(
                frac=tf.SIERPINSKI, r=R, m=M, steps=8, seed=1,
                kind="cuda-strips", rid="join-1"))
            return await first, late
        finally:
            await svc.stop()
    r0, r1 = asyncio.run(go())
    assert r0.ok and r1.ok and runner.stats.builds == 1
    np.testing.assert_array_equal(
        eng.run(eng.init_random(1), 8).numpy(), r1.state)
    a = SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=1, kind="cuda")
    b = SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=1,
                   kind="cuda-strips", k=2)
    d = SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=1,
                   kind="dist-fused", n_shards=4)
    assert a.bucket == b.bucket and d.bucket.n_shards == 4
    assert SimRequest(frac=tf.SIERPINSKI, r=R, steps=1).kind == "block"


def test_stop_lets_finished_buckets_call_back(monkeypatch):
    """``stop()`` yields to the loop while it drains: a gather of bucket
    tasks that are all done completes without yielding (Python 3.12), so a
    finished task whose done callback had not run yet kept the loop from
    ever running it, and ``stop()`` spun."""
    real_gather, calls = asyncio.gather, [0]

    def gather(*aws, **kw):
        calls[0] += 1
        if calls[0] > 50:
            raise RuntimeError("stop() does not yield to the loop")
        return real_gather(*aws, **kw)
    monkeypatch.setattr(asyncio, "gather", gather)

    async def finished():
        return None

    async def go():
        svc = FractalService(ServiceConfig(), BatchedRunner(device="cpu"))
        await svc.start()
        bucket = SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=1).bucket
        task = asyncio.get_running_loop().create_task(finished())
        svc._tasks.add(task)
        svc._running.add(bucket)
        task.add_done_callback(svc._on_task_done(bucket))
        await asyncio.sleep(0)    # the task ends; its callback is queued
        assert task.done() and task in svc._tasks
        await svc.stop()
        assert not svc._tasks and not svc._running
    asyncio.run(go())
    assert calls[0] == 1


def test_admission_deadline_and_breaker(tmp_path):
    runner = BatchedRunner(device="cpu")
    res = FractalService(ServiceConfig(max_segment_steps=1), runner).serve(
        [SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=100000, seed=0,
                    deadline_s=0.5, rid="dl-0")])
    assert res[0].status == "timeout" and res[0].steps_done < 100000

    async def full():
        svc = FractalService(ServiceConfig(max_queue=2), runner)
        await svc.start()
        try:
            svc._queued = 2
            with pytest.raises(AdmissionError) as ei:
                await svc.submit(SimRequest(frac=tf.SIERPINSKI, r=R,
                                            steps=4))
            assert ei.value.reason == "queue_full"
        finally:
            svc._queued = 0
            await svc.stop()
    asyncio.run(full())
    inj = FaultInjector([Fault("exception", at_segment=i) for i in range(8)])
    svc = FractalService(ServiceConfig(max_retries=1, breaker_threshold=2,
                                       breaker_cooldown_s=30.0,
                                       backoff_base_s=0.01), runner,
                         injector=inj)
    res = svc.serve([SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=8,
                                rid="brk")])
    assert res[0].status == "failed" and svc.breaker.state == "open"
    res = svc.serve([SimRequest(frac=tf.SIERPINSKI, r=R, m=M, steps=8,
                                rid="brk2")])
    assert res[0].status == "rejected" and res[0].error == "breaker_open"
    t = [0.0]
    br = CircuitBreaker(threshold=2, cooldown_s=1.0, clock=lambda: t[0])
    br.record_failure()
    br.record_failure()
    assert br.state == "open" and not br.allow()
    t[0] = 1.5
    assert br.allow() and br.state == "half-open"
    br.record_success()
    assert br.state == "closed"
    with pytest.raises(RuntimeError):
        asyncio.run(FractalService(ServiceConfig(), runner).submit(
            SimRequest(frac=tf.SIERPINSKI, r=R, steps=4)))
    with pytest.raises(ValueError):
        SimRequest(frac=tf.SIERPINSKI, r=R, steps=0)


def test_default_service_is_on_the_card():
    """``FractalService()`` builds its runner on the card: without CUDA it
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        assert FractalService().runner.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            FractalService()


def test_serve_telemetry_matches_reference_counts(tmp_path, reference):
    """The serve.* counters of one clean run equal the reference's for the
    same requests (the clock series aside)."""
    names = ("serve.admitted", "serve.completed", "serve.joins",
             "serve.segments", "serve.batches", "serve.checkpoints")

    def counts(o, registry, kind):
        return {n: registry.value(n, kind=kind) if n != "serve.checkpoints"
                else registry.value(n) for n in names}
    with obs.enabled_scope(True) as reg, robs.enabled_scope(True) as rreg:
        obs.reset()
        robs.reset()
        _seed(CheckpointManager, tmp_path / "p", "port")
        FractalService(_cfg(ServiceConfig, tmp_path / "p",
                            max_inflight=1), BatchedRunner(device="cpu")
                       ).serve(_port_requests("block", "port"))
        _seed(RefManager, tmp_path / "r", "ref")
        RefService(_cfg(RefConfig, tmp_path / "r", max_inflight=1,
                        hang_threshold_s=30.0, compile_grace_s=60.0)
                   ).serve([RefRequest(
                       frac=rf.SIERPINSKI, r=R, m=M, steps=STEPS, seed=s,
                       workload=rrules.WORKLOADS[wl], snapshot_every=SNAP,
                       rid=f"ref-{s}") for s, wl in ROWS])
        assert counts(obs, reg, "block") == counts(robs, rreg, "block")
        assert reg.value("serve.completed", kind="block") == len(ROWS)
