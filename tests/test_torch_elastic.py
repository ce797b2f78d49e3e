"""The port's ElasticDistributedRunner on the CPU: 8 shards (one CPU device
repeated), every fault class of the shard-aware chaos matrix, and the
elastic 8 -> 4 (and 4 -> 2) reshard after a lost device, each run equal
to the reference's single-device ``block`` engine from the same state
(CA bit for bit, HEAT within rtol=atol=1e-5): the compact trajectory does
not depend on the shard count."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.compact import BlockLayout as RefLayout
from repro.core.fractals import SIERPINSKI as RSIERPINSKI
from repro.core.stencil import SqueezeBlockEngine as RefBlockEngine
from repro.workloads import rules as rrules
from repro_torch.core.compact import BlockLayout
from repro_torch.core.elastic import ElasticDistributedRunner
from repro_torch.core.fractals import SIERPINSKI
from repro_torch.runtime.fault import (DeviceLostError, Fault, FaultInjector,
                                       InjectedFault, PreemptionHandler)
from repro_torch.workloads import rules as trules

R, M, STEPS, K, SHARDS = 5, 2, 12, 2, 8
LAYOUT = BlockLayout(SIERPINSKI, R, M)


def _init(wl: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    shape = (LAYOUT.n_blocks, LAYOUT.rho, LAYOUT.rho)
    x = (rng.integers(0, 2, shape).astype(np.uint8) if wl == "life"
         else rng.random(shape).astype(np.float32))
    return x * LAYOUT.micro_mask.astype(x.dtype)


@pytest.fixture(scope="module")
def ref():
    """{workload: the reference block engine's state after STEPS}."""
    lay = RefLayout(RSIERPINSKI, R, M)
    out = {}
    for wl in ("life", "heat"):
        eng = RefBlockEngine(lay, rrules.WORKLOADS[wl], fusion_k=K)
        out[wl] = np.asarray(eng.run(jnp.asarray(_init(wl)), STEPS))
    return out


def _runner(tmp_path, faults=(), wl="life", **kw):
    kw.setdefault("ckpt_dir", str(tmp_path / "ckpts"))
    kw.setdefault("ckpt_every", 4)
    kw.setdefault("backoff_base_s", 0.01)
    kw.setdefault("backoff_cap_s", 0.05)
    kw.setdefault("n_shards", SHARDS)
    kw.setdefault("compute", "fused")
    inj = FaultInjector(faults) if faults else None
    return ElasticDistributedRunner(LAYOUT, device="cpu",
                                    workload=trules.WORKLOADS[wl],
                                    fusion_k=K, injector=inj, **kw), inj


def _run(runner, wl="life"):
    out = runner.run(STEPS, state=runner.engine.from_dense(_init(wl)))
    return runner.engine.to_dense(out).numpy()


def _assert_equal(got, want, wl="life"):
    if wl == "life":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


PLANS = {
    "clean": [],
    "shard_exception": [Fault("shard_exception", at_segment=1, shard=2)],
    "halo_corrupt": [Fault("halo_corrupt", at_segment=1, shard=0)],
    "strip_corrupt": [Fault("strip_corrupt", at_segment=2, shard=3)],
    "strip_drop": [Fault("strip_drop", at_segment=1, shard=5)],
    "corrupt_checkpoint": [Fault("corrupt", at_segment=4),
                           Fault("shard_exception", at_segment=5)],
    "truncate_checkpoint": [Fault("truncate", at_segment=4),
                            Fault("shard_exception", at_segment=5)],
    "two_streaks": [Fault("shard_exception", at_segment=1),
                    Fault("shard_exception", at_segment=4)],
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_recovery_equals_reference(tmp_path, ref, plan):
    runner, inj = _runner(tmp_path, PLANS[plan], max_retries=1)
    with runner:
        _assert_equal(_run(runner), ref["life"])
    st = runner.stats
    assert runner.n_shards == SHARDS and not st.degraded
    assert st.steps_done == STEPS
    if plan == "clean":
        assert st.failures == st.retries == 0
        assert st.launches == STEPS // K
        assert st.checkpoints == STEPS // 4
    else:
        assert inj.all_fired()
        assert st.failures >= 1 and st.retries >= 1 and st.recoveries >= 1
    if plan == "two_streaks":
        assert st.recoveries == 2 and len(st.recovery_seconds) == 2
    if plan.endswith("_checkpoint"):
        assert st.restores >= 1


@pytest.mark.parametrize("compute", ["fused", "jnp", "mxu"])
@pytest.mark.parametrize("wl", ["life", "heat"])
def test_device_loss_reshards_8_to_4(tmp_path, ref, compute, wl):
    runner, inj = _runner(
        tmp_path, [Fault("device_loss", at_segment=2, shard=5)], wl=wl,
        compute=compute)
    with runner:
        _assert_equal(_run(runner, wl), ref[wl], wl)
    st = runner.stats
    assert inj.all_fired() and runner.n_shards == SHARDS // 2
    assert st.reshards == 1 and st.degraded and st.restores == 1
    assert st.recoveries == 1


def test_two_losses_reshard_to_2(tmp_path, ref):
    runner, _ = _runner(tmp_path, [
        Fault("device_loss", at_segment=1, shard=0),
        Fault("device_loss", at_segment=4, shard=1)])
    with runner:
        _assert_equal(_run(runner), ref["life"])
    assert runner.n_shards == 2 and runner.stats.reshards == 2


def test_stalled_launch_abandoned_and_engine_rebuilt(tmp_path, ref):
    """Launch 0 warms the launch key; the stall at launch 1 outlasts the
    timeout, and the runner rebuilds the engine on the same devices."""
    runner, inj = _runner(
        tmp_path, [Fault("shard_stall", at_segment=1, stall_s=0.3)],
        launch_timeout_s=0.15, compile_grace_s=60.0)
    eng0 = runner.engine
    with runner:
        _assert_equal(_run(runner), ref["life"])
    assert inj.all_fired()
    assert runner.stats.hangs >= 1 and runner.watchdog.hangs >= 1
    assert runner.engine is not eng0 and runner.n_shards == SHARDS


def test_device_loss_at_floor_is_terminal(tmp_path):
    runner, _ = _runner(tmp_path, [Fault("device_loss", at_segment=1)],
                        min_devices=SHARDS)
    with runner, pytest.raises(DeviceLostError):
        _run(runner)
    assert runner.stats.reshards == 0 and not runner.stats.degraded


def test_retries_exhausted_reraises(tmp_path):
    runner, _ = _runner(tmp_path, [Fault("shard_exception", at_segment=i)
                                   for i in range(3)], max_retries=2)
    with runner, pytest.raises(InjectedFault):
        _run(runner)
    assert runner.stats.failures == 3 and runner.stats.retries == 2


def test_resume_and_preemption(tmp_path, ref):
    handler = PreemptionHandler(install=False)
    handler.request()   # preempted before the first launch
    first, _ = _runner(tmp_path, preemption=handler)
    with first:
        _run(first)
    assert first.stats.preempted and first.stats.checkpoints == 1
    second, _ = _runner(tmp_path)
    with second:
        _assert_equal(_run(second), ref["life"])
    third, _ = _runner(tmp_path, n_shards=3)   # another shard count
    with third:
        _assert_equal(_run(third), ref["life"])
    assert third.stats.launches == 0 and third.stats.restores == 1
    assert third.stats.retries == 0


def test_min_devices_validated():
    with pytest.raises(ValueError):
        ElasticDistributedRunner(LAYOUT, n_shards=2, device="cpu",
                                 min_devices=3)
