"""The port's engines, runner and engine spec against the JAX reference:
every port kind runs the same inputs as its reference counterpart, with
fusion remainders, through ``make_engine`` and ``BatchedRunner`` (CA
bit-exact, floats rtol=atol=1e-5)."""
import functools
import threading
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import fractals as rf
from repro.core.baselines import BBEngine as RefBB
from repro.core.baselines import LambdaEngine as RefLambda
from repro.core.compact import BlockLayout as RefLayout
from repro.core.stencil import SqueezeBlockEngine as RefBlockEngine
from repro.core.stencil import SqueezeCellEngine as RefCell
from repro.tuning.spec import KINDS as REF_KINDS
from repro.workloads import rules as rrules
from repro_torch.core import fractals as tf
from repro_torch.core.stencil import (KINDS, REFERENCE_KINDS,
                                      SqueezeKernelEngine, default_fusion_k,
                                      make_engine)
from repro_torch.tuning.spec import KIND_ALIASES, EngineSpec
from repro_torch.workloads import BatchedRunner
from repro_torch.workloads import rules as trules

WORKLOADS = ["life", "highlife", "heat", "gray-scott"]
FRAC, R, M = "sierpinski", 5, 2
STEPS = 7


def _tol(wl):
    return dict(rtol=0, atol=0) if wl.dtype == torch.uint8 \
        else dict(rtol=1e-5, atol=1e-5)


def _expanded(wl_name, seed=0, r=R, name=FRAC):
    """A numpy expanded state (C?, n, n) with holes zeroed."""
    frac, wl = tf.REGISTRY[name], trules.WORKLOADS[wl_name]
    n = frac.side(r)
    rng = np.random.default_rng(seed)
    shape = ((wl.n_channels,) if wl.n_channels > 1 else ()) + (n, n)
    x = rng.integers(0, 2, shape).astype(np.uint8) \
        if wl.dtype == torch.uint8 else rng.random(shape).astype(np.float32)
    return x * frac.mask(r)


@functools.lru_cache(maxsize=None)
def _ref_block(wl_name, case=(FRAC, R, M)):
    name, r, m = case
    return RefBlockEngine(RefLayout(rf.REGISTRY[name], r, m),
                          rrules.WORKLOADS[wl_name])


@functools.lru_cache(maxsize=None)
def _ref_expanded_run(wl_name, steps, seed=0, case=(FRAC, R, M)):
    """The reference block engine's expanded state after ``steps`` single
    steps from ``_expanded`` (its k-step fusion gives the same)."""
    eng = _ref_block(wl_name, case)
    s = eng.layout.from_expanded(jnp.asarray(
        _expanded(wl_name, seed, r=case[1], name=case[0])))
    for _ in range(steps):
        s = eng.step(s)
    return np.asarray(eng.to_expanded(s))


def _port_block_state(eng, wl_name, seed=0):
    return eng.layout.from_expanded(
        torch.from_numpy(_expanded(wl_name, seed)))


# ------------------------------------------------------------ kinds
def test_kind_table_names_reference_kinds():
    assert set(KINDS) == set(REFERENCE_KINDS)
    assert set(REFERENCE_KINDS.values()) <= set(REF_KINDS)
    assert REFERENCE_KINDS["cuda-fused"] == "pallas-fused"
    assert REFERENCE_KINDS["cuda-mxu"] == "pallas-mxu"


def test_cuda_alias_is_strips_and_shares_one_engine(monkeypatch):
    """'cuda' is 'cuda-strips', as the reference's 'pallas' is
    'pallas-strips' (v2 is the reference's default kernel)."""
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    from repro.tuning.spec import KIND_ALIASES as REF_ALIASES
    assert REFERENCE_KINDS[KIND_ALIASES["cuda"]] == REF_ALIASES["pallas"]
    spec = EngineSpec("cuda", 2, "sierpinski", R, M).normalize()
    assert spec.kind == "cuda-strips" and spec.fusion_k == 2
    eng = make_engine("cuda", tf.SIERPINSKI, R, M, device="cpu")
    assert isinstance(eng, SqueezeKernelEngine) and eng.variant == "strips"
    runner = BatchedRunner(device="cpu")
    assert runner.engine_for("cuda", tf.SIERPINSKI, R, m=M) is \
        runner.engine_for("cuda-strips", tf.SIERPINSKI, R, m=M)
    assert runner.stats.builds == 1 and runner.cache_size() == 1
    with pytest.raises(ValueError, match="'cuda'"):
        EngineSpec("cuda-warp", 2, "sierpinski", R).canonical()


#: (fractal, r, m) of the single-step kind checks
SINGLE_CASES = [(FRAC, R, M), ("carpet", 3, 1), ("vicsek", 3, 1)]


@pytest.mark.parametrize("case", SINGLE_CASES,
                         ids=[f"{f}-r{r}-m{m}" for f, r, m in SINGLE_CASES])
@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("kind", ["cuda-blocks", "cuda-strips", "cuda"])
def test_single_step_kinds_match_reference(kind, wl_name, case):
    """run(7) with fusion_k=1 (every step v1 or v2) and at the default k
    (v4 launches plus a v1/v2 remainder) equals the reference."""
    name, r, m = case
    wl = trules.WORKLOADS[wl_name]
    want = _ref_expanded_run(wl_name, STEPS, case=case)
    for k in (1, None):
        eng = make_engine(kind, tf.REGISTRY[name], r, m, workload=wl,
                          fusion_k=k, device="cpu")
        x = eng.layout.from_expanded(torch.from_numpy(
            _expanded(wl_name, r=r, name=name)))
        out = eng.run(x, STEPS)
        np.testing.assert_allclose(eng.to_expanded(out).numpy(), want,
                                   **_tol(wl))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("kind", ["block", "cuda-fused", "cuda-mxu"])
def test_block_kinds_run_matches_reference(kind, wl_name, k):
    """run(7 steps) = floor(7/k) fused launches + 7 % k single steps."""
    wl = trules.WORKLOADS[wl_name]
    eng = make_engine(kind, tf.REGISTRY[FRAC], R, M, workload=wl,
                      fusion_k=k, device="cpu")
    assert eng.effective_fusion_k == k
    out = eng.run(_port_block_state(eng, wl_name), STEPS)
    np.testing.assert_allclose(eng.to_expanded(out).numpy(),
                               _ref_expanded_run(wl_name, STEPS), **_tol(wl))


_REF_PLAIN = {"bb": RefBB, "lambda": RefLambda, "cell": RefCell}


@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("kind", ["bb", "lambda", "cell"])
def test_plain_kinds_step_matches_reference(kind, wl_name):
    wl = trules.WORKLOADS[wl_name]
    ref = _REF_PLAIN[REFERENCE_KINDS[kind]](rf.REGISTRY[FRAC], R,
                                            rrules.WORKLOADS[wl_name])
    eng = make_engine(kind, tf.REGISTRY[FRAC], R, workload=wl, device="cpu")
    x = _expanded(wl_name, seed=1)
    if kind == "cell":
        from repro.core.compact import expanded_to_compact
        rs = expanded_to_compact(rf.REGISTRY[FRAC], R, jnp.asarray(x))
        ts = torch.from_numpy(np.array(rs))
    else:
        rs, ts = jnp.asarray(x), torch.from_numpy(x)
    for _ in range(3):
        rs, ts = ref.step(rs), eng.step(ts)
    got, want = ts, rs
    if kind == "cell":
        got, want = eng.to_expanded(ts), ref.to_expanded(rs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(wl))


def test_kernel_engine_ping_pong_keeps_the_input():
    eng = make_engine("cuda-fused", tf.SIERPINSKI, R, M, device="cpu")
    x = _port_block_state(eng, "life")
    keep = x.clone()
    out = eng.run(x, 5)
    assert torch.equal(x, keep) and out.data_ptr() != x.data_ptr()
    assert torch.equal(eng.run(x, 5), out)
    assert eng.run(x, 0) is x


def test_init_random_is_drawn_on_the_device_with_holes_zeroed():
    for kind, wl in (("cuda-mxu", trules.LIFE),
                     ("block", trules.GRAY_SCOTT)):
        eng = make_engine(kind, tf.SIERPINSKI, 7, 2, workload=wl,
                          device="cpu")
        s = eng.init_random(seed=4)
        assert s.device.type == "cpu" and s.dtype == wl.dtype
        hole = torch.from_numpy(eng.layout.micro_mask) == 0
        assert (s[..., hole] == 0).all()
        assert torch.equal(s, eng.init_random(seed=4))
        if wl is trules.LIFE:
            frac = s.float().sum() / (eng.layout.n_blocks * 9)
            assert 0.45 < frac < 0.55
        else:
            assert torch.allclose(s[0][..., ~hole].min(), torch.tensor(0.5))


def test_device_rule():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_engine("block", tf.SIERPINSKI, R, M)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BatchedRunner()
    eng = make_engine("cell", tf.SIERPINSKI, R, device="cpu")
    assert eng.device == "cpu"


def test_kernel_engine_refuses_k_beyond_rho():
    with pytest.raises(ValueError, match="rho"):
        make_engine("cuda-fused", tf.SIERPINSKI, R, M, fusion_k=5,
                    device="cpu")
    assert isinstance(make_engine("cuda-mxu", tf.SIERPINSKI, R, M,
                                  device="cpu"), SqueezeKernelEngine)


# ----------------------------------------------------------- runner
@pytest.mark.parametrize("wl_name", ["life", "gray-scott"])
@pytest.mark.parametrize("kind", ["cuda-mxu", "cuda-fused", "block"])
def test_runner_batch_matches_reference(kind, wl_name):
    """B simulations in one call (native batch for the kernel kinds)
    equal each simulation stepped by the reference."""
    wl = trules.WORKLOADS[wl_name]
    runner = BatchedRunner(device="cpu")
    eng = runner.engine_for(kind, tf.SIERPINSKI, R, m=M, workload=wl)
    states = torch.stack([_port_block_state(eng, wl_name, seed)
                          for seed in (0, 1, 2)])
    out = runner.run(kind, tf.SIERPINSKI, R, states, 5, m=M, workload=wl,
                     k=2)
    for b, seed in enumerate((0, 1, 2)):
        np.testing.assert_allclose(eng.to_expanded(out[b]).numpy(),
                                   _ref_expanded_run(wl_name, 5, seed),
                                   **_tol(wl))
    one = runner.step(kind, tf.SIERPINSKI, R, states, m=M, workload=wl)
    np.testing.assert_allclose(eng.to_expanded(one[0]).numpy(),
                               _ref_expanded_run(wl_name, 1, 0),
                               **_tol(wl))


def test_runner_cache_keys_are_normalized_specs(monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    runner = BatchedRunner(capacity=2, device="cpu")
    spec = EngineSpec("cuda-mxu", 2, "sierpinski", 5, 2, "life")
    e1 = runner.engine_for(spec)
    e2 = runner.engine_for("cuda-mxu", tf.SIERPINSKI, 5, m=2,
                           workload=trules.LIFE, k=default_fusion_k(4))
    assert e1 is e2 and runner.stats.builds == 1
    seeds = runner.init_batch(spec, [0, 1])
    assert seeds.shape == (2, 27, 4, 4) and runner.stats.builds == 1
    runner.engine_for("block", tf.SIERPINSKI, 5, m=2)
    runner.engine_for("cell", tf.SIERPINSKI, 5)
    assert runner.cache_size() == 2 and runner.stats.evictions == 1
    assert runner.engine_for(spec) is not e1       # evicted, rebuilt
    assert runner.stats.builds == 4


def test_runner_builds_once_under_concurrent_misses():
    runner = BatchedRunner(device="cpu")
    spec = EngineSpec("block", 3, "carpet", 3, 1, "heat")
    engines, errors = [], []

    def worker():
        try:
            engines.append(runner.engine_for(spec))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=worker) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(engines) == 16 and all(e is engines[0] for e in engines)
    assert runner.stats.builds == 1


# ------------------------------------------------------------- spec
def test_engine_spec_normalize(monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    spec = EngineSpec.from_args("cuda-mxu", tf.CARPET, 4, 1, trules.HEAT)
    norm = spec.normalize()
    assert norm.fusion_k == default_fusion_k(3) == 2
    assert norm.macro_p is not None and norm == norm.normalize()
    assert norm == EngineSpec.from_args("cuda-mxu", tf.CARPET, 4, 1,
                                        "heat", fusion_k=2,
                                        macro_p=norm.macro_p).normalize()
    cell = EngineSpec("cell", 3, "carpet", 4, 2, "life", 3, 4).normalize()
    assert (cell.m, cell.fusion_k, cell.macro_p) == (0, 1, None)
    custom = tf.NBBFractal("custom", 2, ((0, 0), (1, 1)))
    cspec = EngineSpec.from_args("block", custom, 3)
    assert cspec.frac == ((0, 0), (1, 1))
    assert cspec.build_frac().positions == custom.positions
    with pytest.raises(ValueError, match="unknown engine kind"):
        EngineSpec("pallas-mxu", 2, "sierpinski", 5).canonical()
    with pytest.raises(ValueError, match="fusion_k"):
        EngineSpec("block", 2, "sierpinski", 5, 2, fusion_k=0).normalize()
