"""The port's workloads against the JAX reference: weights, rank-1
factors, banded operators, the update rules and k-substep tile rules, and
the reference rules carried across by ``interop``. CA results are
bit-exact; floats agree to rtol=atol=1e-5, the reference's own bar."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.workloads import base as rbase
from repro.workloads import rules as rrules
from repro_torch import interop
from repro_torch.workloads import base as tbase
from repro_torch.workloads import rules as trules

NAMES = ["life", "highlife", "seeds", "heat", "gray-scott"]


def _pair(name):
    return rrules.WORKLOADS[name], trules.WORKLOADS[name]


def _tol(wl):
    return dict(rtol=0, atol=0) if wl.dtype == torch.uint8 \
        else dict(rtol=1e-5, atol=1e-5)


def _inputs(wl, shape, seed):
    """A numpy state of ``shape`` (C prepended for multi-channel)."""
    rng = np.random.default_rng(seed)
    shape = ((wl.n_channels,) if wl.n_channels > 1 else ()) + shape
    if wl.dtype == torch.uint8:
        return rng.integers(0, 2, shape).astype(np.uint8)
    return rng.random(shape).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_weights_factors_and_operators_match(name):
    ref, port = _pair(name)
    assert port.weights2d == ref.weights2d
    np.testing.assert_array_equal(port.weights3x3, ref.weights3x3)
    assert port.weight_factors == ref.weight_factors
    assert tbase.halo_needs(port.weights2d) == rbase.halo_needs(
        ref.weights2d)
    for w in (5, 8, 27):
        for a, b in zip(tbase.banded_operators(port.weight_factors, w),
                        rbase.banded_operators(ref.weight_factors, w)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_apply_matches(name):
    ref, port = _pair(name)
    center = _inputs(port, (6, 7), 0)
    if port.dtype == torch.uint8:
        agg = np.random.default_rng(1).integers(0, 9, center.shape)
        agg = agg.astype(np.int32)
    else:
        agg = np.random.default_rng(1).random(center.shape)
        agg = agg.astype(np.float32)
    mask = (np.random.default_rng(2).random((6, 7)) < 0.7).astype(np.uint8)
    want = ref.apply(jnp.asarray(center), jnp.asarray(agg),
                     jnp.asarray(mask))
    got = port.apply(torch.from_numpy(center), torch.from_numpy(agg),
                     torch.from_numpy(mask))
    assert got.dtype == port.dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(port))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("k", [1, 2, 3])
def test_tile_rule_k_matches(name, k):
    ref, port = _pair(name)
    w = 4 + 2 * k
    padded = _inputs(port, (3, w, w), k)
    mask = (np.random.default_rng(5).random((3, w, w)) < 0.8)
    mask = mask.astype(np.uint8)
    want = jax.jit(lambda p, m: ref.tile_rule_k(p, m, k))(padded, mask)
    got = port.tile_rule_k(torch.from_numpy(padded),
                           torch.from_numpy(mask), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(port))


@pytest.mark.parametrize("weights", [(1,) * 8, (0, 1, 0, 1, 1, 0, 1, 0),
                                     (0.05, 0.2, 0.05, 0.2, 0.2, 0.05, 0.2,
                                      0.05), (1, 2, 3, 4, 5, 6, 7, 8)],
                         ids=["ones", "cross", "ring", "irregular"])
def test_weighted_moore_agg_matches(weights):
    """Both summation paths: the ring-uniform separable one and the
    per-direction loop."""
    x = np.random.default_rng(3).random((2, 9, 11)).astype(np.float32)
    want = rbase.weighted_moore_agg(jnp.asarray(x), weights, jnp.float32)
    got = tbase.weighted_moore_agg(torch.from_numpy(x), weights,
                                   torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_workload_carried_across_from_reference_fields(name):
    ref, port = _pair(name)
    twin = interop.workload_from_fields(type(ref).__name__,
                                        **dataclasses.asdict(ref))
    assert twin == port and hash(twin) == hash(port)


def test_kernel_params():
    assert trules.LIFE.kernel_params()["born"] == 0b1000
    assert trules.LIFE.kernel_params()["survive"] == 0b1100
    assert trules.HIGHLIFE.born_mask == (1 << 3) | (1 << 6)
    assert trules.HEAT.kernel_params()["p"][:2] == (0.2, 4.0)
    gs = trules.GRAY_SCOTT
    assert gs.kernel_params()["p"] == (1.0, 0.5, 0.055, 0.055 + 0.062)
    assert trules.GRAY_SCOTT.ring_weights == (0.05, 0.2)
    assert trules.HEAT.ring_weights == (0, 1)
    with pytest.raises(ValueError):
        trules.TotalisticCA(name="x", born=frozenset({27})).born_mask


def test_state_round_trip():
    x = _inputs(trules.GRAY_SCOTT, (5, 4, 4), 9)
    t = interop.state_from_numpy(x, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(interop.state_to_numpy(t), x)
    with pytest.raises(KeyError):
        interop.workload_from_fields("Unknown")
