"""The port's lambda/nu map kernels (their plain versions on the CPU) and its
float32 "MXU form" of the maps against the JAX reference's Pallas map
kernels in interpret mode: the five registry fractals, r in {1, 2, 4},
coordinates past both edges (and negative compact ones), bit-exact. The
CUDA kernels are held against the plain versions in ``test_torch_cuda.py``.
"""
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import fractals as rf
from repro.core import maps as rm
from repro.kernels import ops
from repro_torch.core import fractals as tf
from repro_torch.core import maps as tm
from repro_torch.kernels import build
from repro_torch.kernels import lambda_map as lm
from repro_torch.kernels import nu_map as nm

NAMES = sorted(tf.REGISTRY)


def _coords(lo, hi, seed, shape=(3, 130)):
    """Two int32 numpy coordinate arrays uniform in [lo, hi)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(lo, hi, size=shape).astype(np.int32)
                 for _ in range(2))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_nu_matches_reference_kernel(name, r):
    """nu_map_tc (plain on the CPU) equals the reference kernel on every
    coordinate, clipped ones too; nu_map_matmul equals the reference's
    (unclipped) float32 form."""
    frac, n = tf.REGISTRY[name], tf.REGISTRY[name].side(r)
    ex, ey = _coords(-2, n + 2, seed=r * 100 + len(name))
    want = ops.nu_map_tc(rf.REGISTRY[name], r, jnp.asarray(ex),
                         jnp.asarray(ey), interpret=True)
    got = nm.nu_map_tc(frac, r, torch.from_numpy(ex), torch.from_numpy(ey))
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    for g, w in zip(got, want):
        _eq(g, w)
    for g, w in zip(tm.nu_map_matmul(frac, r, torch.from_numpy(ex),
                                     torch.from_numpy(ey)),
                    rm.nu_map_matmul(rf.REGISTRY[name], r, jnp.asarray(ex),
                                     jnp.asarray(ey))):
        _eq(g, w)
    m = np.asarray(want[2])
    cx, cy = tm.nu_map_matmul(frac, r, ex, ey)   # numpy in, numpy out
    _eq(cx[m], np.asarray(want[0])[m])
    _eq(cy[m], np.asarray(want[1])[m])


@pytest.mark.parametrize("r", [1, 2, 4])
@pytest.mark.parametrize("name", NAMES)
def test_lambda_matches_reference_kernel(name, r):
    """lambda_map_tc (plain on the CPU), lambda_map_matmul and
    lambda_codes equal the reference's, negative and past-the-edge
    compact coordinates included (floor division in both)."""
    frac = tf.REGISTRY[name]
    rows, cols = frac.compact_dims(r)
    cx, cy = _coords(-2 * max(rows, cols), 2 * max(rows, cols),
                     seed=r * 7 + len(name))
    ref = rf.REGISTRY[name]
    want = ops.lambda_map_tc(ref, r, jnp.asarray(cx), jnp.asarray(cy),
                             interpret=True)
    tcx, tcy = torch.from_numpy(cx), torch.from_numpy(cy)
    for got in (lm.lambda_map_tc(frac, r, tcx, tcy),
                tm.lambda_map_matmul(frac, r, tcx, tcy),
                tm.lambda_map_matmul(frac, r, cx, cy)):
        assert got[0].dtype in (torch.int32, np.int32)
        for g, w in zip(got, want):
            _eq(g, w)
    _eq(tm.lambda_codes(frac, r, tcx, tcy),
        rm.lambda_codes(ref, r, jnp.asarray(cx), jnp.asarray(cy)))


def test_roundtrip_deep_level():
    """lambda -> nu at r=16 through the wrappers returns the compact
    coordinates, as the reference kernels do."""
    frac, r = tf.SIERPINSKI, 16
    rows, cols = frac.compact_dims(r)
    rng = np.random.default_rng(0)
    cx = rng.integers(0, cols, size=512).astype(np.int32)
    cy = rng.integers(0, rows, size=512).astype(np.int32)
    ex, ey = lm.lambda_map_tc(frac, r, torch.from_numpy(cx),
                              torch.from_numpy(cy))
    rex, rey = ops.lambda_map_tc(rf.SIERPINSKI, r, jnp.asarray(cx),
                                 jnp.asarray(cy), interpret=True)
    _eq(ex, rex)
    _eq(ey, rey)
    bx, by, valid = nm.nu_map_tc(frac, r, ex, ey)
    assert bool(valid.all())
    _eq(bx, cx)
    _eq(by, cy)


def test_map_wrappers_check_levels():
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        nm.nu_map_tc(tf.CARPET, 129, c, c)
    with pytest.raises(ValueError, match="outside"):
        lm.lambda_map_tc(tf.CARPET, 65, c, c)
    with pytest.raises(ValueError, match="int32"):
        nm.nu_map_tc(tf.SIERPINSKI, 31, c, c)      # 2^31
    with pytest.raises(ValueError, match="int32"):
        lm.lambda_map_tc(tf.CARPET, 20, c, c)      # 3^20
    wide = tf.NBBFractal("wide", 4, tuple(
        (x, y) for y in range(4) for x in range(4) if (x, y) != (0, 0)))
    with pytest.raises(ValueError, match="int32"):
        nm.nu_map_tc(wide, 15, c, c)               # 4^15 fits, 15^8 not
    assert lm.lambda_map_tc(tf.SIERPINSKI, 30, c, c)[0].dtype == torch.int32
    assert [nm.max_int32_level(f) for f in (tf.SIERPINSKI, tf.CARPET)] == \
        [30, 19]


@pytest.mark.parametrize("which", ["nu", "lambda"])
def test_map_wrappers_never_fall_back(which):
    """Off the CPU a map wrapper goes to its kernel: a failed build raises,
    another device is refused, and the plain version is never called."""
    meta = torch.empty(5, dtype=torch.int32, device="meta")
    mod, fn, plain = (nm, nm.nu_map_tc, "nu_map_tc_plain") \
        if which == "nu" else (lm, lm.lambda_map_tc, "lambda_map_tc_plain")
    before = dict(build.LAUNCHES)
    with mock.patch.object(mod, plain,
                           side_effect=AssertionError("fell back")):
        with mock.patch.object(build, "load_library",
                               side_effect=build.KernelBuildError("nvcc")):
            with pytest.raises(build.KernelBuildError):
                fn(tf.VICSEK, 3, meta, meta)
        with mock.patch.object(build, "load_library",
                               return_value=mock.MagicMock()):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                fn(tf.VICSEK, 3, meta, meta)
    assert build.LAUNCHES == before
