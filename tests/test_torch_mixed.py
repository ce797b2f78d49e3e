"""The port's mixed-level NBB fractals (``repro_torch.core.mixed``)
against the reference's ``repro.core.mixed``: the same geometry, mask and
MRF, and the same lambda and nu maps (int32, bit-exact) over every compact
cell and over expanded coordinates past both edges, from numpy arrays and
from torch tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractals as rf
from repro.core.mixed import MixedFractal as RefMixed
from repro_torch.core import fractals as tf
from repro_torch.core import maps
from repro_torch.core.mixed import MixedFractal

#: (name, generator names from the finest level up)
CASES = [
    ("sier-carpet", ("sierpinski", "carpet")),
    ("carpet-vicsek-sier", ("carpet", "vicsek", "sierpinski")),
    ("bottles-sier-sier", ("empty_bottles", "sierpinski", "sierpinski")),
    ("chandelier-vicsek", ("chandelier", "vicsek")),
    ("five-levels", ("sierpinski", "vicsek", "sierpinski", "carpet",
                     "sierpinski")),
]


def _pair(name, levels):
    return (MixedFractal(name, tuple(tf.REGISTRY[n] for n in levels)),
            RefMixed(name, tuple(rf.REGISTRY[n] for n in levels)))


def _as(kind, a):
    return torch.from_numpy(a) if kind == "torch" else a


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("name,levels", CASES, ids=[c[0] for c in CASES])
def test_geometry_mask_and_mrf(name, levels):
    mine, ref = _pair(name, levels)
    assert (mine.r, mine.side, mine.volume) == (ref.r, ref.side, ref.volume)
    assert mine.compact_dims() == ref.compact_dims()
    assert mine.mrf() == ref.mrf()
    np.testing.assert_array_equal(mine.mask(), ref.mask())


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("name,levels", CASES, ids=[c[0] for c in CASES])
def test_lambda_equals_reference(name, levels, kind):
    mine, ref = _pair(name, levels)
    rows, cols = mine.compact_dims()
    cy, cx = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    cx, cy = cx.ravel().astype(np.int32), cy.ravel().astype(np.int32)
    got = mine.lambda_map(_as(kind, cx), _as(kind, cy))
    want = ref.lambda_map(jnp.asarray(cx), jnp.asarray(cy))
    for g, w in zip(got, want):
        assert _np(g).dtype == np.int32
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    ex, ey = (_np(g) for g in got)
    assert mine.mask()[ey, ex].all()
    assert len(np.unique(ey.astype(np.int64) * mine.side + ex)) == \
        mine.volume


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("name,levels", CASES, ids=[c[0] for c in CASES])
def test_nu_equals_reference(name, levels, kind):
    """nu over every expanded cell and a ring past the edges: compact
    coordinates and membership as the reference's."""
    mine, ref = _pair(name, levels)
    n = mine.side
    ey, ex = np.meshgrid(np.arange(-2, n + 2), np.arange(-2, n + 2),
                         indexing="ij")
    ex, ey = ex.ravel().astype(np.int32), ey.ravel().astype(np.int32)
    got = mine.nu_map(_as(kind, ex), _as(kind, ey))
    want = ref.nu_map(jnp.asarray(ex), jnp.asarray(ey))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    inside = (ex >= 0) & (ex < n) & (ey >= 0) & (ey < n)
    member = np.zeros(ex.shape, bool)
    member[inside] = mine.mask()[ey[inside], ex[inside]] > 0
    np.testing.assert_array_equal(_np(got[2]), member)


@pytest.mark.parametrize("frac,r", [("sierpinski", 5), ("carpet", 3),
                                    ("vicsek", 3)])
def test_uniform_mixed_reduces_to_the_maps(frac, r):
    f = tf.REGISTRY[frac]
    mf = MixedFractal("uniform", (f,) * r)
    rows, cols = mf.compact_dims()
    cy, cx = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    cx, cy = cx.ravel(), cy.ravel()
    for g, w in zip(mf.lambda_map(cx, cy), maps.lambda_map(f, r, cx, cy)):
        np.testing.assert_array_equal(g, w)
    ex, ey = maps.lambda_map(f, r, cx, cy)
    got = mf.nu_map(ex, ey)
    for g, w in zip(got[:2], maps.nu_map(f, r, ex, ey)):
        np.testing.assert_array_equal(g, w)
    assert got[2].all()
