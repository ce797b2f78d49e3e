"""The nu kernel's grouped lookup (``csrc/squeeze_maps.cu``, ``nu_kernel``),
emulated in numpy from the port's pure table functions (``nu_plan``,
``nu_tables``), against the JAX reference's maps, bit for bit: the five
registry fractals, r in {0, 1, 2, 3, an r whose top group is short,
max_int32_level}, coordinates past every edge of the grid. The reference's
scalar maps (Python integers) are the oracle at every r; its vectorised
``nu_with_membership`` is held too where its float32 weights are exact
(below 2^24). The kernel itself is held against its plain version on the
card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fractals as rf
from repro.core import maps as rm
from repro_torch.core import fractals as tf
from repro_torch.kernels import nu_map as nm

NAMES = sorted(tf.REGISTRY)
SOURCE = Path(nm.__file__).parent / "csrc" / "squeeze_maps.cu"


def _emulate(frac, r, ex, ey, levels=0):
    """(cx, cy, valid) as ``nu_kernel`` computes them: clip, then per group
    one lookup in the tables (the lower groups by L digits of each
    coordinate, the top group by what is left), the partials weighted by
    k^(gL/2) in int32, the hole bits OR-ed."""
    plan = nm.nu_plan(frac, r, levels)
    tab = nm.nu_tables(frac, plan.levels, plan.top).astype(np.int64)
    assert tab.size == plan.entries
    n, s = frac.side(r), frac.s
    sl = s ** plan.levels
    top_off = sl * sl if plan.top < plan.levels else 0
    top_stride, kl = s ** plan.top, frac.k ** (plan.levels // 2)
    ex, ey = np.asarray(ex, np.int64), np.asarray(ey, np.int64)
    inside = (ex >= 0) & (ex < n) & (ey >= 0) & (ey < n)
    ux, uy = np.clip(ex, 0, n - 1), np.clip(ey, 0, n - 1)
    ax, ay, bad, w = np.zeros_like(ux), np.zeros_like(ux), 0, 1
    for g in range(plan.groups):
        last = g == plan.groups - 1
        if last:
            at = top_off + ux + top_stride * uy
        else:
            at = ux % sl + sl * (uy % sl)
            ux, uy = ux // sl, uy // sl
        e = tab[at]
        bad = bad | e
        ax += (e & nm.FIELD) * w
        ay += (e >> 16) * w
        if not last:
            w *= kl
        assert w < 2 ** 31
    assert ax.max(initial=0) < 2 ** 31 and ay.max(initial=0) < 2 ** 31
    return (ax.astype(np.int32), ay.astype(np.int32),
            inside & ((bad & nm.HOLE) == 0))


def _levels(frac):
    """r in {0, 1, 2, 3}, an r with a short top group (2L + 1) and the
    largest r whose coordinates fit int32."""
    short = 2 * nm.group_levels(frac.s) + 1
    return sorted({0, 1, 2, 3, short, nm.max_int32_level(frac)})


def _coords(n, seed, count=240):
    """Seeded coordinates over the grid and past each of its edges, every
    pairing of the edge values included."""
    rng = np.random.default_rng(seed)
    edges = np.array([-3, -1, 0, n - 1, n, n + 2], np.int64)
    ex, ey = (rng.integers(-3, n + 3, count) for _ in range(2))
    gx, gy = np.meshgrid(edges, edges)
    return (np.concatenate([ex, gx.ravel()]).astype(np.int32),
            np.concatenate([ey, gy.ravel()]).astype(np.int32))


def _scalar(frac, r, ex, ey):
    """The reference's scalar maps on the clipped coordinates."""
    n = frac.s ** r
    out = []
    for x, y in zip(ex.tolist(), ey.tolist()):
        cx, cy = rm.nu_map_scalar(frac, r, min(max(x, 0), n - 1),
                                  min(max(y, 0), n - 1))
        out.append((cx, cy, rm.is_fractal_scalar(frac, r, x, y)))
    return [np.array(c) for c in zip(*out)]


@pytest.mark.parametrize("name", NAMES)
def test_grouped_lookup_matches_the_reference(name):
    frac, ref = tf.REGISTRY[name], rf.REGISTRY[name]
    for r in _levels(frac):
        ex, ey = _coords(frac.side(r), seed=r + len(name))
        got = _emulate(frac, r, ex, ey)
        for g, w in zip(got, _scalar(ref, r, ex, ey)):
            np.testing.assert_array_equal(g, w, err_msg=f"r={r}")
        if 0 < r and frac.k ** ((r - 1) // 2) < 2 ** 24:
            want = rm.nu_with_membership(ref, r, jnp.asarray(ex),
                                         jnp.asarray(ey))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, np.asarray(w),
                                              err_msg=f"r={r}")


@pytest.mark.parametrize("name,levels", [("sierpinski", 2), ("sierpinski", 6),
                                         ("carpet", 4), ("vicsek", 4)])
def test_other_group_lengths_match_the_plain_version(name, levels):
    """Groups of other even lengths (the A/B's candidates) compute the same
    function: the emulation against the port's plain version."""
    frac = tf.REGISTRY[name]
    for r in sorted({1, levels - 1, levels + 1, 2 * levels + 1,
                     nm.max_int32_level(frac)}):
        ex, ey = _coords(frac.side(r), seed=r)
        want = nm.nu_map_tc_plain(frac, r, torch.from_numpy(ex),
                                  torch.from_numpy(ey))
        for g, w in zip(_emulate(frac, r, ex, ey, levels), want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"r={r}")


def test_plan_groups_and_tables():
    """G = ceil(r / L) groups, the top one over r - (G - 1) L levels with a
    table of its own where that is short of L; r = 0 has none."""
    sier, carpet = tf.SIERPINSKI, tf.CARPET
    assert nm.nu_plan(sier, 16) == nm.NuPlan(4, 4, 4, 256)
    assert nm.nu_plan(sier, 30) == nm.NuPlan(4, 8, 2, 256 + 16)
    assert nm.nu_plan(sier, 0) == nm.NuPlan(4, 0, 0, 256)
    assert nm.nu_plan(carpet, 19) == nm.NuPlan(2, 10, 1, 81 + 9)
    assert nm.nu_plan(carpet, 4, levels=4) == nm.NuPlan(4, 1, 4, 6561)
    # vicsek's (0, 0) is a hole: a group with it at either level is not a
    # member; (4, 4) is the center at both
    table = nm.nu_group_table(tf.VICSEK, 2)
    assert table[0] & nm.HOLE and table[1 + 9 * 1] & nm.HOLE
    assert table[4 + 9 * 4] == 2 | 2 << 16
    # sierpinski's H_nu[y, x] = x + y over one (odd) level: the code in the
    # cx part, (1, 0) a hole
    assert nm.nu_group_table(sier, 1).tolist() == [0, nm.HOLE, 1, 2]


def test_plan_refuses_tables_past_shared_memory():
    """s = 15 fits (15^4 + 15^2 entries), s = 16 does not."""
    def square(s):
        return tf.NBBFractal(f"s{s}", s, ((0, 0), (1, 1)))
    assert nm.nu_plan(square(15), 3).entries == 15 ** 4 + 15 ** 2
    with pytest.raises(ValueError, match="shared memory|entries"):
        nm.nu_plan(square(16), 3)
    frac = square(5)   # another s: L = 2 on the runtime path
    ex, ey = _coords(frac.side(5), seed=5)
    for g, w in zip(_emulate(frac, 5, ex, ey), nm.nu_map_tc_plain(
            frac, 5, torch.from_numpy(ex), torch.from_numpy(ey))):
        np.testing.assert_array_equal(g, w.numpy())


def test_nu_entry_matches_the_source():
    """The C entry takes as many arguments as the wrapper passes; its
    compiled group lengths and hole bit are the wrapper's."""
    text = SOURCE.read_text()
    params = re.search(r"int sq_nu_map\((.*?)\)", text, re.S).group(1)
    assert len(params.split(",")) == len(nm._ARGS)
    assert "int levels, const int* table, int entries" in " ".join(
        params.split())
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kLevels2"]) == nm.LEVELS[2]
    assert int(consts["kLevels3"]) == nm.LEVELS[3] == nm.group_levels(5)
    assert re.search(r"constexpr int kHole = 1 << 15;", text)
    assert nm.HOLE == 1 << 15 and nm.FIELD == nm.HOLE - 1


@pytest.mark.parametrize("name", NAMES)
def test_plain_nu_at_level_zero(name):
    """r = 0, one cell: the plain version (the CPU wrapper) gives cx = cy =
    0 and valid = in bounds, as the reference's scalar maps do (it raised
    on the empty list of levels before)."""
    frac = tf.REGISTRY[name]
    ex, ey = _coords(1, seed=0, count=8)
    got = nm.nu_map_tc(frac, 0, torch.from_numpy(ex), torch.from_numpy(ey))
    for g, w in zip(got, _scalar(rf.REGISTRY[name], 0, ex, ey)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
