"""The lambda kernel's grouped lookup (``csrc/squeeze_maps.cu``,
``lambda_kernel``), emulated in numpy from the port's pure table functions
(``lambda_plan``, ``lambda_tables``), against the JAX reference's scalar
map (Python integers), bit for bit: the five registry fractals, r from 0 to
max_int32_level, compact coordinates negative and past every edge (lambda
does not clip: floor division, non-negative remainders), short top groups
and vicsek, whose tau(0) is (1, 0), not (0, 0). The kernel itself is held
against its plain version on the card (``tests/test_torch_cuda.py``).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import fractals as rf
from repro.core import maps as rm
from repro_torch.core import fractals as tf
from repro_torch.kernels import lambda_map as lm
from repro_torch.kernels import nu_map as nm

NAMES = sorted(tf.REGISTRY)
SOURCE = Path(lm.__file__).parent / "csrc" / "squeeze_maps.cu"


def _floor_divmod(q, d):
    """(floor(q / d), q mod d) as the kernel's ``floor_divmod`` computes
    them: an unsigned division of q, or of ~q for q < 0, flipped back."""
    q = np.asarray(q, np.int64)
    neg = q < 0
    u = np.where(neg, ~q, q)
    uq, ur = u // d, u % d
    return np.where(neg, ~uq, uq), np.where(neg, d - 1 - ur, ur)


def _emulate(frac, r, cx, cy, levels=0):
    """(ex, ey) as ``lambda_kernel`` computes them: per group one floor
    divmod of each coordinate by k^(L/2), one lookup (the top group in its
    own table where it is short), the partials weighted by s^(gL) in
    int32."""
    plan = lm.lambda_plan(frac, r, levels)
    tab = lm.lambda_tables(frac, plan.levels, plan.top).astype(np.int64)
    assert tab.size == plan.entries
    d, sl = frac.k ** (plan.levels // 2), frac.s ** plan.levels
    top_off = d * d if 0 < plan.top < plan.levels else 0
    qx, qy = np.asarray(cx, np.int64), np.asarray(cy, np.int64)
    ax, ay, w = np.zeros_like(qx), np.zeros_like(qx), 1
    for g in range(plan.groups):
        last = g == plan.groups - 1
        qx, rx = _floor_divmod(qx, d)
        qy, ry = _floor_divmod(qy, d)
        e = tab[(top_off if last else 0) + rx + d * ry] & 0xFFFFFFFF
        ax += (e & lm.FIELD) * w
        ay += (e >> 16) * w
        if not last:
            w *= sl
        assert w < 2 ** 31
    assert max(ax.max(initial=0), ay.max(initial=0)) < 2 ** 31
    return ax.astype(np.int32), ay.astype(np.int32)


def _coords(frac, r, seed, count=200):
    """Seeded compact coordinates over [-2 side, 2 side) of each axis
    (within int32), and every pairing of the edge values."""
    rng = np.random.default_rng(seed)
    rows, cols = frac.compact_dims(r)
    out = []
    for side in (cols, rows):
        lo, hi = max(-2 * side, -2 ** 31), min(2 * side, 2 ** 31 - 1)
        edges = np.clip([-side - 1, -1, 0, side - 1, side, 2 * side - 1],
                        -2 ** 31, 2 ** 31 - 1)
        out.append((rng.integers(lo, hi, count), np.array(edges)))
    (ux, ex), (uy, ey) = out
    gx, gy = np.meshgrid(ex, ey)
    return (np.concatenate([ux, gx.ravel()]).astype(np.int32),
            np.concatenate([uy, gy.ravel()]).astype(np.int32))


def _scalar(ref, r, cx, cy):
    """The reference's scalar lambda (Python integers) at each point."""
    return [np.array(c, np.int64) for c in zip(*(
        rm.lambda_map_scalar(ref, r, int(x), int(y))
        for x, y in zip(cx, cy)))]


@pytest.mark.parametrize("name", NAMES)
def test_grouped_lookup_matches_the_reference(name):
    """Every r from 0 to the largest whose coordinates fit int32: the top
    group full and short by every count of levels."""
    frac, ref = tf.REGISTRY[name], rf.REGISTRY[name]
    for r in range(nm.max_int32_level(frac) + 1):
        cx, cy = _coords(frac, r, seed=r + len(name), count=40)
        got = _emulate(frac, r, cx, cy)
        if r == 0:
            want = [np.zeros(cx.size, np.int64)] * 2
        else:
            want = _scalar(ref, r, cx, cy)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.astype(np.int32),
                                          err_msg=f"r={r}")


@pytest.mark.parametrize("name,levels", [("sierpinski", 4),
                                         ("sierpinski", 6), ("carpet", 2),
                                         ("vicsek", 2)])
def test_other_group_lengths_match_the_plain_version(name, levels):
    """Groups of other even lengths (the A/B's candidates) compute the
    same function: the emulation against the port's plain version."""
    frac = tf.REGISTRY[name]
    for r in sorted({1, levels - 1, levels + 1, 2 * levels + 1,
                     nm.max_int32_level(frac)}):
        cx, cy = _coords(frac, r, seed=r)
        want = lm.lambda_map_tc_plain(frac, r, torch.from_numpy(cx),
                                      torch.from_numpy(cy))
        for g, w in zip(_emulate(frac, r, cx, cy, levels), want):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=f"r={r}")


def test_plan_groups_and_tables():
    """G = ceil(r / L) groups, the top one over r - (G - 1) L levels with a
    table of its own (k^L more entries) where that is short of L; vicsek's
    replica 0 sits at (1, 0), so a short top table does not pad with digit
    0."""
    sier, carpet, vicsek = tf.SIERPINSKI, tf.CARPET, tf.VICSEK
    assert lm.lambda_plan(sier, 16) == lm.LambdaPlan(8, 2, 8, 6561)
    assert lm.lambda_plan(sier, 17) == lm.LambdaPlan(8, 3, 1, 2 * 6561)
    assert lm.lambda_plan(sier, 0) == lm.LambdaPlan(8, 0, 0, 6561)
    assert lm.lambda_plan(carpet, 19) == lm.LambdaPlan(4, 5, 3, 2 * 4096)
    assert lm.lambda_plan(vicsek, 8).entries == 625
    assert lm.lambda_plan(sier, 16, levels=6) == lm.LambdaPlan(6, 3, 4,
                                                               2 * 729)
    full = lm.lambda_group_table(vicsek, 4, 4)
    top = lm.lambda_group_table(vicsek, 4, 1)
    # digits (0, 0, 0, 0): tau(0) = (1, 0) at every level, or the first
    assert full[0] == (1 + 3 + 9 + 27) | (0 << 16) and top[0] == 1
    # sierpinski's tau(2) = (1, 1): rx = 2 at the group's first level
    assert lm.lambda_group_table(sier, 2, 2)[2] == 1 | 1 << 16


def test_plan_shrinks_groups_past_shared_memory():
    """A fractal whose k^L tables outgrow one CTA take shorter groups (the
    kernel's runtime path), and still compute lambda; an odd or oversized
    group length is refused."""
    full2 = tf.NBBFractal("full2", 2, ((0, 0), (1, 0), (0, 1), (1, 1)))
    plan = lm.lambda_plan(full2, 13)
    assert plan.levels == 6 and plan.entries == 2 * 4 ** 6
    cx, cy = _coords(full2, 13, seed=1)
    want = lm.lambda_map_tc_plain(full2, 13, torch.from_numpy(cx),
                                  torch.from_numpy(cy))
    for g, w in zip(_emulate(full2, 13, cx, cy), want):
        np.testing.assert_array_equal(g, w.numpy())
    with pytest.raises(ValueError, match="entries"):
        lm.lambda_plan(tf.SIERPINSKI, 16, levels=5)
    with pytest.raises(ValueError, match="entries"):
        lm.lambda_plan(full2, 16, levels=10)


def test_lambda_entry_matches_the_source():
    """The C entry takes as many arguments as the wrapper passes; its
    compiled group lengths are the plan's."""
    text = SOURCE.read_text()
    params = re.search(r"int sq_lambda_map\((.*?)\)", text, re.S).group(1)
    assert len(params.split(",")) == len(lm._ARGS)
    assert "int levels, const int* table, int entries" in " ".join(
        params.split())
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", text))
    assert int(consts["kLambdaL2"]) == lm.LEVELS[2]
    assert int(consts["kLambdaL3"]) == lm.LEVELS[3]
    for name in ("sierpinski", "carpet", "vicsek", "empty_bottles"):
        frac = tf.REGISTRY[name]
        assert re.search(rf"s == {frac.s} && k == {frac.k} && levels == "
                         rf"kLambdaL{frac.s}", text), name
