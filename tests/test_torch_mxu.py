"""v5's tensor-core design on the CPU: its launch geometry (``mxu_plan``),
its banded operators against the reference's, and the precision of its
TF32 products, emulated in numpy.

The kernel (``csrc/squeeze_stencil.cu``, ``products``) computes a slot's
Moore aggregate as ``sum_t (R_t X) C_t^T`` with ``mma.sync`` in TF32. For
the uint8 CA states it takes one pass: X in {0, 1} is exact in TF32, the
operators and Y = R_t X are rounded to TF32 (round to nearest), products
are exact in float32 and summed there, and ``rintf`` of the aggregate has
to give the count. For the float32 states it takes three (3xTF32: each
operand a = a_hi + a_lo, the product a_hi b_hi + a_hi b_lo + a_lo b_hi).
The emulations below round the same operands at the same places and sum
in float32; the bars are the ones the kernel's note states: within 0.25
of the count for every Moore pattern (``rintf`` needs 0.5), within 1e-6
of the float64 aggregate for HEAT and GRAY_SCOTT.
"""
import numpy as np
import pytest
import torch

from repro.kernels import squeeze_stencil as rsk
from repro.workloads import rules as rrules
from repro_torch.kernels import build
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.workloads import rules as trules
from repro_torch.workloads.base import banded_operators

#: every window width the tests and the main paths run: rho in {3, 4}
#: with k in {1, 2, rho}
WIDTHS = list(range(5, 13))


def tf32(x: np.ndarray) -> np.ndarray:
    """x (float32) rounded to TF32 as ``cvt.rna.tf32.f32`` does: to
    nearest with ties away from zero, keeping a 10-bit mantissa."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32((np.asarray(x, np.float32) - hi).astype(np.float32))


def one_pass(rm, cm, x):
    """sum_t tf32(tf32(R_t) @ X) @ tf32(C_t)^T, float32 sums; x (..., w,
    w) exact in TF32."""
    agg = np.zeros(x.shape, np.float32)
    for r, c in zip(rm, cm):
        y = tf32(np.matmul(tf32(r), x, dtype=np.float32))
        agg += np.matmul(y, tf32(c).T, dtype=np.float32)
    return agg


def three_pass(rm, cm, x):
    """The same with each product in 3xTF32."""
    def prod(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return (np.matmul(al, bh, dtype=np.float32)
                + np.matmul(ah, bl, dtype=np.float32)
                + np.matmul(ah, bh, dtype=np.float32))
    agg = np.zeros(x.shape, np.float32)
    for r, c in zip(rm, cm):
        agg += prod(prod(r, x), c.T)
    return agg


def moore_windows(w: int) -> np.ndarray:
    """(512 * (w-2)^2, w, w) float32: each of the 512 3x3 patterns placed
    at each interior center of a w x w window of zeros."""
    pats = ((np.arange(512)[:, None] >> np.arange(9)) & 1).reshape(512, 3, 3)
    out = []
    for y in range(1, w - 1):
        for x in range(1, w - 1):
            win = np.zeros((512, w, w), np.float32)
            win[:, y - 1:y + 2, x - 1:x + 2] = pats
            out.append(win)
    return np.concatenate(out)


@pytest.mark.parametrize("wl_name", ["life", "highlife"])
@pytest.mark.parametrize("w", WIDTHS)
def test_tf32_one_pass_counts_every_moore_pattern(wl_name, w):
    """One TF32 pass gives each of the 512 Moore patterns' counts, at every
    interior cell of the window, within 0.25 (rintf needs 0.5)."""
    wl = trules.WORKLOADS[wl_name]
    rm, cm = banded_operators(wl.weight_factors, w, np.float32)
    x = moore_windows(w)
    agg = one_pass(rm, cm, x)
    pats = x.reshape(-1, w, w)
    want = np.zeros_like(agg, dtype=np.float64)
    for (dy, dx), wt in np.ndenumerate(wl.weights3x3):
        if wt:
            want[:, 1:-1, 1:-1] += wt * pats[:, dy:w - 2 + dy, dx:w - 2 + dx]
    err = np.abs(agg[:, 1:-1, 1:-1] - want[:, 1:-1, 1:-1]).max()
    assert err <= 0.25, err
    assert np.array_equal(np.rint(agg[:, 1:-1, 1:-1]), want[:, 1:-1, 1:-1])


@pytest.mark.parametrize("wl_name", ["heat", "gray-scott"])
@pytest.mark.parametrize("w", WIDTHS)
def test_3xtf32_float_aggregate_within_1e6(wl_name, w):
    """3xTF32 agrees with the float64 aggregate of the same float32
    operators and states within 1e-6 (states in [0, 1))."""
    wl = trules.WORKLOADS[wl_name]
    rm, cm = banded_operators(wl.weight_factors, w, np.float32)
    x = np.random.default_rng(w).random((64, w, w)).astype(np.float32)
    want = sum(r.astype(np.float64) @ x.astype(np.float64)
               @ c.astype(np.float64).T for r, c in zip(rm, cm))
    assert np.abs(three_pass(rm, cm, x) - want).max() <= 1e-6
    # one pass would not do: the float bar needs the second and third
    assert np.abs(one_pass(rm, cm, x) - want).max() > 1e-5


@pytest.mark.parametrize("w", [5, 8, 12])
@pytest.mark.parametrize("wl_name", ["life", "highlife", "heat",
                                     "gray-scott"])
def test_banded_operators_match_reference(wl_name, w):
    """The operators the kernel multiplies are the reference v5's R and
    the blocks of its block-diagonal C^T."""
    rm, cm = sk._mxu_operators(trules.WORKLOADS[wl_name], w)
    ref_r, ref_ct = rsk._mxu_operators(rrules.WORKLOADS[wl_name], w, 1)
    np.testing.assert_array_equal(rm, ref_r)
    np.testing.assert_array_equal(np.swapaxes(cm, 1, 2), ref_ct)
    assert rm.shape[0] == 2   # two rank-1 terms: [R_0; R_1] fill M = 16


def test_tf32_rounding_is_round_to_nearest():
    x = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -12, -1.5,
                  1 + 2 ** -10], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1 + 2 ** -10, 1 + 2 ** -9, 1, -1.5, 1 + 2 ** -10],
                          np.float32))


@pytest.mark.parametrize("dtype,nc,rho,k,p,pieces,want", [
    # the main paths: LIFE / HEAT / GRAY_SCOTT at rho=4, k=2, P=16
    (torch.uint8, 1, 4, 2, 16, False, (1, 1, 8, 2, 12800)),
    (torch.float32, 1, 4, 2, 16, False, (1, 3, 8, 2, 26624)),
    (torch.float32, 2, 4, 2, 16, False, (1, 3, 8, 2, 53248)),
    (torch.uint8, 1, 4, 2, 16, True, (1, 1, 8, 2, 10240)),
    # w = 5..8 pad to one tile; an odd P leaves a zero slot; P=1 one warp
    (torch.uint8, 1, 3, 1, 7, False, (1, 1, 4, 2, 5504)),
    (torch.uint8, 1, 3, 1, 1, False, (1, 1, 1, 2, 1376)),
    # k = rho: W = 16, the wide instance
    (torch.uint8, 1, 4, 4, 7, False, (2, 1, 4, 2, 17536)),
    (torch.float32, 1, 3, 3, 11, True, (2, 3, 6, 2, 28512)),
    # windows near the old P w^2 <= 8192 limit: one warp, then one slot a
    # warp
    (torch.float32, 1, 32, 29, 1, False, (12, 3, 1, 2, 221184)),
    (torch.float32, 2, 27, 27, 1, False, (11, 3, 1, 1, 176400)),
])
def test_mxu_plan_by_shape(dtype, nc, rho, k, p, pieces, want):
    plan = sk.mxu_plan(dtype, nc, rho, k, p, pieces)
    assert (plan.nt, plan.passes, plan.warps, plan.spw, plan.smem) == want
    assert 8 * plan.nt >= rho + 2 * k > 8 * plan.nt - 8
    assert plan.smem <= build.MAX_SMEM
    assert plan.body == ("" if plan.nt == 1 else "[wide]")



def test_mxu_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        sk.mxu_plan(torch.float32, 2, 64, 32, 1)


def test_mxu_launch_names_are_registered():
    for name in ("stencil_step_mxu_batched", "stencil_step_mxu_k_local"):
        for body in ("", "[wide]"):
            assert name + body in sk.LAUNCHES
