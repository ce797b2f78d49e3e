"""The port's Mamba-2 SSD scan on the CPU against the reference.

``models.ssm._ssd_chunked`` against the reference's (G = 1 and 2 groups);
``ssd_chunk_scan`` (the plain intra-chunk block for CPU tensors, then the
PyTorch recurrence) against ``repro.kernels.ref.ssd_ref`` at the reference
test's shapes, across chunk sizes and against the token-by-token
recurrence, at the reference's bars (``tests/test_kernels_ssd.py``: 2e-5,
3e-5, 2e-4), and one case against the Pallas kernel in interpret mode.
Inputs come from numpy with a seed and go to both packages.
"""
import re
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models import ssm as jssm
from repro_torch.kernels import build
from repro_torch.kernels import ssd_chunk as ts
from repro_torch.models import ssm as tssm

SHAPES = {                      # (b, s, h, p, n, chunk)
    "tiny": (1, 16, 2, 8, 8, 8),
    "multi": (2, 64, 4, 16, 16, 16),
    "ragged": (1, 40, 3, 8, 16, 16),
}


def _inputs(b, s, h, p, n, seed, groups=None):
    """x, dt (softplus), a (negative), B and C, as the reference test draws
    them; B and C (b, s, n), or (b, s, groups, n)."""
    rng = np.random.default_rng(seed)
    lead = (b, s) if groups is None else (b, s, groups)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)) \
        .astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = (rng.standard_normal(lead + (n,)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal(lead + (n,)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jnp(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_the_reference(groups):
    arrays = _inputs(2, 40, 4, 8, 16, seed=groups, groups=groups)
    want = np.asarray(jssm._ssd_chunked(*_jnp(arrays), 16))
    got = tssm._ssd_chunked(*_torch(arrays), 16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_ssd_scan_matches_the_oracle(shape):
    b, s, h, p, n, chunk = SHAPES[shape]
    arrays = _inputs(b, s, h, p, n, seed=s)
    want = np.asarray(ref.ssd_ref(*_jnp(arrays), chunk))
    got = ts.ssd_chunk_scan(*_torch(arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    x, dt, a, bm, cm = _torch(arrays)
    oracle = tssm._ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None],
                               chunk)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_ssd_scan_is_chunk_size_invariant():
    arrays = _torch(_inputs(1, 64, 2, 8, 8, seed=3))
    y1 = ts.ssd_chunk_scan(*arrays, chunk=8)
    y2 = ts.ssd_chunk_scan(*arrays, chunk=32)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=3e-5, atol=3e-5)


def test_ssd_scan_matches_the_sequential_recurrence():
    """h = h exp(dt a) + dt B x, y = C h, token by token (float64)."""
    b, s, h, p, n = 1, 24, 2, 4, 8
    x, dt, a, bm, cm = _inputs(b, s, h, p, n, seed=7)
    state = np.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        da = np.exp(dt[:, t] * a[None])
        upd = np.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        state = state * da[..., None, None] + upd
        ys.append(np.einsum("bhpn,bn->bhp", state, cm[:, t]))
    want = np.stack(ys, axis=1)
    got = ts.ssd_chunk_scan(*_torch((x, dt, a, bm, cm)), chunk=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_ssd_scan_matches_the_pallas_kernel_in_interpret_mode():
    arrays = _inputs(2, 40, 3, 8, 16, seed=11)
    want = np.asarray(ops.ssd_chunk_scan(*_jnp(arrays), chunk=16,
                                         interpret=True))
    got = ts.ssd_chunk_scan(*_torch(arrays), chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ssd_chunk_plain_is_the_intra_chunk_block():
    """y_diag and the states of one chunk against their definitions, summed
    in float64: the lower triangle only, the state weighted to the chunk's
    end."""
    x, dt, a, bm, cm = _inputs(1, 8, 2, 4, 4, seed=5)
    y, st = ts.ssd_chunk_plain(*_torch((x, dt, a, bm, cm)))
    cs = np.cumsum(dt[0].astype(np.float64) * a, axis=0)       # (L, H)
    cb = cm[0].astype(np.float64) @ bm[0].T
    want_y = np.zeros((8, 2, 4))
    want_st = np.zeros((2, 4, 4))
    for hh in range(2):
        for li in range(8):
            for m in range(li + 1):
                want_y[li, hh] += cb[li, m] * np.exp(cs[li, hh] - cs[m, hh]) \
                    * dt[0, m, hh] * x[0, m, hh]
        for m in range(8):
            want_st[hh] += np.outer(
                x[0, m, hh] * np.exp(cs[-1, hh] - cs[m, hh]) * dt[0, m, hh],
                bm[0, m])
    np.testing.assert_allclose(y[0].numpy(), want_y, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(st[0].numpy(), want_st, rtol=2e-5, atol=2e-5)


def test_ssd_grid_and_shared_memory_at_mamba2_780m():
    """64 chunks of 128 (batch 4, S = 2048) and 48 heads: 256 CTAs of 8
    warps, two an SM, of 12 (chunk, head) units with two x buffers in
    82,964 shared bytes. Chunks of 256 and 512 at the same S are planned
    (one CTA of 16 warps an SM; one x buffer at 512) and taken up to the
    launch, which a device that is not CUDA refuses; a chunk whose x alone
    is over one CTA's shared memory (832 at P = 64) is refused before any
    build."""
    assert ts.ssd_plan(64, 128, 48, 64) == ts.SsdPlan(128, 12, 256, 8, 2)
    assert ts.smem_bytes(128, 64, 12, 2) == 82964
    assert ts.ssd_plan(32, 256, 48, 64) == ts.SsdPlan(256, 12, 128, 16, 2)
    assert ts.ssd_plan(16, 512, 48, 64) == ts.SsdPlan(512, 6, 128, 16, 1)

    def meta(chunk):
        return [torch.empty(s, device="meta") for s in
                ((1, chunk, 2, 64), (1, chunk, 2), (2,), (1, chunk, 128),
                 (1, chunk, 128))]
    with mock.patch.object(build, "load_library",
                           return_value=mock.MagicMock()):
        for chunk in (128, 256, 512):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                ts.ssd_chunk(*meta(chunk))
    assert ts.smem_bytes(832, 64, 1, 1) > 232448
    with mock.patch.object(build, "load_library",
                           side_effect=AssertionError("built")):
        with pytest.raises(ValueError, match="shared memory"):
            ts.ssd_chunk(*meta(832))


@pytest.mark.parametrize("args,want", [
    ((1, 8, 2, 8), (16, 1, 2, 2, 2)),        # two units: a CTA each
    ((3, 40, 3, 16), (48, 1, 9, 2, 2)),      # a chunk of 40 in 48 rows
    ((4, 128, 2, 64), (128, 1, 8, 2, 2)),
    ((10 ** 4, 128, 48, 64), (128, 43, 11163, 2, 2)),  # cs, dt cap units
    ((16, 256, 48, 64), (256, 6, 128, 1, 2)),
    ((1, 816, 1, 64), (816, 1, 1, 1, 1)),    # the longest chunk at P = 64
    ((2, 512, 4, 8), (512, 1, 8, 1, 2)),     # two buffers, one CTA
])
def test_ssd_plan_cases(args, want):
    """(rows, heads, ctas, CTAs an SM, x_buffers) by shape (16 warps an
    SM), the layout within its CTAs' share of an SM, every unit in some
    CTA's range."""
    plan = ts.ssd_plan(*args)
    per_sm = 16 // plan.warps
    assert (plan.rows, plan.heads, plan.ctas, per_sm, plan.x_buffers) == want
    units = args[0] * args[2]
    assert plan.ctas <= units <= plan.ctas * plan.heads
    assert ts.smem_bytes(args[1], args[3], plan.heads, plan.x_buffers) <= \
        min(232448, 233472 // per_sm - 1024)


def test_ssd_entry_matches_the_source():
    """The C entry takes as many arguments as the wrapper passes, in the
    plan's order, and lays out shared memory as ``smem_bytes`` does."""
    text = (Path(ts.__file__).parent / "csrc" / "ssd_chunk.cu").read_text()
    params = re.search(r"int sq_ssd_chunk\((.*?)\)", text, re.S).group(1)
    assert len(params.split(",")) == len(ts._ARGS)
    assert "int heads, int ctas, int xbuf, int warps, void* stream" in \
        " ".join(params.split())
    assert "round_up(P, 32) + 4" in text
    assert "(size_t)xbuf * Lp * (x_stride(P) + 1) +" in text
    assert "(size_t)2 * heads * Lp + 1 + 2 * xbuf" in text


def _tf32(x):
    """x rounded to TF32 as the kernel's ``tf32`` does (half an ulp added,
    the 13 low bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _mm3(a, b):
    """a @ b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, float32 sums."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (np.matmul(al, bh, dtype=np.float32)
            + np.matmul(ah, bl, dtype=np.float32)
            + np.matmul(ah, bh, dtype=np.float32))


def _emulated_chunk(xc, dtc, a, bc, cc):
    """The kernel's intra-chunk block in numpy: cs summed in float32 in
    order, cb = C B^T, the scores (cb exp(cs_l - cs_m)) dt_m below the
    diagonal, y = scores x and state = (x w)^T B, every product in 3xTF32
    with float32 sums."""
    x, dt, bm, cm = (t.numpy() for t in (xc, dtc, bc, cc))
    ll = x.shape[1]
    cs = np.cumsum(dt * a.numpy()[None, None, :], axis=1, dtype=np.float32)
    cb = _mm3(cm, bm.transpose(0, 2, 1))                       # (C, L, L)
    csh = cs.transpose(0, 2, 1)                                # (C, H, L)
    tri = np.tril(np.ones((ll, ll), bool))
    with np.errstate(over="ignore", invalid="ignore"):
        decay = np.exp(csh[..., :, None] - csh[..., None, :])
        scores = np.where(tri, cb[:, None] * decay
                          * dt.transpose(0, 2, 1)[:, :, None, :], 0)
    y = _mm3(scores.astype(np.float32), x.transpose(0, 2, 1, 3))
    w = np.exp(cs[:, -1:, :] - cs) * dt                        # (C, L, H)
    xw = (x * w[..., None]).transpose(0, 2, 3, 1)              # (C,H,P,L)
    states = _mm3(xw, bm[:, None])                             # (C,H,P,N)
    return (torch.from_numpy(np.ascontiguousarray(y.transpose(0, 2, 1, 3))),
            torch.from_numpy(states))


@pytest.mark.parametrize("shape", sorted(SHAPES) + ["chunk256"])
def test_3xtf32_chunk_products_match_the_reference(shape):
    """The scan with the intra-chunk block emulated as the kernel computes
    it (3xTF32 products) against ``ref.ssd_ref`` at 2e-5, at the reference
    test's shapes and at a chunk of 256 with a ragged S at mamba2-780m's
    head and state widths (P = 64, N = 128)."""
    b, s, h, p, n, chunk = {**SHAPES, "chunk256": (1, 300, 2, 64, 128, 256)
                            }[shape]
    arrays = _inputs(b, s, h, p, n, seed=s)
    want = np.asarray(ref.ssd_ref(*_jnp(arrays), chunk))
    with mock.patch.object(ts, "ssd_chunk", _emulated_chunk):
        got = ts.ssd_chunk_scan(*_torch(arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_ssd_on_a_device_tensor_launches_or_raises():
    """A tensor off the CPU goes to the kernel: a failed build raises, the
    plain version is never called and nothing is counted."""
    meta = [torch.empty(s, device="meta") for s in
            ((2, 8, 2, 4), (2, 8, 2), (2,), (2, 8, 4), (2, 8, 4))]
    before = dict(build.LAUNCHES)
    with mock.patch.object(ts, "ssd_chunk_plain",
                           side_effect=AssertionError("fell back")):
        with mock.patch.object(build, "load_library",
                               side_effect=build.KernelBuildError("nvcc")):
            with pytest.raises(build.KernelBuildError):
                ts.ssd_chunk(*meta)
        with mock.patch.object(build, "load_library",
                               return_value=mock.MagicMock()):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                ts.ssd_chunk(*meta)
    with pytest.raises(ValueError, match="do not match"):
        ts.ssd_chunk(*_torch(_inputs(1, 8, 2, 4, 4, seed=0))[:1],
                     torch.zeros(8, 2), torch.zeros(2), torch.zeros(8, 4),
                     torch.zeros(8, 4))
    assert build.LAUNCHES == before
