"""The port's flash attention on the CPU against the reference.

``attention_plain`` and ``flash_attention`` (which takes its plain version
for CPU tensors) against ``repro.kernels.ref.attention_ref`` on the cases of
``chip_smoke.py``'s phase 14 at small widths, at the reference's bars
(``tests/test_kernels_attention.py``: 2e-5 for float32, 2e-2 for
bfloat16), and one case against the Pallas kernel in interpret mode. Inputs
come from numpy with a seed and go to both packages. ``plan``, which picks
the kernel body on the card from the shape alone, is tested here too: the
body for each dtype, D, alignment and Sq, and the split body's splits.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import attention as ta
from repro_torch.kernels import build

TOL = {"f32": 2e-5, "bf16": 2e-2}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}

#: name -> ((B, H, Sq, Sk, D), keyword arguments)
CASES = {
    "1blk": ((1, 2, 128, 128, 128), {}),
    "multi": ((2, 3, 256, 256, 128), {}),
    "prefill-chunk": ((1, 2, 128, 384, 128), {}),
    "window128": ((1, 2, 384, 384, 128), {"window": 128}),
    "window256": ((1, 2, 384, 384, 128), {"window": 256}),
    "softcap": ((1, 2, 256, 256, 128), {"softcap": 50.0}),
    "decode": ((2, 2, 1, 512, 128), {"bq": 1}),
    "noncausal": ((1, 2, 128, 256, 64), {"causal": False}),
    "empty-rows": ((1, 2, 256, 128, 64), {}),
    "window-hides-all": ((1, 1, 64, 128, 64), {"window": 0}),
    "d256": ((1, 2, 128, 256, 256), {"window": 96, "softcap": 50.0}),
}


def _qkv(shape, seed):
    b, h, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


def _ref(arrays, dtype, kw):
    kw = {n: v for n, v in kw.items() if n not in ("bq", "bk")}
    got = ref.attention_ref(*(jnp.asarray(a, JNP[dtype]) for a in arrays),
                            **kw)
    return np.asarray(got.astype(jnp.float32))


def _port(fn, arrays, dtype, kw):
    out = fn(*(torch.from_numpy(a).to(TORCH[dtype]) for a in arrays), **kw)
    assert out.dtype == TORCH[dtype]
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_reference(case, dtype):
    shape, kw = CASES[case]
    arrays = _qkv(shape, seed=len(case))
    want = _ref(arrays, dtype, kw)
    tol = TOL[dtype]
    got = _port(ta.flash_attention, arrays, dtype, kw)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    plain_kw = {n: v for n, v in kw.items() if n not in ("bq", "bk")}
    np.testing.assert_allclose(_port(ta.attention_plain, arrays, dtype,
                                     plain_kw), want, rtol=tol, atol=tol)


def test_rows_without_a_visible_key_get_the_mean_of_v():
    """Causal with Sq > Sk: the first Sq - Sk queries see no key; as in the
    reference (-1e30, not -inf) they get the mean of v, with no NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 96, 32, 16), 4))
    out = ta.flash_attention(q, k, v, causal=True)
    assert torch.isfinite(out).all()
    mean = v.mean(dim=2, keepdim=True).expand(1, 2, 64, 16)
    np.testing.assert_allclose(out[:, :, :64].numpy(), mean.numpy(),
                               rtol=2e-5, atol=2e-5)
    assert not torch.allclose(out[:, :, 64:], mean[:, :, :32])


def test_flash_matches_the_pallas_kernel_in_interpret_mode():
    shape = (1, 2, 128, 256, 64)
    arrays = _qkv(shape, seed=9)
    kw = dict(causal=True, window=96, softcap=30.0)
    want = np.asarray(ops.flash_attention(
        *(jnp.asarray(a) for a in arrays), bq=64, bk=128, interpret=True,
        **kw))
    got = _port(ta.flash_attention, arrays, "f32", dict(kw, bq=64, bk=128))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_refuses_what_the_reference_refuses():
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 1, 96, 128, 16), 0))
    with pytest.raises(ValueError, match="multiples"):
        ta.flash_attention(q, k, v, bq=64)
    with pytest.raises(ValueError, match="multiples"):
        ta.flash_attention(q, k, v, bk=96)
    with pytest.raises(ValueError, match="Sk"):
        ta.flash_attention(q, k[..., :8], v)
    with pytest.raises(TypeError, match="bfloat16"):
        ta.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        ta.flash_attention(q, k.bfloat16(), v)
    # a length that divides is taken whatever the default tile
    assert ta.flash_attention(q, k, v, bq=32).shape == q.shape


def test_flash_on_a_device_tensor_launches_or_raises():
    """A tensor off the CPU goes to the kernel: a failed build raises, the
    plain version is never called and nothing is counted; a device that is
    not CUDA is refused."""
    meta = [torch.empty((1, 2, 8, 8), device="meta") for _ in range(3)]
    before = dict(build.LAUNCHES)
    with mock.patch.object(ta, "attention_plain",
                           side_effect=AssertionError("fell back")):
        with mock.patch.object(build, "load_library",
                               side_effect=build.KernelBuildError("nvcc")):
            with pytest.raises(build.KernelBuildError):
                ta.flash_attention(*meta)
        with mock.patch.object(build, "load_library",
                               return_value=mock.MagicMock()):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                ta.flash_attention(*meta)
    assert build.LAUNCHES == before


#: (dtype, D, aligned, Sq, B*H) -> the body ``plan`` picks
PLANS = [
    ("f32", 256, True, 8192, 8, ta.FP32),      # float32 prefill: FP32 FMA
    ("bf16", 256, True, 8192, 8, ta.TC),       # gemma2 global/local layer
    ("bf16", 72, True, 200, 2, ta.TC),         # ragged tiles, padded D
    ("bf16", 36, True, 128, 2, ta.FP32),       # no 16-byte rows
    ("bf16", 256, False, 128, 8, ta.FP32),     # not 16-byte aligned
    ("bf16", 256, True, 1, 64, ta.SPLIT),      # gemma2 decode
    ("f32", 256, True, 1, 64, ta.SPLIT),
    ("f32", 36, True, 1, 4, ta.SPLIT),         # 36 floats: 16-byte rows
    ("bf16", 36, True, 1, 4, ta.FP32),
    ("f32", 256, False, 1, 64, ta.FP32),
    ("bf16", 64, True, 8, 2, ta.SPLIT),        # the split body's most rows
    ("bf16", 64, True, 9, 2, ta.TC),
    ("f32", 64, True, 9, 2, ta.FP32),
    ("bf16", 128, True, 1, 4096, ta.SPLIT),    # a batch that fills the card
]


@pytest.mark.parametrize("dtype,d,aligned,sq,bh,body", PLANS,
                         ids=[f"{p[0]}-d{p[1]}-{'al' if p[2] else 'mis'}"
                              f"-sq{p[3]}-bh{p[4]}" for p in PLANS])
def test_plan_picks_the_body_from_the_shape(dtype, d, aligned, sq, bh,
                                            body):
    p = ta.plan(TORCH[dtype], bh, sq, 8192, d, aligned)
    assert p.body == body
    assert (p.n_split > 0) == (body == ta.SPLIT)


#: (B*H, Sq, Sk, causal, window)
SPLITS = [
    (64, 1, 8192, True, None),     # gemma2 decode: every key
    (64, 1, 8192, True, 4096),     # a local layer's decode: the last 4096
    (4, 1, 1000, True, None),      # no split size divides 1000
    (4, 4, 1000, True, 250),       # four rows under a window
    (2, 8, 5, True, None),         # causal Sq > Sk: rows that see no key
    (2, 1, 512, True, 0),          # a window that hides every key
    (3, 2, 77, False, 10),         # non-causal window
    (1, 1, 1, True, None),         # one key
    (4096, 1, 300, True, None),    # many heads: one split each
]


@pytest.mark.parametrize("bh,sq,sk,causal,window", SPLITS)
def test_plan_splits_cover_the_visible_keys_none_empty(bh, sq, sk, causal,
                                                       window):
    """The splits tile [kv_lo, kv_end) in order, none empty; that range
    holds every key some row sees, or every key when a row sees none (it
    then takes the mean of v over all Sk)."""
    p = ta.plan(torch.bfloat16, bh, sq, sk, 128, True, causal, window)
    assert p.body == ta.SPLIT
    # split i holds keys [kv_lo + i split_len, kv_lo + (i + 1) split_len),
    # cut at kv_end, as the kernel takes them
    splits = [(p.kv_lo + i * p.split_len,
               min(p.kv_lo + (i + 1) * p.split_len, p.kv_end))
              for i in range(p.n_split)]
    assert p.n_split >= 1
    assert splits[0][0] == p.kv_lo and splits[-1][1] == p.kv_end
    assert all(a < b <= a + p.split_len for a, b in splits)
    assert all(b == a2 for (_, b), (a2, _) in zip(splits, splits[1:]))
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    seen = np.ones((sq, sk), bool)
    if causal:
        seen &= kpos <= qpos
    if window is not None:
        seen &= kpos > qpos - window
    if not seen.any(axis=1).all():
        assert (p.kv_lo, p.kv_end) == (0, sk)
    else:
        cols = np.flatnonzero(seen.any(axis=0))
        assert (p.kv_lo, p.kv_end) == (cols[0], cols[-1] + 1)
    assert p.n_split * bh >= min(ta.SPLIT_CTAS,
                                 bh * -(-(p.kv_end - p.kv_lo)
                                        // ta.SPLIT_MIN_KEYS))
