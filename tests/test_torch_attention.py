"""The port's flash attention on the CPU against the reference.

``attention_plain`` and ``flash_attention`` (which takes its plain version
for CPU tensors) against ``repro.kernels.ref.attention_ref`` on the cases of
``chip_smoke.py``'s phase 14 at small widths, at the reference's bars
(``tests/test_kernels_attention.py``: 2e-5 for float32, 2e-2 for
bfloat16), and one case against the Pallas kernel in interpret mode. Inputs
come from numpy with a seed and go to both packages.
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
