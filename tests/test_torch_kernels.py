"""The port's stencil kernels: each plain PyTorch version against the JAX
reference ``block`` engine (bit-exact for CA, rtol=atol=1e-5 for floats),
one case each against the reference Pallas kernels in interpret mode, the
v2 strip gather against the reference's, and the wrappers' refusal to fall
back. The CUDA kernels themselves are held
against these plain versions in ``test_torch_cuda.py``."""
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import fractals as rf
from repro.core.compact import BlockLayout as RefLayout
from repro.core.stencil import SqueezeBlockEngine as RefBlockEngine
from repro.kernels import squeeze_stencil as rsk
from repro.workloads import rules as rrules
from repro.workloads.base import halo_needs as ref_halo_needs
from repro_torch.core import fractals as tf
from repro_torch.core.compact import BlockLayout
from repro_torch.kernels import build
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.workloads import rules as trules
from repro_torch.workloads.base import halo_needs

WORKLOADS = ["life", "highlife", "heat", "gray-scott"]
CASES = [("sierpinski", 5, 2), ("carpet", 3, 1)]
CASE_IDS = [f"{f}-r{r}-m{m}" for f, r, m in CASES]


def _tol(wl):
    return dict(rtol=0, atol=0) if wl.dtype == torch.uint8 \
        else dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _layout(name, r, m):
    return BlockLayout(tf.REGISTRY[name], r, m)


def _state(name, r, m, wl, batch=None, seed=0):
    """A numpy block state with holes zeroed by the layout's mask; the
    unbatched state is element 0 of the batch of 2."""
    lay = _layout(name, r, m)
    rng = np.random.default_rng(seed)
    shape = (batch or 2,) + \
        ((wl.n_channels,) if wl.n_channels > 1 else ()) + \
        (lay.n_blocks, lay.rho, lay.rho)
    x = rng.integers(0, 2, shape).astype(np.uint8) \
        if wl.dtype == torch.uint8 else rng.random(shape).astype(np.float32)
    x = x * lay.micro_mask
    return x if batch is not None else x[0]


@functools.lru_cache(maxsize=None)
def _ref_engine(name, r, m, wl_name):
    return RefBlockEngine(RefLayout(rf.REGISTRY[name], r, m),
                          rrules.WORKLOADS[wl_name])


@functools.lru_cache(maxsize=None)
def _reference(name, r, m, wl_name, k, batch=None):
    """k single steps of the reference XLA block engine from ``_state``
    (equal to its k-step fusion, which the reference's own tests show)."""
    if k == 0:
        return _state(name, r, m, trules.WORKLOADS[wl_name], batch=2)
    eng = _ref_engine(name, r, m, wl_name)
    prev = _reference(name, r, m, wl_name, k - 1, 2)
    out = np.stack([np.asarray(eng.step(jnp.asarray(s))) for s in prev])
    return out if batch is not None else out[0]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_fused_plain_matches_reference_block(case, wl_name):
    wl = trules.WORKLOADS[wl_name]
    x = torch.from_numpy(_state(*case, wl))
    got = sk.stencil_step_fused_plain(_layout(*case), x, wl)
    np.testing.assert_allclose(got.numpy(), _reference(*case, wl_name, 1),
                               **_tol(wl))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_fused_k_plain_matches_reference_block(case, wl_name, k):
    wl = trules.WORKLOADS[wl_name]
    x = torch.from_numpy(_state(*case, wl))
    got = sk.stencil_step_fused_k_plain(_layout(*case), x, wl, k=k)
    np.testing.assert_allclose(got.numpy(), _reference(*case, wl_name, k),
                               **_tol(wl))


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_mxu_plain_matches_reference_block(case, wl_name, k):
    wl = trules.WORKLOADS[wl_name]
    x = torch.from_numpy(_state(*case, wl, batch=2))
    got = sk.stencil_step_mxu_batched_plain(_layout(*case), x, wl, k=k)
    np.testing.assert_allclose(got.numpy(),
                               _reference(*case, wl_name, k, batch=2),
                               **_tol(wl))


@pytest.mark.parametrize("variant", ["blocks", "strips"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_single_step_plain_matches_reference_block(case, wl_name, variant):
    """v1's and v2's plain versions, batch of 2."""
    wl = trules.WORKLOADS[wl_name]
    plain = getattr(sk, f"stencil_step_{variant}_plain")
    x = torch.from_numpy(_state(*case, wl, batch=2))
    np.testing.assert_allclose(plain(_layout(*case), x, wl).numpy(),
                               _reference(*case, wl_name, 1, batch=2),
                               **_tol(wl))


@pytest.mark.parametrize("case,wl_name", [
    (CASES[0], "life"), (CASES[1], "heat"), (CASES[0], "gray-scott")],
    ids=["sierpinski-life", "carpet-heat", "sierpinski-gray-scott"])
def test_gather_halo_strips_matches_reference(case, wl_name):
    """The plain gather's (C, nb, 4, rho+2) strips with the workload's dead
    directions zero, and with a leading batch axis; the single-channel
    entry point too (on the CPU, the plain version)."""
    wl = trules.WORKLOADS[wl_name]
    ref_lay = _ref_engine(*case, wl_name).layout  # tables shared
    x = _state(*case, wl, batch=2)
    x5 = x if wl.n_channels > 1 else x[:, None]
    gather = jax.jit(rsk._gather_halo_strips, static_argnums=(0, 2))
    want = np.stack([np.asarray(gather(
        ref_lay, jnp.asarray(s), ref_halo_needs(
            rrules.WORKLOADS[wl_name].weights2d))) for s in x5])
    got = sk.gather_halo_strips_plain(_layout(*case), torch.from_numpy(x5),
                                      halo_needs(wl.weights2d))
    np.testing.assert_array_equal(got.numpy(), want)
    if wl.n_channels == 1:
        np.testing.assert_array_equal(
            sk.gather_halo_strips(_layout(*case),
                                  torch.from_numpy(x[0])).numpy(),
            np.asarray(gather(ref_lay, jnp.asarray(x[0])[None]))[0])


@pytest.mark.parametrize("entry,case,wl_name,k", [
    ("stencil_step_mxu", CASES[1], "heat", 1),
    ("stencil_step_mxu_k", CASES[0], "gray-scott", 2),
    ("life_step_fused", CASES[0], "life", 1)])
def test_single_state_entries_match_reference_block(entry, case, wl_name,
                                                     k):
    """The reference's single-state entries (``kernels/squeeze_stencil.py``
    stencil_step_mxu, stencil_step_mxu_k, life_step_fused) on the CPU."""
    wl = trules.WORKLOADS[wl_name]
    x = torch.from_numpy(_state(*case, wl))
    fn = getattr(sk, entry)
    got = fn(_layout(*case), x) if entry == "life_step_fused" else \
        fn(_layout(*case), x, wl, **({"k": k} if k > 1 else {}))
    np.testing.assert_allclose(got.numpy(), _reference(*case, wl_name, k),
                               **_tol(wl))


# ---------------------------------------- the reference Pallas kernels
def test_blocks_matches_reference_pallas_v1():
    case, wl = ("carpet", 3, 1), trules.GRAY_SCOTT
    x = _state(*case, wl, seed=1)
    want = rsk.stencil_step_blocks(RefLayout(rf.CARPET, 3, 1),
                                   jnp.asarray(x), rrules.GRAY_SCOTT,
                                   interpret=True)
    got = sk.stencil_step_blocks(_layout(*case), torch.from_numpy(x), wl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(wl))


def test_strips_matches_reference_pallas_v2():
    case, wl = ("sierpinski", 5, 2), trules.HEAT
    x = _state(*case, wl, seed=2)
    want = rsk.stencil_step_strips(RefLayout(rf.SIERPINSKI, 5, 2),
                                   jnp.asarray(x), rrules.HEAT,
                                   interpret=True)
    got = sk.stencil_step_strips(_layout(*case), torch.from_numpy(x), wl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(wl))
    np.testing.assert_array_equal(
        sk.life_step_strips(_layout(*case), torch.from_numpy(
            _state(*case, trules.LIFE))).numpy(),
        _reference(*case, "life", 1))


def test_fused_matches_reference_pallas_v3():
    case, wl = ("carpet", 3, 1), trules.HIGHLIFE
    x = _state(*case, wl, seed=3)
    want = rsk.stencil_step_fused(RefLayout(rf.CARPET, 3, 1),
                                  jnp.asarray(x), rrules.HIGHLIFE,
                                  interpret=True)
    got = sk.stencil_step_fused(_layout(*case), torch.from_numpy(x), wl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fused_k_matches_reference_pallas_v4():
    case, wl = ("sierpinski", 5, 2), trules.GRAY_SCOTT
    x = _state(*case, wl, seed=4)
    want = rsk.stencil_step_fused_k(RefLayout(rf.SIERPINSKI, 5, 2),
                                    jnp.asarray(x), rrules.GRAY_SCOTT, k=2,
                                    interpret=True)
    got = sk.stencil_step_fused_k(_layout(*case), torch.from_numpy(x), wl,
                                  k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(wl))


@pytest.mark.parametrize("p", [2, 5])
def test_mxu_matches_reference_pallas_v5(p):
    """Two packings: the result depends on neither."""
    case, wl = ("sierpinski", 5, 2), trules.LIFE
    x = _state(*case, wl, batch=2, seed=5)
    want = rsk.stencil_step_mxu_batched(RefLayout(rf.SIERPINSKI, 5, 2),
                                        jnp.asarray(x), rrules.LIFE, k=2,
                                        p=p, interpret=True)
    got = sk.stencil_step_mxu_batched(_layout(*case), torch.from_numpy(x),
                                      wl, k=2, p=p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_mxu_operators_match_reference(wl_name):
    """R is the reference's; C is each diagonal block of its CT
    transposed (the port keeps one w x w slot operand)."""
    w, p = 8, 3
    rm, ct = rsk._mxu_operators(rrules.WORKLOADS[wl_name], w, p)
    r_port, c_port = sk._mxu_operators(trules.WORKLOADS[wl_name], w)
    np.testing.assert_array_equal(r_port, rm)
    for s in range(p):
        blk = ct[:, s * w:(s + 1) * w, s * w:(s + 1) * w]
        np.testing.assert_array_equal(c_port.transpose(0, 2, 1), blk)


# ------------------------------------------------- wrappers and build
def _kernel_calls():
    lay = _layout("sierpinski", 5, 2)
    meta = torch.empty((2, lay.n_blocks, 4, 4), dtype=torch.uint8,
                       device="meta")
    return [
        ("stencil_step_fused_plain",
         lambda: sk.stencil_step_fused(lay, meta[0], trules.LIFE)),
        ("stencil_step_blocks_plain",
         lambda: sk.life_step_blocks(lay, meta)),
        ("stencil_step_strips_plain",
         lambda: sk.stencil_step_strips(lay, meta[0], trules.LIFE)),
        ("stencil_step_fused_k_plain",
         lambda: sk.stencil_step_fused_k(lay, meta[0], trules.LIFE, k=2)),
        ("stencil_step_mxu_batched_plain",
         lambda: sk.stencil_step_mxu_batched(lay, meta, trules.LIFE, k=2)),
    ]


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 4],
                         ids=["v3", "v1", "v2", "v4", "v5"])
def test_wrapper_raises_when_the_build_fails(idx):
    """A tensor off the CPU goes to the kernel: a failed build raises and
    the plain version is never called."""
    plain_name, call = _kernel_calls()[idx]
    boom = build.KernelBuildError("nvcc failed")
    with mock.patch.object(build, "load_library", side_effect=boom), \
            mock.patch.object(sk, plain_name,
                              side_effect=AssertionError("fell back")):
        with pytest.raises(build.KernelBuildError, match="nvcc failed"):
            call()


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 4],
                         ids=["v3", "v1", "v2", "v4", "v5"])
def test_wrapper_refuses_a_non_cuda_device(idx):
    _, call = _kernel_calls()[idx]
    before = dict(sk.LAUNCHES)
    with mock.patch.object(build, "load_library",
                           return_value=mock.MagicMock()):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()
    assert sk.LAUNCHES == before


def test_cpu_path_launches_nothing_and_validates():
    lay = _layout("sierpinski", 5, 2)
    before = dict(sk.LAUNCHES)
    x = torch.from_numpy(_state("sierpinski", 5, 2, trules.LIFE))
    sk.stencil_step_fused_k(lay, x, trules.LIFE, k=2)
    assert sk.LAUNCHES == before
    with pytest.raises(ValueError, match="k <= rho"):
        sk.stencil_step_fused_k(lay, x, trules.LIFE, k=5)
    with pytest.raises(ValueError, match="does not match"):
        sk.stencil_step_fused(lay, x[:, :3], trules.LIFE)
    with pytest.raises(ValueError, match="alias"):
        sk.stencil_step_fused(lay, x, trules.LIFE, out=x)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: a named build error, and nothing written."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "target",
                        lambda src: tmp_path / "out" / "missing.so")
    monkeypatch.setattr(build.os, "access", lambda *args: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "out").exists()
