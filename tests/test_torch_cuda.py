"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU. The module imports neither jax nor the reference package, so it runs
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

CA results are bit-exact; floats agree to rtol=atol=1e-5 (v5 sums the
banded products in another order than the plain aggregate), v1-v4 and the
strip gather bit for bit; the lambda/nu maps are bit-exact. The 3D kernels
(cuda-3d, cuda-3d-mxu) are held the same way on the Menger sponge and the
Sierpinski tetrahedron.
"""
import ctypes
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import fractals as tf
from repro_torch.core import fractals3d as tf3
from repro_torch.core.compact import BlockLayout
from repro_torch.core.compact3d import BlockLayout3D
from repro_torch.core.stencil import make_engine
from repro_torch.kernels import attention as ta
from repro_torch.kernels import build
from repro_torch.kernels import lambda_map as lm
from repro_torch.kernels import nu_map as nm
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.kernels import squeeze_stencil3d as k3
from repro_torch.kernels import ssd_chunk as ts
from repro_torch.models import ssm as tssm
from repro_torch.workloads import BatchedRunner
from repro_torch.workloads import rules as trules
from repro_torch.workloads.base import halo_needs

WORKLOADS = ["life", "highlife", "heat", "gray-scott"]
CASES = [(tf.SIERPINSKI, 7, 2), (tf.CARPET, 4, 1), (tf.VICSEK, 4, 1)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tol(wl):
    return dict(rtol=0, atol=0) if wl.dtype == torch.uint8 \
        else dict(rtol=1e-5, atol=1e-5)


def _state(lay, wl, batch, seed=0, scale=1.0):
    """Random states (B, C?, nb, rho, rho) under the micro mask; floats in
    [0, scale)."""
    rng = np.random.default_rng(seed)
    shape = (batch,) + ((wl.n_channels,) if wl.n_channels > 1 else ()) + \
        (lay.n_blocks, lay.rho, lay.rho)
    x = rng.integers(0, 2, shape).astype(np.uint8) \
        if wl.dtype == torch.uint8 \
        else (scale * rng.random(shape)).astype(np.float32)
    return torch.from_numpy(x * lay.micro_mask)


def _close(got, want, wl):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **_tol(wl))


def _equal(got, want):
    """Bit for bit (v4 and kernel 6 round each float operation as their
    plain versions do)."""
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_cuda_kernels_match_plain(cuda, wl_name):
    wl = trules.WORKLOADS[wl_name]
    for frac, r, m in CASES:
        lay = BlockLayout(frac, r, m)
        x = _state(lay, wl, 3).to(cuda)
        _close(sk.stencil_step_fused(lay, x[0], wl),
               sk.stencil_step_fused_plain(lay, x[0], wl), wl)
        for k in (1, 2, lay.rho):
            _equal(sk.stencil_step_fused_k(lay, x, wl, k=k),
                   sk.stencil_step_fused_k_plain(lay, x, wl, k=k))
        for k in (1, 2):
            for p in (1, 3, None):
                _close(sk.stencil_step_mxu_batched(lay, x, wl, k=k, p=p),
                       sk.stencil_step_mxu_batched_plain(lay, x, wl, k=k),
                       wl)


@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_cuda_single_step_kernels_match_plain(cuda, wl_name):
    """v1 and v2, one simulation and a batch of 3, 4 steps each, bit for
    bit on the warp body (v2 a gather launch a step)."""
    wl = trules.WORKLOADS[wl_name]
    for frac, r, m in CASES:
        lay = BlockLayout(frac, r, m)
        x = _state(lay, wl, 3).to(cuda)
        for fn, plain in ((sk.stencil_step_blocks,
                           sk.stencil_step_blocks_plain),
                          (sk.stencil_step_strips,
                           sk.stencil_step_strips_plain)):
            for s in (x[0], x):
                got, want = s, s
                sk.reset_launches()
                for _ in range(4):
                    got, want = fn(lay, got, wl), plain(lay, want, wl)
                assert {n: v for n, v in sk.LAUNCHES.items() if v} == (
                    {fn.__name__: 4, "gather_halo_strips": 4}
                    if fn is sk.stencil_step_strips else {fn.__name__: 4})
                _equal(got, want)


@pytest.mark.parametrize("name", sorted(tf.REGISTRY))
def test_cuda_maps_match_plain(cuda, name):
    """nu over coordinates past both edges, lambda over negative and
    past-the-edge compact coordinates, at small r and at the largest r
    whose coordinates fit int32: bit-exact."""
    frac = tf.REGISTRY[name]
    rng = np.random.default_rng(7)
    for r in (1, 3, nm.max_int32_level(frac)):
        n = frac.side(r)
        rows, cols = frac.compact_dims(r)
        ex, ey = (torch.from_numpy(rng.integers(
            -3, n + 3, size=(3, 1000)).astype(np.int32)) for _ in range(2))
        cx, cy = (torch.from_numpy(rng.integers(
            max(-2 * side, -2 ** 31), min(2 * side, 2 ** 31), size=3000)
            .astype(np.int32)) for side in (cols, rows))
        for got, want in zip(nm.nu_map_tc(frac, r, ex.to(cuda), ey.to(cuda)),
                             nm.nu_map_tc_plain(frac, r, ex, ey)):
            assert torch.equal(got.cpu(), want)
        for got, want in zip(lm.lambda_map_tc(frac, r, cx.to(cuda),
                                              cy.to(cuda)),
                             lm.lambda_map_tc_plain(frac, r, cx, cy)):
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("kind", ["cell", "lambda"])
def test_cuda_map_engines_match_cpu(cuda, kind):
    """The cell and lambda engines build their index tensors with the map
    kernels: 1 + 8 launches for cell, 1 for lambda."""
    on_card = make_engine(kind, tf.CARPET, 3, workload=trules.HIGHLIFE)
    on_cpu = make_engine(kind, tf.CARPET, 3, workload=trules.HIGHLIFE,
                         device="cpu")
    x = on_cpu.init_random(seed=2)
    sk.reset_launches()
    got = on_card.run(x.to(cuda), 3)
    assert (sk.LAUNCHES["lambda_map_tc"], sk.LAUNCHES["nu_map_tc"]) == \
        ((1, 8) if kind == "cell" else (1, 0))
    _close(got, on_cpu.run(x, 3), trules.HIGHLIFE)


#: kernel kind -> the kernel its single steps launch
_SINGLE = {"cuda-fused": "stencil_step_fused",
           "cuda-blocks": "stencil_step_blocks",
           "cuda-strips": "stencil_step_strips"}


@pytest.mark.parametrize("wl_name", ["life", "gray-scott"])
@pytest.mark.parametrize("kind", ["cuda-fused", "cuda-mxu", "cuda-blocks",
                                  "cuda-strips"])
def test_cuda_engine_run_matches_cpu(cuda, kind, wl_name):
    """run(7) on the card equals the CPU path; every launch is counted.
    The state comes from the workload's own distribution: uniform (u, v)
    in [0, 1)^2 lies outside Gray-Scott's stable regime, where values grow
    to ~1e16 within 7 steps and v5's summation order (which differs from
    the plain aggregate's) drives the two paths apart."""
    wl = trules.WORKLOADS[wl_name]
    on_card = make_engine(kind, tf.SIERPINSKI, 7, 2, workload=wl)
    on_cpu = make_engine(kind, tf.SIERPINSKI, 7, 2, workload=wl,
                         device="cpu")
    x = on_cpu.init_random(seed=1)
    sk.reset_launches()
    got = on_card.run(x.to(cuda), 7)
    want = on_cpu.run(x, 7)
    _close(got, want, wl)
    k = on_card.effective_fusion_k
    if kind in _SINGLE:
        assert sk.LAUNCHES["stencil_step_fused_k"] == 7 // k
        assert sk.LAUNCHES[_SINGLE[kind]] == 7 % k
    else:
        assert sk.LAUNCHES["stencil_step_mxu_batched"] == 7 // k + 7 % k


@pytest.mark.parametrize("kind", ["cuda-fused", "cuda-mxu", "cuda"])
def test_cuda_runner_batch_matches_cpu(cuda, kind):
    wl = trules.HEAT
    runner = BatchedRunner()
    states = _state(BlockLayout(tf.CARPET, 4, 1), wl, 3)
    got = runner.run(kind, tf.CARPET, 4, states.to(cuda), 5, m=1,
                     workload=wl)
    want = BatchedRunner(device="cpu").run(kind, tf.CARPET, 4, states, 5,
                                           m=1, workload=wl)
    _close(got, want, wl)


def test_cuda_wrapper_refuses_bad_inputs(cuda):
    lay = BlockLayout(tf.SIERPINSKI, 5, 2)
    x = _state(lay, trules.LIFE, 1)[0].to(cuda)
    with pytest.raises(TypeError):
        sk.stencil_step_fused(lay, x.float(), trules.LIFE)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stencil_step_fused(lay, x.transpose(-1, -2), trules.LIFE)
    with pytest.raises(ValueError, match="alias"):
        sk.stencil_step_fused_k(lay, x, trules.LIFE, k=2, out=x)
    before = dict(sk.LAUNCHES)
    with pytest.raises(TypeError):
        sk.stencil_step_fused_k(lay, x.float(), trules.LIFE, k=2)
    with pytest.raises(ValueError, match="contiguous"):
        sk.stencil_step_fused_k(lay, x.transpose(-1, -2), trules.LIFE, k=2)
    with pytest.raises(ValueError, match="k <= rho"):
        sk.stencil_step_fused_k(lay, x, trules.LIFE, k=lay.rho + 1)
    with pytest.raises(ValueError, match="does not match"):
        sk.stencil_step_fused_k(lay, x[:, :3], trules.LIFE, k=2)
    assert sk.LAUNCHES == before


def test_cuda_new_wrappers_refuse_bad_inputs(cuda):
    lay = BlockLayout(tf.SIERPINSKI, 5, 2)
    x = _state(lay, trules.LIFE, 2).to(cuda)
    for fn in (sk.stencil_step_blocks, sk.stencil_step_strips):
        with pytest.raises(TypeError):
            fn(lay, x.float(), trules.LIFE)
        with pytest.raises(ValueError, match="contiguous"):
            fn(lay, x.transpose(-1, -2), trules.LIFE)
        with pytest.raises(ValueError, match="alias"):
            fn(lay, x, trules.LIFE, out=x)
    with pytest.raises(ValueError, match="strips"):
        sk._launch_step("stencil_step_strips", lay, x, trules.LIFE, 1, None,
                        strips=torch.zeros((2, 1, lay.n_blocks, 4, 5),
                                           dtype=torch.uint8, device=cuda))
    c = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        nm.nu_map_tc(tf.CARPET, 3, c.long(), c.long())
    with pytest.raises(ValueError, match="shapes"):
        lm.lambda_map_tc(tf.CARPET, 3, c, c[:5])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        lm.lambda_map_tc(tf.CARPET, 3, c, c.cpu())
    with pytest.raises(ValueError, match="int32"):
        nm.nu_map_tc(tf.CARPET, 20, c, c)
    before = dict(sk.LAUNCHES)
    cx, cy, valid = nm.nu_map_tc(tf.CARPET, 3, c[:0], c[:0])
    assert cx.shape == (0,) and valid.dtype == torch.bool
    assert sk.LAUNCHES == before


# ---------------------------------------------------------------- 3D
WORKLOADS3D = ["life3d", "heat3d", "life"]
CASES3D = [(tf3.MENGER, 3, 1), (tf3.SIERPINSKI3D, 6, 2), (tf3.MENGER, 4, 2)]


def _state3(lay, wl, batch, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, lay.n_blocks) + (lay.rho,) * 3
    x = rng.integers(0, 2, shape).astype(np.uint8) \
        if wl.dtype == torch.uint8 else rng.random(shape).astype(np.float32)
    return torch.from_numpy(x * lay.micro_mask)


@pytest.mark.parametrize("wl_name", WORKLOADS3D)
def test_cuda_3d_kernels_match_plain(cuda, wl_name):
    """Both 3D kernels, k in {1, 2, rho}, one simulation and a batch of 3,
    two packings of the mxu kernel for k <= 2."""
    wl = trules.get_workload(wl_name)
    for frac, r, m in CASES3D:
        lay = BlockLayout3D(frac, r, m)
        x = _state3(lay, wl, 3).to(cuda)
        for k in sorted({1, 2, lay.rho}):
            for s in (x[0], x):
                _close(k3.stencil3d_step_fused_k(lay, s, wl, k=k),
                       k3.stencil3d_step_fused_k_plain(lay, s, wl, k=k), wl)
                for p in ((None, 2) if k <= 2 else (None,)):
                    _close(k3.stencil3d_step_mxu_k(lay, s, wl, k=k, p=p),
                           k3.stencil3d_step_mxu_k_plain(lay, s, wl, k=k),
                           wl)


@pytest.mark.parametrize("wl_name", ["life3d", "heat3d"])
@pytest.mark.parametrize("kind", ["cuda-3d", "cuda-3d-mxu"])
def test_cuda_3d_engine_run_matches_cpu(cuda, kind, wl_name):
    """run(7) on the card equals the CPU path, floor(7/k) + 7 % k launches
    of the kind's kernel and none of the other."""
    wl = trules.get_workload(wl_name)
    on_card = make_engine(kind, tf3.MENGER, 4, 2, workload=wl)
    on_cpu = make_engine(kind, tf3.MENGER, 4, 2, workload=wl, device="cpu")
    x = on_cpu.init_random(seed=1)
    k3.reset_launches()
    got = on_card.run(x.to(cuda), 7)
    _close(got, on_cpu.run(x, 7), wl)
    k = on_card.effective_fusion_k
    name = "stencil3d_step_mxu_k" if kind.endswith("mxu") else \
        "stencil3d_step_fused_k"
    other = "stencil3d_step_fused_k" if kind.endswith("mxu") else \
        "stencil3d_step_mxu_k"
    assert (k3.LAUNCHES[name], k3.LAUNCHES[other]) == (7 // k + 7 % k, 0)


@pytest.mark.parametrize("kind", ["bb3d", "cell3d", "block3d"])
def test_cuda_3d_plain_engines_match_cpu(cuda, kind):
    """The plain 3D engines default to the card and equal the CPU path."""
    wl = trules.LIFE3D
    on_card = make_engine(kind, tf3.MENGER, 3, 1, workload=wl)
    on_cpu = make_engine(kind, tf3.MENGER, 3, 1, workload=wl, device="cpu")
    x = on_cpu.init_random(seed=2)
    _close(on_card.run(x.to(cuda), 4), on_cpu.run(x, 4), wl)


@pytest.mark.parametrize("kind", ["cuda-3d", "cuda-3d-mxu"])
def test_cuda_3d_runner_batch_matches_cpu(cuda, kind):
    wl = trules.HEAT3D
    states = _state3(BlockLayout3D(tf3.MENGER, 3, 1), wl, 3)
    got = BatchedRunner().run(kind, tf3.MENGER, 3, states.to(cuda), 5, m=1,
                              workload=wl)
    want = BatchedRunner(device="cpu").run(kind, tf3.MENGER, 3, states, 5,
                                           m=1, workload=wl)
    _close(got, want, wl)


def test_cuda_3d_wrappers_refuse_bad_inputs(cuda):
    """k > rho, a wrong dtype, a strided state and an aliased output raise
    on the card; nothing falls back to the plain version and nothing is
    counted (a window over shared memory runs: see
    test_cuda_3d_global_window_matches_plain)."""
    lay = BlockLayout3D(tf3.MENGER, 4, 2)
    x = _state3(lay, trules.LIFE3D, 1)[0].to(cuda)
    before = dict(k3.LAUNCHES)
    for kernel in ("fused", "mxu"):
        fn = getattr(k3, f"stencil3d_step_{kernel}_k")
        with mock.patch.object(k3, f"stencil3d_step_{kernel}_k_plain",
                               side_effect=AssertionError("fell back")):
            with pytest.raises(ValueError, match="k <= rho"):
                fn(lay, x, trules.LIFE3D, k=10)
            with pytest.raises(TypeError):
                fn(lay, x.float(), trules.LIFE3D, k=1)
            with pytest.raises(ValueError, match="contiguous"):
                fn(lay, x.transpose(-1, -2), trules.LIFE3D, k=1)
            with pytest.raises(ValueError, match="alias"):
                fn(lay, x, trules.LIFE3D, k=1, out=x)
    assert k3.LAUNCHES == before



#: (fractal, r, m) and the depths that reach every body of the 3D plans:
#: rho = 3 and 4 at k <= 2 (the column body's W = 8), k = 3 and rho = 9 at
#: k <= 3 (W = 16, the main path's w = 15), k = rho = 9 (the CTA body)
BODIES3D = [(tf3.MENGER, 3, 1, (1, 2, 3)), (tf3.SIERPINSKI3D, 6, 2, (1, 2, 4)),
            (tf3.MENGER, 4, 2, (1, 2, 3, 9))]


@pytest.mark.parametrize("wl_name", WORKLOADS3D)
def test_cuda_3d_bodies_at_every_plan_class(cuda, wl_name):
    """Each body the plans pick, one simulation and a batch of 3: the
    fused kernel bit for bit with its plain version (floats too), the
    banded one exact for the CA states and within the float bar for
    HEAT3D; each launch counted under the name of its plan's body."""
    wl = trules.get_workload(wl_name)
    seen = set()
    for frac, r, m, ks in BODIES3D:
        lay = BlockLayout3D(frac, r, m)
        x = _state3(lay, wl, 3, seed=4).to(cuda)
        for k in ks:
            fplan = k3.fused3_plan_for(lay, wl, k)
            mplan = k3.mxu3_plan_for(lay, wl, k)
            seen |= {("fused", fplan.body, fplan.W),
                     ("mxu", mplan.body, mplan.W)}
            k3.reset_launches()
            for s in (x[0], x):
                _equal(k3.stencil3d_step_fused_k(lay, s, wl, k=k),
                       k3.stencil3d_step_fused_k_plain(lay, s, wl, k=k))
                _close(k3.stencil3d_step_mxu_k(lay, s, wl, k=k),
                       k3.stencil3d_step_mxu_k_plain(lay, s, wl, k=k), wl)
            assert {n: v for n, v in k3.LAUNCHES.items() if v} == {
                "stencil3d_step_fused_k" + fplan.body: 2,
                "stencil3d_step_mxu_k" + mplan.body: 2}
    assert seen == {("fused", "", 8), ("fused", "", 16),
                    ("fused", "[wide]", 0), ("mxu", "", 16),
                    ("mxu", "[wide]", 0)}


@dataclasses.dataclass(frozen=True)
class _DownHeat3D(trules.HeatDiffusion):
    """Heat without the z+1 face: three rank-1 terms with no equal dz = -1
    / +1 pair and weights the column body does not take: both kernels run
    the CTA body."""
    name: str = "down-heat3d"
    degree: int = 6

    def weight(self, offset):
        return 1 if sum(abs(d) for d in offset) == 1 and \
            tuple(offset) != (0, 0, 1) else 0


def test_cuda_3d_other_weights(cuda):
    wl = _DownHeat3D()
    lay = BlockLayout3D(tf3.MENGER, 4, 2)
    x = _state3(lay, wl, 3, seed=6).to(cuda)
    assert k3.mxu3_plan_for(lay, wl, 3).body == "[wide]"
    assert k3.fused3_plan_for(lay, wl, 3).body == "[wide]"
    k3.reset_launches()
    for s in (x[0], x):
        _close(k3.stencil3d_step_mxu_k(lay, s, wl, k=3),
               k3.stencil3d_step_mxu_k_plain(lay, s, wl, k=3), wl)
        _equal(k3.stencil3d_step_fused_k(lay, s, wl, k=3),
               k3.stencil3d_step_fused_k_plain(lay, s, wl, k=3))
    assert {n: v for n, v in k3.LAUNCHES.items() if v} == {
        "stencil3d_step_mxu_k[wide]": 2, "stencil3d_step_fused_k[wide]": 2}


def _call3(kernel, lay, x, wl, k, **change):
    """The C entry of ``kernel`` called as its wrapper calls it, with the
    named arguments changed; its CUDA error code (0: launched)."""
    out = torch.empty_like(x)
    nbr = lay.device_table("neighbor_table", x.device)
    wmask = lay.device_table("window_mask", x.device, k)
    rule, born, survive, alpha, degree = k3._rule_params(wl)
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "fused":
        plan = k3.fused3_plan_for(lay, wl, k)
        weights = change.pop("weights", wl.weights3d)
        host_w = (ctypes.c_float * 26)(*weights)
        args = dict(W=plan.W, G=plan.windows)
        args.update(change)
        rc = k3._c_function("sq3_step_fused_k")(
            rule, x.data_ptr(), out.data_ptr(), nbr.data_ptr(),
            wmask.data_ptr(), lay.n_blocks, 1, lay.rho, k, args["W"],
            args["G"], born, survive, alpha, degree, 0, 1.0,
            ctypes.addressof(host_w), None, 0, stream)
    else:
        plan = k3.mxu3_plan_for(lay, wl, k)
        rm, cm, dzs = k3._mxu3_operators_on(wl, lay.rho + 2 * k,
                                            str(x.device))
        args = dict(P=plan.windows, W=plan.W, t0=dzs.count(-1),
                    t1=dzs.count(-1) + dzs.count(0))
        args.update(change)
        rc = k3._c_function("sq3_step_mxu_k")(
            rule, x.data_ptr(), out.data_ptr(), nbr.data_ptr(),
            wmask.data_ptr(), rm.data_ptr(), cm.data_ptr(), len(dzs),
            args["t0"], args["t1"], lay.n_blocks, 1, lay.rho, k, args["P"],
            args["W"], born, survive, alpha, degree, None, 0, stream)
    torch.cuda.synchronize()
    return rc


def test_cuda_3d_c_entries_refuse_other_plans(cuda):
    """The C entries launch the body the plan names and refuse any other:
    a W other than the plan's, other windows a CTA, weights not of the
    rule's form, terms not one at dz = -1, at most two at 0 and one at +1;
    the plan's own arguments launch."""
    lay = BlockLayout3D(tf3.MENGER, 4, 2)   # rho = 9: w = 15 at k = 3
    small = BlockLayout3D(tf3.MENGER, 3, 1)   # rho = 3: w = 7 at k = 2
    for wl in (trules.LIFE3D, trules.HEAT3D):
        x = _state3(lay, wl, 1)[0].to(cuda)
        xs = _state3(small, wl, 1)[0].to(cuda)
        assert _call3("fused", lay, x, wl, 3) == 0
        assert _call3("mxu", lay, x, wl, 3) == 0
        assert _call3("fused", small, xs, wl, 2) == 0
        for bad in (dict(W=8), dict(W=32), dict(G=4)):
            assert _call3("fused", lay, x, wl, 3, **bad) != 0, bad
        assert _call3("fused", small, xs, wl, 2, W=16, G=1) != 0
        other = trules.HEAT3D if wl is trules.LIFE3D else trules.LIFE3D
        assert _call3("fused", lay, x, wl, 3,
                      weights=other.weights3d) != 0
        assert _call3("fused", lay, x, wl, 4, W=16, G=1) != 0   # w = 17
        for bad in (dict(W=8), dict(P=2), dict(t0=2, t1=3),
                    dict(t0=1, t1=4), dict(t0=0, t1=3)):
            assert _call3("mxu", lay, x, wl, 3, **bad) != 0, bad
        assert _call3("mxu", lay, x, wl, 4, W=16, P=1) != 0   # w = 17


@pytest.mark.parametrize("kernel", ["fused", "mxu"])
def test_cuda_3d_global_window_matches_plain(cuda, kernel):
    """Menger r=4 m=3 (rho = 27, 20 blocks), HEAT3D at k = 3: two 33^3 f32
    windows are over one CTA's shared memory, so the kernel holds them in
    its device workspace; one simulation and B = 3 equal the plain version
    and count as launches of the workspace variant."""
    wl = trules.HEAT3D
    lay = BlockLayout3D(tf3.MENGER, 4, 3)
    x = _state3(lay, wl, 3).to(cuda)
    fn = getattr(k3, f"stencil3d_step_{kernel}_k")
    plain = getattr(k3, f"stencil3d_step_{kernel}_k_plain")
    name = f"stencil3d_step_{kernel}_k"
    assert k3.window_variant(lay, wl, 3, kernel) == "global"
    before = dict(k3.LAUNCHES)
    for s in (x[0], x):
        _close(fn(lay, s, wl, k=3), plain(lay, s, wl, k=3), wl)
    assert k3.LAUNCHES[name + "[global]"] - before[name + "[global]"] == 2
    assert k3.LAUNCHES[name] == before[name]


# ------------------------------------------------------- attention, SSD
#: id -> ((B, H, Sq, Sk, D), dtype, keyword arguments, the body that runs)
ATTENTION = {
    "empty-rows": ((1, 2, 256, 128, 64), torch.float32, {}, ta.FP32),
    "decode": ((2, 2, 1, 4096, 128), torch.float32, {"bq": 1}, ta.SPLIT),
    "d256-bf16": ((1, 2, 384, 384, 256), torch.bfloat16,
                  {"window": 128, "softcap": 50.0}, ta.TC),   # gemma2-like
    "d36-bf16": ((1, 2, 128, 256, 36), torch.bfloat16, {"causal": False},
                 ta.FP32),                                    # 2-byte loads
    "empty-rows-bf16": ((1, 2, 256, 128, 64), torch.bfloat16, {}, ta.TC),
    "window-hides-all-bf16": ((1, 2, 128, 256, 64), torch.bfloat16,
                              {"window": 0}, ta.TC),
    "ragged-tiles-bf16": ((1, 2, 200, 328, 72), torch.bfloat16,
                          {"bq": 8, "bk": 8, "softcap": 30.0}, ta.TC),
    "decode-8192-f32": ((1, 4, 1, 8192, 256), torch.float32,
                        {"bq": 1, "softcap": 50.0}, ta.SPLIT),
    "decode-8192-bf16": ((1, 4, 1, 8192, 256), torch.bfloat16,
                         {"bq": 1, "softcap": 50.0}, ta.SPLIT),
    # 1000 keys in 16 splits of 63: the last holds 55
    "decode-ragged-bf16": ((1, 4, 1, 1000, 128), torch.bfloat16,
                           {"bq": 1, "bk": 8}, ta.SPLIT),
    "decode-rows-window-bf16": ((2, 2, 4, 1000, 64), torch.bfloat16,
                                {"bq": 4, "bk": 8, "window": 250}, ta.SPLIT),
    "decode-hides-all": ((1, 2, 1, 512, 128), torch.float32,
                         {"bq": 1, "window": 0}, ta.SPLIT),
}


def bf16_rounding_bound(want):
    """ulp_bf16(|want|) + 1e-5 elementwise, ulp_bf16(x) = 2^(floor(log2 x)
    - 7): the bf16 bar at one rounding of the float32 result."""
    a = want.double().abs()
    _, e = torch.frexp(a)   # a = f * 2^e, 0.5 <= f < 1: floor(log2 a) = e - 1
    ulp = torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                      torch.zeros_like(a))
    return ulp + 1e-5


@pytest.mark.parametrize("case", sorted(ATTENTION))
def test_cuda_attention_matches_plain(cuda, case):
    """Each shape through the body ``plan`` names, counted under that name
    alone, at the reference's bar against the plain version; a bf16 result
    also within one bf16 rounding of the plain version in float32."""
    shape, dtype, kw, body = ATTENTION[case]
    b, h, sq, sk, d = shape
    g = torch.Generator().manual_seed(sorted(ATTENTION).index(case))
    q = torch.randn((b, h, sq, d), generator=g).to(cuda, dtype)
    k, v = (torch.randn((b, h, sk, d), generator=g).to(cuda, dtype)
            for _ in range(2))
    before = dict(build.LAUNCHES)
    got = ta.flash_attention(q, k, v, **kw)
    assert {n: build.LAUNCHES[n] - before[n]
            for n in (ta.FP32, ta.TC, ta.SPLIT)} == {
        n: int(n == body) for n in (ta.FP32, ta.TC, ta.SPLIT)}
    plain_kw = {n: x for n, x in kw.items() if n not in ("bq", "bk")}
    want = ta.attention_plain(q, k, v, **plain_kw)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol,
                               atol=tol)
    if dtype == torch.bfloat16:
        want32 = ta.attention_plain(q.float(), k.float(), v.float(),
                                    **plain_kw)
        err = (got.double() - want32.double()).abs()
        bound = bf16_rounding_bound(want32)
        assert bool((err <= bound).all()), float((err - bound).max())


def _ssd_inputs(cuda, b, s, h, p, n):
    """x, dt (softplus), a (negative), B and C as the reference test draws
    them, seeded by s, on the card."""
    g = torch.Generator().manual_seed(s)
    x = torch.randn((b, s, h, p), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g)
                                      - 1.0)
    a = -torch.exp(torch.randn(h, generator=g) * 0.3)
    bm, cm = (torch.randn((b, s, n), generator=g) * 0.5 for _ in range(2))
    return [t.to(cuda) for t in (x, dt, a, bm, cm)]


@pytest.mark.parametrize("shape", [(1, 40, 3, 8, 16, 16),
                                   (2, 256, 4, 64, 128, 128),
                                   (1, 600, 4, 64, 128, 256),
                                   (1, 1024, 2, 64, 128, 512)],
                         ids=["ragged", "mamba2-width", "chunk256",
                              "chunk512"])
def test_cuda_ssd_matches_plain(cuda, shape):
    """The intra-chunk kernel against its plain version, and the whole scan
    (kernel and recurrence) against the chunked oracle, at 2e-5; chunks of
    256 (S ragged) and 512 too."""
    b, s, h, p, n, chunk = shape
    x, dt, a, bm, cm = _ssd_inputs(cuda, b, s, h, p, n)
    xc, dtc, bc, cc = ts.to_chunks(x, dt, bm, cm, chunk)
    chunks = (xc, dtc, a, bc, cc)
    name = "ssd_chunk_scan"
    before = build.LAUNCHES[name]
    for got, want in zip(ts.ssd_chunk(*chunks), ts.ssd_chunk_plain(*chunks)):
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)
    got = ts.ssd_chunk_scan(x, dt, a, bm, cm, chunk=chunk)
    assert build.LAUNCHES[name] == before + 2
    want = tssm._ssd_chunked(x, dt, a, bm[:, :, None], cm[:, :, None], chunk)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-5, atol=2e-5)


def test_cuda_attention_and_ssd_refuse_bad_inputs(cuda):
    """D over 256 and inputs on two devices raise on the card; nothing
    falls back and nothing is counted for them. A chunk of 256 at
    mamba2-780m's widths (once refused: over one CTA's shared memory) runs
    the kernel, counted once, never the plain version, and matches it."""
    q = torch.zeros((1, 1, 64, 320), device=cuda)
    chunks = [torch.zeros(s, device=cuda) for s in
              ((1, 16, 2, 8), (1, 16, 2), (2,), (1, 16, 8), (1, 16, 8))]
    x, dt, a, bm, cm = _ssd_inputs(cuda, 1, 256, 2, 64, 128)
    long = ts.to_chunks(x, dt, bm, cm, 256)
    long = (long[0], long[1], a, long[2], long[3])
    before = dict(build.LAUNCHES)
    with mock.patch.object(ta, "attention_plain",
                           side_effect=AssertionError("fell back")), \
            mock.patch.object(ts, "ssd_chunk_plain",
                              side_effect=AssertionError("fell back")):
        with pytest.raises(ValueError, match="D <= 256"):
            ta.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="one device"):
            ta.flash_attention(q[..., :64], q[..., :64].cpu(), q[..., :64])
        with pytest.raises(ValueError, match="one device"):
            ts.ssd_chunk(*chunks[:2], chunks[2].cpu(), *chunks[3:])
        assert build.LAUNCHES == before
        got = ts.ssd_chunk(*long)
    assert {n: v - before[n] for n, v in build.LAUNCHES.items() if
            v != before[n]} == {"ssd_chunk_scan": 1}
    for g, w in zip(got, ts.ssd_chunk_plain(*long)):
        torch.cuda.synchronize()
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- distributed
def _pieces(lay, wl, lead, k, seed=0, scale=1.0):
    """Random halo pieces (top, bot, west, east) with leading axes
    ``lead`` (..., C, nbl) for the shard-local entries; floats in [0,
    scale)."""
    rng = np.random.default_rng(seed)
    rho, w = lay.rho, lay.rho + 2 * k
    out = []
    for tail in ((k, w), (k, w), (rho, k), (rho, k)):
        shape = lead + tail
        x = rng.integers(0, 2, shape).astype(np.uint8) \
            if wl.dtype == torch.uint8 \
            else (scale * rng.random(shape)).astype(np.float32)
        out.append(torch.from_numpy(x))
    return tuple(out)


@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_cuda_local_kernels_match_plain(cuda, wl_name):
    """Kernels 6 and 7 (the shard-local v4 and v5) against their plain
    versions on random states, pieces and existence rows (the pieces are
    read whatever the existence says, as the plain version does)."""
    wl = trules.WORKLOADS[wl_name]
    nc = wl.n_channels
    rng = np.random.default_rng(5)
    for frac, r, m in CASES:
        lay = BlockLayout(frac, r, m)
        nbl = lay.n_blocks // 2 + 1
        ex = torch.from_numpy(
            rng.integers(0, 2, (nbl, 8)).astype(np.int32)).to(cuda)
        for k in sorted({1, 2, lay.rho}):
            x = _state(lay, wl, 3)
            x = (x if nc > 1 else x[:, None])[:, :, :nbl].contiguous()
            halo = tuple(h.to(cuda) for h in
                         _pieces(lay, wl, (3, nc, nbl), k, seed=k))
            x = x.to(cuda)
            _equal(sk.stencil_step_fused_k_local(
                       lay, x[0], tuple(h[0] for h in halo), ex, wl, k=k),
                   sk.stencil_step_fused_k_local_plain(
                       lay, x[0], tuple(h[0] for h in halo), ex, wl, k=k))
            _equal(sk.stencil_step_fused_k_local(lay, x, halo, ex, wl, k=k),
                   sk.stencil_step_fused_k_local_plain(lay, x, halo, ex, wl,
                                                       k=k))
            for p in (None, 3):
                _close(sk.stencil_step_mxu_k_local(lay, x, halo, ex, wl,
                                                   k=k, p=p),
                       sk.stencil_step_mxu_k_local_plain(lay, x, halo, ex,
                                                         wl, k=k), wl)


@pytest.mark.parametrize("exchange", ["p2p", "gather"])
@pytest.mark.parametrize("wl_name", ["life", "gray-scott"])
@pytest.mark.parametrize("kind", ["dist-fused", "dist-mxu"])
def test_cuda_dist_engine_matches_single_device(cuda, kind, wl_name,
                                                exchange):
    """A 3-shard run on the card equals the single-device kernel engine of
    the same kind on the same state; a p2p launch runs two kernel launches
    per shard (interior pass and boundary patch), a gather launch one."""
    wl = trules.WORKLOADS[wl_name]
    single = make_engine("cuda-" + kind[len("dist-"):], tf.SIERPINSKI, 7, 2,
                         workload=wl)
    dist = make_engine(kind, tf.SIERPINSKI, 7, 2, workload=wl, n_shards=3,
                       exchange=exchange)
    assert dist.exchange_mode == exchange and dist.n_shards == 3
    x = single.init_random(seed=2)
    want = single.run(x, 7)
    sk.reset_launches()
    out = dist.run(dist.from_dense(x), 7)
    _close(dist.to_dense(out), want, wl)
    k = dist.effective_fusion_k
    per = 2 if exchange == "p2p" else 1
    name = "stencil_step_" + ("mxu" if kind == "dist-mxu" else "fused") + \
        "_k_local"
    assert sk.LAUNCHES[name] == per * 3 * (7 // k + (7 % k > 0))
    dead = torch.from_numpy(dist.dead_mask()).to(cuda)
    assert int((torch.cat(out, dim=-3) * dead).abs().sum()) == 0


def test_cuda_local_wrappers_refuse_bad_inputs(cuda):
    lay = BlockLayout(tf.SIERPINSKI, 5, 2)
    wl, k, nbl = trules.LIFE, 2, 5
    x = _state(lay, wl, 2)[:, None, :nbl].contiguous().to(cuda)
    halo = tuple(h.to(cuda) for h in _pieces(lay, wl, (2, 1, nbl), k))
    ex = torch.ones((nbl, 8), dtype=torch.int32, device=cuda)
    before = dict(sk.LAUNCHES)
    for fn in (sk.stencil_step_fused_k_local, sk.stencil_step_mxu_k_local):
        with pytest.raises(ValueError, match="existence"):
            fn(lay, x, halo, ex.long(), wl, k=k)
        with pytest.raises(ValueError, match="piece west"):
            fn(lay, x, (halo[0], halo[1], halo[2].transpose(-1, -2),
                        halo[3]), ex, wl, k=k)
        with pytest.raises(ValueError, match="piece top"):
            fn(lay, x, (halo[0].cpu(),) + halo[1:], ex, wl, k=k)
        with pytest.raises(ValueError, match="alias"):
            fn(lay, x, halo, ex, wl, k=k, out=x)
        with pytest.raises(ValueError, match="k <= rho"):
            fn(lay, x, halo, ex, wl, k=lay.rho + 1)
    assert sk.LAUNCHES == before


# ---------------------------------------------------------------------------
# v5 and kernel 7 on the tensor cores: every window width, packing and body
# ---------------------------------------------------------------------------
#: (fractal, r, m, k) giving the windows w = rho + 2k = 5, 6, 7, 8 (one 8 x 8
#: tile) and 9, 12 (k = rho: the wide instance)
MXU_WINDOWS = [(tf.CARPET, 4, 1, 1), (tf.SIERPINSKI, 7, 2, 1),
               (tf.CARPET, 4, 1, 2), (tf.SIERPINSKI, 7, 2, 2),
               (tf.CARPET, 4, 1, 3), (tf.SIERPINSKI, 7, 2, 4)]


@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("case", MXU_WINDOWS,
                         ids=[f"{c[0].name}-k{c[3]}" for c in MXU_WINDOWS])
def test_cuda_mxu_every_window_and_packing(cuda, wl_name, case):
    """v5 on B=3 at P = 1, 5 (odd: a warp with a zero slot), 7 (nb not a
    multiple of P) and the default, each one launch of the body its width
    picks, against the plain version."""
    frac, r, m, k = case
    wl = trules.WORKLOADS[wl_name]
    lay = BlockLayout(frac, r, m)
    assert lay.n_blocks % 7 and lay.n_blocks % 5
    x = _state(lay, wl, 3, seed=k).to(cuda)
    want = sk.stencil_step_mxu_batched_plain(lay, x.cpu(), wl, k=k)
    name = "stencil_step_mxu_batched" + \
        ("" if lay.rho + 2 * k <= 8 else "[wide]")
    for p in (1, 5, 7, None):
        sk.reset_launches()
        got = sk.stencil_step_mxu_batched(lay, x, wl, k=k, p=p)
        assert sk.LAUNCHES[name] == 1 and sum(sk.LAUNCHES.values()) == 1
        _close(got, want, wl)


@pytest.mark.parametrize("wl_name", ["life", "highlife"])
def test_cuda_mxu_fully_alive_windows(cuda, wl_name):
    """Every fractal cell alive: counts reach 8 and the aggregate's TF32
    rounding still gives them exactly."""
    wl = trules.WORKLOADS[wl_name]
    for frac, r, m in CASES:
        lay = BlockLayout(frac, r, m)
        x = torch.from_numpy(np.broadcast_to(
            lay.micro_mask, (2, lay.n_blocks, lay.rho, lay.rho)).copy())
        for k in (1, 2):
            _close(sk.stencil_step_mxu_batched(lay, x.to(cuda), wl, k=k),
                   sk.stencil_step_mxu_batched_plain(lay, x, wl, k=k), wl)


def test_cuda_runner_mxu_heat_64_steps(cuda):
    """HEAT through the cuda-mxu runner for 64 steps (32 launches of 3xTF32
    products) stays within the float bar of the CPU path."""
    frac, r, m = tf.SIERPINSKI, 7, 2
    states = _state(BlockLayout(frac, r, m), trules.HEAT, 2, seed=4)
    sk.reset_launches()
    got = BatchedRunner().run("cuda-mxu", frac, r, states.to(cuda), 64, m=m,
                              workload=trules.HEAT)
    assert sk.LAUNCHES["stencil_step_mxu_batched"] == 32
    want = BatchedRunner(device="cpu").run("cuda-mxu", frac, r, states, 64,
                                           m=m, workload=trules.HEAT)
    _close(got, want, trules.HEAT)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("wl_name", ["life", "gray-scott"])
def test_cuda_dist_mxu_shards_match_single_device(cuda, wl_name, n_shards):
    """Kernel 7 from the halo pieces over 1, 3 and 8 shards (p2p) equals
    the single-device cuda-mxu run."""
    wl = trules.WORKLOADS[wl_name]
    single = make_engine("cuda-mxu", tf.SIERPINSKI, 7, 2, workload=wl)
    dist = make_engine("dist-mxu", tf.SIERPINSKI, 7, 2, workload=wl,
                       n_shards=n_shards, exchange="p2p")
    x = single.init_random(seed=6)
    sk.reset_launches()
    out = dist.run(dist.from_dense(x), 6)
    assert sk.LAUNCHES["stencil_step_mxu_k_local"] > 0
    _close(dist.to_dense(out), single.run(x, 6), wl)


# ---------------------------------------------------------------------------
# v4 and kernel 6: every body fused_plan picks
# ---------------------------------------------------------------------------
#: (fractal, r, m, k): windows w = rho + 2k of 6 and 8 (W = 8: four windows
#: a warp), 12 and 9 (W = 16), 24, 27, 29 and 31 (W = 32), 33 and 81 (the
#: CTA body, [wide]); k = 1 and k = rho among them; block counts 243, 125,
#: 27, 25 and 5, none a multiple of the windows a CTA takes
FUSED_BODIES = [(tf.SIERPINSKI, 7, 2, 1), (tf.SIERPINSKI, 7, 2, 2),
                (tf.SIERPINSKI, 7, 2, 4), (tf.VICSEK, 4, 1, 3),
                (tf.SIERPINSKI, 6, 3, 8), (tf.VICSEK, 4, 2, 9),
                (tf.VICSEK, 4, 3, 1), (tf.VICSEK, 4, 3, 2),
                (tf.VICSEK, 4, 3, 3), (tf.VICSEK, 4, 3, 27)]


@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("case", FUSED_BODIES,
                         ids=[f"{c[0].name}-r{c[1]}m{c[2]}-k{c[3]}"
                              for c in FUSED_BODIES])
def test_cuda_fused_every_body(cuda, wl_name, case):
    """v4 (one simulation and B=3) and kernel 6 (B=1 and 3, random pieces
    and existence rows) at each body ``fused_plan`` picks, bit for bit
    against their plain versions, each one launch under its body's name."""
    frac, r, m, k = case
    wl = trules.WORKLOADS[wl_name]
    nc = wl.n_channels
    lay = BlockLayout(frac, r, m)
    body = sk.fused_plan(wl.dtype, nc, lay.rho, k).body
    assert body == ("" if lay.rho + 2 * k <= 32 else "[wide]")
    # floats in [0, 0.25): Gray-Scott stays finite over k = rho substeps
    x = _state(lay, wl, 3, seed=k, scale=0.25).to(cuda)
    for s in (x[0], x):
        sk.reset_launches()
        got = sk.stencil_step_fused_k(lay, s, wl, k=k)
        assert sk.LAUNCHES["stencil_step_fused_k" + body] == 1
        assert sum(sk.LAUNCHES.values()) == 1
        want = sk.stencil_step_fused_k_plain(lay, s.cpu(), wl, k=k)
        assert bool(torch.isfinite(want.float()).all())
        _equal(got, want)
    rng = np.random.default_rng(k)
    nbl = lay.n_blocks - 1 if lay.n_blocks > 2 else lay.n_blocks
    ex = torch.from_numpy(
        rng.integers(0, 2, (nbl, 8)).astype(np.int32)).to(cuda)
    xl = (x if nc > 1 else x[:, None])[:, :, :nbl].contiguous()
    halo = tuple(h.to(cuda) for h in _pieces(lay, wl, (3, nc, nbl), k,
                                             seed=k, scale=0.25))
    for s, h in ((xl[0], tuple(p[0] for p in halo)), (xl, halo)):
        sk.reset_launches()
        got = sk.stencil_step_fused_k_local(lay, s, h, ex, wl, k=k)
        assert sk.LAUNCHES["stencil_step_fused_k_local" + body] == 1
        assert sum(sk.LAUNCHES.values()) == 1
        want = sk.stencil_step_fused_k_local_plain(
            lay, s.cpu(), tuple(p.cpu() for p in h), ex.cpu(), wl, k=k)
        assert bool(torch.isfinite(want.float()).all())
        _equal(got, want)


@dataclasses.dataclass(frozen=True)
class _OrthCA(trules.TotalisticCA):
    """Life's rule over the 4 orthogonal neighbors: ring weights (0, 1)."""
    name: str = "orth-life"

    def weight(self, offset):
        return 1 if sum(abs(d) for d in offset) == 1 else 0


@dataclasses.dataclass(frozen=True)
class _MooreHeat(trules.HeatDiffusion):
    """Heat over all 8 neighbors: ring weights (1, 1)."""
    name: str = "moore-heat"
    degree: int = 8

    def weight(self, offset):
        return 1


@pytest.mark.parametrize("wl", [_OrthCA(), _MooreHeat()],
                         ids=["orth-life", "moore-heat"])
def test_cuda_fused_other_weights_run_the_cta_body(cuda, wl):
    """Ring weights other than the rule's own run the CTA body ([wide])
    even where the window fits a warp (w = 8), v4 and kernel 6 bit for bit
    with B = 3; the C entry refuses the warp body's plan for them."""
    lay, k = BlockLayout(tf.SIERPINSKI, 7, 2), 2
    assert not sk._rule_form(wl)
    x = _state(lay, wl, 3, seed=5, scale=0.25).to(cuda)
    sk.reset_launches()
    got = sk.stencil_step_fused_k(lay, x, wl, k=k)
    assert sk.LAUNCHES["stencil_step_fused_k[wide]"] == 1
    assert sum(sk.LAUNCHES.values()) == 1
    _equal(got, sk.stencil_step_fused_k_plain(lay, x.cpu(), wl, k=k))
    nbl = lay.n_blocks
    ex = torch.from_numpy(np.random.default_rng(5).integers(
        0, 2, (nbl, 8)).astype(np.int32)).to(cuda)
    halo = tuple(h.to(cuda) for h in _pieces(lay, wl, (3, 1, nbl), k,
                                             seed=5, scale=0.25))
    xl = x[:, None].contiguous()
    sk.reset_launches()
    got = sk.stencil_step_fused_k_local(lay, xl, halo, ex, wl, k=k)
    assert sk.LAUNCHES["stencil_step_fused_k_local[wide]"] == 1
    assert sum(sk.LAUNCHES.values()) == 1
    _equal(got, sk.stencil_step_fused_k_local_plain(
        lay, xl.cpu(), tuple(h.cpu() for h in halo), ex.cpu(), wl, k=k))
    # the warp body's plan, asked for with these weights: refused, nothing
    # launched
    plan = sk.fused_plan(wl.dtype, 1, lay.rho, k)
    assert plan.body == ""
    out = torch.zeros_like(x)
    with torch.cuda.device(cuda):
        rc = sk._c_function("sq_stencil_step_fused_k")(
            sk._rule(wl), x.data_ptr(), out.data_ptr(),
            lay.device_table("neighbor_table", cuda).data_ptr(),
            lay.device_table("window_mask", cuda, k).data_ptr(),
            lay.n_blocks, 3, lay.rho, k, plan.W, plan.warps,
            *sk._rule_args(wl, torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert rc != 0
    assert not bool(out.any())


# ---------------------------------------------------------------------------
# v1 and v2: every body step_plan picks, and the strip gather
# ---------------------------------------------------------------------------
#: (fractal, r, m): windows w = rho + 2 of 4, 5 (rho = 3: 9-byte uint8
#: centers and 20-byte strip rows, no 16-byte run) and 6 (W = 8: four
#: windows a warp), 10 and 11 (W = 16) and 29 (W = 32); block counts 9,
#: 25, 243, 27, 25 and 5, none a multiple of the windows a warp takes
SINGLE_BODIES = [(tf.SIERPINSKI, 3, 1), (tf.VICSEK, 3, 1),
                 (tf.SIERPINSKI, 7, 2), (tf.SIERPINSKI, 6, 3),
                 (tf.VICSEK, 4, 2), (tf.VICSEK, 4, 3)]
_SINGLE_FNS = ((sk.stencil_step_blocks, sk.stencil_step_blocks_plain),
               (sk.stencil_step_strips, sk.stencil_step_strips_plain))


def _single_launches(fn, body):
    """The launches of one v1 or v2 call through ``body``."""
    want = {fn.__name__ + body: 1}
    if fn is sk.stencil_step_strips:
        want["gather_halo_strips"] = 1
    return want


@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("case", SINGLE_BODIES,
                         ids=[f"{c[0].name}-r{c[1]}m{c[2]}"
                              for c in SINGLE_BODIES])
def test_cuda_single_step_every_body(cuda, wl_name, case):
    """v1 and v2 (one simulation and B=3) at each body ``step_plan``
    picks, bit for bit against their plain version, each one launch under
    its body's name (v2 and its gather)."""
    frac, r, m = case
    wl = trules.WORKLOADS[wl_name]
    lay = BlockLayout(frac, r, m)
    x = _state(lay, wl, 3, seed=r, scale=0.25).to(cuda)
    for fn, plain in _SINGLE_FNS:
        plan = sk.step_plan(wl.dtype, wl.n_channels, lay.rho,
                            fn is sk.stencil_step_strips)
        assert plan.body == "" and plan.W >= lay.rho + 2
        for s in (x[0], x):
            sk.reset_launches()
            got = fn(lay, s, wl)
            assert {n: v for n, v in sk.LAUNCHES.items() if v} == \
                _single_launches(fn, "")
            _equal(got, plain(lay, s.cpu(), wl))


@pytest.mark.parametrize("wl", [_OrthCA(), _MooreHeat()],
                         ids=["orth-life", "moore-heat"])
def test_cuda_single_step_other_weights_run_the_cta_body(cuda, wl):
    """Ring weights other than the rule's own run the CTA body ([wide]) for
    v1 and v2, bit for bit with B = 1 and 3; the C entries refuse the warp
    body's plan for them."""
    lay = BlockLayout(tf.SIERPINSKI, 7, 2)
    x = _state(lay, wl, 3, seed=6, scale=0.25).to(cuda)
    micro = lay.device_table("micro_mask", cuda)
    for fn, plain in _SINGLE_FNS:
        strips = fn is sk.stencil_step_strips
        assert sk.step_plan(wl.dtype, 1, lay.rho, strips, False).body == \
            "[wide]"
        for s in (x[0], x):
            sk.reset_launches()
            got = fn(lay, s, wl)
            assert {n: v for n, v in sk.LAUNCHES.items() if v} == \
                _single_launches(fn, "[wide]")
            _equal(got, plain(lay, s.cpu(), wl))
        plan = sk.step_plan(wl.dtype, 1, lay.rho, strips)
        assert plan.body == ""
        halo = sk.gather_halo_strips_plain(lay, x[:, None].cpu()).to(cuda) \
            if strips else lay.device_table("neighbor_table", cuda)
        out = torch.zeros_like(x)
        with torch.cuda.device(cuda):
            rc = sk._c_function("sq_" + fn.__name__)(
                sk._rule(wl), x.data_ptr(), out.data_ptr(), halo.data_ptr(),
                micro.data_ptr(), lay.n_blocks, 3, lay.rho, plan.W,
                plan.warps,
                *sk._rule_args(wl, torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        assert rc != 0
        assert not bool(out.any())


@pytest.mark.parametrize("wl_name", ["life", "heat", "gray-scott"])
@pytest.mark.parametrize("case", SINGLE_BODIES,
                         ids=[f"{c[0].name}-r{c[1]}m{c[2]}"
                              for c in SINGLE_BODIES])
def test_cuda_gather_halo_strips_matches_plain(cuda, wl_name, case):
    """The gather kernel bit for bit against its plain version, B = 1 and
    3: every direction, and the workload's ``halo_needs`` (HEAT's corners
    zero); ghosts read zeros; one launch each. A source that is not
    16-byte aligned takes the general body."""
    frac, r, m = case
    wl = trules.WORKLOADS[wl_name]
    lay = BlockLayout(frac, r, m)
    x = _state(lay, wl, 3, seed=r)
    x5 = x if wl.n_channels > 1 else x[:, None]
    for needs in (None, halo_needs(wl.weights2d)):
        for s in (x5[:1], x5):
            sk.reset_launches()
            got = sk._gather_halo_strips(lay, s.to(cuda), needs)
            assert {n: v for n, v in sk.LAUNCHES.items() if v} == {
                "gather_halo_strips": 1}
            _equal(got, sk.gather_halo_strips_plain(lay, s, needs))
    flat = torch.zeros(x5.numel() + 1, dtype=x5.dtype, device=cuda)
    odd = flat[1:].view(x5.shape)
    odd.copy_(x5)
    assert odd.data_ptr() % 16 and odd.is_contiguous()
    _equal(sk._gather_halo_strips(lay, odd), sk.gather_halo_strips_plain(
        lay, x5))
    if wl.n_channels == 1:
        _equal(sk.gather_halo_strips(lay, x[0].to(cuda)),
               sk.gather_halo_strips(lay, x[0]))


def test_cuda_gather_refuses_bad_inputs(cuda):
    lay = BlockLayout(tf.SIERPINSKI, 5, 2)
    x = _state(lay, trules.LIFE, 2).to(cuda)
    before = dict(sk.LAUNCHES)
    with pytest.raises(TypeError, match="1 or 4 bytes"):
        sk._gather_halo_strips(lay, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        sk._gather_halo_strips(lay, x.transpose(-1, -2))
    with pytest.raises(ValueError, match="does not match"):
        sk._gather_halo_strips(lay, x[:, :3])
    assert sk.LAUNCHES == before


@pytest.mark.parametrize("wl_name", ["life", "heat"])
def test_cuda_single_state_wrappers_match_plain(cuda, wl_name):
    """``stencil_step_mxu``, ``stencil_step_mxu_k`` and ``life_step_fused``
    on one simulation, each one launch."""
    wl = trules.WORKLOADS[wl_name]
    lay = BlockLayout(tf.CARPET, 4, 1)
    x = _state(lay, wl, 1, seed=3)[0]
    for k, fn in ((1, lambda s: sk.stencil_step_mxu(lay, s, wl)),
                  (2, lambda s: sk.stencil_step_mxu_k(lay, s, wl, k=2)),
                  (3, lambda s: sk.stencil_step_mxu_k(lay, s, wl, k=3,
                                                      p=2))):
        sk.reset_launches()
        got = fn(x.to(cuda))   # w = 9 at k = 3: the wide instance
        assert sk.LAUNCHES["stencil_step_mxu_batched" + (
            "[wide]" if k == 3 else "")] == 1
        assert sum(sk.LAUNCHES.values()) == 1
        _close(got, sk.stencil_step_fused_k_plain(lay, x, wl, k=k), wl)
    if wl is trules.LIFE:
        sk.reset_launches()
        got = sk.life_step_fused(lay, x.to(cuda))
        assert sk.LAUNCHES["stencil_step_fused"] == 1
        _equal(got, sk.stencil_step_fused_plain(lay, x, wl))


# ---------------------------------------------------------------------------
# v3 (v4 at k = 1): every body fused_plan picks at k = 1
# ---------------------------------------------------------------------------
#: SINGLE_BODIES' layouts (W = 8, 16 and 32), and rho = 32 (w = 34: the CTA
#: body, [wide])
V3_BODIES = SINGLE_BODIES + [(tf.SIERPINSKI, 7, 5)]


@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("case", V3_BODIES,
                         ids=[f"{c[0].name}-r{c[1]}m{c[2]}"
                              for c in V3_BODIES])
def test_cuda_v3_every_body(cuda, wl_name, case):
    """v3 (one simulation and B=3, 3 steps) at each body ``fused_plan``
    picks at k = 1, bit for bit against its plain version, each launch
    under its body's name."""
    frac, r, m = case
    wl = trules.WORKLOADS[wl_name]
    lay = BlockLayout(frac, r, m)
    plan = sk.fused_plan(wl.dtype, wl.n_channels, lay.rho, 1)
    assert plan.body == ("" if lay.rho + 2 <= 32 else "[wide]")
    x = _state(lay, wl, 3, seed=r, scale=0.25).to(cuda)
    for s in (x[0], x):
        sk.reset_launches()
        got, want = s, s.cpu()
        for _ in range(3):
            got = sk.stencil_step_fused(lay, got, wl)
            want = sk.stencil_step_fused_plain(lay, want, wl)
        assert {n: v for n, v in sk.LAUNCHES.items() if v} == {
            "stencil_step_fused" + plan.body: 3}
        _equal(got, want)


@pytest.mark.parametrize("wl", [_OrthCA(), _MooreHeat()],
                         ids=["orth-life", "moore-heat"])
def test_cuda_v3_other_weights_run_the_cta_body(cuda, wl):
    """Ring weights other than the rule's own run v3's CTA body ([wide]),
    bit for bit with B = 1 and 3; the C entry refuses the warp body's plan
    for them."""
    lay = BlockLayout(tf.SIERPINSKI, 7, 2)
    x = _state(lay, wl, 3, seed=7, scale=0.25).to(cuda)
    for s in (x[0], x):
        sk.reset_launches()
        got = sk.stencil_step_fused(lay, s, wl)
        assert {n: v for n, v in sk.LAUNCHES.items() if v} == {
            "stencil_step_fused[wide]": 1}
        _equal(got, sk.stencil_step_fused_plain(lay, s.cpu(), wl))
    plan = sk.fused_plan(wl.dtype, 1, lay.rho, 1)
    assert plan.body == ""
    out = torch.zeros_like(x)
    with torch.cuda.device(cuda):
        rc = sk._c_function("sq_stencil_step_fused")(
            sk._rule(wl), x.data_ptr(), out.data_ptr(),
            lay.device_table("neighbor_table", cuda).data_ptr(),
            lay.device_table("window_mask", cuda, 1).data_ptr(),
            lay.n_blocks, 3, lay.rho, plan.W, plan.warps,
            *sk._rule_args(wl, torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert rc != 0
    assert not bool(out.any())


@pytest.mark.parametrize("wl_name", ["life", "heat"])
def test_cuda_fused_k1_engine_runs_v3(cuda, wl_name):
    """cuda-fused at fusion_k=1: every step one v3 launch on the warp body,
    the run equal to the CPU path bit for bit."""
    wl = trules.WORKLOADS[wl_name]
    on_card = make_engine("cuda-fused", tf.SIERPINSKI, 7, 2, workload=wl,
                          fusion_k=1)
    on_cpu = make_engine("cuda-fused", tf.SIERPINSKI, 7, 2, workload=wl,
                         fusion_k=1, device="cpu")
    x = on_cpu.init_random(seed=4)
    sk.reset_launches()
    got = on_card.run(x.to(cuda), 5)
    assert {n: v for n, v in sk.LAUNCHES.items() if v} == {
        "stencil_step_fused": 5}
    _equal(got, on_cpu.run(x, 5))


# ---------------------------------------------------------------------------
# nu on the grouped tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(tf.REGISTRY))
def test_cuda_nu_every_level_count_and_alignment(cuda, name):
    """nu bit for bit against its plain version at r in {0, 1, 2, 3, an r
    whose top group is short, the largest r}; over counts of 1, 3 and 4n +
    1 (the scalar tail), coordinates past every edge, and a contiguous
    view that is not 16-byte aligned (the kernel's scalar path)."""
    frac = tf.REGISTRY[name]
    rng = np.random.default_rng(9)
    short = 2 * nm.group_levels(frac.s) + 1
    for r in sorted({0, 1, 2, 3, short, nm.max_int32_level(frac)}):
        n = frac.side(r)
        ex, ey = (torch.from_numpy(rng.integers(
            -3, n + 3, size=4 * 257 + 1).astype(np.int32)) for _ in range(2))
        ex[:4] = torch.tensor([-1, 0, n - 1, n], dtype=torch.int32)
        ey[:4] = torch.tensor([n, n - 1, 0, -1], dtype=torch.int32)
        for count in (1, 3, ex.numel()):
            a, b = ex[:count], ey[:count]
            sk.reset_launches()
            got = nm.nu_map_tc(frac, r, a.to(cuda), b.to(cuda))
            assert sk.LAUNCHES["nu_map_tc"] == 1
            for g, w in zip(got, nm.nu_map_tc_plain(frac, r, a, b)):
                assert torch.equal(g.cpu(), w), (r, count)
        flat = torch.cat([ex, ey]).to(cuda)
        odd_x, odd_y = flat[1:ex.numel()], flat[ex.numel() + 1:]
        assert odd_x.is_contiguous() and odd_x.data_ptr() % 16
        for g, w in zip(nm.nu_map_tc(frac, r, odd_x, odd_y),
                        nm.nu_map_tc_plain(frac, r, ex[1:], ey[1:])):
            assert torch.equal(g.cpu(), w), r


@pytest.mark.parametrize("name", sorted(tf.REGISTRY))
def test_cuda_lambda_every_level_count_and_alignment(cuda, name):
    """lambda bit for bit against its plain version at r in {0, 1, 2, 3,
    an r whose top group is short, the largest r}; over counts of 1, 3 and
    4n + 1 (the scalar tail), compact coordinates negative and past the
    edges, and a contiguous view that is not 16-byte aligned (the kernel's
    scalar path)."""
    frac = tf.REGISTRY[name]
    rng = np.random.default_rng(10)
    top = nm.max_int32_level(frac)
    short = min(top, 2 * lm.lambda_plan(frac, 0).levels + 1)
    for r in sorted({0, 1, 2, 3, short, top}):
        rows, cols = frac.compact_dims(r)
        cx, cy = (torch.from_numpy(rng.integers(
            max(-2 * side, -2 ** 31), min(2 * side, 2 ** 31),
            size=4 * 257 + 1).astype(np.int32)) for side in (cols, rows))
        cx[:4] = torch.tensor([-1, 0, cols - 1, cols], dtype=torch.int32)
        cy[:4] = torch.tensor([rows, rows - 1, 0, -1], dtype=torch.int32)
        for count in (1, 3, cx.numel()):
            a, b = cx[:count], cy[:count]
            sk.reset_launches()
            got = lm.lambda_map_tc(frac, r, a.to(cuda), b.to(cuda))
            assert sk.LAUNCHES["lambda_map_tc"] == 1
            for g, w in zip(got, lm.lambda_map_tc_plain(frac, r, a, b)):
                assert torch.equal(g.cpu(), w), (r, count)
        flat = torch.cat([cx, cy]).to(cuda)
        odd_x, odd_y = flat[1:cx.numel()], flat[cx.numel() + 1:]
        assert odd_x.is_contiguous() and odd_x.data_ptr() % 16
        for g, w in zip(lm.lambda_map_tc(frac, r, odd_x, odd_y),
                        lm.lambda_map_tc_plain(frac, r, cx[1:], cy[1:])):
            assert torch.equal(g.cpu(), w), r


@pytest.mark.parametrize("name", ["sierpinski", "carpet", "vicsek"])
def test_cuda_lambda_nu_round_trip_on_the_compact_grid(cuda, name):
    """lambda of every compact cell, then nu: every cell back, all
    members."""
    frac = tf.REGISTRY[name]
    r = 12 if frac.s == 2 else 6
    rows, cols = frac.compact_dims(r)
    cy, cx = torch.meshgrid(torch.arange(rows, dtype=torch.int32),
                            torch.arange(cols, dtype=torch.int32),
                            indexing="ij")
    cx, cy = cx.contiguous().to(cuda), cy.contiguous().to(cuda)
    bx, by, valid = nm.nu_map_tc(frac, r, *lm.lambda_map_tc(frac, r, cx, cy))
    assert torch.equal(bx, cx) and torch.equal(by, cy)
    assert bool(valid.all())


# ----------------------------------------------------------------------
# the simulation service and the elastic runner on the card
# ----------------------------------------------------------------------
def _legs(runner, q, frac):
    """{step: host state} of one uninterrupted ``runner.run`` of q's seed
    in legs of ``snapshot_every`` steps."""
    eng = runner.engine_for(q.bucket, frac=frac, workload=q.workload)
    dist = q.kind.startswith("dist-")
    state = eng.init_random(q.seed)
    state = state if dist else state[None]
    out, done = {}, 0
    while done < q.steps:
        n = min(q.snapshot_every, q.steps - done)
        state = runner.run(q.bucket, states=state, steps=n, frac=frac)
        done += n
        out[done] = (eng.to_dense(state) if dist else state[0]).cpu().numpy()
    return out


def test_cuda_service_matches_runner_run(cuda, tmp_path):
    """cuda-fused and dist-fused (4 shards on one card) LIFE requests with
    snapshots through ``FractalService`` on the card, one injected
    exception: every final state and snapshot equals an uninterrupted
    ``runner.run`` of the same seed, and the kernels ran."""
    from repro_torch.runtime.fault import Fault, FaultInjector
    from repro_torch.serving import (FractalService, ServiceConfig,
                                     SimRequest)
    frac = tf.SIERPINSKI
    runner = BatchedRunner()
    reqs = [SimRequest(frac=frac, r=6, m=2, kind=kind, seed=seed, steps=12,
                       snapshot_every=4, rid=f"{kind}-{seed}",
                       n_shards=4 if kind == "dist-fused" else None)
            for kind, seed in (("cuda-fused", 0), ("cuda-fused", 1),
                               ("dist-fused", 2))]
    inj = FaultInjector([Fault("exception", at_segment=1)])
    svc = FractalService(ServiceConfig(ckpt_dir=str(tmp_path), max_batch=4,
                                       backoff_base_s=0.01,
                                       hang_threshold_s=60.0), runner,
                         injector=inj)
    sk.reset_launches()
    res = svc.serve(reqs)
    assert inj.all_fired()
    assert sk.LAUNCHES["stencil_step_fused_k"] > 0
    assert sk.LAUNCHES["stencil_step_fused_k_local"] > 0
    assert sum(r.retries for r in res) >= 1
    for q, r in zip(reqs, res):
        assert r.ok and r.steps_done == 12, (q.rid, r.status, r.error)
        want = _legs(runner, q, frac)
        assert [s for s, _ in r.snapshots] == [4, 8]
        for step, snap in r.snapshots:
            np.testing.assert_array_equal(snap, want[step])
        np.testing.assert_array_equal(r.state, want[12])


def test_cuda_elastic_reshard_matches_runner_run(cuda, tmp_path):
    """4 shards on one card lose a device at launch 2, reshard to 2 and
    end equal to the single-device cuda-fused run, bit for bit."""
    from repro_torch.core.elastic import ElasticDistributedRunner
    from repro_torch.runtime.fault import Fault, FaultInjector
    frac = tf.SIERPINSKI
    runner = BatchedRunner()
    eng = runner.engine_for("cuda-fused", frac, 6, m=2)
    want = runner.run("cuda-fused", frac, 6, eng.init_random(3)[None], 12,
                      m=2)[0]
    inj = FaultInjector([Fault("device_loss", at_segment=2, shard=1)])
    sk.reset_launches()
    with ElasticDistributedRunner(
            BlockLayout(frac, 6, 2), n_shards=4, compute="fused",
            ckpt_dir=str(tmp_path), ckpt_every=4, launch_timeout_s=60.0,
            backoff_base_s=0.01, injector=inj) as el:
        out = el.run(12, seed=3)
        assert el.n_shards == 2 and el.stats.reshards == 1
        assert el.stats.restores == 1
        _equal(el.engine.to_dense(out), want)
    assert sk.LAUNCHES["stencil_step_fused_k_local"] > 0


# ------------------------------------------------------------ the autotuner
@pytest.mark.parametrize("kind", ["cuda-fused", "cuda-mxu"])
def test_cuda_tune_spec_is_parity_exact(cuda, kind, monkeypatch):
    """The sweep on the card at sierpinski r=8 m=2: every candidate (k in
    1..4, and P for cuda-mxu) bit for bit with the heuristic engine (the
    search's own gate on the compact states), the winner no slower than
    the baseline on its own matrix."""
    from repro_torch.tuning import EngineSpec, candidate_space, tune_spec
    monkeypatch.setenv("SQUEEZE_TUNING", "off")
    spec = EngineSpec(kind, 2, "sierpinski", 8, 2, "life")
    res = tune_spec(spec, steps=4, rounds=2, seed=1)
    assert not res.parity_failures
    assert set(res.times) == {c.label for c in candidate_space(spec, 3 ** 6)}
    assert res.speedup >= 1.0 and res.roofline_s > 0
    win = dataclasses.replace(spec, fusion_k=res.best.fusion_k,
                              macro_p=res.best.macro_p)
    e_win = make_engine(win, table=None)
    e_base = make_engine(spec, table=None)
    _equal(e_win.run(e_win.init_random(2), 9),
           e_base.run(e_base.init_random(2), 9))


def test_cuda_make_engine_hits_an_override_table(cuda, tmp_path,
                                                 monkeypatch):
    from repro_torch import obs
    from repro_torch.tuning import (EngineSpec, TableEntry, TuningTable,
                                    reset_default_table_cache)
    spec = EngineSpec("cuda-mxu", 2, "sierpinski", 8, 2, "life")
    table = TuningTable()
    table.put(spec, TableEntry(fusion_k=3, macro_p=4))
    path = str(tmp_path / "t.json")
    table.save(path)
    monkeypatch.delenv("SQUEEZE_TUNING", raising=False)
    monkeypatch.setenv("SQUEEZE_TUNING_TABLE", path)
    reset_default_table_cache()
    with obs.enabled_scope(True) as reg:
        obs.reset()
        eng = make_engine(spec)
        assert reg.value("engine.tune.hit", kind="cuda-mxu") == 1
    reset_default_table_cache()
    assert (eng.fusion_k, eng.macro_p) == (3, 4)
    base = make_engine(spec, table=None)
    assert (base.fusion_k, base.macro_p) != (3, 4)
    _equal(eng.run(eng.init_random(5), 7), base.run(base.init_random(5), 7))


def test_cuda_measured_bandwidth_is_near_the_card(cuda):
    """A 1 GiB float32 copy: under the H100's 3.35 TB/s, over 0.5 TB/s."""
    from repro_torch.tuning.measure import measured_bandwidth_gbs
    gbs = measured_bandwidth_gbs()
    assert 500.0 < gbs < 3350.0


# ----------------------------------------------------- the training path
def _train_batch(cfg, device, b=4, s=16, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch,accum", [("smollm-135m", 1),
                                        ("smollm-135m", 4),
                                        ("mixtral-8x22b", 1),
                                        ("whisper-small", 1)])
def test_cuda_train_step_matches_cpu(cuda, arch, accum):
    """One ``make_train_step`` step of a smoke config on the card against
    the same step on the CPU, from the same weights, seeded non-zero
    moments and batch: loss, grad norm, parameters and moments within the
    reference's step bar, rtol 5e-4, atol 5e-6."""
    from repro_torch import configs
    from repro_torch.launch import specs
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke_config(arch)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    card = lm.init_params(3, cfg, device=cuda)
    host = lm.build_model(cfg, torch.device("cpu"), None)
    host.load_state_dict(card.state_dict())
    states = []
    for model in (card, host):
        named = dict(model.named_parameters())
        state = adamw.init(ocfg, named)
        gen = torch.Generator().manual_seed(5)
        for n, p in named.items():
            state["m"][n].copy_(1e-3 * torch.randn(p.shape, generator=gen))
            state["v"][n].copy_(1e-6 * torch.rand(p.shape, generator=gen)
                                + 1e-8)
        states.append(state)
    step = specs.make_train_step(cfg, ocfg, accum_steps=accum)
    _, s_card, m_card = step(card, states[0], _train_batch(cfg, cuda))
    _, s_host, m_host = step(host, states[1],
                             _train_batch(cfg, torch.device("cpu")))
    tol = dict(rtol=5e-4, atol=5e-6)
    for k in ("loss", "grad_norm", "lr", "ce"):
        torch.testing.assert_close(m_card[k].cpu(), m_host[k], **tol)
    for n, p in host.named_parameters():
        torch.testing.assert_close(card.get_parameter(n).detach().cpu(),
                                   p.detach(), **tol, msg=n)
        for key in ("m", "v"):
            torch.testing.assert_close(s_card[key][n].cpu(), s_host[key][n],
                                       **tol, msg=f"{key} {n}")


def test_cuda_restart_is_bit_exact(cuda, tmp_path, monkeypatch):
    """The smoke smollm-135m trained 12 steps on the card, killed after
    step 6 and resumed from its step-4 checkpoint, ends bit for bit where
    the uninterrupted run does. Deterministic algorithms are on for the
    test: a gradient summed with atomics (the label gather's backward) may
    differ in its last bits from run to run."""
    from repro_torch import configs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.data.pipeline import SyntheticMarkov
    from repro_torch.launch.train import train
    from repro_torch.models import model as lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.fault import run_with_restarts

    cfg = configs.get_smoke_config("smollm-135m")
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12,
                             weight_decay=0.0)
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=16, global_batch=2,
                           seed=3)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        clean = str(tmp_path / "clean")
        train(cfg, ocfg, data, steps=12, ckpt_dir=clean, ckpt_every=4,
              log_every=0)
        broken = str(tmp_path / "broken")
        calls = []

        def run():
            calls.append(1)
            return train(cfg, ocfg, data, steps=12, ckpt_dir=broken,
                         ckpt_every=4, log_every=0,
                         fail_at=6 if len(calls) == 1 else None).step

        assert run_with_restarts(run, max_restarts=2) == 12
        assert len(calls) == 2
    finally:
        torch.use_deterministic_algorithms(was)
    named = dict(lm.build_model(cfg, torch.device("cpu"),
                                None).named_parameters())
    like = {"params": named, "opt": adamw.init(ocfg, named)}
    want = CheckpointManager(clean).restore(like)
    got = CheckpointManager(broken).restore(like)
    for n in named:
        np.testing.assert_array_equal(got["params"][n], want["params"][n],
                                      err_msg=n)
