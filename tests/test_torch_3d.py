"""The port's 3D stack against the JAX reference: the 3D fractal maps,
every ``BlockLayout3D`` table (bit-exact), the 3D workload parts, the
bb3d / cell3d / block3d / cuda-3d / cuda-3d-mxu engines (the kernel kinds
on their plain path) against the reference's ``bb3d`` oracle, fused
k-stepping with its remainder and k > rho, the runner's 3D dispatch, and
each plain kernel version against the reference Pallas kernel in interpret
mode (one case each). LIFE3D is bit-exact; HEAT3D agrees to
rtol=atol=1e-5, the reference's own bar
(``tests/test_stencil3d_fused.py``). The CUDA kernels themselves are held
against these plain versions in ``test_torch_cuda.py``."""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import fractals3d as rf3
from repro.core.compact3d import BlockLayout3D as RefLayout
from repro.core.stencil3d import BB3DEngine as RefBB3D
from repro.core.stencil3d import Squeeze3DBlockEngine as RefBlock3D
from repro.kernels import squeeze_stencil3d as rk3
from repro.workloads import base as rbase
from repro.workloads import rules as rrules
from repro_torch import interop
from repro_torch.core import fractals3d as tf3
from repro_torch.core.compact3d import BlockLayout3D, expanded_to_compact3
from repro_torch.core.stencil import make_engine
from repro_torch.core.stencil3d import Squeeze3DKernelEngine, life3_rule
from repro_torch.kernels import build
from repro_torch.kernels import squeeze_stencil3d as k3
from repro_torch.tuning.spec import REFERENCE_KINDS, EngineSpec
from repro_torch.workloads import BatchedRunner
from repro_torch.workloads import base as tbase
from repro_torch.workloads import rules as trules

#: the reference's own 3D cases: rho = 2 with holes everywhere, rho = 3
#: with interior holes
CASES = [("sierpinski3d", 4, 1), ("menger", 2, 1)]
CASE_IDS = [f"{f}-r{r}-m{m}" for f, r, m in CASES]
WORKLOADS = ["life3d", "heat3d"]
KINDS3D = ["bb3d", "cell3d", "block3d", "cuda-3d", "cuda-3d-mxu"]
BLOCK_KINDS = ["block3d", "cuda-3d", "cuda-3d-mxu"]
STEPS = 3


def _pair(name):
    """(reference, port) workload of this name (2D LIFE included)."""
    ref = {"life3d": rrules.LIFE3D, "heat3d": rrules.HEAT3D,
           "life": rrules.LIFE}[name]
    return ref, trules.get_workload(name)


def _tol(wl):
    return dict(rtol=0, atol=0) if wl.dtype == torch.uint8 \
        else dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _layouts(name, r, m):
    return (RefLayout(rf3.REGISTRY3D[name], r, m),
            BlockLayout3D(tf3.REGISTRY3D[name], r, m))


def _expanded(name, r, wl_name, seed=0):
    """A numpy expanded state (n, n, n) with holes zeroed."""
    frac = tf3.REGISTRY3D[name]
    n = frac.side(r)
    rng = np.random.default_rng(seed)
    if wl_name == "heat3d":
        x = rng.random((n, n, n)).astype(np.float32)
    else:
        x = rng.integers(0, 2, (n, n, n)).astype(np.uint8)
    return x * frac.mask(r)


@functools.lru_cache(maxsize=None)
def _ref_bb_run(name, r, wl_name, seed=0):
    """The reference bb3d oracle's expanded states after 0..STEPS steps."""
    eng = RefBB3D(rf3.REGISTRY3D[name], r, _pair(wl_name)[0])
    s = jnp.asarray(_expanded(name, r, wl_name, seed))
    out = [np.asarray(s)]
    for _ in range(STEPS):
        s = eng.step(s)
        out.append(np.asarray(s))
    return out


# ------------------------------------------------------- fractal maps
@pytest.mark.parametrize("name,r", [("sierpinski3d", 4), ("menger", 2)])
def test_fractal3d_maps_match_reference(name, r):
    ref, port = rf3.REGISTRY3D[name], tf3.REGISTRY3D[name]
    assert port.compact_dims(r) == ref.compact_dims(r)
    assert port.volume(r) == ref.volume(r) and port.mrf(r) == ref.mrf(r)
    np.testing.assert_array_equal(port.mask(r), ref.mask(r))
    nx, ny, nz = port.compact_dims(r)
    cz, cy, cx = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    want = rf3.lambda3_map(ref, r, *(jnp.asarray(a) for a in (cx, cy, cz)))
    for got in (tf3.lambda3_map(port, r, cx, cy, cz),
                tf3.lambda3_map(port, r, *(torch.from_numpy(a)
                                           for a in (cx, cy, cz)))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # nu3 and membership over the whole volume and one cell past each edge
    n = port.side(r)
    ez, ey, ex = np.meshgrid(*(np.arange(-1, n + 1),) * 3, indexing="ij")
    ref_args = [jnp.asarray(a) for a in (ex, ey, ez)]
    for g, w in zip(tf3.nu3_map(port, r, ex, ey, ez),
                    rf3.nu3_map(ref, r, *ref_args)):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(
        tf3.is_fractal3(port, r, *(torch.from_numpy(a) for a in
                                   (ex, ey, ez))).numpy(),
        np.asarray(rf3.is_fractal3(ref, r, *ref_args)))


# -------------------------------------------------------- layout tables
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_layout3d_block_tables_match_reference(case):
    ref, port = _layouts(*case)
    assert (port.rho, port.r_b, port.block_dims, port.n_blocks,
            port.ghost) == (ref.rho, ref.r_b, ref.block_dims, ref.n_blocks,
                            ref.ghost)
    np.testing.assert_array_equal(port.micro_mask, ref.micro_mask)
    for g, w in zip(port.block_coords, ref.block_coords):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.block_origin_expanded,
                                  ref.block_origin_expanded)
    np.testing.assert_array_equal(port.neighbor_table, ref.neighbor_table)
    np.testing.assert_array_equal(port.existence_table, ref.existence_table)
    assert port.memory_bytes(4) == ref.memory_bytes(4)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_layout3d_depth_k_tables_match_reference(case, k):
    """Offset tables (k > rho spans several block rings), window and halo
    masks, the halo regions, ``pad_with_halo_k`` and the mxu padding."""
    ref, port = _layouts(*case)
    assert port.halo_block_radius(k) == ref.halo_block_radius(k)
    assert port.halo_offsets(k) == ref.halo_offsets(k)
    np.testing.assert_array_equal(port.offset_table(k), ref.offset_table(k))
    np.testing.assert_array_equal(port.window_mask(k), ref.window_mask(k))
    np.testing.assert_array_equal(port.halo_mask(k), ref.halo_mask(k))
    if k <= port.rho:
        from repro.core.compact3d import halo_regions3 as ref_regions
        from repro_torch.core.compact3d import halo_regions3
        assert halo_regions3(port.rho, k) == ref_regions(ref.rho, k)
        np.testing.assert_array_equal(
            k3.window_masks(port, k, "cpu").numpy(), ref.halo_mask(k))
        p = ref.macro_tiles(k)[0]
        np.testing.assert_array_equal(port.existence_padded(k, p=p),
                                      ref.existence_padded(k))
        assert port.macro_tiles_for(7, k, p=3) == \
            ref.macro_tiles_for(7, k, p=3)
    rng = np.random.default_rng(k)
    x = (rng.integers(0, 9, (port.n_blocks,) + (port.rho,) * 3)
         * port.micro_mask).astype(np.float32)
    np.testing.assert_array_equal(
        port.pad_with_halo_k(torch.from_numpy(x), k).numpy(),
        np.asarray(ref.pad_with_halo_k(jnp.asarray(x), k)))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_layout3d_expanded_round_trip(case):
    ref, port = _layouts(*case)
    e = _expanded(case[0], case[1], "heat3d", seed=3)
    b = port.from_expanded(torch.from_numpy(e))
    np.testing.assert_array_equal(b.numpy(), np.asarray(
        ref.from_expanded(jnp.asarray(e))))
    np.testing.assert_array_equal(port.to_expanded(b).numpy(), e)
    np.testing.assert_array_equal(port.to_expanded(b[None])[0].numpy(), e)


def test_layout3d_mxu_packing_fills_the_cta_budget():
    """The default P packs MXU3_CELLS_PER_CTA window cells (one block at
    rho = 9, k >= 2) and is rebalanced; P never changes a result."""
    from repro_torch.core.compact3d import MXU3_CELLS_PER_CTA
    lay = BlockLayout3D(tf3.MENGER, 4, 2)  # rho = 9, 400 blocks
    assert lay.macro_tiles(3) == (1, 400, 400)
    p, n_macro, nb_pad = lay.macro_tiles(1)
    assert p * 11 ** 3 <= MXU3_CELLS_PER_CTA and nb_pad >= 400
    assert n_macro == -(-400 // p)
    with pytest.raises(ValueError):
        lay.macro_tiles(1, p=0)


# ----------------------------------------------------- workload parts
@pytest.mark.parametrize("name", WORKLOADS + ["life"])
def test_workload3d_weights_and_factors_match_reference(name):
    ref, port = _pair(name)
    assert port.weights3d == ref.weights3d
    np.testing.assert_array_equal(port.weights3x3x3, ref.weights3x3x3)
    assert port.weight_factors3 == ref.weight_factors3
    for dz in (-1, 0, 1):
        recon = np.zeros((3, 3))
        for row, col in port.weight_factors3[dz + 1]:
            recon += np.outer(row, col)
        np.testing.assert_allclose(recon, port.weights3x3x3[dz + 1],
                                   rtol=0, atol=1e-12)
    w, p = 7, 2
    rm, ct, dzs = rk3._mxu3_operators(ref, w, p)
    r_port, c_port, dz_port = k3.mxu3_operators(port, w)
    assert dz_port == dzs
    np.testing.assert_array_equal(r_port, rm)
    for s in range(p):
        blk = ct[:, s * w:(s + 1) * w, s * w:(s + 1) * w]
        np.testing.assert_array_equal(c_port.transpose(0, 2, 1), blk)


@pytest.mark.parametrize("weights", ["ones", "heat", "irregular"])
def test_weighted_moore_agg3_matches_reference(weights):
    """The separable path and the per-direction loop."""
    w = {"ones": (1,) * 26, "heat": rrules.HEAT3D.weights3d,
         "irregular": tuple(range(1, 27))}[weights]
    x = np.random.default_rng(4).random((2, 5, 6, 7)).astype(np.float32)
    want = rbase.weighted_moore_agg3(jnp.asarray(x), w, jnp.float32)
    got = tbase.weighted_moore_agg3(torch.from_numpy(x), w, torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name", WORKLOADS)
def test_tile_rule_k3_matches_reference(name):
    ref, port = _pair(name)
    k = 2
    rng = np.random.default_rng(5)
    shape = (3,) + (4 + 2 * k,) * 3
    x = rng.random(shape).astype(np.float32) if name == "heat3d" else \
        rng.integers(0, 2, shape).astype(np.uint8)
    mask = (rng.random(shape) < 0.8).astype(np.uint8)
    want = jax.jit(lambda p, m: ref.tile_rule_k(p, m, k, ndim=3))(x, mask)
    got = port.tile_rule_k(torch.from_numpy(x), torch.from_numpy(mask), k,
                           ndim=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(port))


def test_life3d_count_masks():
    """The 27-bit masks the kernels take: bit c set iff c is in the set;
    counts outside [0, 26] are refused."""
    wl = trules.LIFE3D
    params = wl.kernel_params()
    assert params["born"] == sum(1 << c for c in wl.born) == 1 << 6
    assert params["survive"] == sum(1 << c for c in wl.survive) \
        == (1 << 5) | (1 << 6) | (1 << 7)
    assert trules.count_mask(frozenset({26})) == 1 << 26
    for bad in (27, -1):
        with pytest.raises(ValueError, match="26"):
            trules.count_mask(frozenset({bad}))
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 2, 500).astype(np.uint8))
    agg = torch.from_numpy(np.random.default_rng(7).integers(
        0, 27, 500).astype(np.int32))
    assert torch.equal(wl.apply(x, agg, None), life3_rule(x, agg))


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload3d_carried_across_from_reference_fields(name):
    ref, port = _pair(name)
    twin = interop.workload_from_fields(type(ref).__name__,
                                        **dataclasses.asdict(ref))
    assert twin == port and hash(twin) == hash(port)
    assert trules.get_workload(name) is port


def test_block3d_state_round_trip():
    x = np.random.default_rng(8).random((2, 20, 3, 3, 3)).astype(np.float32)
    t = interop.state_from_numpy(x, device="cpu")
    np.testing.assert_array_equal(interop.state_to_numpy(t), x)


# --------------------------------------------- engines against bb3d
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("kind", KINDS3D)
def test_3d_engines_match_reference_bb_oracle(case, wl_name, kind):
    """Every port kind (the kernel kinds on their plain path) from the
    same expanded state, 3 steps, against the reference's bb3d."""
    name, r, m = case
    wl = _pair(wl_name)[1]
    frac = tf3.REGISTRY3D[name]
    eng = make_engine(kind, frac, r, m, workload=wl, device="cpu")
    want = _ref_bb_run(name, r, wl_name)
    e0 = torch.from_numpy(want[0].copy())
    if kind == "bb3d":
        s = e0
    elif kind == "cell3d":
        s = expanded_to_compact3(frac, r, e0)
    else:
        s = eng.layout.from_expanded(e0)
    for step in range(STEPS):
        s = eng.step(s)
        got = s if kind == "bb3d" else eng.to_expanded(s)
        np.testing.assert_allclose(got.numpy(), want[step + 1], **_tol(wl),
                                   err_msg=f"{kind} step {step}")


def test_2d_life_on_block3d_matches_reference():
    """The totalistic rules are dimension-free: 2D LIFE (B3/S23) over the
    26-cell neighborhood, as on the reference's 3D engines."""
    name, r, m = "menger", 2, 1
    ref_wl, wl = _pair("life")
    ref_eng = RefBlock3D(RefLayout(rf3.MENGER, r, m), ref_wl)
    eng = make_engine("block3d", tf3.MENGER, r, m, workload=wl,
                      device="cpu")
    e = _expanded(name, r, "life", seed=2)
    s_ref = ref_eng.layout.from_expanded(jnp.asarray(e))
    s = eng.layout.from_expanded(torch.from_numpy(e))
    s_ref = ref_eng.run(s_ref, 4)
    s = eng.run(s, 4)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    for kind in ("cuda-3d", "cuda-3d-mxu"):
        e2 = make_engine(kind, tf3.MENGER, r, m, workload=wl, device="cpu")
        np.testing.assert_array_equal(
            e2.run(eng.layout.from_expanded(torch.from_numpy(e)), 4).numpy(),
            s.numpy())


def _single_steps(eng, state, n):
    for _ in range(n):
        state = eng.step(state)
    return state


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("wl_name", WORKLOADS)
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_3d_step_k_matches_single_steps(case, wl_name, kind):
    name, r, m = case
    wl = _pair(wl_name)[1]
    frac = tf3.REGISTRY3D[name]
    blk = make_engine("block3d", frac, r, m, workload=wl, device="cpu")
    eng = make_engine(kind, frac, r, m, workload=wl, device="cpu")
    s = blk.layout.from_expanded(torch.from_numpy(_expanded(name, r,
                                                            wl_name, 1)))
    for k in sorted({1, 2, blk.layout.rho}):
        np.testing.assert_allclose(
            eng.step_k(s, k).numpy(), _single_steps(blk, s, k).numpy(),
            **_tol(wl), err_msg=f"{kind} k={k}")


def test_3d_step_k_beyond_rho_multi_ring():
    """k > rho spans two block rings: the offset tables resolve blocks
    beyond holes exactly."""
    frac, r, m = tf3.SIERPINSKI3D, 4, 1  # rho = 2
    eng = make_engine("block3d", frac, r, m, workload=trules.LIFE3D,
                      device="cpu")
    s = eng.init_random(seed=8)
    k = eng.layout.rho + 1
    assert eng.layout.halo_block_radius(k) == 2
    np.testing.assert_array_equal(eng.step_k(s, k).numpy(),
                                  _single_steps(eng, s, k).numpy())


@pytest.mark.parametrize("kind", BLOCK_KINDS)
@pytest.mark.parametrize("k,steps", [(2, 5), (3, 4)])
def test_3d_fused_run_remainder_path(kind, k, steps):
    eng = make_engine(kind, tf3.MENGER, 2, 1, workload=trules.HEAT3D,
                      fusion_k=k, device="cpu")
    assert eng.effective_fusion_k == k
    s = eng.init_random(seed=9)
    np.testing.assert_allclose(eng.run(s, steps).numpy(),
                               _single_steps(eng, s, steps).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_3d_kernel_engine_batches_and_keeps_its_input():
    eng = make_engine("cuda-3d", tf3.MENGER, 2, 1, workload=trules.LIFE3D,
                      device="cpu")
    x = torch.stack([eng.init_random(i) for i in range(3)])
    before = x.clone()
    got = eng.run(x, 4)
    assert torch.equal(x, before)
    for b in range(3):
        assert torch.equal(got[b], eng.run(x[b], 4))


# ------------------------------------------------------- rejections
def test_3d_kernels_reject_k_beyond_rho_and_wrong_workloads():
    lay = BlockLayout3D(tf3.SIERPINSKI3D, 4, 1)  # rho = 2
    s = torch.zeros((lay.n_blocks, 2, 2, 2), dtype=torch.uint8)
    for fn in (k3.stencil3d_step_fused_k, k3.stencil3d_step_mxu_k):
        with pytest.raises(ValueError, match="k <= rho"):
            fn(lay, s, trules.LIFE3D, k=3)
        with pytest.raises(ValueError, match="does not match"):
            fn(lay, s[:, :1], trules.LIFE3D, k=1)
        with pytest.raises(ValueError, match="single-channel"):
            fn(lay, s, trules.GRAY_SCOTT, k=1)
        with pytest.raises(ValueError, match="2D-only"):
            fn(lay, s, trules.HEAT, k=1)
    with pytest.raises(ValueError, match="fusion_k"):
        make_engine("cuda-3d", tf3.SIERPINSKI3D, 4, 1,
                    workload=trules.LIFE3D, fusion_k=3, device="cpu")
    with pytest.raises(ValueError, match="macro_p"):
        Squeeze3DKernelEngine(lay, trules.LIFE3D, variant="fused", macro_p=2,
                              device="cpu")
    with pytest.raises(ValueError, match="single-channel"):
        make_engine("cell3d", tf3.SIERPINSKI3D, 3, workload=trules.GRAY_SCOTT,
                    device="cpu")
    with pytest.raises(ValueError, match="2D-only"):
        make_engine("block3d", tf3.SIERPINSKI3D, 3, 1, workload=trules.HEAT,
                    device="cpu")


def test_3d_window_over_shared_memory_is_refused_before_any_launch():
    """HEAT3D at rho = 27, k = 2: 2 x 31^3 f32 cells exceed one CTA's
    232,448 bytes, so both wrappers take the device-workspace variant in
    place of refusing (the shape the reference's pallas-3d kinds accept);
    windows that fit keep shared memory, and k > rho is still refused
    before anything is built."""
    assert k3.smem_bytes(1, 31, 0, 4) > 232448
    assert k3.smem_bytes(1, 15, 0, 4) < 32 * 1024   # rho=9, k=3: ~30 KB
    assert k3.smem_bytes(1, 15, 0, 1) < 11 * 1024   # LIFE3D: ~10 KB
    lay = BlockLayout3D(tf3.MENGER, 3, 3)  # rho = 27, one block
    small = BlockLayout3D(tf3.MENGER, 3, 2)  # rho = 9
    for kernel in ("fused", "mxu"):
        assert k3.window_variant(lay, trules.HEAT3D, 2, kernel) == "global"
        assert k3.window_variant(lay, trules.LIFE3D, 27, kernel) == "global"
        assert k3.window_variant(lay, trules.LIFE3D, 1, kernel) == "shared"
        assert k3.window_variant(small, trules.HEAT3D, 3, kernel) == \
            "shared"
        with pytest.raises(ValueError, match="k <= rho"):
            k3.window_variant(lay, trules.LIFE3D, 28, kernel)
    meta = torch.empty((1, 27, 27, 27), dtype=torch.float32, device="meta")
    with mock.patch.object(build, "load_library",
                           side_effect=AssertionError("built")):
        for fn in (k3.stencil3d_step_fused_k, k3.stencil3d_step_mxu_k):
            with pytest.raises(ValueError, match="k <= rho"):
                fn(lay, meta, trules.HEAT3D, k=28)
    # past the plan, the meta tensor is refused only as not CUDA
    with mock.patch.object(build, "load_library",
                           return_value=mock.MagicMock()):
        for fn in (k3.stencil3d_step_fused_k, k3.stencil3d_step_mxu_k):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                fn(lay, meta, trules.HEAT3D, k=2)


@pytest.mark.parametrize("kernel", ["fused", "mxu"])
def test_3d_wrapper_raises_when_the_build_fails(kernel):
    """A tensor off the CPU goes to the kernel: a failed build raises, the
    plain version is never called and nothing is counted."""
    lay = BlockLayout3D(tf3.MENGER, 2, 1)
    meta = torch.empty((lay.n_blocks, 3, 3, 3), dtype=torch.uint8,
                       device="meta")
    fn = getattr(k3, f"stencil3d_step_{kernel}_k")
    before = dict(k3.LAUNCHES)
    boom = build.KernelBuildError("nvcc failed")
    with mock.patch.object(build, "load_library", side_effect=boom), \
            mock.patch.object(k3, f"stencil3d_step_{kernel}_k_plain",
                              side_effect=AssertionError("fell back")):
        with pytest.raises(build.KernelBuildError, match="nvcc failed"):
            fn(lay, meta, trules.LIFE3D, k=1)
    with mock.patch.object(build, "load_library",
                           return_value=mock.MagicMock()):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            fn(lay, meta, trules.LIFE3D, k=1)
    assert k3.LAUNCHES == before


# ------------------------------------------------------------ runner
def test_runner_dispatches_3d_states():
    frac, r, m = tf3.SIERPINSKI3D, 4, 1
    runner = BatchedRunner(device="cpu")
    states = runner.init_batch("block3d", frac, r, seeds=range(3), m=m,
                               workload=trules.LIFE3D)
    assert states.shape == (3, frac.volume(r - m), 2, 2, 2)
    eng = runner.engine_for("block3d", frac, r, m=m, workload=trules.LIFE3D,
                            k=2)
    for kind in BLOCK_KINDS:
        ran = runner.run(kind, frac, r, states, steps=5, m=m,
                         workload=trules.LIFE3D, k=2)
        for b in range(3):
            np.testing.assert_array_equal(
                ran[b].numpy(), _single_steps(eng, states[b], 5).numpy(),
                err_msg=f"{kind} batch {b}")
    exp = runner.to_expanded("block3d", frac, r, states, m=m,
                             workload=trules.LIFE3D)
    assert exp.shape == (3,) + (frac.side(r),) * 3
    assert torch.equal(exp[1], eng.to_expanded(states[1]))
    cells = runner.init_batch("cell3d", frac, r, seeds=[0, 1],
                              workload=trules.LIFE3D)
    assert runner.to_expanded("cell3d", frac, r, cells,
                              workload=trules.LIFE3D).shape == \
        (2,) + (frac.side(r),) * 3
    step = runner.step("cuda-3d-mxu", frac, r, states, m=m,
                       workload=trules.LIFE3D)
    assert torch.equal(step, torch.stack([eng.step(s) for s in states]))


def test_runner_3d_cache_key_includes_k(monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    frac, r, m = tf3.SIERPINSKI3D, 4, 1  # rho = 2 -> heuristic k = 2
    runner = BatchedRunner(device="cpu")
    e_default = runner.engine_for("block3d", frac, r, m=m,
                                  workload=trules.LIFE3D)
    assert runner.engine_for("block3d", frac, r, m=m, workload=trules.LIFE3D,
                             k=2) is e_default
    assert runner.stats.builds == 1
    e3 = runner.engine_for("block3d", frac, r, m=m, workload=trules.LIFE3D,
                           k=3)
    assert e3 is not e_default and e3.fusion_k == 3
    runner.engine_for("cell3d", frac, r, workload=trules.LIFE3D)
    runner.engine_for("cell3d", frac, r, workload=trules.LIFE3D, k=5)
    assert runner.stats.builds == 3


def test_3d_kinds_and_specs(monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    for kind in KINDS3D:
        assert kind in REFERENCE_KINDS
    assert REFERENCE_KINDS["cuda-3d"] == "pallas-3d"
    assert REFERENCE_KINDS["cuda-3d-mxu"] == "pallas-3d-mxu"
    spec = EngineSpec.from_args("cuda-3d-mxu", tf3.MENGER, 4, 2,
                                trules.HEAT3D)
    norm = spec.normalize()
    assert (norm.frac, norm.workload, norm.fusion_k, norm.macro_p) == \
        ("menger", "heat3d", 3, 1)
    assert norm.build_frac() is tf3.MENGER
    assert norm.build_workload() is trules.HEAT3D
    custom = tf3.NBBFractal3D("corner", 2, ((0, 0, 0), (1, 1, 1)))
    cspec = EngineSpec.from_args("block3d", custom, 3, 1, trules.LIFE3D)
    assert cspec.build_frac().positions == custom.positions
    eng = make_engine(cspec, device="cpu")
    assert eng.layout.n_blocks == 4


# ------------------------------------- plain kernels against Pallas
def test_fused_plain_matches_reference_pallas_3d():
    name, r, m = "menger", 2, 1
    ref_lay, lay = _layouts(name, r, m)
    ref_wl, wl = _pair("life3d")
    x = lay.from_expanded(torch.from_numpy(_expanded(name, r, "life3d", 4)))
    want = rk3.stencil3d_step_fused_k(ref_lay, jnp.asarray(x.numpy()),
                                      ref_wl, k=2, interpret=True)
    got = k3.stencil3d_step_fused_k(lay, x, wl, k=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mxu_plain_matches_reference_pallas_3d():
    name, r, m = "menger", 2, 1
    ref_lay, lay = _layouts(name, r, m)
    ref_wl, wl = _pair("heat3d")
    x = lay.from_expanded(torch.from_numpy(_expanded(name, r, "heat3d", 4)))
    want = rk3.stencil3d_step_mxu_k(ref_lay, jnp.asarray(x.numpy()), ref_wl,
                                    k=2, interpret=True)
    got = k3.stencil3d_step_mxu_k(lay, x, wl, k=2, p=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
