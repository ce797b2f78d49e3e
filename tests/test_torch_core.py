"""The port's fractals, lambda/nu maps and block tables against the JAX
reference: bit-exact over the full domain at small r."""
import functools

import numpy as np
import pytest
import torch

import jax

from repro.core import compact as rc
from repro.core import fractals as rf
from repro.core import maps as rm
from repro_torch.core import compact as tc
from repro_torch.core import fractals as tf
from repro_torch.core import maps as tm

FRACS = ["sierpinski", "carpet", "vicsek"]
LEVEL = {"sierpinski": 5, "carpet": 3, "vicsek": 3}
CASES = [("sierpinski", 5, 2), ("carpet", 3, 1), ("vicsek", 3, 1)]
CASE_IDS = [f"{f}-r{r}-m{m}" for f, r, m in CASES]


@functools.lru_cache(maxsize=None)
def _layouts(name, r, m):
    """(reference, port) layouts, shared by the tests so each host table
    is built once per process."""
    return (rc.BlockLayout(rf.REGISTRY[name], r, m),
            tc.BlockLayout(tf.REGISTRY[name], r, m))


@functools.lru_cache(maxsize=None)
def _ref_maps(name):
    """The reference maps over the full domains of one fractal."""
    rfr, r = rf.REGISTRY[name], LEVEL[name]
    rows, cols = rfr.compact_dims(r)
    cy, cx = np.meshgrid(np.arange(rows, dtype=np.int32),
                         np.arange(cols, dtype=np.int32), indexing="ij")
    n = rfr.side(r)
    gy, gx = np.meshgrid(np.arange(-1, n + 1, dtype=np.int32),
                         np.arange(-1, n + 1, dtype=np.int32), indexing="ij")
    inb = np.clip(gx, 0, n - 1), np.clip(gy, 0, n - 1)

    @jax.jit
    def run(cx, cy, gx, gy, ix, iy):
        return (rm.lambda_map(rfr, r, cx, cy),
                rm.nu_with_membership(rfr, r, gx, gy),
                rm.is_fractal(rfr, r, gx, gy), rm.nu_map(rfr, r, ix, iy))
    lam, nuw, isf, nu = run(cx, cy, gx, gy, *inb)
    return dict(c=(cx, cy), g=(gx, gy), inb=inb, lam=lam, nuw=nuw,
                isf=isf, nu=nu)


def _eq(a, b, msg=""):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("name", sorted(rf.REGISTRY))
def test_fractal_registry_matches(name):
    ref, port = rf.REGISTRY[name], tf.REGISTRY[name]
    assert (port.s, port.positions, port.k) == (ref.s, ref.positions, ref.k)
    _eq(port.h_lambda, ref.h_lambda)
    _eq(port.h_nu, ref.h_nu)
    for r in range(4):
        _eq(port.mask(r), ref.mask(r))
        assert port.compact_dims(r) == ref.compact_dims(r)
        assert port.mrf(r) == ref.mrf(r)


@pytest.mark.parametrize("name", FRACS)
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_maps_match_over_full_domain(name, kind):
    """lambda over the whole compact grid; nu, membership and the fused
    form over the expanded grid plus a one-cell out-of-bounds ring."""
    tfr, r, ref = tf.REGISTRY[name], LEVEL[name], _ref_maps(name)
    conv = torch.from_numpy if kind == "torch" else (lambda a: a)
    for a, b in zip(tm.lambda_map(tfr, r, *map(conv, ref["c"])),
                    ref["lam"]):
        _eq(a, b)
    for a, b in zip(tm.nu_with_membership(tfr, r, *map(conv, ref["g"])),
                    ref["nuw"]):
        _eq(a, b)
    _eq(tm.is_fractal(tfr, r, *map(conv, ref["g"])), ref["isf"])
    for a, b in zip(tm.nu_map(tfr, r, *map(conv, ref["inb"])), ref["nu"]):
        _eq(a, b)


@pytest.mark.parametrize("name", FRACS)
def test_scalar_maps_and_weight_matrices_match(name):
    rfr, tfr, r = rf.REGISTRY[name], tf.REGISTRY[name], LEVEL[name]
    rng = np.random.default_rng(0)
    rows, cols = rfr.compact_dims(r)
    n = rfr.side(r)
    for _ in range(50):
        cx, cy = int(rng.integers(cols)), int(rng.integers(rows))
        assert tm.lambda_map_scalar(tfr, r, cx, cy) == \
            rm.lambda_map_scalar(rfr, r, cx, cy)
        ex, ey = (int(v) for v in rng.integers(-1, n + 1, 2))
        assert tm.is_fractal_scalar(tfr, r, ex, ey) == \
            rm.is_fractal_scalar(rfr, r, ex, ey)
        if 0 <= ex < n and 0 <= ey < n:
            assert tm.nu_map_scalar(tfr, r, ex, ey) == \
                rm.nu_map_scalar(rfr, r, ex, ey)
    _eq(tm.nu_weight_matrix(tfr, r), rm.nu_weight_matrix(rfr, r))
    _eq(tm.lambda_weight_matrix(tfr, r), rm.lambda_weight_matrix(rfr, r))


@pytest.mark.parametrize("name,r,m", CASES, ids=CASE_IDS)
def test_block_tables_match(name, r, m):
    ref, port = _layouts(name, r, m)
    assert (port.rho, port.r_b, port.block_dims, port.n_blocks,
            port.ghost) == (ref.rho, ref.r_b, ref.block_dims,
                            ref.n_blocks, ref.ghost)
    _eq(port.micro_mask, ref.micro_mask)
    for a, b in zip(port.block_coords, ref.block_coords):
        _eq(a, b)
    _eq(port.block_origin_expanded, ref.block_origin_expanded)
    _eq(port.neighbor_table, ref.neighbor_table)
    _eq(port.existence_table, ref.existence_table)
    assert port.memory_bytes(4) == ref.memory_bytes(4)


@pytest.mark.parametrize("name,r,m", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_depth_k_tables_match(name, r, m, k):
    """Depth-k geometry, including k > rho (multi-ring offset tables)."""
    ref, port = _layouts(name, r, m)
    assert port.halo_offsets(k) == ref.halo_offsets(k)
    assert port.halo_block_radius(k) == ref.halo_block_radius(k)
    _eq(port.window_mask(k), ref.window_mask(k))
    _eq(port.offset_table(k), ref.offset_table(k))
    _eq(port.halo_mask(k), ref.halo_mask(k))
    assert tc.halo_regions(port.rho, k) == rc.halo_regions(ref.rho, k)
    for p in (1, 2, 5, 10 ** 6):
        assert port.macro_tiles(k, p=p) == ref.macro_tiles(k, p=p)
        _eq(port.existence_padded(k, p=p), ref.existence_padded(k, p=p))


def test_conversions_and_halo_pads_match():
    ref, port = _layouts("sierpinski", 5, 2)
    rng = np.random.default_rng(1)
    s = (rng.integers(0, 9, (2, port.n_blocks, port.rho, port.rho))
         .astype(np.float32) * port.micro_mask)
    rows, cols = tf.SIERPINSKI.compact_dims(5)
    c = rng.integers(0, 5, (2, rows, cols)).astype(np.uint8)
    ref.materialize()

    @jax.jit
    def run(js, c):
        e = ref.to_expanded(js)
        return (e, ref.from_expanded(e), ref.pad_with_halo(js[0]),
                ref.pad_with_halo_k(js[1], 2),
                rc.compact_to_expanded(rf.SIERPINSKI, 5, c))
    want = run(s, c)
    ts = torch.from_numpy(s)
    e = port.to_expanded(ts)
    ce = tc.compact_to_expanded(tf.SIERPINSKI, 5, torch.from_numpy(c))
    got = (e, port.from_expanded(e), port.pad_with_halo(ts[0]),
           port.pad_with_halo_k(ts, 2)[1], ce)
    for a, b in zip(got, want):
        _eq(a, b)
    _eq(tc.expanded_to_compact(tf.SIERPINSKI, 5, ce), c)


@pytest.mark.parametrize("name,r,m", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("k", [1, 2, 5])
def test_halo_pads_match_expanded_windows(name, r, m, k):
    """pad_with_halo_k equals the depth-k window around each block cut
    from the zero-padded expanded state, at every depth (k > rho too)."""
    _, port = _layouts(name, r, m)
    rho, w = port.rho, port.rho + 2 * k
    rng = np.random.default_rng(2)
    s = torch.from_numpy(
        rng.integers(1, 9, (port.n_blocks, rho, rho)).astype(np.int32)
        * port.micro_mask)
    state_pad = np.pad(port.to_expanded(s).numpy(), k)
    padded = port.pad_with_halo_k(s, k).numpy()
    for b, (ox, oy) in enumerate(port.block_origin_expanded):
        _eq(padded[b], state_pad[oy:oy + w, ox:ox + w], f"block {b}")


def test_default_packing_is_chosen_for_the_card():
    """The default v5 packing fills MXU_CELLS_PER_CTA window cells (not
    128 TPU lanes) and rebalances to the fewest padding slots."""
    lay = tc.BlockLayout(tf.SIERPINSKI, 7, 2)        # 243 blocks, rho 4
    p, n_macro, nb_pad = lay.macro_tiles(2)           # w = 8
    assert n_macro == -(-243 // (tc.MXU_CELLS_PER_CTA // 64))
    assert p * n_macro == nb_pad >= 243 and nb_pad - 243 < n_macro


@pytest.mark.parametrize("rho,m,paper", [(1, 0, 99.8), (2, 1, 74.8),
                                         (4, 2, 56.1), (8, 3, 42.1),
                                         (16, 4, 31.6), (32, 5, 23.7)])
def test_table2_memory_reduction(rho, m, paper):
    """Paper Table 2 at r=16: BB bytes over block-level Squeeze bytes
    (analytic, no tables are built)."""
    frac = tf.SIERPINSKI
    bb = frac.side(16) ** 2
    sq = tc.BlockLayout(frac, 16, m).memory_bytes() if m \
        else frac.volume(16)
    assert abs(bb / sq - paper) / paper < 0.02
