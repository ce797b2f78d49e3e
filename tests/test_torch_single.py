"""The geometry of v1, v2 and v3 (``stencil_step_blocks``,
``stencil_step_strips``, ``stencil_step_fused``) and the strip gather's
wrapper: ``step_plan`` and, for v3 (v4 at k = 1), ``fused_plan``, which pick
the body and its launch shape, for every shipped fractal's block side,
dtype and channel count; the C entries' arguments against the source; and
a numpy emulation of the warp body's three one-step stagings (the staged
region of a group, each lane's offset per row), which must rebuild every
window ``pad_with_halo`` builds.
Pure and cheap; the kernels themselves are held against their plain
versions on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import fractals as tf
from repro_torch.core.compact import BlockLayout
from repro_torch.kernels import build
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.workloads import rules as trules

#: every block side rho = s^m of the registry's fractals at m = 1..3
RHOS = sorted({f.s ** m for f in tf.REGISTRY.values() for m in (1, 2, 3)})
SOURCE = Path(sk.__file__).parent / "csrc" / "squeeze_stencil.cu"


def _round16(n):
    return -(-n // 16) * 16


def _region(strips, g, rho, esize):
    """Elements of one channel's staged region (``region_elems`` in the
    source): v1 G centers and 8 G whole neighbor blocks, v2 G centers,
    then from the next 16 bytes G strips of 4 (rho + 2)."""
    if strips:
        return _round16(g * rho * rho * esize) // esize + 4 * g * (rho + 2)
    return 9 * g * rho * rho


@pytest.mark.parametrize("strips", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("rho", RHOS)
def test_step_plan_every_rho_and_channel_count(rho, strips):
    """W >= w = rho + 2, 32 / W windows a warp, each channel's region and
    16 zero bytes a warp, the most warps that fit a CTA."""
    w = rho + 2
    for dtype in (torch.uint8, torch.float32):
        esize = torch.empty((), dtype=dtype).element_size()
        for nc in (1, 2, 3):
            plan = sk.step_plan(dtype, nc, rho, strips)
            assert plan.body == ""
            assert plan.W in (8, 16, 32) and plan.W >= w
            assert plan.W == 8 or plan.W // 2 < w
            assert plan.windows == 32 // plan.W
            per_warp = nc * (_round16(_region(strips, plan.windows, rho,
                                              esize) * esize) + 16)
            assert plan.smem == plan.warps * per_warp <= build.MAX_SMEM
            assert 1 <= plan.warps <= 8
            assert plan.warps == 8 or \
                (plan.warps + 1) * per_warp > build.MAX_SMEM


@pytest.mark.parametrize("dtype,nc,rho,strips,rule_form,want", [
    # the main path: LIFE at rho = 4 (w = 6), HEAT, GRAY_SCOTT
    (torch.uint8, 1, 4, False, True, (8, 4, 8, 4736, "")),
    (torch.uint8, 1, 4, True, True, (8, 4, 8, 1408, "")),
    (torch.float32, 1, 4, True, True, (8, 4, 8, 5248, "")),
    (torch.float32, 2, 4, False, True, (8, 4, 8, 37120, "")),
    # rho = 3: 36 bytes of centers, then 16-byte aligned strips
    (torch.uint8, 1, 3, True, True, (8, 4, 8, 1152, "")),
    # rho = 9 (w = 11) and rho = 27 (w = 29: one window a warp; four warps
    # where eight do not fit)
    (torch.uint8, 1, 9, False, True, (16, 2, 8, 11904, "")),
    (torch.float32, 2, 27, False, True, (32, 1, 4, 210176, "")),
    (torch.uint8, 1, 27, True, True, (32, 1, 8, 7040, "")),
    # other weights: the CTA body, v1's nine blocks in its shared memory
    (torch.uint8, 1, 4, False, False, (0, 28, 8, 7092, "[wide]")),
    (torch.uint8, 1, 4, True, False, (0, 28, 8, 3060, "[wide]")),
    # a window over 32 cells (rho = 31): the CTA body
    (torch.uint8, 1, 31, False, True, (0, 1, 8, 11957, "[wide]")),
    (torch.float32, 2, 31, True, True, (0, 1, 8, 18549, "[wide]")),
])
def test_step_plan_by_shape(dtype, nc, rho, strips, rule_form, want):
    assert tuple(sk.step_plan(dtype, nc, rho, strips, rule_form)) == want


@dataclasses.dataclass(frozen=True)
class _OrthCA(trules.TotalisticCA):
    """Life's rule over the 4 orthogonal neighbors: ring weights (0, 1)."""
    name: str = "orth-life"

    def weight(self, offset):
        return 1 if sum(abs(d) for d in offset) == 1 else 0


@pytest.mark.parametrize("strips", [False, True], ids=["v1", "v2"])
def test_step_plan_for_other_weights_is_the_cta_body(strips):
    """The wrapper's plan: the warp body for the shipped workloads, the CTA
    body where the ring weights are not the rule's own."""
    lay = BlockLayout(tf.SIERPINSKI, 4, 2)
    x = torch.zeros((2, lay.n_blocks, 4, 4), dtype=torch.uint8)
    assert sk._step_plan_for(lay, x, trules.LIFE, strips).body == ""
    assert sk._step_plan_for(lay, x, _OrthCA(), strips).body == "[wide]"
    g = torch.zeros((2, 2, lay.n_blocks, 4, 4))
    assert sk._step_plan_for(lay, g, trules.GRAY_SCOTT, strips).W == 8


@pytest.mark.parametrize("rho", RHOS)
def test_v3_plan_is_v4_at_k1_for_every_rho_and_channel_count(rho):
    """v3 takes ``fused_plan`` at k = 1: the warp body (w = rho + 2 <= 32
    for every shipped rho) with v1's staging region, so v1's plan."""
    for dtype in (torch.uint8, torch.float32):
        for nc in (1, 2, 3):
            plan = sk.fused_plan(dtype, nc, rho, 1)
            assert plan.body == "" and plan.W >= rho + 2
            assert plan == sk.step_plan(dtype, nc, rho)


@pytest.mark.parametrize("dtype,nc,rho,rule_form,want", [
    # the main path: LIFE and HEAT at rho = 4 (w = 6), GRAY_SCOTT
    (torch.uint8, 1, 4, True, (8, 4, 8, 4736, "")),
    (torch.float32, 1, 4, True, (8, 4, 8, 18560, "")),
    (torch.float32, 2, 4, True, (8, 4, 8, 37120, "")),
    # rho = 3 (9-byte blocks), rho = 9 (W = 16), rho = 27 (W = 32)
    (torch.uint8, 1, 3, True, (8, 4, 8, 2816, "")),
    (torch.uint8, 1, 9, True, (16, 2, 8, 11904, "")),
    (torch.float32, 2, 27, True, (32, 1, 4, 210176, "")),
    # other weights and a window over 32 cells: the CTA body, no blocks of
    # v1's in its shared memory
    (torch.uint8, 1, 4, False, (0, 28, 8, 3060, "[wide]")),
    (torch.uint8, 1, 31, True, (0, 1, 8, 3317, "[wide]")),
    (torch.float32, 2, 31, True, (0, 1, 8, 18549, "[wide]")),
])
def test_v3_plan_by_shape(dtype, nc, rho, rule_form, want):
    assert tuple(sk.fused_plan(dtype, nc, rho, 1, False, rule_form)) == want


def test_v3_plan_for_other_weights_is_the_cta_body():
    lay = BlockLayout(tf.SIERPINSKI, 4, 2)
    x = torch.zeros((2, lay.n_blocks, 4, 4), dtype=torch.uint8)
    assert sk._fused_plan_for(lay, x, trules.LIFE, 1, False).body == ""
    assert sk._fused_plan_for(lay, x, _OrthCA(), 1, False).body == "[wide]"


def test_single_step_launch_names_are_registered():
    for name in ("stencil_step_blocks", "stencil_step_strips",
                 "stencil_step_fused"):
        for body in ("", "[wide]"):
            assert name + body in sk.LAUNCHES
    assert "gather_halo_strips" in sk.LAUNCHES


def test_single_step_entries_match_the_source():
    """v1 and v2 take step_plan's W and warps after rho, v3 fused_plan's;
    the gather entry takes as many arguments as its signature passes; the
    CTA body's limits are the source's; v3 runs v4's entry at k = 1."""
    text = SOURCE.read_text()
    for name in ("sq_stencil_step_blocks", "sq_stencil_step_strips",
                 "sq_stencil_step_fused", "sq_gather_halo_strips"):
        params = re.search(rf"int {name}\((.*?)\)", text, re.S).group(1)
        assert len(params.split(",")) == len(sk._SIGNATURES[name]), name
    v3 = re.search(r"int sq_stencil_step_fused\(.*?\{(.*?)\n\}", text,
                   re.S).group(1)
    assert "fused_entry<kInKernel>(" in v3
    assert "rho, 1, W, warps" in " ".join(v3.split())
    for name in ("sq_stencil_step_blocks", "sq_stencil_step_strips",
                 "sq_stencil_step_fused"):
        params = re.search(rf"int {name}\((.*?)\)", text, re.S).group(1)
        assert "int rho, int W, int warps," in " ".join(params.split())
    strips_at = re.search(r"int strips_at\(int G, int rho, int sz\) \{\s*"
                          r"return (.*?);", text).group(1)
    assert strips_at == "((G * rho * rho * sz + 15) & ~15) / sz"


# ---------------------------------------------------------------------------
# a numpy emulation of the warp body's v1 and v2 staging
# ---------------------------------------------------------------------------
def _lane_offset(strips, q, x, y, rho, g, zero, esize):
    """The staged element lane (q, x) reads for row y (``off[y]`` in
    ``warp_kernel`` at k = 1)."""
    w, rho2 = rho + 2, rho * rho
    if x >= w or y >= w:
        return zero
    ry = 0 if y < 1 else (1 if y < 1 + rho else 2)
    rx = 0 if x < 1 else (1 if x < 1 + rho else 2)
    if strips:
        st = _round16(g * rho2 * esize) // esize + q * 4 * w
        if ry == 0:
            return st + x
        if ry == 2:
            return st + w + x
        if rx == 0:
            return st + 2 * w + y - 1
        if rx == 2:
            return st + 3 * w + y - 1
        return q * rho2 + (y - 1) * rho + x - 1
    raster = ry * 3 + rx
    d = raster if raster < 4 else raster - 1
    blk = q if raster == 4 else g + 8 * q + d
    return blk * rho2 + (y - 1 - (ry - 1) * rho) * rho + \
        (x - 1 - (rx - 1) * rho)


def _rows_staged(d, rho, esize):
    """[olo, ohi): the elements v3 stages of its direction-d neighbor, the
    loads (as wide as rho^2 elements allow, 16 bytes at most) that hold
    the row or column its window reads, as ``warp_kernel`` computes them
    at k = 1."""
    vin = next((v for v in (16, 8, 4) if rho * rho * esize % v == 0), esize)
    per = vin // esize
    olo = (rho - 1) * rho // per * per if d < 3 else 0
    ohi = -(-rho // per) * per if d > 4 else rho * rho
    return olo, ohi


def _emulated_windows(lay, x, staging):
    """(nb, W, W): each group's staged region as ``issue_group`` fills it
    (v1 "blocks", v2 "strips" or v3 "rows"; past the group's blocks, a
    ghost neighbor, and the rows v3 does not load, zeros), each window
    read by its lanes through ``_lane_offset``."""
    rho, nb, rho2 = lay.rho, lay.n_blocks, lay.rho ** 2
    esize, strips = x.dtype.itemsize, staging == "strips"
    plan = sk.step_plan(torch.from_numpy(x[:0]).dtype, 1, rho, strips)
    big_w, g = plan.W, plan.windows
    zero = _round16(_region(strips, g, rho, esize) * esize) // esize
    table = lay.neighbor_table
    st = sk.gather_halo_strips_plain(lay, torch.from_numpy(x)).numpy()
    out = np.zeros((nb, big_w, big_w), x.dtype)
    for blk0 in range(0, nb, g):
        nv = min(g, nb - blk0)
        buf = np.zeros(zero + 16 // esize, x.dtype)
        buf[:nv * rho2] = x[blk0:blk0 + nv].ravel()
        if strips:
            sat = _round16(g * rho2 * esize) // esize
            buf[sat:sat + nv * 4 * (rho + 2)] = st[blk0:blk0 + nv].ravel()
        else:
            for q in range(nv):
                for d in range(8):
                    i = table[blk0 + q, d]
                    if i < nb:
                        lo, hi = _rows_staged(d, rho, esize) \
                            if staging == "rows" else (0, rho2)
                        s = (g + 8 * q + d) * rho2
                        buf[s + lo:s + hi] = x[i].ravel()[lo:hi]
        for q in range(nv):
            for yy in range(big_w):
                for xx in range(big_w):
                    out[blk0 + q, yy, xx] = buf[_lane_offset(
                        strips, q, xx, yy, rho, g, zero, esize)]
    return out


@pytest.mark.parametrize("staging", ["blocks", "strips", "rows"],
                         ids=["v1", "v2", "v3"])
@pytest.mark.parametrize("case,dtype", [
    ((tf.SIERPINSKI, 4, 2), np.uint8), ((tf.VICSEK, 3, 1), np.uint8),
    ((tf.CARPET, 3, 2), np.float32), ((tf.SIERPINSKI, 5, 3), np.uint8)],
    ids=["rho4", "rho3", "rho9-f32", "rho8"])
def test_emulated_staging_rebuilds_every_window(case, dtype, staging):
    """Every lane's rows, read from the staged region, are the window
    ``pad_with_halo`` builds, and zeros past it (w <= W): v3 loads of each
    neighbor only what its window reads."""
    lay = BlockLayout(*case)
    rng = np.random.default_rng(1)
    x = (rng.random((lay.n_blocks, lay.rho, lay.rho)) * 200 + 1).astype(
        dtype) * lay.micro_mask.astype(dtype)
    got = _emulated_windows(lay, x, staging)
    w = lay.rho + 2
    want = lay.pad_with_halo(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[:, :w, :w], want)
    assert not got[:, w:, :].any() and not got[:, :, w:].any()


# ---------------------------------------------------------------------------
# the strip gather
# ---------------------------------------------------------------------------
def _emulated_gather(lay, x, bits):
    """(rows, nb, 4, w) as ``gather_kernel`` writes them: direction d
    (MOORE_DIRS order) read where bit d of ``bits`` is set and its
    neighbor is no ghost, else zeros."""
    rho, nb, w = lay.rho, lay.n_blocks, lay.rho + 2
    table = lay.neighbor_table
    out = np.zeros(x.shape[:-2] + (4, w), x.dtype)
    for blk in range(nb):
        def at(d, y, xx):
            i = table[blk, d]
            on = (bits >> d) & 1 and i < nb
            return x[:, i, y, xx] if on else 0
        o = out[:, blk]
        o[:, 0, 0] = at(0, rho - 1, rho - 1)
        o[:, 0, rho + 1] = at(2, rho - 1, 0)
        o[:, 1, 0] = at(5, 0, rho - 1)
        o[:, 1, rho + 1] = at(7, 0, 0)
        for j in range(rho):
            o[:, 0, 1 + j] = at(1, rho - 1, j)
            o[:, 1, 1 + j] = at(6, 0, j)
            o[:, 2, j] = at(3, j, rho - 1)
            o[:, 3, j] = at(4, j, 0)
    return out


@pytest.mark.parametrize("wl_name", ["life", "heat", "orth", "random"])
def test_emulated_gather_matches_the_plain_version(wl_name):
    """The kernel's layout and its ``needs`` bits (``_NEED_OF_DIR``): a
    workload's ``halo_needs`` leave the same directions zero as the plain
    version does (HEAT's corners; the orthogonal rule's too)."""
    from repro_torch.workloads.base import halo_needs
    needs = {"life": halo_needs(trules.LIFE.weights2d),
             "heat": halo_needs(trules.HEAT.weights2d),
             "orth": halo_needs(_OrthCA().weights2d),
             "random": (True, False, False, True, True, False, True,
                        False)}[wl_name]
    lay = BlockLayout(tf.VICSEK, 3, 1)
    x = np.random.default_rng(3).integers(
        1, 200, (2, lay.n_blocks, 3, 3)).astype(np.uint8)
    bits = sum(1 << d for d, i in enumerate(sk._NEED_OF_DIR) if needs[i])
    np.testing.assert_array_equal(
        _emulated_gather(lay, x, bits),
        sk.gather_halo_strips_plain(lay, torch.from_numpy(x), needs).numpy())


def test_gather_on_the_cpu_is_the_plain_version():
    lay = BlockLayout(tf.CARPET, 3, 1)
    x = torch.from_numpy(np.random.default_rng(2).integers(
        0, 2, (2, 1, lay.n_blocks, 3, 3)).astype(np.uint8))
    before = dict(sk.LAUNCHES)
    needs = (True, False) * 4
    assert torch.equal(sk._gather_halo_strips(lay, x, needs),
                       sk.gather_halo_strips_plain(lay, x, needs))
    assert sk.LAUNCHES == before


def test_gather_off_the_cpu_never_falls_back():
    """A tensor off the CPU goes to the kernel: a failed build raises, and
    a device that is not CUDA is refused, neither launching nor calling
    the plain version."""
    lay = BlockLayout(tf.SIERPINSKI, 4, 2)
    meta = torch.empty((1, 1, lay.n_blocks, 4, 4), dtype=torch.uint8,
                       device="meta")
    before = dict(sk.LAUNCHES)
    with mock.patch.object(sk, "gather_halo_strips_plain",
                           side_effect=AssertionError("fell back")):
        with mock.patch.object(build, "load_library", side_effect=(
                build.KernelBuildError("nvcc failed"))):
            with pytest.raises(build.KernelBuildError, match="nvcc failed"):
                sk._gather_halo_strips(lay, meta)
        with mock.patch.object(build, "load_library",
                               return_value=mock.MagicMock()):
            with pytest.raises(ValueError, match="CUDA or CPU"):
                sk.gather_halo_strips(lay, meta[0, 0])
    assert sk.LAUNCHES == before
