"""The two 3D kernel bodies on the CPU: their plans (``fused3_plan``,
``mxu3_plan``), numpy emulations of what each body computes, and the
precision of the tensor-core body's TF32 products.

The column body (``column_kernel`` in ``csrc/squeeze_stencil3d.cu``) holds
a window column a thread, its z-cells in registers; the emulation below
follows it column by column: the staged element of each z from the three
blocks that own the column's z regions, the mask bits gated by their
existence, the planes [J0, W - J0) a substep computes in place, the z-sums
(or values) of the rows above and below through a shared plane, x from
the lanes beside (shuffles as shifts, a row's edge lane reading its own),
the rule, the centers. It must equal the plain version bit for bit, as
the kernel must. The tensor-core body (``tc_kernel``) keeps each window
padded to 16^3 in two float32 buffers, a plane's aggregate ``sum_t (R_t
X[z + dz_t]) C_t^T`` over operator groups (the equal dz = -1 and +1 terms
one group on X[z - 1] + X[z + 1]); the emulation runs its substeps with
the products exact, in one TF32 pass (uint8 states) or in 3xTF32
(float32), rounding the operands where the kernel does. Pure numpy and
small shapes (rho <= 9, r <= 4); the kernels themselves are held against
their plain versions on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import fractals3d as tf3
from repro_torch.core.compact3d import BlockLayout3D
from repro_torch.kernels import build
from repro_torch.kernels import squeeze_stencil3d as k3
from repro_torch.workloads import rules as trules
from repro_torch.workloads.base import MOORE3_DIRS, weighted_moore_agg3

#: every block side rho = s^m of the 3D registry's fractals at m = 1..3
RHOS = sorted({f.s ** m for f in tf3.REGISTRY3D.values() for m in (1, 2, 3)})
SOURCE = Path(k3.__file__).parent / "csrc" / "squeeze_stencil3d.cu"
FACES = tuple(float(sum(map(abs, d)) == 1) for d in MOORE3_DIRS)


def test_shipped_3d_block_sides():
    assert RHOS == [2, 3, 4, 8, 9, 27]


# ------------------------------------------------------------------ plans
@pytest.mark.parametrize("rho", RHOS)
def test_fused3_plan_every_k(rho):
    """The column body exactly for windows of w <= 16 (W = 8 and four
    windows a CTA for w <= 8, else W = 16 and one), the CTA body for wider
    ones, its workspace variant where its windows exceed shared memory."""
    for dtype, weights, form in ((torch.uint8, (1,) * 26, "uniform"),
                                 (torch.float32, FACES, "orth")):
        assert k3.weight_form(dtype, weights) == form
        esize = torch.empty((), dtype=dtype).element_size()
        for k in range(1, rho + 1):
            w = rho + 2 * k
            plan = k3.fused3_plan(dtype, rho, k, weights, 1000)
            if w <= 16:
                big_w = 8 if w <= 8 else 16
                assert plan == k3.Fused3Plan(big_w, 256 // big_w ** 2, "")
                continue
            g = max(1, 4096 // w ** 3)
            smem = k3.smem_bytes(g, w, 0, esize)
            assert plan == k3.Fused3Plan(
                0, g, "[wide]" if smem <= build.MAX_SMEM else "[global]")


@pytest.mark.parametrize("dtype,rho,k,want", [
    # the 3D main path: Menger r=6 m=2, rho = 9, k = 3 (w = 15)
    (torch.uint8, 9, 3, (16, 1, "")),
    (torch.float32, 9, 3, (16, 1, "")),
    # w <= 8: four windows of 8 x 8 columns a CTA
    (torch.uint8, 3, 2, (8, 4, "")),
    (torch.float32, 4, 1, (8, 4, "")),
    # w = 16 exactly; then the CTA body (219,617 shared bytes at rho = 27,
    # k = 1; 2 x 31^3 float32 cells past 232,448 at k = 2)
    (torch.uint8, 8, 4, (16, 1, "")),
    (torch.uint8, 9, 4, (0, 1, "[wide]")),
    (torch.float32, 27, 1, (0, 1, "[wide]")),
    (torch.float32, 27, 2, (0, 1, "[global]")),
])
def test_fused3_plan_by_shape(dtype, rho, k, want):
    weights = (1,) * 26 if dtype == torch.uint8 else FACES
    assert tuple(k3.fused3_plan(dtype, rho, k, weights, 1000)) == want


@dataclasses.dataclass(frozen=True)
class _MooreHeat3D(trules.HeatDiffusion):
    """Heat over all 26 neighbors: weights the column body does not take."""
    name: str = "moore-heat3d"
    degree: int = 6

    def weight(self, offset):
        return 1


@dataclasses.dataclass(frozen=True)
class _FaceCA(trules.TotalisticCA):
    """A totalistic rule over the six faces only."""
    name: str = "face-ca"

    def weight(self, offset):
        return 1 if sum(abs(d) for d in offset) == 1 else 0


@dataclasses.dataclass(frozen=True)
class _DownHeat3D(trules.HeatDiffusion):
    """Heat without the z+1 face: three rank-1 terms (dz = -1, two at dz =
    0), no equal pair, so the tensor-core body's groups are the terms."""
    name: str = "down-heat3d"
    degree: int = 6

    def weight(self, offset):
        return 1 if sum(abs(d) for d in offset) == 1 and \
            tuple(offset) != (0, 0, 1) else 0


def test_weight_form_per_workload():
    """One aggregate sum per rule: every shipped 3D workload has its rule's
    form; other weight sets have none and take the CTA body."""
    for wl, form in ((trules.LIFE3D, "uniform"), (trules.LIFE, "uniform"),
                     (trules.HIGHLIFE, "uniform"), (trules.HEAT3D, "orth")):
        assert k3.weight_form(wl.dtype, wl.weights3d) == form, wl.name
    for wl in (_MooreHeat3D(), _FaceCA(), _DownHeat3D()):
        assert k3.weight_form(wl.dtype, wl.weights3d) == "", wl.name
        plan = k3.fused3_plan(wl.dtype, 9, 3, wl.weights3d, 100)
        assert (plan.W, plan.body) == (0, "[wide]")


@pytest.mark.parametrize("rho", RHOS)
def test_mxu3_plan_every_k(rho):
    """The tensor-core body exactly for windows of w <= 16 (one window a
    CTA); the shipped workloads' four terms have the equal dz = -1 / +1
    pair, so three groups."""
    for wl in (trules.LIFE3D, trules.HEAT3D, trules.LIFE):
        for k in range(1, rho + 1):
            w = rho + 2 * k
            _, _, dzs = k3.mxu3_operators(wl, w)
            assert dzs == (-1, 0, 0, 1) and k3.mxu3_symmetric(wl, w)
            plan = k3.mxu3_plan(wl.dtype, rho, k, dzs, True, 5)
            if w <= 16:
                assert plan == k3.Mxu3Plan(16, 1, "")
                continue
            smem = k3.smem_bytes(5, w, 4, wl.dtype.itemsize)
            assert plan == k3.Mxu3Plan(
                0, 5, "[wide]" if smem <= build.MAX_SMEM else "[global]")


def test_mxu3_plan_groups_other_weights():
    """Only terms with the equal dz = -1 / +1 pair run on the tensor cores
    (the pair one group, at most two dz = 0 terms); any other set runs on
    the CTA body, however few its terms."""
    down = _DownHeat3D()
    _, _, dzs = k3.mxu3_operators(down, 15)
    assert dzs == (-1, 0, 0) and not k3.mxu3_symmetric(down, 15)
    assert k3.mxu3_plan(down.dtype, 9, 3, dzs, False, 1) == \
        k3.Mxu3Plan(0, 1, "[wide]")
    moore = _MooreHeat3D()
    _, _, dzs = k3.mxu3_operators(moore, 15)
    assert len(dzs) == 4 and k3.mxu3_symmetric(moore, 15)
    assert k3.mxu3_plan(moore.dtype, 9, 3, dzs, True, 1) == \
        k3.Mxu3Plan(16, 1, "")
    assert k3.mxu3_plan(moore.dtype, 9, 3, dzs, False, 1) == \
        k3.Mxu3Plan(0, 1, "[wide]")
    assert k3.mxu3_plan(moore.dtype, 9, 3, (-1, 0, 0, 0, 1), True, 1) == \
        k3.Mxu3Plan(0, 1, "[wide]")


def test_plans_of_the_layouts():
    """The wrappers' plans on a layout: the CTA body's P from
    ``macro_tiles`` (and ``p``), the result's name by body."""
    lay = BlockLayout3D(tf3.MENGER, 3, 2)   # rho = 9, 20 blocks
    assert k3.fused3_plan_for(lay, trules.LIFE3D, 3).body == ""
    assert k3.fused3_plan_for(lay, trules.LIFE3D, 4).windows == 1
    assert k3.mxu3_plan_for(lay, trules.LIFE3D, 3, p=2).windows == 1
    wide = k3.mxu3_plan_for(lay, trules.HEAT3D, 5, p=2)
    assert (wide.windows, wide.body) == (2, "[wide]")
    for kernel in ("fused", "mxu"):
        for body in ("", "[wide]", "[global]"):
            assert f"stencil3d_step_{kernel}_k{body}" in k3.LAUNCHES


def test_plan_constants_and_signatures_match_the_source():
    """The plans' limits are the source's, and each C entry takes as many
    arguments as its ctypes signature passes (W and the windows a CTA
    after k)."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             text).group(1))
    assert const("kBodyThreads") == k3.BODY_THREADS
    assert const("kGroups") == k3.TC_GROUPS
    assert const("kMaxSmem") == build.MAX_SMEM
    for name, types in k3._SIGNATURES.items():
        params = re.search(rf"int {name}\((.*?)\)", text, re.S).group(1)
        assert len(params.split(",")) == len(types), name
    flat = " ".join(text.split())
    assert "int rho, int k, int W, int G, int born" in flat
    assert "int rho, int k, int P, int W, int born" in flat


# ------------------------------------------------------------- emulations
def _state(lay, wl, batch, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, lay.n_blocks) + (lay.rho,) * 3
    x = rng.integers(0, 2, shape).astype(np.uint8) \
        if wl.dtype == torch.uint8 else rng.random(shape).astype(np.float32)
    return x * lay.micro_mask


def _rule(wl, u, agg, m):
    """The kernels' rule on arrays: the totalistic count's bit by a shift
    that gives 0 past 31 (and for a negative count), Heat in float32."""
    if wl.dtype == torch.uint8:
        sets = np.where(u > 0, wl.survive_mask, wl.born_mask)
        a = agg.astype(np.int64)
        bit = np.where((a >= 0) & (a < 32), sets >> np.clip(a, 0, 31), 0)
        return (bit & m & 1).astype(u.dtype)
    alpha, degree = np.float32(wl.alpha), np.float32(wl.degree)
    nx = u + alpha * (agg - degree * u)
    return nx * np.where(m != 0, np.float32(1), np.float32(0))


def _region(v, k, rho):
    return np.where(v < k, 0, np.where(v < k + rho, 1, 2))


def _direction(rz, ry, rx):
    """MOORE3_DIRS index of a region (26: the center)."""
    raster = (rz * 3 + ry) * 3 + rx
    return np.where(raster < 13, raster, np.where(raster == 13, 26,
                                                  raster - 1))


def emulate_column_body(lay, x, wl, k):
    """The column body's k substeps of every window of one simulation x
    (nb, rho, rho, rho) -> the new centers."""
    rho, nb, w = lay.rho, lay.n_blocks, lay.rho + 2 * k
    big_w = k3.fused3_plan_for(lay, wl, k).W
    rho2, rho3 = rho * rho, rho ** 3
    flat = x.reshape(nb, rho3)
    a_t = np.int32 if wl.dtype == torch.uint8 else np.float32
    ys, xs = np.meshgrid(np.arange(big_w), np.arange(big_w), indexing="ij")
    inside = (ys < w) & (xs < w)
    ry, rx = _region(ys, k, rho), _region(xs, k, rho)
    yx = (ys - k - (ry - 1) * rho) * rho + (xs - k - (rx - 1) * rho)
    nbr = np.concatenate([lay.neighbor_table,
                          np.arange(nb)[:, None]], axis=1)   # 26: self
    ids, base = [], []
    for r in range(3):
        ids.append(nbr[:, _direction(r, ry, rx)])           # (nb, W, W)
        base.append(-(k + (r - 1) * rho) * rho2 + yx)
    ends = (0, k, k + rho, w)
    zbits = [((1 << ends[r + 1]) - 1) & ~((1 << ends[r]) - 1)
             for r in range(3)]
    wm = lay.window_mask(k)
    q = np.zeros((big_w, nb, big_w, big_w), a_t)   # [z, blk, y, x]
    wmc = np.zeros((big_w, big_w), np.int64)
    for z in range(big_w):
        r = 0 if z < k else (1 if z < k + rho else 2)
        ok = inside & (ids[r] < nb) & (z < w)
        at = np.where(ok, ids[r] * rho3 + base[r] + z * rho2, 0)
        q[z] = np.where(ok, flat.reshape(-1)[at], 0)
        if z < w:
            wmc |= np.where(inside, wm[z, np.minimum(ys, w - 1),
                                       np.minimum(xs, w - 1)], 0) \
                .astype(np.int64) << z
    cmask = np.zeros((nb, big_w, big_w), np.int64)
    for r in range(3):
        cmask |= np.where(ids[r] < nb, zbits[r], 0)
    cmask &= wmc
    up = np.maximum(np.arange(big_w) - 1, 0)
    dn = np.minimum(np.arange(big_w) + 1, big_w - 1)
    uniform = k3.weight_form(wl.dtype, wl.weights3d) == "uniform"

    def shfl(v, d):   # the lane x + d of the row, an edge lane its own
        idx = np.clip(np.arange(big_w) + d, 0, big_w - 1)
        return v[..., idx]

    for j in range(1, k + 1):
        j0 = 1 if j == 1 else (2 if big_w == 8 or j == 2 else 3)
        zs = range(j0, big_w - j0)
        plane = {z: ((q[z - 1] + q[z]) + q[z + 1]) if uniform else
                 q[z].copy() for z in zs}
        prev = q[j0 - 1].copy()
        for z in zs:
            old = q[z].copy()
            p_up, p_dn = plane[z][:, up, :], plane[z][:, dn, :]
            if uniform:
                row = (p_up + plane[z]) + p_dn
                agg = ((shfl(row, -1) + row) + shfl(row, 1)) - old
            else:
                agg = np.zeros_like(old)
                for v in (prev, p_up, shfl(old, -1), shfl(old, 1), p_dn,
                          q[z + 1]):
                    agg = agg + v
            q[z] = _rule(wl, old, agg, (cmask >> z) & 1)
            prev = old
    mid = slice(k, k + rho)
    return q[mid].transpose(1, 0, 2, 3)[:, :, mid, mid].astype(x.dtype)


COLUMN_CASES = [(tf3.MENGER, 3, 1), (tf3.MENGER, 3, 2),
                (tf3.SIERPINSKI3D, 5, 2)]


@pytest.mark.parametrize("wl_name", ["life3d", "heat3d", "life"])
@pytest.mark.parametrize("case", COLUMN_CASES, ids=lambda c: f"{c[0].name}"
                         f"{c[1]}-{c[2]}")
def test_column_body_emulation_equals_plain_bit_for_bit(case, wl_name):
    """The column body's dataflow (both W, every k it takes) gives the
    plain version's result bit for bit, HEAT3D's floats too."""
    frac, r, m = case
    lay = BlockLayout3D(frac, r, m)
    wl = trules.get_workload(wl_name)
    x = _state(lay, wl, 1, 3)[0]
    for k in range(1, lay.rho + 1):
        if k3.fused3_plan_for(lay, wl, k).body:
            continue
        want = k3.stencil3d_step_fused_k_plain(lay, torch.from_numpy(x), wl,
                                               k=k).numpy()
        np.testing.assert_array_equal(emulate_column_body(lay, x, wl, k),
                                      want)


def test_column_sums_follow_weighted_moore_agg3():
    """The column body's two sums, in their order, equal the plain
    aggregate bit for bit on float32 windows: the uniform one (z pass from
    the column, y pass over the rows' z-sums, x pass over the lanes'
    y-sums, minus the center) and Heat's six faces from zero."""
    rng = np.random.default_rng(7)
    pad = rng.random((3, 9, 10, 11)).astype(np.float32)
    t = torch.from_numpy(pad)
    z = (pad[:, :-2] + pad[:, 1:-1]) + pad[:, 2:]
    y = (z[:, :, :-2] + z[:, :, 1:-1]) + z[:, :, 2:]
    uni = ((y[..., :-2] + y[..., 1:-1]) + y[..., 2:]) - pad[:, 1:-1, 1:-1,
                                                            1:-1]
    np.testing.assert_array_equal(
        uni, weighted_moore_agg3(t, (1.0,) * 26, torch.float32).numpy())
    c = (slice(None), slice(1, -1), slice(1, -1), slice(1, -1))
    faces = np.zeros_like(uni)
    for v in (pad[:, :-2, 1:-1, 1:-1], pad[:, 1:-1, :-2, 1:-1],
              pad[:, 1:-1, 1:-1, :-2], pad[:, 1:-1, 1:-1, 2:],
              pad[:, 1:-1, 2:, 1:-1], pad[:, 2:, 1:-1, 1:-1]):
        faces = faces + v
    np.testing.assert_array_equal(
        faces, weighted_moore_agg3(t, FACES, torch.float32).numpy())
    assert pad[c].shape == uni.shape


def tf32(x):
    """x (float32) rounded to TF32 as the kernel rounds (to nearest, ties
    away from zero, a 10-bit mantissa)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32((np.asarray(x, np.float32) - hi).astype(np.float32))


def exact(r, x, c):
    return r.astype(np.float64) @ x.astype(np.float64) @ \
        c.astype(np.float64).T


def one_pass(r, x, c):
    """tf32(tf32(R) X) tf32(C)^T in float32, X exact in TF32."""
    y = np.matmul(tf32(r), x.astype(np.float32), dtype=np.float32)
    return np.matmul(tf32(y), tf32(c).T, dtype=np.float32)


def three_pass(r, x, c):
    def prod(a, b):
        (ah, al), (bh, bl) = split(a), split(b)
        return (np.matmul(al, bh, dtype=np.float32)
                + np.matmul(ah, bl, dtype=np.float32)
                + np.matmul(ah, bh, dtype=np.float32))
    return prod(prod(r, x.astype(np.float32)), c.T)


def emulate_tc_body(lay, x, wl, k, products):
    """The tensor-core body's k substeps of every window of one
    simulation x, each plane's group products by ``products(R, X, C)`` on
    16 x 16 operands -> the new centers."""
    rho, nb, w = lay.rho, lay.n_blocks, lay.rho + 2 * k
    plan = k3.mxu3_plan_for(lay, wl, k)
    assert plan.body == ""
    rm, cm, dzs = k3.mxu3_operators(wl, w)
    r16 = np.zeros((len(dzs), 16, 16), np.float32)
    c16 = np.zeros_like(r16)
    r16[:, :w, :w], c16[:, :w, :w] = rm, cm
    groups = [(t, dz) for t, dz in enumerate(dzs)][:-1]
    win = np.zeros((nb, 16, 16, 16), np.float32)
    win[:, :w, :w, :w] = k3._windows(lay, torch.from_numpy(x), k).numpy()
    # the mask: window_mask(k) gated by the existence of the region's
    # block, bit (rz, ry, rx) of the window's raster existence bits
    ex = np.concatenate([lay.neighbor_table < nb,
                         np.ones((nb, 1), bool)], axis=1)
    reg = _region(np.arange(16), k, rho)
    d = _direction(reg[:, None, None], reg[None, :, None], reg[None, None])
    mask = np.zeros((nb, 16, 16, 16), np.int64)
    mask[:, :w, :w, :w] = lay.window_mask(k)
    mask &= ex[:, d]
    buf = [win.copy(), np.zeros_like(win)]
    u = win.copy()
    for j in range(1, k + 1):
        cur, nw = buf[(j - 1) & 1], buf[j & 1]
        for z in range(j, w - j):
            e = 0
            for gi, (t, dz) in enumerate(groups):
                xg = cur[:, z + dz]
                if gi == 0:
                    xg = xg + cur[:, z + 1]
                e = e + products(r16[t], xg, c16[t])
            u[:, z] = _rule(wl, u[:, z], np.rint(e) if wl.dtype ==
                            torch.uint8 else e.astype(np.float32),
                            mask[:, z])
            nw[:, z] = u[:, z]
    mid = slice(k, k + rho)
    return u[:, mid, mid, mid].astype(x.dtype)


TC_CASES = [(tf3.MENGER, 3, 1), (tf3.MENGER, 3, 2)]


@pytest.mark.parametrize("wl_name", ["life3d", "heat3d"])
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: f"{c[0].name}"
                         f"{c[1]}-{c[2]}")
def test_tc_body_emulation_equals_plain(case, wl_name):
    """The tensor-core body's dataflow, with its products as the kernel
    rounds them (one TF32 pass for LIFE3D, 3xTF32 for HEAT3D), gives the
    plain version's result: LIFE3D exactly, HEAT3D within the float bar."""
    frac, r, m = case
    lay = BlockLayout3D(frac, r, m)
    wl = trules.get_workload(wl_name)
    x = _state(lay, wl, 1, 5)[0]
    products = one_pass if wl.dtype == torch.uint8 else three_pass
    for k in sorted({1, 2, 3} & set(range(1, lay.rho + 1))):
        want = k3.stencil3d_step_mxu_k_plain(lay, torch.from_numpy(x), wl,
                                             k=k).numpy()
        got = emulate_tc_body(lay, x, wl, k, products)
        if wl.dtype == torch.uint8:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _plane_patterns():
    """(512 * 16, 3, 16, 16) float32: each of the 512 3x3 patterns of the
    dz = 0 plane at each of 16 centers of a 15 x 15 plane, with random 0/1
    planes above and below."""
    rng = np.random.default_rng(11)
    pats = ((np.arange(512)[:, None] >> np.arange(9)) & 1).reshape(512, 3, 3)
    out = []
    for y, xx in zip(rng.integers(1, 14, 16), rng.integers(1, 14, 16)):
        win = np.zeros((512, 3, 16, 16), np.float32)
        win[:, 0, :15, :15] = rng.integers(0, 2, (512, 15, 15))
        win[:, 2, :15, :15] = rng.integers(0, 2, (512, 15, 15))
        win[:, 1, y - 1:y + 2, xx - 1:xx + 2] = pats
        out.append(win)
    return np.concatenate(out)


@pytest.mark.parametrize("wl_name", ["life3d", "life"])
def test_tf32_one_pass_counts_every_plane_pattern(wl_name):
    """One TF32 pass, the merged dz = +-1 group on X[z-1] + X[z+1] and the
    two dz = 0 terms on X[z], counts each of the 512 patterns of the plane
    at every interior cell within 2e-3 (rintf needs 0.5)."""
    wl = trules.get_workload(wl_name)
    rm, cm, dzs = k3.mxu3_operators(wl, 15)
    r16 = np.zeros((4, 16, 16), np.float32)
    c16 = np.zeros_like(r16)
    r16[:, :15, :15], c16[:, :15, :15] = rm, cm
    x = _plane_patterns()
    agg = one_pass(r16[0], x[:, 0] + x[:, 2], c16[0]) + \
        one_pass(r16[1], x[:, 1], c16[1]) + one_pass(r16[2], x[:, 1], c16[2])
    count = np.rint(sum(exact(r16[t], x[:, dz + 1], c16[t])
                        for t, dz in enumerate(dzs)))
    inner = (slice(None), slice(1, 14), slice(1, 14))
    err = np.abs(agg[inner] - count[inner]).max()
    assert err <= 2e-3, err
    np.testing.assert_array_equal(np.rint(agg[inner]), count[inner])


def test_3xtf32_heat3d_aggregate_within_1e6():
    """3xTF32 (the merged identity group on X[z-1] + X[z+1], the two dz = 0
    terms) agrees with the float64 aggregate within 1e-6; one pass would
    not do."""
    wl = trules.HEAT3D
    rm, cm, dzs = k3.mxu3_operators(wl, 15)
    r16 = np.zeros((4, 16, 16), np.float32)
    c16 = np.zeros_like(r16)
    r16[:, :15, :15], c16[:, :15, :15] = rm, cm
    x = np.zeros((64, 3, 16, 16), np.float32)
    x[:, :, :15, :15] = np.random.default_rng(3).random((64, 3, 15, 15))
    want = sum(exact(r16[t], x[:, dz + 1], c16[t]) for t, dz in
               enumerate(dzs))

    def agg(prod):
        return prod(r16[0], x[:, 0] + x[:, 2], c16[0]) + \
            prod(r16[1], x[:, 1], c16[1]) + prod(r16[2], x[:, 1], c16[2])
    assert np.abs(agg(three_pass) - want).max() <= 1e-6
    assert np.abs(agg(one_pass) - want).max() > 1e-5
