"""The geometry of v4 and kernel 6 (``stencil_step_fused_k`` and
``stencil_step_fused_k_local``): ``fused_plan``, which picks the body and
its launch shape from the shape (and whether the ring weights are the
rule's own), for every shipped fractal's block side and every k the
wrappers take. Pure; the kernels themselves are held against their plain
versions on the card (``tests/test_torch_cuda.py``).
"""
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from repro_torch.core import fractals as tf
from repro_torch.kernels import build
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.workloads import rules as trules

#: every block side rho = s^m of the registry's fractals at m = 1..3
RHOS = sorted({f.s ** m for f in tf.REGISTRY.values() for m in (1, 2, 3)})
SOURCE = Path(sk.__file__).parent / "csrc" / "squeeze_stencil.cu"


def test_shipped_block_sides():
    assert RHOS == [2, 3, 4, 8, 9, 27]


@pytest.mark.parametrize("pieces", [False, True], ids=["v4", "local"])
@pytest.mark.parametrize("rho", RHOS)
def test_fused_plan_every_k_and_channel_count(rho, pieces):
    """W >= w, 32 / W windows a warp, shared memory under one CTA's with
    the most warps that fit, and the CTA body (``[wide]``) exactly for
    windows over 32 cells."""
    for dtype in (torch.uint8, torch.float32):
        esize = torch.empty((), dtype=dtype).element_size()
        for nc in (1, 2, 3):
            for k in range(1, rho + 1):
                w = rho + 2 * k
                plan = sk.fused_plan(dtype, nc, rho, k, pieces)
                assert plan.smem <= build.MAX_SMEM
                if w > 32:
                    assert plan == sk.FusedPlan(0, 1, 8, plan.smem,
                                                "[wide]")
                    continue
                assert plan.body == ""
                assert plan.W in (8, 16, 32) and plan.W >= w
                assert plan.W == 8 or plan.W // 2 < w
                assert plan.windows == 32 // plan.W
                assert 1 <= plan.warps <= 8
                g = plan.windows
                # a channel's region (kernel 6: w^2 elements a window; v4:
                # G centers and 8 G neighbor slots) and 16 zero bytes
                blocks = g * w * w if pieces else 9 * g * rho * rho
                per_warp = nc * (-(-blocks * esize // 16) * 16 + 16)
                assert plan.smem == plan.warps * per_warp
                # the most warps that fit
                more = (plan.warps + 1) * per_warp
                assert plan.warps == 8 or more > build.MAX_SMEM


@pytest.mark.parametrize("dtype,nc,rho,k,pieces,want", [
    # the main paths: LIFE / HEAT / GRAY_SCOTT at rho=4, k=2 (w = 8)
    (torch.uint8, 1, 4, 2, False, (8, 4, 8, 4736, "")),
    (torch.float32, 1, 4, 2, False, (8, 4, 8, 18560, "")),
    (torch.float32, 2, 4, 2, False, (8, 4, 8, 37120, "")),
    (torch.uint8, 1, 4, 2, True, (8, 4, 8, 2176, "")),
    # k = rho at rho = 4 (w = 12) and rho = 9 (w = 27)
    (torch.uint8, 1, 4, 4, False, (16, 2, 8, 2432, "")),
    (torch.float32, 2, 9, 9, True, (32, 1, 8, 47104, "")),
    # rho = 27: one window a warp at k <= 2, four warps where eight do
    # not fit; the CTA body past w = 32
    (torch.float32, 2, 27, 2, False, (32, 1, 4, 210176, "")),
    (torch.uint8, 1, 27, 1, False, (32, 1, 8, 52736, "")),
    (torch.uint8, 1, 27, 3, False, (0, 1, 8, 3317, "[wide]")),
    (torch.float32, 2, 27, 27, True, (0, 1, 8, 111573, "[wide]")),
])
def test_fused_plan_by_shape(dtype, nc, rho, k, pieces, want):
    assert tuple(sk.fused_plan(dtype, nc, rho, k, pieces)) == want


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


@dataclasses.dataclass(frozen=True)
class _OrthGrayScott(trules.GrayScott):
    """Gray-Scott with no diagonal weight: ring weights (0, 0.2)."""
    name: str = "orth-gray-scott"

    def weight(self, offset):
        return 0.2 if sum(abs(d) for d in offset) == 1 else 0


def test_rule_form_holds_for_the_shipped_workloads_only():
    """The warp body computes one aggregate sum per rule; every shipped
    2D workload has it, and other ring weights do not."""
    for name in ("life", "highlife", "seeds", "heat", "gray-scott"):
        assert sk._rule_form(trules.WORKLOADS[name]), name
    for wl in (_OrthCA(), _MooreHeat(), _OrthGrayScott()):
        assert not sk._rule_form(wl), wl.name


@pytest.mark.parametrize("pieces", [False, True], ids=["v4", "local"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_plan_gives_other_weights_the_cta_body(k, pieces):
    """Where the weights are not the rule's own, every window runs the CTA
    body, even one that fits a warp."""
    for dtype, nc in ((torch.uint8, 1), (torch.float32, 2)):
        plan = sk.fused_plan(dtype, nc, 4, k, pieces, rule_form=False)
        assert (plan.W, plan.body) == (0, "[wide]")
        assert plan.smem <= build.MAX_SMEM
        assert sk.fused_plan(dtype, nc, 4, k, pieces).body == ""


def test_fused_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        sk.fused_plan(torch.float32, 2, 64, 32)


def test_fused_launch_names_are_registered():
    for name in ("stencil_step_fused_k", "stencil_step_fused_k_local"):
        for body in ("", "[wide]"):
            assert name + body in sk.LAUNCHES


def test_fused_plan_constants_match_the_source():
    """The plan's limits are the kernel source's."""
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             text).group(1))
    assert const("kWarpWarps") == sk.FUSED_WARPS
    assert const("kThreads") == sk.CTA_THREADS
    assert const("kCellsPerCta") == sk.CTA_CELLS
    assert const("kMaxSmem") == build.MAX_SMEM


def test_c_signatures_match_the_source():
    """Each C entry the wrappers call takes as many arguments as its
    ctypes signature passes (v4 and kernel 6 take fused_plan's W and
    warps after k)."""
    text = SOURCE.read_text()
    for name, types in sk._SIGNATURES.items():
        params = re.search(rf"int {name}\((.*?)\)", text, re.S).group(1)
        assert len(params.split(",")) == len(types), name
    for name in ("sq_stencil_step_fused_k", "sq_stencil_step_fused_k_local"):
        params = re.search(rf"int {name}\((.*?)\)", text, re.S).group(1)
        assert "int k, int W, int warps," in " ".join(params.split())
