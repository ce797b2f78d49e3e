"""The port's configs against the reference's, field for field: every
architecture's full config (the one served at full width) and its smoke
config, their derived properties and parameter counts, the shape table,
the long-context policy, the cell matrix and the fractal case study's
config. The configs are hand copies, and the parity tests of the models
all run at ``reduced()``, which overwrites most full-width fields."""
import dataclasses

import pytest

from repro import configs as RC
from repro.configs import sierpinski as RS
from repro_torch import configs as TC
from repro_torch.configs import sierpinski as TS

ARCHS = list(RC.ARCHS)
DERIVED = ("head_dim_", "n_layers", "vocab_padded", "is_attention_free",
           "is_sub_quadratic")


def _summary(cfg):
    return dict(dataclasses.asdict(cfg),
                **{k: getattr(cfg, k) for k in DERIVED},
                param_count=cfg.param_count(),
                active_param_count=cfg.active_param_count())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    want = getattr(RC, get)(arch)
    got = getattr(TC, get)(arch)
    assert _summary(got) == _summary(want)


def test_registry_matches_reference():
    assert TC.ARCHS == RC.ARCHS
    assert TC.ALL_ARCHS == RC.ALL_ARCHS
    assert TC.LONG_CONTEXT_ARCHS == RC.LONG_CONTEXT_ARCHS
    assert TC.SHAPES == RC.SHAPES
    for skipped in (False, True):
        assert list(TC.cells(skipped)) == list(RC.cells(skipped))
    with pytest.raises(KeyError):
        TC.get_config("no-such-arch")


def test_fractal_config_matches_reference():
    assert dataclasses.asdict(TS.CONFIG) == dataclasses.asdict(RS.CONFIG)
    assert ((TS.FRACTAL.name, TS.FRACTAL.s, TS.FRACTAL.positions)
            == (RS.FRACTAL.name, RS.FRACTAL.s, RS.FRACTAL.positions))
