"""The port's public names: ``repro_torch.core``,
``repro_torch.workloads`` and ``repro_torch.tuning`` export every name of
the reference's ``repro.core``, ``repro.workloads`` and ``repro.tuning``
``__all__``, with one stated
rename (the reference's Pallas engine is the port's kernel engine), and
the ported ``life_rule`` and ``default_runner`` behave as the
reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.tuning
import repro.workloads
import repro_torch.core
import repro_torch.tuning
import repro_torch.workloads
from repro.workloads import rules as rrules
from repro_torch.workloads import rules as trules
from repro_torch.workloads import runner as trunner

#: reference name -> port name, where they differ
RENAMES = {"SqueezePallasEngine": "SqueezeKernelEngine"}


@pytest.mark.parametrize("ref,port", [(repro.core, repro_torch.core),
                                      (repro.workloads,
                                       repro_torch.workloads),
                                      (repro.tuning, repro_torch.tuning)],
                         ids=["core", "workloads", "tuning"])
def test_port_exports_every_reference_name(ref, port):
    wanted = {RENAMES.get(n, n) for n in ref.__all__}
    assert wanted <= set(port.__all__), sorted(wanted - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert len(set(port.__all__)) == len(port.__all__)


@pytest.mark.parametrize("name", ["CHANDELIER", "EMPTY_BOTTLES", "CARPET"])
def test_exported_fractals_equal_reference(name):
    mine, ref = getattr(repro_torch.core, name), getattr(repro.core, name)
    assert (mine.name, mine.s, mine.positions) == \
        (ref.name, ref.s, tuple(map(tuple, ref.positions)))


def test_moore_dirs_equal_reference():
    assert tuple(map(tuple, repro_torch.core.MOORE_DIRS)) == \
        tuple(map(tuple, repro.core.MOORE_DIRS))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_life_rule_equals_reference(seed):
    rng = np.random.default_rng(seed)
    alive = rng.integers(0, 2, (5, 17, 9)).astype(np.uint8)
    counts = rng.integers(0, 9, alive.shape).astype(np.int32)
    got = trules.life_rule(torch.from_numpy(alive), torch.from_numpy(counts))
    want = rrules.life_rule(jnp.asarray(alive), jnp.asarray(counts))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert repro_torch.core.life_rule is trules.life_rule


def test_default_runner_is_one_runner_on_the_card(monkeypatch):
    monkeypatch.setattr(trunner, "_DEFAULT", None)
    if torch.cuda.is_available():
        first = trunner.default_runner()
        assert first is trunner.default_runner()
        assert first.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            trunner.default_runner()
        assert trunner._DEFAULT is None
    assert repro_torch.workloads.default_runner is trunner.default_runner
