"""The port's public names: ``repro_torch.core``,
``repro_torch.workloads``, ``repro_torch.tuning``, ``repro_torch.kernels``,
``repro_torch.models`` and ``repro_torch.configs`` export every name of
the matching reference package's ``__all__``, with one stated rename (the
reference's Pallas engine is the port's kernel engine) and the stated
absence below; ``optim.adamw``, ``data.pipeline``, ``launch.train`` and
``launch.specs`` (modules with no ``__all__``) define every public
function and class the reference's define; and the ported ``life_rule``
and ``default_runner`` behave as the reference's."""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs
import repro.core
import repro.kernels
import repro.models
import repro.tuning
import repro.workloads
import repro_torch.configs
import repro_torch.core
import repro_torch.kernels
import repro_torch.models
import repro_torch.tuning
import repro_torch.workloads
from repro.workloads import rules as rrules
from repro_torch.workloads import rules as trules
from repro_torch.workloads import runner as trunner

#: reference name -> port name, where they differ
RENAMES = {"SqueezePallasEngine": "SqueezeKernelEngine"}

#: reference names the port does not have, each for a stated reason:
#: ``default_interpret`` has no meaning without an interpreter
ABSENT = {"default_interpret"}


@pytest.mark.parametrize("ref,port", [(repro.core, repro_torch.core),
                                      (repro.workloads,
                                       repro_torch.workloads),
                                      (repro.tuning, repro_torch.tuning),
                                      (repro.kernels, repro_torch.kernels),
                                      (repro.models, repro_torch.models),
                                      (repro.configs, repro_torch.configs)],
                         ids=["core", "workloads", "tuning", "kernels",
                              "models", "configs"])
def test_port_exports_every_reference_name(ref, port):
    wanted = {RENAMES.get(n, n) for n in ref.__all__} - ABSENT
    assert wanted <= set(port.__all__), sorted(wanted - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name
    assert len(set(port.__all__)) == len(port.__all__)


def test_stated_absences_are_reference_names_the_port_lacks():
    ref = set(repro.kernels.__all__) | set(repro.models.__all__)
    port = set(repro_torch.kernels.__all__) | set(repro_torch.models.__all__)
    assert ABSENT <= ref and not ABSENT & port


def _defined(module) -> set:
    """The public functions and classes a module defines itself."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and getattr(v, "__module__", None)
            == module.__name__
            and (inspect.isfunction(v) or inspect.isclass(v))}


@pytest.mark.parametrize("name", ["optim.adamw", "data.pipeline",
                                  "launch.train", "launch.specs"])
def test_training_modules_define_every_reference_name(name):
    import importlib
    ref = _defined(importlib.import_module(f"repro.{name}"))
    port = _defined(importlib.import_module(f"repro_torch.{name}"))
    assert ref and ref <= port, sorted(ref - port)


def test_models_export_train_loss():
    from repro_torch.models.model import train_loss
    assert repro_torch.models.train_loss is train_loss


def test_kernels_export_the_attention_kernel_wrapper():
    from repro_torch.kernels.attention import flash_attention
    assert repro_torch.kernels.flash_attention is flash_attention


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


#: (module, name) of every reference function or class that takes a mesh
MESH_TAKERS = [("models.model", n) for n in (
    "train_loss", "forward", "prefill", "decode_step", "generate",
    "greedy_generate")] + [("launch.specs", n) for n in (
        "make_train_step", "make_prefill_fn", "make_decode_fn")] + [
    ("launch.serve", "BatchServer"), ("launch.train", "train"),
    ("models.moe", "n_token_groups")]


@pytest.mark.parametrize("module,name", MESH_TAKERS,
                         ids=[f"{m}.{n}" for m, n in MESH_TAKERS])
def test_port_takes_mesh_where_the_reference_does(module, name):
    """The port's function takes ``mesh`` as the reference's does: the
    same kind of parameter with the same default, at the same place
    among the others; ``n_token_groups`` (``(cfg, n_tokens, mesh=None)``
    in the port, ``(cfg, mesh, n_tokens)`` in the reference) only takes
    one."""
    import importlib
    ref = inspect.signature(getattr(importlib.import_module(
        f"repro.{module}"), name))
    port = inspect.signature(getattr(importlib.import_module(
        f"repro_torch.{module}"), name))
    want, got = ref.parameters["mesh"], port.parameters["mesh"]
    if name == "n_token_groups":
        assert got.default is None
        return
    assert (got.kind, got.default) == (want.kind, want.default)
    assert list(port.parameters).index("mesh") == \
        list(ref.parameters).index("mesh")
