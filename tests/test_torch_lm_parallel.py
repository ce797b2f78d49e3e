"""The port's placement side against the reference's, on the CPU:

  * ``utils.sharding.param_specs`` for every parameter of every full
    config on the 16x16, 2x16x16 and 64x4 production meshes: a unit's
    placement is the reference's spec of its stacked leaf less the leading
    None, every other one the reference's spec (the reference's functions
    read only ``.shape`` and ``.axis_names`` of a mesh, so they take the
    port's mesh description and no host devices are forced);
  * ``launch.specs.cache_shardings`` for every arch's decode cache, the
    same way, and ``opt_state_shardings``' int8 rule;
  * ``utils.analytic`` equal to the reference's for every
    ``configs.cells()`` entry on both production meshes (flops, bytes and
    collective terms exactly; the roofline's times by the H100's rates);
  * ``runtime.pipeline_parallel.pipeline_apply`` on CPU "stages" equal to
    the sequential layers within 1e-5 (the bar of ``tests/_pp_check.py``)
    and to the same layers run by the reference;
  * ``launch.dryrun`` rows of the reference's six small cells
    (``tests/_dryrun_small_check.py``) at their smoke configs on a 2x4
    mesh: the planned parameter bytes equal those of the reference's
    specs on its stacked tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import specs as RS
from repro.models import model as RM
from repro.runtime import pipeline_parallel as RPP
from repro.utils import analytic as RAN
from repro.utils import sharding as RSH
from repro_torch import configs as TC
from repro_torch.launch import dryrun
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import (Mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models.model import build_model
from repro_torch.runtime import pipeline_parallel as TPP
from repro_torch.utils import analytic as TAN
from repro_torch.utils import sharding as TSH

ARCHS = list(RC.ARCHS)
MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "64x4": make_production_mesh(data=64, model=4)}
META = torch.device("meta")
STACKED = ("units", "enc_units", "dec_units")


def _spec(p) -> tuple:
    """A placement as a tuple in one form: jax's PartitionSpec writes an
    axis tuple of one name as the bare name, so both sides do."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in p)


def _is_spec(x) -> bool:
    return isinstance(x, jax.sharding.PartitionSpec)


def _ref_by_port_name(ref_tree, ref_specs):
    """(shape, spec tuple, stacked) of the reference's leaves keyed by the
    port's names: a stacked leaf once for each unit."""
    specs = jax.tree.leaves(ref_specs, is_leaf=_is_spec)
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(ref_tree)[0], specs):
        keys = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
        if keys[0] in STACKED:
            for i in range(leaf.shape[0]):
                out[".".join([keys[0], str(i)] + keys[1:])] = (
                    tuple(leaf.shape), _spec(spec), True)
        else:
            out[".".join(keys)] = (tuple(leaf.shape), _spec(spec), False)
    return out


@pytest.fixture(scope="module")
def full_trees():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = RC.get_config(arch)
            cache[arch] = jax.eval_shape(
                lambda k: RM.init_params(k, cfg), jax.random.PRNGKey(0))
        return cache[arch]
    return get


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, full_trees):
    m = MESHES[mesh]
    ref_tree = full_trees(arch)
    ref = _ref_by_port_name(ref_tree, RSH.param_specs(ref_tree, m))
    model = build_model(TC.get_config(arch), META, None)
    got = TSH.param_specs(model, m)
    assert set(got) == set(ref)
    for name, p in model.named_parameters():
        shape, want, stacked = ref[name]
        if stacked:
            assert want[0] is None, name
            want, shape = want[1:], shape[1:]
        # the rules saw the reference's shape, less the unit axis
        assert tuple(p.shape) == shape, name
        assert got[name] == want, (name, got[name], want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh):
    m = MESHES[mesh]
    for extra in (1, 2):
        assert _spec(TSH.batch_spec(m, extra_dims=extra)) == _spec(
            RSH.batch_spec(m, extra_dims=extra))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch):
    m = MESHES["16x16"]
    rcfg = RS.serve_config(RC.get_config(arch))
    r_cache, r_extras = RS.cache_specs(rcfg, "decode_32k")
    # the reference wraps each spec in a NamedSharding, which needs a jax
    # mesh of devices: its specs are read with that wrapper left out
    is_spec = _is_spec
    real_named = RS.NamedSharding
    RS.NamedSharding = lambda mesh, spec: spec
    try:
        want_c = RS.cache_shardings(r_cache, rcfg, m)
        want_e = RS.cache_shardings(r_extras, rcfg, m)
    finally:
        RS.NamedSharding = real_named
    cfg = TS.serve_config(TC.get_config(arch))
    cache, extras = TS.cache_specs(cfg, "decode_32k")
    got_c = jax.tree.map(_spec, TS.cache_shardings(cache, cfg, m),
                         is_leaf=lambda x: isinstance(x, tuple))
    got_e = jax.tree.map(_spec, TS.cache_shardings(extras, cfg, m),
                         is_leaf=lambda x: isinstance(x, tuple))
    for i, unit in enumerate(got_c["units"]):
        want_u = jax.tree.map(lambda s: _spec(s)[1:], want_c["units"],
                              is_leaf=is_spec)
        assert unit == want_u, (arch, i)
    if "tail" in got_c:
        assert got_c["tail"] == jax.tree.map(_spec, want_c["tail"],
                                             is_leaf=is_spec)
    if extras:
        want_mem = jax.tree.map(lambda s: _spec(s)[1:],
                                want_e["memory_kv"], is_leaf=is_spec)
        assert all(layer == want_mem for layer in got_e["memory_kv"])
        assert len(got_e["memory_kv"]) == cfg.n_units


def test_opt_state_shardings_int8_rule():
    cfg = TC.get_smoke_config("mixtral-8x22b")
    m = Mesh(("data", "model"), (2, 4))
    model = build_model(cfg, META, None)
    named = dict(model.named_parameters())
    ocfg = TS.opt_config(cfg, quantize_moments=True, compress_grads=True)
    opt = TS.adamw.init(ocfg, named)
    p_sh = TS.param_shardings(model, m)
    plan = TS.opt_state_shardings(opt, p_sh, m)
    assert plan["step"] == ()
    for n, spec in p_sh.items():
        assert plan["m"]["q"][n] == spec == plan["ef"][n]
        assert plan["v"]["scale"][n] == spec[:-1] + (None,)
        assert len(plan["v"]["scale"][n]) == opt["v"]["scale"][n].ndim


def test_meshes():
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}
    assert MESHES["64x4"].size == 256 and MESHES["16x16"].devices == ()
    with pytest.raises(ValueError):
        make_production_mesh(data=16, model=8)
    local = make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1}
    assert local.devices == (torch.device("cpu"),)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "2pods"])
@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in RC.cells()])
def test_analytic_matches_reference(arch, shape, multi_pod):
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    kw = dict(pod=2 if multi_pod else 1)
    rmesh, tmesh = RAN.MeshModel(**kw), TAN.MeshModel(**kw)
    assert TAN.flops_model(tcfg, shape) == RAN.flops_model(rcfg, shape)
    assert TAN.bytes_model(tcfg, shape, tmesh) == \
        RAN.bytes_model(rcfg, shape, rmesh)
    assert TAN.collective_model(tcfg, shape, tmesh) == \
        RAN.collective_model(rcfg, shape, rmesh)
    got = TAN.analytic_roofline(tcfg, shape, tmesh)
    want = RAN.analytic_roofline(rcfg, shape, rmesh)
    for k in ("flops", "hbm_bytes", "coll_bytes", "n_chips", "model_flops"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.useful_flops_ratio == want.useful_flops_ratio
    # the constants: one H100's, where the reference has a TPU v5e's
    assert got.t_compute == got.flops / 989e12
    assert got.t_memory == got.hbm_bytes / 3.35e12
    assert got.t_collective == got.coll_bytes / 450e9


def test_roofline_terms_and_bottleneck():
    r = TAN.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=0.0,
                     n_chips=4, model_flops=4 * 989e12)
    assert abs(r.t_compute - 1.0) < 1e-9 and abs(r.t_memory - 1.0) < 1e-9
    assert r.t_collective == 0.0 and r.bottleneck in ("compute", "memory")
    assert abs(r.useful_flops_ratio - 1.0) < 1e-9
    assert abs(r.mfu_bound - 1.0) < 1e-9
    assert set(r.row()) >= {"t_compute_s", "bottleneck", "mfu_bound"}


N_LAYERS, D, B = 8, 32, 16


@pytest.fixture(scope="module")
def layers():
    rng = np.random.default_rng(0)
    ws = (0.3 * rng.standard_normal((N_LAYERS, D, D))).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    ref = jnp.asarray(x)
    for i in range(N_LAYERS):
        ref = jnp.tanh(ref @ ws[i])
    return ws, x, np.asarray(ref)


def _stage_fn(stage_params, h):
    for w in stage_params["w"]:
        h = torch.tanh(h @ w)
    return h


@pytest.mark.parametrize("n_stages,n_micro", [(4, 4), (4, 1), (2, 8),
                                              (1, 4), (8, 2)])
def test_pipeline_matches_sequential(layers, n_stages, n_micro):
    ws, x, ref = layers
    wt, xt = torch.from_numpy(ws), torch.from_numpy(x)
    seq = xt
    for w in wt:
        seq = torch.tanh(seq @ w)
    stages = TPP.stack_stages({"w": wt}, n_stages)
    np.testing.assert_array_equal(
        stages["w"].numpy(),
        np.asarray(RPP.stack_stages({"w": jnp.asarray(ws)}, n_stages)["w"]))
    got = TPP.pipeline_apply(_stage_fn, stages, xt,
                             devices=[torch.device("cpu")] * n_stages,
                             n_microbatches=n_micro)
    assert got.shape == xt.shape and got.device == xt.device
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_pipeline_runs_each_microbatch_once_a_stage():
    calls = []

    def stage_fn(p, h):
        calls.append(int(p["id"]))
        return h + p["id"]

    x = torch.zeros(6, 3)
    out = TPP.pipeline_apply(stage_fn, {"id": torch.arange(3.0)}, x,
                             devices=[torch.device("cpu")] * 3,
                             n_microbatches=3)
    assert sorted(calls) == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert torch.equal(out, torch.full((6, 3), 3.0))
    with pytest.raises(ValueError):
        TPP.pipeline_apply(stage_fn, {"id": torch.arange(3.0)}, x,
                           devices=[torch.device("cpu")] * 3,
                           n_microbatches=4)


#: the reference's small dry-run cells (tests/_dryrun_small_check.py)
CELLS = [("smollm-135m", "train_4k"), ("mixtral-8x22b", "train_4k"),
         ("mamba2-780m", "decode_32k"), ("gemma2-2b", "long_500k"),
         ("whisper-small", "decode_32k"), ("llava-next-34b", "prefill_32k")]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_dryrun_small_cells(arch, shape, monkeypatch):
    full = TC.get_config
    monkeypatch.setattr(TC, "get_config", lambda a: TC.reduced(full(a)))
    mesh = Mesh(("data", "model"), (2, 4))
    row = dryrun.run_cell(arch, shape, mesh)
    kind = RC.SHAPES[shape][2]
    rcfg = RC.get_smoke_config(arch)
    if kind != "train":
        rcfg = RS.serve_config(rcfg)
    tree = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    specs = jax.tree.leaves(RSH.param_specs(tree, mesh), is_leaf=_is_spec)
    want = sum(leaf.size * leaf.dtype.itemsize
               / TSH.shard_factor(_spec(s), mesh)
               for leaf, s in zip(jax.tree.leaves(tree), specs))
    assert row["params_bytes"] == pytest.approx(want, rel=1e-12)
    assert row["mesh"] == "2x4" and row["n_chips"] == 8 and row["ok"]
    if kind == "train":
        assert row["grads_bytes"] == row["params_bytes"]
        # float32 m and v, and the int32 step (replicated)
        assert row["opt_bytes"] == 2 * row["params_bytes"] + 4
    mm = RAN.MeshModel(data=2, model=4)
    roof = RAN.analytic_roofline(rcfg, shape, mm)
    assert row["flops"] == roof.flops and row["hbm_bytes"] == roof.hbm_bytes
    assert row["model_flops"] == RS.model_flops_for(rcfg, shape)
    assert row["per_device_bytes"] > row["params_bytes"] > 0


def test_dryrun_cli_one_cell(capsys):
    rows = dryrun.main(["--arch", "smollm-135m", "--shape", "train_4k"])
    assert len(rows) == 1 and rows[0]["ok"] and rows[0]["mesh"] == "16x16"
    assert '"arch": "smollm-135m"' in capsys.readouterr().out
