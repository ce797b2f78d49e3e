"""The language-model path run sharded over a local mesh in one process
(``mesh=`` on the port's entry points, ``runtime/spmd.py``), on the CPU
with every position on the one CPU device, at the smoke configs:

  (a) the reference's sharded-equality check (``tests/
      _sharded_equality_check.py``) at its own inputs: smollm-135m,
      smollm-135m with ``seq_shard`` and mixtral-8x22b with
      ``dispatch_groups=4``, one ``make_train_step`` step on a (data=4,
      model=2) mesh from the reference's initial weights and zero moments
      (``AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4,
      weight_decay=0.0)``, tokens and labels (8, 32)). Against the port's
      unsharded step (``SHARD_TOL``): loss and grad norm within 1e-5
      relative, each moment leaf within 1e-5 of its largest entry, each
      parameter within 1e-5 absolute (the leaves are below 1; the norm
      scales start at zero and move by lr, where a bar relative to the
      leaf would hold Adam's direction m / (sqrt(v) + eps) on gradients
      at the size of eps). Against the reference's unsharded step: the
      metrics and moments at the step bar of ``tests/
      test_torch_lm_train.py`` (rtol 5e-4, atol 5e-6),
      the loss also within the reference check's 2e-3, and the
      parameters within its 5e-2 of each leaf's largest entry, and for
      smollm-135m at that step bar too (for mixtral-8x22b the first step
      from zero moments moves each parameter by lr times the sign of its
      gradient, and a few signs round apart between jax and torch where
      a gradient is noise). The other six
      architectures on a (2, 4) mesh, remat, two microbatches, int8
      moments and compressed gradients, and a batch the data axis does not
      divide, against the unsharded step at ``SHARD_TOL``;
  (b) greedy serving of the seven attention-family architectures on a
      (4, 2) and a (2, 4) mesh through ``BatchServer(mesh=)`` on the
      serve tests' ragged, left-padded prompts: the tokens equal the
      unsharded server's, and prefill and every decode step's logits
      within 1e-5 of the unsharded ones (MoE dispatch groups pinned to 4
      on both sides: capacity is bounded per group); a one-row decode on
      a data axis of 4 (the batch replicates);
  (c) ``utils.sharding.shard`` / ``gather`` round trips bit for bit, and
      each position's parameter and moment bytes equal to
      ``launch.dryrun``'s planned per-device bytes; the int8 moments'
      shard-wise quantization bit for bit with the whole leaf's;
  (d) ``moe.n_token_groups(cfg, t, mesh)`` equal to the reference's
      ``n_token_groups(cfg, mesh, t)`` on the port's mesh descriptions
      (the reference's reads only ``.shape`` and ``.axis_names``), the
      port's ``activation_spec`` equal to the reference's, and unpinned
      MoE groups under a mesh equal to groups pinned to its batch degree
      without one;
  (e) the ``rec``, ``ssm`` and ``encdec`` families, which run under a
      mesh as well, are ``tests/test_torch_lm_sharded_families.py``'s;
      here only their parameter and moment bytes against the plan (c);
  (f) a checkpoint saved on a (4, 2) mesh resumes on none, one saved on
      none on a (2, 4) mesh and one saved on (4, 2) on (2, 4), each with
      the losses of an uninterrupted unsharded run (rtol 1e-5); and the
      sharded collectives' element counts.

The unsharded results are computed once a case (module-scoped)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import specs as RS
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.optim import adamw as RA
from repro_torch import configs as TC
from repro_torch.data.pipeline import SyntheticMarkov
from repro_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.launch import dryrun
from repro_torch.launch import serve as TSV
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import Mesh, make_local_mesh, parse_mesh
from repro_torch.launch.train import train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as TA
from repro_torch.runtime import spmd
from repro_torch.utils import sharding as TSH

ATTENTION = ["smollm-135m", "tinyllama-1.1b", "qwen1.5-110b",
             "mixtral-8x22b", "arctic-480b", "gemma2-2b", "llava-next-34b"]
#: the reference check's optimizer and batch
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=4, weight_decay=0.0)
B, S = 8, 32
SHARD_TOL = dict(loss=1e-5, moments=1e-5, params=1e-5)
REF_TOL = dict(loss=2e-3, params=5e-2)
#: the step bar of ``tests/test_torch_lm_train.py``
STEP_TOL = dict(rtol=5e-4, atol=5e-6)
LOGIT_TOL = 1e-5
PROMPTS = (24, 17, 31, 8)   # the serve tests' ragged prompts
NEW = 8


def mesh_of(data, model):
    return make_local_mesh(model, data, device="cpu")


def _pinned(cfg, groups=4):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=groups))


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


# ----------------------------------------------------------------- (a)
#: the reference check's three cases
REF_CASES = {"smollm": ("smollm-135m", False),
             "smollm-seq": ("smollm-135m", True),
             "mixtral-g4": ("mixtral-8x22b", False)}


def _ref_cfg(mod, arch, seq_shard):
    cfg = mod.get_smoke_config(arch)
    if seq_shard:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    return _pinned(cfg)


@functools.lru_cache(maxsize=None)
def _reference_case(name):
    """The reference check's inputs and its unsharded step (jitted), and
    the port's unsharded step from the same inputs."""
    arch, seq_shard = REF_CASES[name]
    rcfg = _ref_cfg(RC, arch, seq_shard)
    ocfg = RA.AdamWConfig(**OPT)
    params = RM.init_params(jax.random.PRNGKey(0), rcfg)
    opt = RA.init(ocfg, params)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (B, S), 0,
                                          rcfg.vocab),
             "labels": jax.random.randint(jax.random.PRNGKey(2), (B, S), 0,
                                          rcfg.vocab)}
    tree = jax.tree.map(np.asarray, params)
    opt_np = jax.tree.map(np.asarray, opt)
    x = {k: np.asarray(v) for k, v in batch.items()}
    step = jax.jit(RS.make_train_step(rcfg, ocfg, mesh=None))
    p_ref, o_ref, m_ref = jax.tree.map(np.asarray, step(params, opt, batch))
    tcfg = _ref_cfg(TC, arch, seq_shard)
    unsharded = _port_step(tcfg, tree, opt_np, x, None)
    return dict(cfg=tcfg, tree=tree, opt=opt_np, x=x,
                ref=(p_ref, o_ref, {k: float(v) for k, v in m_ref.items()}),
                unsharded=unsharded)


def _port_step(cfg, tree, opt_np, x, mesh, ocfg=None, accum=1):
    """The port's step from numpy inputs -> (params, opt state, metrics)
    as numpy trees and floats."""
    ocfg = ocfg or TA.AdamWConfig(**OPT)
    model = params_from_numpy(cfg, tree, device="cpu", mesh=mesh)
    state = opt_state_from_numpy(cfg, opt_np, device="cpu", mesh=mesh)
    step = TS.make_train_step(cfg, ocfg, mesh=mesh, accum_steps=accum)
    model, state, metrics = step(model, state,
                                 {k: torch.from_numpy(v)
                                  for k, v in x.items()})
    return (params_to_numpy(cfg, model), opt_state_to_numpy(cfg, state),
            {k: float(v) for k, v in metrics.items()})


def _dequantized(opt_tree):
    """The int8 moments of an opt tree dequantized (their padding too)."""
    return {key: jax.tree.map(lambda q, s: TA._dequantize(
        torch.from_numpy(q), torch.from_numpy(s), q.shape).numpy(),
        opt_tree[key]["q"], opt_tree[key]["scale"]) for key in ("m", "v")}


def _assert_matches_unsharded(got, want, tol=SHARD_TOL, moments=True):
    (p_g, o_g, m_g), (p_w, o_w, m_w) = got, want
    for k in ("loss", "grad_norm"):
        assert abs(m_g[k] - m_w[k]) <= tol["loss"] * abs(m_w[k]), k
    for a, b in zip(_leaves(p_g), _leaves(p_w)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol["params"]
    if moments:
        for key in ("m", "v"):
            for a, b in zip(_leaves(o_g[key]), _leaves(o_w[key])):
                assert np.abs(a - b).max() <= tol["moments"] * max(
                    np.abs(b).max(), 1e-30), key
    assert o_g["step"].item() == o_w["step"].item()


@pytest.mark.parametrize("name", list(REF_CASES))
def test_reference_check_sharded_matches_unsharded(name):
    case = _reference_case(name)
    got = _port_step(case["cfg"], case["tree"], case["opt"], case["x"],
                     mesh_of(4, 2))
    _assert_matches_unsharded(got, case["unsharded"])


@pytest.mark.parametrize("name", list(REF_CASES))
def test_reference_check_sharded_matches_reference(name):
    """Metrics and moments at the training tests' step bar; parameters at
    it for smollm-135m (measured: within it), at the reference check's own
    bar for mixtral-8x22b, whose first step from zero moments puts a few
    parameters 3.8e-3 of their leaf's largest entry from the reference's
    (the port's unsharded step too: the sharded one is within 3.2e-6 of
    it)."""
    case = _reference_case(name)
    p_g, o_g, m_g = _port_step(case["cfg"], case["tree"], case["opt"],
                               case["x"], mesh_of(4, 2))
    p_r, o_r, m_r = case["ref"]
    for k in ("loss", "ce", "z_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(m_g[k], m_r[k], **STEP_TOL, err_msg=k)
    assert abs(m_g["loss"] - m_r["loss"]) <= REF_TOL["loss"] * abs(
        m_r["loss"])
    for key in ("m", "v"):
        for a, b in zip(_leaves(o_g[key]), _leaves(o_r[key])):
            np.testing.assert_allclose(a, b, **STEP_TOL, err_msg=key)
    for a, b in zip(_leaves(p_g), _leaves(p_r)):
        if name.startswith("smollm"):
            np.testing.assert_allclose(a, b, **STEP_TOL)
        assert np.abs(a - b).max() <= REF_TOL["params"] * (
            np.abs(b).max() + 1e-6)


def _own_inputs(cfg, seed=3, rows=B, ocfg=None):
    """The port's seeded weights (zero leaves perturbed, so biases and
    norm scales carry values), seeded non-zero moments at step 5 (as
    ``tests/test_torch_lm_train.py`` starts its steps: from zero moments
    Adam's first direction m / (sqrt(v) + eps) is the sign of each
    gradient, ill-conditioned where a gradient is near eps) and a
    batch."""
    ocfg = ocfg or TA.AdamWConfig(**OPT)
    model = TM.init_params(seed, cfg, device="cpu")
    tree = params_to_numpy(cfg, model)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: a if np.abs(a).max() > 0 else (
        0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    moments = {"m": jax.tree.map(lambda a: (1e-3 * rng.standard_normal(
        a.shape)).astype(np.float32), tree),
        "v": jax.tree.map(lambda a: (1e-6 * rng.random(a.shape) + 1e-8
                                     ).astype(np.float32), tree)}
    opt = {"step": np.asarray(5, np.int32)}
    for key, sub in moments.items():
        if ocfg.quantize_moments:
            pairs = jax.tree.map(lambda a: tuple(
                t.numpy() for t in TA._quantize(torch.from_numpy(a))), sub)
            is_pair = lambda x: isinstance(x, tuple)   # noqa: E731
            sub = {"q": jax.tree.map(lambda p: p[0], pairs, is_leaf=is_pair),
                   "scale": jax.tree.map(lambda p: p[1], pairs,
                                         is_leaf=is_pair)}
        opt[key] = sub
    if ocfg.compress_grads:
        opt["ef"] = jax.tree.map(np.zeros_like, moments["m"])
    x = {"tokens": rng.integers(0, cfg.vocab, (rows, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (rows, S)).astype(np.int32)}
    x["labels"][0, :5] = -1
    if cfg.n_patches:
        x["prefix_embeds"] = rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return tree, opt, x


#: (id, arch, mesh, config change, optimizer change, accum, rows)
STEP_CASES = [(a, a, (2, 4), {}, {}, 1, B) for a in ATTENTION] + [
    ("remat", "smollm-135m", (4, 2), {"remat": "full"}, {}, 1, B),
    ("accum2", "mixtral-8x22b", (2, 4), {"remat": "full"}, {}, 2, B),
    ("int8", "qwen1.5-110b", (2, 4), {}, {"quantize_moments": True}, 1, B),
    ("ef", "gemma2-2b", (4, 2), {}, {"compress_grads": True}, 1, B),
    ("rows6", "tinyllama-1.1b", (4, 2), {}, {}, 1, 6),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_sharded_step_matches_unsharded(case):
    """int8 moments: the parameters at the bar, the dequantized moments
    within one int8 step of their block (a value at a rounding tie may
    land one step apart); compressed gradients: the parameters and the
    loss (the residuals are quantization noise)."""
    _, arch, shape, change, ochange, accum, rows = case
    cfg = dataclasses.replace(_pinned(TC.get_smoke_config(arch)), **change)
    ocfg = TA.AdamWConfig(**{**OPT, **ochange})
    tree, opt, x = _own_inputs(cfg, rows=rows, ocfg=ocfg)
    want = _port_step(cfg, tree, opt, x, None, ocfg, accum)
    got = _port_step(cfg, tree, opt, x, mesh_of(*shape), ocfg, accum)
    _assert_matches_unsharded(got, want, moments=not ochange)
    if ocfg.quantize_moments:
        dg, dw = _dequantized(got[1]), _dequantized(want[1])
        for key in ("m", "v"):
            for a, b in zip(_leaves(dg[key]), _leaves(dw[key])):
                assert np.abs(a - b).max() <= np.abs(b).max() / 127 + 1e-12


# ----------------------------------------------------------------- (b)
def _requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [TSV.Request(prompt=rng.integers(0, vocab, size=n
                                            ).astype(np.int32),
                        max_new=NEW) for n in PROMPTS]


@functools.lru_cache(maxsize=None)
def _served(arch):
    """The unsharded server's tokens and the logits of prefill and of
    each decode step fed those tokens."""
    cfg = _pinned(TC.get_smoke_config(arch))
    tree, _, _ = _own_inputs(cfg, seed=5)
    model = params_from_numpy(cfg, tree, device="cpu")
    out = TSV.BatchServer(cfg, model, max_len=64).serve(
        _requests(cfg.vocab))
    toks = np.stack([r.out for r in out])
    return cfg, tree, toks, _replay(cfg, model, toks, None)


def _replay(cfg, model, toks, mesh):
    s_max = max(PROMPTS)
    batch = np.zeros((len(PROMPTS), s_max), np.int32)
    for i, r in enumerate(_requests(cfg.vocab)):
        batch[i, s_max - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(batch)}
    if cfg.n_patches:
        batch["prefix_embeds"] = torch.from_numpy(
            np.random.default_rng(9).standard_normal(
                (len(PROMPTS), cfg.n_patches, cfg.d_model)
            ).astype(np.float32))
    start = s_max + cfg.n_patches
    cache = TM.init_cache(cfg, len(PROMPTS), 64, "cpu", mesh=mesh)
    with torch.no_grad():
        last, cache, _ = TM.prefill(model, batch, cfg, cache, mesh=mesh)
        out = [last]
        for i in range(toks.shape[1]):
            last, cache = TM.decode_step(
                model, torch.from_numpy(toks[:, i:i + 1]), start + i, cfg,
                cache, mesh=mesh)
            out.append(last)
    return torch.stack(out, dim=1).numpy()


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
@pytest.mark.parametrize("arch", ATTENTION)
def test_sharded_serving_matches_unsharded(arch, shape):
    cfg, tree, toks, logits = _served(arch)
    mesh = mesh_of(*shape)
    model = params_from_numpy(cfg, tree, mesh=mesh)
    got = TSV.BatchServer(cfg, model, max_len=64, mesh=mesh).serve(
        _requests(cfg.vocab))
    np.testing.assert_array_equal(np.stack([r.out for r in got]), toks)
    np.testing.assert_allclose(_replay(cfg, model, toks, mesh), logits,
                               rtol=0, atol=LOGIT_TOL)


def test_one_row_decode_replicates_over_data():
    cfg = TC.get_smoke_config("gemma2-2b")
    model = TM.init_params(0, cfg, device="cpu")
    batch = {"tokens": torch.arange(1, 10, dtype=torch.int32)[None]}
    want = TM.greedy_generate(model, batch, cfg, max_new=5, max_len=16)
    got = TM.greedy_generate(model, batch, cfg, max_new=5, max_len=16,
                             mesh=mesh_of(4, 2))
    assert torch.equal(got, want)


# ----------------------------------------------------------------- (c)
MESHES = {"4x2": mesh_of(4, 2), "2x4": mesh_of(2, 4),
          "2x2x2": Mesh(("pod", "data", "model"), (2, 2, 2),
                        (torch.device("cpu"),) * 8)}
SPECS = [(), (None, None), ("data", None), (None, "model"),
         ("model", "data"), (("data", "model"), None),
         (("pod", "data"), "model")]


ROUND_TRIPS = [(m, s) for m in MESHES for s in SPECS
               if all(a in MESHES[m].axis_names
                      for e in s for a in spmd.axes_of(e))]


@pytest.mark.parametrize("mesh,spec", ROUND_TRIPS, ids=str)
def test_shard_gather_round_trip(mesh, spec):
    m = MESHES[mesh]
    x = torch.randn(16, 8) if spec else torch.randn(())
    placed = TSH.shard(x, spec, m)
    assert len(placed.shards) == m.size
    assert placed.shape == x.shape
    assert sum(t.numel() for t in placed.shards) == \
        x.numel() * m.size // TSH.shard_factor(spec, m)
    assert torch.equal(TSH.gather(placed), x)
    assert torch.equal(TSH.gather(placed.shards, spec, m), x)
    moved = TSH.constraint(placed, m, (None,) * x.ndim)
    assert all(torch.equal(t, x) for t in moved.shards)
    assert TSH.constraint(x, None, spec) is x


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
@pytest.mark.parametrize("arch", ["smollm-135m", "mixtral-8x22b",
                                  "qwen1.5-110b", "recurrentgemma-9b",
                                  "mamba2-780m", "whisper-small"])
def test_resident_bytes_equal_the_dry_run_plan(arch, mesh, int8,
                                               monkeypatch):
    m = MESHES[mesh]
    cfg = TC.get_smoke_config(arch)
    full = TC.get_config
    monkeypatch.setattr(TC, "get_config", lambda a: TC.reduced(full(a)))
    _, args, plans, _, _ = TS.build_cell(arch, "train_4k", m)
    ocfg = TS.opt_config(cfg, quantize_moments=int8)
    meta_opt = TA.init(ocfg, dict(args[0].named_parameters()))
    want_p = dryrun.planned_bytes(dict(args[0].named_parameters()),
                                  plans[0], m)
    want_o = dryrun.planned_bytes(meta_opt, TS.opt_state_shardings(
        meta_opt, plans[0], m), m)
    if not int8:
        row = dryrun.run_cell(arch, "train_4k", m)
        assert (row["params_bytes"], row["opt_bytes"]) == (want_p, want_o)
    model = TM.shard_model(TM.init_params(0, cfg, device="cpu"), m)
    params = dict(model.named_parameters())
    state = TA.init(ocfg, params)
    for p in range(m.size):
        assert spmd.resident_bytes(params, p) == want_p
        assert spmd.resident_bytes(state, p) == want_o


@pytest.mark.parametrize("last", [512, 96, 1000])
@pytest.mark.parametrize("spec", [(None, "model"), ("data", "model"),
                                  (("data", "model"), None),
                                  (None, ("data", "model"))], ids=str)
def test_int8_quantization_keeps_whole_leaf_blocks(spec, last):
    """512 over 4 positions is whole blocks (each quantizes its own, the
    scales gathered); 96 and 1000 are not (the leaf gathered first)."""
    m = MESHES["2x4"]
    x = torch.randn(8, last)
    q, s = TA._quantize(x)
    placed = TSH.shard(x, spec, m)
    qs, ss = TA._quantize_shards(placed.shards, spec, tuple(x.shape), m)
    assert torch.equal(TSH.gather(qs, spec, m), q)
    scale_spec = TA._scale_spec(spec)
    assert torch.equal(TSH.gather(ss, scale_spec, m), s)
    back = TA._dequantize_shards(qs, ss, spec, tuple(x.shape), m)
    assert torch.equal(TSH.gather(back, spec, m),
                       TA._dequantize(q, s, x.shape))


# ----------------------------------------------------------------- (d)
GROUP_MESHES = [Mesh(("data", "model"), (4, 2)),
                Mesh(("data", "model"), (2, 4)),
                Mesh(("data", "model"), (1, 8)),
                Mesh(("pod", "data", "model"), (2, 16, 16)),
                Mesh(("data", "model"), (64, 4))]


@pytest.mark.parametrize("groups", [None, 4, 3])
@pytest.mark.parametrize("mesh", range(len(GROUP_MESHES) + 1),
                         ids=["4x2", "2x4", "1x8", "2x16x16", "64x4",
                              "none"])
def test_n_token_groups_matches_reference(mesh, groups):
    m = GROUP_MESHES[mesh] if mesh < len(GROUP_MESHES) else None
    for arch in ("mixtral-8x22b", "arctic-480b"):
        rcfg, tcfg = (_pinned(mod.get_smoke_config(arch), groups)
                      for mod in (RC, TC))
        for t in (1, 6, 8, 32, 96, 4096, 24 * 512):
            assert TMOE.n_token_groups(tcfg, t, m) == \
                RMOE.n_token_groups(rcfg, m, t), (arch, t)


@pytest.mark.parametrize("seq_shard", [False, True], ids=["plain", "seq"])
@pytest.mark.parametrize("mesh", range(len(GROUP_MESHES) - 1),
                         ids=["4x2", "2x4", "1x8", "2x16x16"])
def test_activation_spec_matches_reference(mesh, seq_shard):
    """Where the batch divides the batch axes (the reference's pin needs
    it), the port's placement is the reference's (an entry naming only
    axes of size 1 places nothing); where it does not, the port's batch
    replicates."""
    from repro.models import transformer as RT
    m = GROUP_MESHES[mesh]
    rcfg, tcfg = (dataclasses.replace(mod.get_smoke_config("smollm-135m"),
                                      seq_shard=seq_shard)
                  for mod in (RC, TC))

    def norm(spec):
        return tuple(tuple(spmd.axes_of(e)) if spmd.size(m, e) > 1
                     else None for e in spec)

    for b, s in ((64, 32), (32, 30), (64, 1)):
        x = np.zeros((b, s, 4), np.float32)
        assert norm(TM.transformer.activation_spec(tcfg, m, x)) == \
            norm(RT.activation_spec(rcfg, m, x)), (b, s)
    assert TM.transformer.activation_spec(tcfg, m, np.zeros((3, 8, 4)))[0] \
        is None


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
def test_unpinned_groups_follow_the_mesh(shape):
    """With ``dispatch_groups=None`` a mesh groups by its batch degree:
    the sharded forward equals an unsharded one pinned to that degree."""
    cfg = TC.get_smoke_config("arctic-480b")
    model = TM.init_params(4, cfg, device="cpu")
    x = {"tokens": torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, 16)).astype(np.int32))}
    got, _, aux = TM.forward(model, x, cfg, mesh=mesh_of(*shape))
    want, _, aux_w = TM.forward(model, x, _pinned(cfg, shape[0]))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(aux.item(), aux_w.item(), rtol=1e-5)


# ----------------------------------------------------------------- (f)
@functools.lru_cache(maxsize=None)
def _whole_run():
    cfg = TC.get_smoke_config("smollm-135m")
    ocfg = TA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12,
                          weight_decay=0.0)
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=S, global_batch=B)
    return cfg, ocfg, data, train(cfg, ocfg, data, steps=8, device="cpu",
                                  log_every=0).losses


@pytest.mark.parametrize("saved,resumed", [((4, 2), None), (None, (2, 4)),
                                           ((4, 2), (2, 4))],
                         ids=["4x2-none", "none-2x4", "4x2-2x4"])
def test_checkpoint_resumes_on_another_mesh(saved, resumed, tmp_path):
    cfg, ocfg, data, whole = _whole_run()
    first = train(cfg, ocfg, data, steps=4, ckpt_dir=str(tmp_path),
                  ckpt_every=4, device="cpu",
                  mesh=saved and mesh_of(*saved), log_every=0)
    rest = train(cfg, ocfg, data, steps=8, ckpt_dir=str(tmp_path),
                 ckpt_every=4, device="cpu",
                 mesh=resumed and mesh_of(*resumed), log_every=0)
    assert rest.restored_from == 4 and len(rest.losses) == 4
    np.testing.assert_allclose(first.losses + rest.losses, whole,
                               rtol=1e-5)


def test_collective_counts():
    """One sharded step of the smoke smollm-135m on a (4, 2) mesh moves
    what the ring model says: the fsdp gathers' adjoints move what the
    gathers did, and the first collective (the embedding's all-reduce
    over ``model``) moves 2 (2 - 1) B S d elements over 4 groups."""
    cfg = TC.get_smoke_config("smollm-135m")
    tree, opt, x = _own_inputs(cfg)
    spmd.reset_counts()
    _port_step(cfg, tree, opt, x, mesh_of(4, 2))
    got = spmd.counts()
    assert got["all_gather"] == got["all_gather.grad"] > 0
    assert got["all_reduce"] > got["all_reduce.grad"] > 0
    spmd.reset_counts()
    model = params_from_numpy(cfg, tree, mesh=mesh_of(4, 2))
    ctx = TL.MeshCtx(model.mesh, cfg, B, S)
    toks = spmd.shard(torch.from_numpy(x["tokens"]), (("data",), None),
                      model.mesh)
    TL.embed_tokens_sharded(TL.gather_fsdp(model, "embed."), toks, cfg, ctx)
    d = cfg.d_model
    assert spmd.counts()["all_reduce"] == 4 * 2 * (2 - 1) * (B // 4) * S * d
    assert parse_mesh("2x4") == (4, 2)
