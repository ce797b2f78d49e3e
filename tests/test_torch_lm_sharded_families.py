"""The ``rec``, ``ssm`` and ``encdec`` families run sharded over a local
mesh in one process (``mesh=`` on the port's entry points), on the CPU
with every position on the one CPU device, at the smoke configs of
recurrentgemma-9b (RG-LRU units, a local-attention layer with one KV
head, a ``tail`` of two RG-LRU layers), mamba2-780m (SSD units) and
whisper-small (a bidirectional encoder, learned positions,
cross-attention):

  (a) one ``make_train_step`` step on a (data=4, model=2) and a (2, 4)
      mesh against the unsharded step at ``SHARD_TOL`` (loss and grad
      norm relative, each moment leaf against its largest entry, each
      parameter absolute), from the port's seeded weights (zero leaves
      perturbed) and seeded non-zero moments; ``seq_shard`` on for
      recurrentgemma and mamba2, and remat on, as extra cases;
  (b) greedy serving through ``BatchServer(mesh=)`` on ragged,
      left-padded prompts: the tokens equal the unsharded server's, and
      prefill's and every decode step's logits within 1e-5 of the
      unsharded ones (whisper with seeded frames, its cross K/V placed by
      ``launch/specs.cache_shardings``); a one-row generate (the batch
      replicates over ``data``); meshes along which the plan splits less
      (a model axis of 16 or 3) and mamba2 with two B/C groups, forward
      and greedy tokens;
  (c) the sharded forward against the reference's unsharded forward on
      the reference's weights, through numpy, at the bar of
      ``tests/test_torch_lm_models.py`` (rtol = atol = 2e-4);
  (d) the SSM's plan slices that do not follow its heads: ``in_proj``'s
      columns across the z | xBC | dt boundaries and the conv cache's
      channels round trip bit for bit, and a decode step's conv window
      kept by the positions gathers to the unsharded one within 1e-6;
  (e) each position's cache bytes (and whisper's cross K/V bytes) equal
      to ``launch.dryrun.planned_bytes`` of ``cache_shardings``' plan;
  (f) a mamba2 checkpoint saved on a (4, 2) mesh resumes on none with
      the losses of an uninterrupted unsharded run (rtol 1e-5); the SSM
      layer's collectives move what its shapes say.

The unsharded results are computed once a case (module-scoped)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.data.pipeline import SyntheticMarkov
from repro_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.launch import dryrun
from repro_torch.launch import serve as TSV
from repro_torch.launch import specs as TS
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TSSM
from repro_torch.optim import adamw as TA
from repro_torch.runtime import spmd
from repro_torch.utils import sharding as TSH

ARCHS = ["recurrentgemma-9b", "mamba2-780m", "whisper-small"]
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=4, weight_decay=0.0)
B, S = 8, 32
SHARD_TOL = dict(loss=1e-5, moments=1e-5, params=1e-5)
LOGIT_TOL = 1e-5
#: the bar of tests/test_torch_lm_models.py
REF_TOL = dict(rtol=2e-4, atol=2e-4)
PROMPTS = (24, 17, 31, 8)
NEW = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The sharded runs launch many small operations a position; on one
    intra-op thread they take about as long, and leave the cores to the
    test processes running beside this one (a pool of threads waiting
    between small operations holds every core)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mesh_of(data, model):
    return make_local_mesh(model, data, device="cpu")


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _frames(cfg, rows, seed):
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)


# ----------------------------------------------------------------- (a)
def _own_inputs(cfg, seed=3, rows=B):
    """The port's seeded weights (zero leaves perturbed, so biases, norm
    scales and the SSM's per-head leaves carry values), seeded non-zero
    moments at step 5 and a batch (whisper's with seeded frames)."""
    model = TM.init_params(seed, cfg, device="cpu")
    tree = params_to_numpy(cfg, model)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: a if np.abs(a).max() > 0 else (
        0.05 * rng.standard_normal(a.shape)).astype(a.dtype), tree)
    opt = {"step": np.asarray(5, np.int32),
           "m": jax.tree.map(lambda a: (1e-3 * rng.standard_normal(
               a.shape)).astype(np.float32), tree),
           "v": jax.tree.map(lambda a: (1e-6 * rng.random(a.shape) + 1e-8
                                        ).astype(np.float32), tree)}
    x = {"tokens": rng.integers(0, cfg.vocab, (rows, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (rows, S)).astype(np.int32)}
    x["labels"][0, :5] = -1
    if cfg.family == "encdec":
        x["frames"] = _frames(cfg, rows, seed)
    return tree, opt, x


def _port_step(cfg, tree, opt_np, x, mesh):
    """The port's step from numpy inputs -> (params, opt state, metrics)
    as numpy trees and floats."""
    model = params_from_numpy(cfg, tree, device="cpu", mesh=mesh)
    state = opt_state_from_numpy(cfg, opt_np, device="cpu", mesh=mesh)
    step = TS.make_train_step(cfg, TA.AdamWConfig(**OPT), mesh=mesh)
    model, state, metrics = step(model, state,
                                 {k: torch.from_numpy(v)
                                  for k, v in x.items()})
    return (params_to_numpy(cfg, model), opt_state_to_numpy(cfg, state),
            {k: float(v) for k, v in metrics.items()})


def _assert_matches_unsharded(got, want):
    (p_g, o_g, m_g), (p_w, o_w, m_w) = got, want
    assert set(m_g) == set(m_w)
    for k in ("loss", "grad_norm"):
        assert abs(m_g[k] - m_w[k]) <= SHARD_TOL["loss"] * abs(m_w[k]), k
    for a, b in zip(_leaves(p_g), _leaves(p_w)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= SHARD_TOL["params"]
    for key in ("m", "v"):
        for a, b in zip(_leaves(o_g[key]), _leaves(o_w[key])):
            assert np.abs(a - b).max() <= SHARD_TOL["moments"] * max(
                np.abs(b).max(), 1e-30), key


@functools.lru_cache(maxsize=None)
def _unsharded_step(arch, change):
    cfg = dataclasses.replace(TC.get_smoke_config(arch), **dict(change))
    tree, opt, x = _own_inputs(cfg)
    return cfg, tree, opt, x, _port_step(cfg, tree, opt, x, None)


#: (id, arch, mesh, config change)
STEP_CASES = [(f"{a}-{m}", a, m, ()) for a in ARCHS for m in MESHES] + [
    ("recurrentgemma-seq", "recurrentgemma-9b", "4x2",
     (("seq_shard", True),)),
    ("mamba2-seq", "mamba2-780m", "4x2", (("seq_shard", True),)),
    ("recurrentgemma-remat", "recurrentgemma-9b", "2x4",
     (("remat", "full"),)),
    ("whisper-remat", "whisper-small", "4x2", (("remat", "full"),)),
]


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_sharded_step_matches_unsharded(case):
    _, arch, mesh, change = case
    cfg, tree, opt, x, want = _unsharded_step(arch, change)
    got = _port_step(cfg, tree, opt, x, mesh_of(*MESHES[mesh]))
    _assert_matches_unsharded(got, want)
    assert got[1]["step"].item() == want[1]["step"].item()


# ----------------------------------------------------------------- (b)
def _requests(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [TSV.Request(prompt=rng.integers(0, vocab, size=n
                                            ).astype(np.int32),
                        max_new=NEW) for n in PROMPTS]


def _replay(cfg, model, toks, mesh):
    """Prefill of the left-padded prompts (whisper's with seeded frames)
    and a decode step for each of ``toks``' columns: the logits a
    step."""
    s_max = max(PROMPTS)
    batch = np.zeros((len(PROMPTS), s_max), np.int32)
    for i, r in enumerate(_requests(cfg.vocab)):
        batch[i, s_max - len(r.prompt):] = r.prompt
    batch = {"tokens": torch.from_numpy(batch)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(cfg, len(PROMPTS), 9))
    cache = TM.init_cache(cfg, len(PROMPTS), 64, "cpu", mesh=mesh)
    with torch.no_grad():
        last, cache, extras = TM.prefill(model, batch, cfg, cache, mesh=mesh)
        out = [last]
        for i in range(toks.shape[1]):
            last, cache = TM.decode_step(
                model, torch.from_numpy(toks[:, i:i + 1]), s_max + i, cfg,
                cache, extras=extras, mesh=mesh)
            out.append(last)
    return torch.stack(out, dim=1).numpy()


@functools.lru_cache(maxsize=None)
def _served(arch):
    cfg = TC.get_smoke_config(arch)
    tree, _, _ = _own_inputs(cfg, seed=5)
    model = params_from_numpy(cfg, tree, device="cpu")
    out = TSV.BatchServer(cfg, model, max_len=64).serve(
        _requests(cfg.vocab))
    toks = np.stack([r.out for r in out])
    return cfg, tree, toks, _replay(cfg, model, toks, None)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_matches_unsharded(arch, mesh):
    cfg, tree, toks, logits = _served(arch)
    m = mesh_of(*MESHES[mesh])
    model = params_from_numpy(cfg, tree, mesh=m)
    got = TSV.BatchServer(cfg, model, max_len=64, mesh=m).serve(
        _requests(cfg.vocab))
    np.testing.assert_array_equal(np.stack([r.out for r in got]), toks)
    np.testing.assert_allclose(_replay(cfg, model, toks, m), logits,
                               rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_row_generate_replicates_over_data(arch):
    cfg = TC.get_smoke_config(arch)
    model = TM.init_params(0, cfg, device="cpu")
    batch = {"tokens": torch.arange(1, 10, dtype=torch.int32)[None]}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(cfg, 1, 4))
    want = TM.greedy_generate(model, batch, cfg, max_new=5, max_len=16)
    got = TM.greedy_generate(model, batch, cfg, max_new=5, max_len=16,
                             mesh=mesh_of(4, 2))
    assert torch.equal(got, want)


#: (arch, mesh, config change): a model axis of 16, along which the smoke
#: mamba2's 8 heads and 296 in_proj columns do not split while its d_in
#: rows and conv channels do (and recurrentgemma's 64 channels split 4 a
#: position); a model axis of 3, along which almost nothing splits (the
#: plan replicates); mamba2 with two B/C groups, each position's heads
#: taking their own group
ODD_CASES = [(a, (1, 16), ()) for a in ARCHS] + \
    [(a, (2, 3), ()) for a in ARCHS] + \
    [("mamba2-780m", (2, 4), (("ssm_groups", 2),))]


@pytest.mark.parametrize("case", ODD_CASES,
                         ids=[f"{a}-{d}x{m}{'-g2' if c else ''}"
                              for a, (d, m), c in ODD_CASES])
def test_sharded_where_the_plan_splits_less(case):
    arch, shape, change = case
    cfg = TC.get_smoke_config(arch)
    if change:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=dict(change)["ssm_groups"]))
    model = TM.init_params(6, cfg, device="cpu")
    x = {"tokens": torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (4, 12)).astype(np.int32))}
    if cfg.family == "encdec":
        x["frames"] = torch.from_numpy(_frames(cfg, 4, 6))
    m = mesh_of(*shape)
    want = TM.forward(model, x, cfg)[0]
    got = TM.forward(model, x, cfg, mesh=m)[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=LOGIT_TOL)
    toks = TM.greedy_generate(model, x, cfg, max_new=4, max_len=16)
    assert torch.equal(TM.greedy_generate(model, x, cfg, max_new=4,
                                          max_len=16, mesh=m), toks)


# ----------------------------------------------------------------- (c)
@pytest.mark.parametrize("arch,mesh", [("recurrentgemma-9b", "2x4"),
                                       ("mamba2-780m", "4x2"),
                                       ("whisper-small", "2x4")])
def test_sharded_forward_matches_reference(arch, mesh):
    rcfg = RC.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(jax.random.PRNGKey(0), rcfg))
    rng = np.random.default_rng(1)
    x = {"tokens": rng.integers(0, rcfg.vocab, (B, 12)).astype(np.int32)}
    if rcfg.family == "encdec":
        x["frames"] = _frames(rcfg, B, 1)
    want = np.asarray(jax.jit(RM.forward, static_argnums=2)(
        tree, {k: jax.numpy.asarray(v) for k, v in x.items()}, rcfg)[0])
    cfg = TC.get_smoke_config(arch)
    m = mesh_of(*MESHES[mesh])
    model = params_from_numpy(cfg, tree, mesh=m)
    got = TM.forward(model, {k: torch.from_numpy(v) for k, v in x.items()},
                     cfg, mesh=m)[0]
    np.testing.assert_allclose(got.numpy(), want, **REF_TOL)


# ----------------------------------------------------------------- (d)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_ssm_misaligned_slices_round_trip(mesh):
    """At the smoke config ``in_proj`` (64, 296) splits into 148 or 74
    columns a position against z's 128, and the conv cache's 160 channels
    into 80 or 40 against heads of 16: each position's slices are the
    plan's and the gathers give the whole back bit for bit; the conv
    window and the state a decode step leaves on the positions gather to
    the unsharded ones within 1e-6 (the window holds in_proj's outputs,
    whose column blocks the CPU's matmul rounds apart from the whole
    product's in the last bit)."""
    m = mesh_of(*MESHES[mesh])
    cfg = TC.get_smoke_config("mamba2-780m")
    model = TM.init_params(2, cfg, device="cpu")
    sm = TM.shard_model(model, m)
    name = "units.0.l0.ssm.in_proj"
    whole = model.get_parameter(name)
    cols = whole.shape[1] // m.shape["model"]
    for p, t in enumerate(sm.shards(name)):
        mi = spmd.coord(m, p, "model")
        rows = whole.shape[0] // m.shape["data"]
        di = spmd.coord(m, p, "data")
        assert torch.equal(t, whole[di * rows:(di + 1) * rows,
                                    mi * cols:(mi + 1) * cols])
    assert torch.equal(TSH.gather(sm.shards(name), sm.specs[name], m), whole)

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (4, 6)).astype(np.int32))
    cache = TM.init_cache(cfg, 4, 16, "cpu")
    scache = TM.init_cache(cfg, 4, 16, mesh=m)
    with torch.no_grad():
        _, cache, _ = TM.prefill(model, {"tokens": toks[:, :5]}, cfg, cache)
        _, scache, _ = TM.prefill(sm, {"tokens": toks[:, :5]}, cfg, scache,
                                  mesh=m)
        _, cache = TM.decode_step(model, toks[:, 5:], 5, cfg, cache)
        _, scache = TM.decode_step(sm, toks[:, 5:], 5, cfg, scache, mesh=m)
    plan = scache.plan["units"][0]["l0"]
    for key in ("conv", "state"):
        got = TSH.gather([c["units"][0]["l0"][key] for c in
                          scache.positions], plan[key], m)
        torch.testing.assert_close(got, cache["units"][0]["l0"][key],
                                   rtol=0, atol=1e-6)
    conv = cache["units"][0]["l0"]["conv"]
    placed = TSH.shard(conv, plan["conv"], m)
    assert all(t.shape[-1] == conv.shape[-1] // m.shape["model"]
               for t in placed.shards)
    assert torch.equal(TSH.gather(placed), conv)


# ----------------------------------------------------------------- (e)
def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in TS._walk(tree))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes_equal_the_dry_run_plan(arch, mesh):
    m = mesh_of(*MESHES[mesh])
    cfg = TC.get_smoke_config(arch)
    rows, max_len = 8, 64
    meta = TM.init_cache(cfg, rows, max_len, TM.META)
    want = dryrun.planned_bytes(meta, TS.cache_shardings(meta, cfg, m), m)
    cache = TM.init_cache(cfg, rows, max_len, mesh=m)
    assert [_bytes(c) for c in cache.positions] == [want] * m.size
    if cfg.family != "encdec":
        return
    model = TM.init_params(0, cfg, device="cpu")
    batch = {"tokens": torch.ones((rows, 4), dtype=torch.int32),
             "frames": torch.from_numpy(_frames(cfg, rows, 2))}
    with torch.no_grad():
        _, _, extras = TM.prefill(model, batch, cfg, cache, mesh=m)
    mem = extras["memory_kv"]
    meta_kv = {"memory_kv": [{k: torch.empty(
        (rows, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim_), device=TM.META)
        for k in ("k", "v")} for _ in range(cfg.n_units)]}
    want = dryrun.planned_bytes(meta_kv, TS.cache_shardings(meta_kv, cfg, m),
                                m)
    assert [_bytes(p) for p in mem.positions] == [want] * m.size


# ----------------------------------------------------------------- (f)
def test_mamba2_checkpoint_resumes_without_a_mesh(tmp_path):
    cfg = TC.get_smoke_config("mamba2-780m")
    ocfg = TA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12,
                          weight_decay=0.0)
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=S, global_batch=B)
    whole = train(cfg, ocfg, data, steps=6, device="cpu",
                  log_every=0).losses
    first = train(cfg, ocfg, data, steps=3, ckpt_dir=str(tmp_path),
                  ckpt_every=3, device="cpu", mesh=mesh_of(4, 2),
                  log_every=0)
    rest = train(cfg, ocfg, data, steps=6, ckpt_dir=str(tmp_path),
                 ckpt_every=3, device="cpu", log_every=0)
    assert rest.restored_from == 3 and len(rest.losses) == 3
    np.testing.assert_allclose(first.losses + rest.losses, whole,
                               rtol=1e-5)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ssm_collective_counts(mesh):
    """One SSM layer on a (data, model) mesh, a batch of b rows and s
    tokens: the in_proj gather moves (m - 1) b s d_proj elements (each of
    the data groups' m positions receives the other m - 1 slices of its
    b / data rows), the norm's sums of squares 2 (m - 1) b s; a decode
    step's conv window gather (m - 1) b (K - 1) conv_dim more."""
    data, model_axis = MESHES[mesh]
    m = mesh_of(data, model_axis)
    cfg = TC.get_smoke_config("mamba2-780m")
    d_in, nh, conv_dim = TSSM._dims(cfg)
    d_proj = d_in + conv_dim + nh
    sm = TM.shard_model(TM.init_params(1, cfg, device="cpu"), m)
    ps = TL.gather_fsdp(sm, "units.0.l0.ssm.")
    ctx = TL.MeshCtx(m, cfg, B, S)
    xs = spmd.shard(torch.randn(B, S, cfg.d_model), (("data",), None, None),
                    m)
    k = cfg.ssm.conv_width
    for cached in (False, True):
        caches = None
        if cached:
            caches = TM.init_cache(cfg, B, S, mesh=m).positions
            caches = [c["units"][0]["l0"] for c in caches]
        spmd.reset_counts()
        with torch.no_grad():
            TSSM.apply_ssm_sharded(ps, xs, cfg, ctx, caches)
        want = (model_axis - 1) * B * S * d_proj
        if cached:
            want += (model_axis - 1) * B * (k - 1) * conv_dim
        assert spmd.counts() == {
            "all_gather": want, "all_reduce": 2 * (model_axis - 1) * B * S}
