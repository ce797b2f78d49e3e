"""The port's training path against the reference's on the CPU, at every
architecture's smoke config (``get_smoke_config``):

  * ``train_loss`` and its metrics within the reference's MoE bar, rtol =
    atol = 2e-4 (``tests/test_moe.py``), and every gradient leaf within
    atol = 2e-5 x the largest gradient entry of the whole model (a key
    bias's true gradient is zero -- softmax cancels it -- so both packages
    hold rounding noise there, and a leaf's own scale says nothing);
  * one ``make_train_step`` step, at ``accum_steps`` 1 and 4, from the
    same parameters and the same non-zero moments (``interop``), loss,
    metrics, parameters and moments after the step within the bar of the
    reference's own step test, rtol = 5e-4, atol = 5e-6
    (``tests/test_grad_accum.py``);
  * the port's ``train()`` of the smoke smollm-135m for 12 steps from the
    reference's initial weights (a step-0 checkpoint) against the
    reference's ``train()``, loss for loss within rtol 1e-5 (measured:
    1.5e-7 at most);
  * remat (``cfg.remat == "full"``) against none, gradient for gradient;
  * kill-and-restart bit for bit, resume from the latest step, and
    preemption, within the port (the reference's
    ``tests/test_fault_restart.py`` cases).

The reference's results are computed once an architecture (jitted) and
shared by the cases."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data.pipeline import SyntheticMarkov as RMarkov
from repro.launch import specs as RS
from repro.launch.train import train as rtrain
from repro.models import model as RM
from repro.optim import adamw as RA
from repro_torch import configs as TC
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticMarkov
from repro_torch.interop import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.launch import specs as TS
from repro_torch.launch.train import train
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.runtime.fault import (PreemptionHandler, SimulatedFailure,
                                       run_with_restarts)

ARCHS = list(RC.ARCHS)
B, S = 4, 16
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_ATOL = 2e-5
STEP_TOL = dict(rtol=5e-4, atol=5e-6)
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
#: (arch, accum_steps) of the step cases: every arch at one microbatch,
#: a dense and an MoE model at four
STEPS = [(a, 1) for a in ARCHS] + [("smollm-135m", 4),
                                   ("mixtral-8x22b", 4)]


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    x = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    x["labels"][0, :3] = -1          # unlabelled positions
    if cfg.family == "encdec":
        x["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        x["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return x


def _moments(tree, seed=2):
    """A reference AdamW state at step 5 with non-zero moments: from zero
    moments a first step moves each parameter by +-lr whatever the size of
    its gradient, so the comparison would hinge on the sign of gradients
    that are rounding noise."""
    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: (1e-3 * rng.standard_normal(a.shape)
                                ).astype(np.float32), tree)
    v = jax.tree.map(lambda a: (1e-6 * rng.random(a.shape) + 1e-8
                                ).astype(np.float32), tree)
    return {"step": np.asarray(5, np.int32), "m": m, "v": v}


def _reference_step(cfg, tree, x, accum):
    """The reference's ``make_train_step`` (jitted) from ``tree`` and
    ``_moments`` on batch ``x`` -> (params, opt_state, metrics), numpy
    leaves."""
    step = RS.make_train_step(cfg, RA.AdamWConfig(**OPT), accum_steps=accum)
    out = jax.jit(step)(jax.tree.map(jnp.asarray, tree),
                        jax.tree.map(jnp.asarray, _moments(tree)),
                        {k: jnp.asarray(v) for k, v in x.items()})
    return jax.tree.map(np.asarray, out)


def _reference(arch):
    """The reference's loss, metrics and gradients (one compile), and its
    one-microbatch step: ``make_train_step`` at ``accum_steps=1`` is
    ``value_and_grad`` then ``adamw.update``, so the step is the
    reference's own ``update`` of these gradients."""
    cfg = RC.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(jax.random.PRNGKey(0), cfg))
    x = _inputs(cfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.train_loss(p, b, cfg), has_aux=True))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in x.items()})
    params, opt, om = jax.jit(functools.partial(
        RA.update, RA.AdamWConfig(**OPT)))(
            grads, jax.tree.map(jnp.asarray, _moments(tree)),
            jax.tree.map(jnp.asarray, tree))
    step = jax.tree.map(np.asarray,
                        (params, opt, {**metrics, **om, "loss": loss}))
    return {"cfg": cfg, "tree": tree, "x": x, "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": jax.tree.map(np.asarray, grads), "step": {1: step}}


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _reference(arch)
        return cache[arch]
    return get


def _batch(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _port_grads(cfg, model, batch):
    model.requires_grad_(True)
    loss, metrics = TM.train_loss(model, batch, cfg)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, metrics, dict(zip(named, grads))


class _Named:
    """A stand-in module over named tensors, for ``params_to_numpy``."""

    def __init__(self, named):
        self._named = named

    def named_parameters(self):
        return self._named.items()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, reference):
    ref = reference(arch)
    cfg = TC.get_smoke_config(arch)
    model = params_from_numpy(cfg, ref["tree"], device="cpu")
    loss, metrics, grads = _port_grads(cfg, model, _batch(ref["x"]))
    np.testing.assert_allclose(loss.item(), ref["loss"], **LOSS_TOL)
    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[k].detach().item(), want,
                                   **LOSS_TOL)
    got = params_to_numpy(cfg, _Named({n: g.detach()
                                       for n, g in grads.items()}))
    want = ref["grads"]
    scale = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_ATOL * scale,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b",
                                  "whisper-small"])
def test_remat_gives_the_same_gradients(arch, reference):
    """Each unit (and each enc-dec layer) recomputed in the backward pass
    gives the gradients of the plain forward, bit for bit on the CPU."""
    ref = reference(arch)
    cfg = TC.get_smoke_config(arch)
    assert cfg.remat == "none"
    full = dataclasses.replace(cfg, remat="full")
    batch = _batch(ref["x"])
    _, _, plain = _port_grads(
        cfg, params_from_numpy(cfg, ref["tree"], device="cpu"), batch)
    _, _, remat = _port_grads(
        full, params_from_numpy(full, ref["tree"], device="cpu"), batch)
    for n, g in plain.items():
        assert torch.equal(g, remat[n]), n


def _assert_trees_close(got, want, what):
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(
            np.asarray(g), np.asarray(w), **STEP_TOL,
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("arch,accum", STEPS,
                         ids=[f"{a}-accum{k}" for a, k in STEPS])
def test_train_step_matches_reference(arch, accum, reference):
    ref = reference(arch)
    if accum not in ref["step"]:
        ref["step"][accum] = _reference_step(ref["cfg"], ref["tree"],
                                             ref["x"], accum)
    r_params, r_opt, r_metrics = ref["step"][accum]

    cfg = TC.get_smoke_config(arch)
    model = params_from_numpy(cfg, ref["tree"], device="cpu")
    opt = opt_state_from_numpy(cfg, _moments(ref["tree"]), device="cpu")
    step = TS.make_train_step(cfg, TA.AdamWConfig(**OPT), accum_steps=accum)
    model, opt, metrics = step(model, opt, _batch(ref["x"]))
    assert set(metrics) == set(r_metrics)
    for k, want in r_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(want),
                                   **STEP_TOL, err_msg=k)
    _assert_trees_close(params_to_numpy(cfg, model), r_params, "params")
    got_opt = opt_state_to_numpy(cfg, opt)
    assert got_opt["step"].item() == r_opt["step"].item() == 6
    _assert_trees_close(got_opt["m"], r_opt["m"], "m")
    _assert_trees_close(got_opt["v"], r_opt["v"], "v")


def _smollm_setup(name, tmp_path):
    cfg = TC.get_smoke_config("smollm-135m")
    opt_cfg = TA.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12,
                             weight_decay=0.0)
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=16, global_batch=2,
                           seed=3)
    return cfg, opt_cfg, data, str(tmp_path / name)


def test_train_matches_reference_losses(tmp_path, reference):
    """Both trainers from the reference's initial weights (the port's
    resumes from a step-0 checkpoint of them) on the same stateless data:
    12 losses within rtol 1e-5."""
    ref = reference("smollm-135m")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=12, weight_decay=0.0)
    want = rtrain(ref["cfg"], RA.AdamWConfig(**kw),
                  RMarkov(vocab=ref["cfg"].vocab, seq_len=16,
                          global_batch=2, seed=3),
                  steps=12, log_every=0).losses
    cfg, opt_cfg, data, d = _smollm_setup("from_reference", tmp_path)
    params = dict(params_from_numpy(cfg, ref["tree"],
                                    device="cpu").named_parameters())
    CheckpointManager(d).save(0, {"params": params,
                                  "opt": TA.init(opt_cfg, params)})
    res = train(cfg, opt_cfg, data, steps=12, ckpt_dir=d, ckpt_every=100,
                log_every=0, device="cpu")
    assert res.restored_from == 0 and len(res.losses) == 12
    np.testing.assert_allclose(res.losses, want, rtol=1e-5)


def _final_params(cfg, opt_cfg, ckpt_dir):
    like = dict(TM.build_model(cfg, torch.device("cpu"),
                               None).named_parameters())
    opt = TA.init(opt_cfg, like)
    return CheckpointManager(ckpt_dir).restore(
        {"params": like, "opt": opt})["params"]


def test_kill_and_restart_is_bit_exact(tmp_path):
    cfg, opt_cfg, data, d1 = _smollm_setup("uninterrupted", tmp_path)
    train(cfg, opt_cfg, data, steps=12, ckpt_dir=d1, ckpt_every=4,
          log_every=0, device="cpu")
    clean = _final_params(cfg, opt_cfg, d1)

    d2 = str(tmp_path / "interrupted")
    calls = {"n": 0}

    def make_run():
        calls["n"] += 1
        # the first attempt dies after step 6 (last checkpoint at step 4)
        fail_at = 6 if calls["n"] == 1 else None
        return train(cfg, opt_cfg, data, steps=12, ckpt_dir=d2,
                     ckpt_every=4, fail_at=fail_at, log_every=0,
                     device="cpu").step

    assert run_with_restarts(make_run, max_restarts=2) == 12
    assert calls["n"] == 2
    restarted = _final_params(cfg, opt_cfg, d2)
    assert set(restarted) == set(clean)
    for name, arr in clean.items():
        np.testing.assert_array_equal(restarted[name], arr, err_msg=name)


def test_restart_resumes_from_latest_step(tmp_path):
    cfg, opt_cfg, data, d = _smollm_setup("resume", tmp_path)
    res1 = train(cfg, opt_cfg, data, steps=8, ckpt_dir=d, ckpt_every=4,
                 log_every=0, device="cpu")
    assert res1.restored_from is None
    res2 = train(cfg, opt_cfg, data, steps=12, ckpt_dir=d, ckpt_every=4,
                 log_every=0, device="cpu")
    assert res2.restored_from == 8
    assert len(res2.losses) == 4 == len(res2.step_seconds)


def test_preemption_checkpoints_and_exits(tmp_path):
    cfg, opt_cfg, data, d = _smollm_setup("preempt", tmp_path)
    handler = PreemptionHandler(install=False)

    def on_step(step, metrics):
        if step == 5:
            handler.request()  # simulated SIGTERM

    res = train(cfg, opt_cfg, data, steps=12, ckpt_dir=d, ckpt_every=100,
                preemption=handler, on_step=on_step, log_every=0,
                device="cpu")
    assert res.step == 6
    assert CheckpointManager(d).latest_step() == 6


def test_simulated_failure_raises_after_its_step(tmp_path):
    cfg, opt_cfg, data, d = _smollm_setup("fail", tmp_path)
    with pytest.raises(SimulatedFailure, match="after step 3"):
        train(cfg, opt_cfg, data, steps=12, ckpt_dir=d, ckpt_every=2,
              fail_at=3, log_every=0, device="cpu")
    assert CheckpointManager(d).latest_step() == 2


def test_trainer_refuses_to_fall_back_without_a_card(monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, opt_cfg, data, _ = _smollm_setup("none", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(cfg, opt_cfg, data, steps=1, log_every=0)


def _recurrence(xh, dt, a, bm, cm):
    """The SSD scan token by token in float64: h_t = exp(dt_t a) h_{t-1}
    + dt_t x_t B_t^T, y_t = h_t C_t (one group)."""
    b, s, h, p = xh.shape
    state = torch.zeros(b, h, p, bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)[..., None, None]
        state = state * decay + (dt[:, t, :, None, None] * xh[:, t, ..., None]
                                 * bm[:, t, 0, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, cm[:, t, 0]))
    return torch.stack(ys, dim=1)


def test_ssd_gradients_stay_finite_where_the_reference_overflows():
    """A chunk whose summed decay passes exp's float32 range (|dt a| up to
    40 a step over 16 steps; mamba2-780m at full width gets there with
    chunks of 128): the reference's where(tri, exp(seg), 0) has NaN
    gradients (0 * inf above the diagonal); the port masks before the exp.
    Forward within 2e-5 of the reference's; gradients finite and within
    1e-4 of a float64 token-by-token recurrence (atol 1e-4 x the largest
    gradient entry: the decay's own gradient is a sum of vanishing terms,
    5 orders below the rest)."""
    from repro.models import ssm as rssm
    from repro_torch.models import ssm as tssm
    rng = np.random.default_rng(0)
    b, s, h, p, n, chunk = 1, 32, 2, 4, 4, 16
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.5, 1.0, (b, s, h)).astype(np.float32)
    a = np.array([-20.0, -40.0], np.float32)
    bm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    r = rng.standard_normal((b, s, h, p)).astype(np.float32)
    args = [jnp.asarray(v) for v in (xh, dt, a, bm, cm)]

    def ref_loss(*xs):
        return jnp.sum(rssm._ssd_chunked(*xs, chunk) * r)

    ref_grads = jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4))(*args)
    assert not all(np.isfinite(np.asarray(g)).all() for g in ref_grads)

    ts_ = [torch.from_numpy(v).requires_grad_(True)
           for v in (xh, dt, a, bm, cm)]
    y = tssm._ssd_chunked(*ts_, chunk)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(rssm._ssd_chunked(*args, chunk)), rtol=2e-5, atol=2e-5)
    got = torch.autograd.grad((y * torch.from_numpy(r)).sum(), ts_)
    ws = [torch.from_numpy(v).double().requires_grad_(True)
          for v in (xh, dt, a, bm, cm)]
    y64 = _recurrence(*ws)
    np.testing.assert_allclose(y.detach().numpy(), y64.detach().numpy(),
                               rtol=1e-4, atol=1e-4)
    want = torch.autograd.grad((y64 * torch.from_numpy(r).double()).sum(),
                               ws)
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * scale)


def test_cross_entropy_matches_reference():
    """The reference's iota-select and the port's gather are one function
    (labels < 0 masked, an all-masked batch 0), within 1e-6."""
    from repro.models import transformer as rt
    from repro_torch.models import transformer as tt
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(-1, 50, (3, 7)).astype(np.int32)
    for lab in (labels, np.full_like(labels, -1)):
        got = tt.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
        want = rt.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-6)
