"""The port's language models against the reference's on the CPU, for
every architecture's smoke config (``get_smoke_config``): the reference's
parameters (``init_params`` from a seed) are carried into the port by
``interop.params_from_numpy``, then

  * ``forward`` logits (llava with its patch prefix, whisper with its
    frames),
  * ``prefill`` of a 12-token prompt (past the smoke configs' window of 8,
    so ring slots are written more than once) and 4 ``decode_step``s,
  * ``generate``, greedy, 6 new tokens,

are held to the reference's MoE bar, rtol = atol = 2e-4
(``tests/test_moe.py``). Greedy tokens are equal up to the first step at
which the reference's two largest logits of a row lie within 2e-4 of each
other (a near tie, where a rounding may pick the other one); from that
step on the tokens are not compared, and the logits are, at every step,
with both packages fed the reference's tokens. The reference's results
are computed once an architecture and shared by its cases."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.models import model as TM

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = list(RC.ARCHS)
B, PROMPT, DECODE, NEW, MAX_LEN = 2, 12, 4, 6, 20


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    x = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT + DECODE)
                                ).astype(np.int32)}
    if cfg.family == "encdec":
        x["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        x["prefix_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return x


def _serving_batch(x, n, to):
    """The first ``n`` tokens (and the frames) as a batch; no patch
    prefix, as the serving path sends none."""
    out = {"tokens": to(x["tokens"][:, :n])}
    if "frames" in x:
        out["frames"] = to(x["frames"])
    return out


def _reference(arch):
    cfg = RC.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        RM.init_params(jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(jnp.asarray, tree)
    x = _inputs(cfg)
    step = jax.jit(RM.decode_step, static_argnums=3)
    prefill = jax.jit(RM.prefill, static_argnums=2)
    res = {"tree": tree, "x": x}
    full = {k: jnp.asarray(v) for k, v in x.items()}
    full["tokens"] = full["tokens"][:, :PROMPT]
    res["forward"] = np.asarray(
        jax.jit(RM.forward, static_argnums=2)(params, full, cfg)[0])

    batch = _serving_batch(x, PROMPT, jnp.asarray)
    cache = RM.init_cache(cfg, B, MAX_LEN)
    last, cache, extras = prefill(params, batch, cfg, cache)
    steps = [np.asarray(last)]
    for i in range(DECODE):
        tok = jnp.asarray(x["tokens"][:, PROMPT + i:PROMPT + i + 1])
        last, cache = step(params, tok, PROMPT + i, cfg, cache,
                           extras=extras)
        steps.append(np.asarray(last))
    res["decode"] = np.stack(steps, axis=1)

    res["generate"] = np.asarray(jax.jit(
        RM.generate, static_argnums=2, static_argnames=("max_new", "max_len"))(
            params, batch, cfg, max_new=NEW, max_len=MAX_LEN))
    # the greedy trajectory's logits, step by step
    cache = RM.init_cache(cfg, B, MAX_LEN)
    last, cache, extras = prefill(params, batch, cfg, cache)
    logits, toks = [], []
    for i in range(NEW):
        logits.append(np.asarray(last))
        tok = jnp.argmax(last, axis=-1).astype(jnp.int32)[:, None]
        toks.append(np.asarray(tok[:, 0]))
        last, cache = step(params, tok, PROMPT + i, cfg, cache,
                           extras=extras)
    res["greedy_logits"] = np.stack(logits, axis=1)
    res["greedy_tokens"] = np.stack(toks, axis=1)
    return res


@pytest.fixture(scope="module")
def reference():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _reference(arch)
        return cache[arch]
    return get


def _port(arch, ref):
    cfg = TC.get_smoke_config(arch)
    return cfg, params_from_numpy(cfg, ref["tree"], device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, reference):
    ref = reference(arch)
    cfg, model = _port(arch, ref)
    x = {k: torch.from_numpy(v) for k, v in ref["x"].items()}
    x["tokens"] = x["tokens"][:, :PROMPT]
    logits, _, aux = TM.forward(model, x, cfg)
    assert logits.shape == (B, PROMPT + cfg.n_patches, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **TOL)
    assert torch.isfinite(aux)
    called = (model(x["frames"], x["tokens"]) if cfg.family == "encdec"
              else model(x["tokens"], prefix_embeds=x.get("prefix_embeds")))
    assert torch.equal(called[0], logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, reference):
    ref = reference(arch)
    cfg, model = _port(arch, ref)
    x = ref["x"]
    cache = TM.init_cache(cfg, B, MAX_LEN, device="cpu")
    last, cache, extras = TM.prefill(
        model, _serving_batch(x, PROMPT, torch.from_numpy), cfg, cache)
    steps = [last]
    for i in range(DECODE):
        tok = torch.from_numpy(x["tokens"][:, PROMPT + i:PROMPT + i + 1])
        last, cache = TM.decode_step(model, tok, PROMPT + i, cfg, cache,
                                     extras=extras)
        steps.append(last)
    np.testing.assert_allclose(torch.stack(steps, dim=1).numpy(),
                               ref["decode"], **TOL)


def _first_near_tie(logits: np.ndarray) -> int:
    """The first step at which a row's two largest logits lie within the
    bar, or the number of steps."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0] <= TOL["atol"]).any(axis=0)
    return int(np.argmax(tied)) if tied.any() else logits.shape[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_matches_reference(arch, reference):
    ref = reference(arch)
    cfg, model = _port(arch, ref)
    upto = _first_near_tie(ref["greedy_logits"])
    np.testing.assert_array_equal(ref["greedy_tokens"][:, :upto],
                                  ref["generate"][:, :upto])
    batch = _serving_batch(ref["x"], PROMPT, torch.from_numpy)
    got = TM.generate(model, batch, cfg, max_new=NEW, max_len=MAX_LEN)
    assert got.dtype == torch.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy()[:, :upto],
                                  ref["generate"][:, :upto])
    # the logits of every step, both packages fed the reference's tokens
    cache = TM.init_cache(cfg, B, MAX_LEN, device="cpu")
    last, cache, extras = TM.prefill(model, batch, cfg, cache)
    logits = []
    for i in range(NEW):
        logits.append(last)
        tok = torch.from_numpy(ref["greedy_tokens"][:, i:i + 1])
        last, cache = TM.decode_step(model, tok, PROMPT + i, cfg, cache,
                                     extras=extras)
    np.testing.assert_allclose(torch.stack(logits, dim=1).numpy(),
                               ref["greedy_logits"], **TOL)
