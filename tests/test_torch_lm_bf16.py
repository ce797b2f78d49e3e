"""The port's language models against the reference's in the dtype that
is served, the configs' bfloat16 compute, on the CPU.

The other LM parity tests run in float32 (``reduced()`` sets it), where a
cast that the port leaves out or adds changes nothing. Here:

  * ``_sdpa`` and ``_sdpa_chunked`` on bfloat16 q, k, v of a size that
    gives scores of standard deviation 15 (random-init models give scores
    near 0, where rounding them would not show): the scores are float32
    in the reference (``preferred_element_type``). Measured, the port
    matches it exactly here, and a port that rounds its scores to
    bfloat16 misses it by 0.03 to 0.11, past the bar;
  * five smoke archs with ``dtype="bfloat16"`` in both packages (gemma2:
    softcaps and a ring cache; mamba2: the SSM conv cache; mixtral: MoE;
    recurrentgemma: RG-LRU; whisper: cross-attention memory): ``forward``,
    ``prefill`` and 4 ``decode_step`` logits, and every cache leaf after
    them with its dtype and shape.

The bar is one bfloat16 ulp at 1, 2**-7. Measured on these inputs, the
port's bfloat16 logits lie at most 0.0042 from the reference's bfloat16
ones, and the reference's own bfloat16 logits lie up to 0.0052 from its
float32 ones: the bar sits above the packages' rounding differences and
at the size of what bfloat16 itself costs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import attention as RA
from repro.models import config as RCFG
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import config as TCFG
from repro_torch.models import model as TM

BAR = dict(rtol=2.0 ** -7, atol=2.0 ** -7)
ARCHS = ["gemma2-2b", "mamba2-780m", "mixtral-8x22b", "recurrentgemma-9b",
         "whisper-small"]
B, PROMPT, DECODE, MAX_LEN = 2, 12, 4, 20


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want):
    np.testing.assert_allclose(_f32(got), _f32(want), **BAR)


# -------------------------------------------------------------- attention
def _cfgs(softcap):
    fields = dict(name="t", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab=128, n_units=1, dtype="bfloat16",
                  attn_softcap=softcap)
    return (RCFG.ModelConfig(unit=(RCFG.LayerSpec(kind="attn"),), **fields),
            TCFG.ModelConfig(unit=(TCFG.LayerSpec(kind="attn"),), **fields))


def _qkv(seed, sq, skv):
    """bfloat16 q, k, v whose scores q.k / sqrt(16) have a standard
    deviation of about 15."""
    rng = np.random.default_rng(seed)

    def bf16(*shape, scale):
        x = torch.from_numpy(scale * rng.standard_normal(shape)
                             .astype(np.float32))
        return x.to(torch.bfloat16)
    return (bf16(2, sq, 4, 16, scale=4.0), bf16(2, skv, 2, 16, scale=4.0),
            bf16(2, skv, 2, 16, scale=1.0))


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("softcap", [None, 30.0], ids=["nocap", "softcap"])
def test_sdpa_bf16_matches_reference(softcap):
    rc, tc = _cfgs(softcap)
    q, k, v = _qkv(5, 6, 9)
    mask = np.random.default_rng(6).random((2, 6, 9)) < 0.7
    want = RA._sdpa(_jnp(q), _jnp(k), _jnp(v), jnp.asarray(mask), rc)
    got = TA._sdpa(q, k, v, torch.from_numpy(mask), tc)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want)


@pytest.mark.parametrize("softcap", [None, 30.0], ids=["nocap", "softcap"])
def test_chunked_attention_bf16_matches_reference(monkeypatch, softcap):
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "_BQ", 16)
        monkeypatch.setattr(mod, "_BK", 8)
    rc, tc = _cfgs(softcap)
    q, k, v = _qkv(7, 40, 37)
    want = RA._sdpa_chunked(_jnp(q), _jnp(k), _jnp(v), rc, q0=9, k0=6,
                            causal=True, window=12)
    got = TA._sdpa_chunked(q, k, v, tc, q0=9, k0=6, causal=True, window=12)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, want)


# ----------------------------------------------------------------- models
def _leaves(tree, prefix=""):
    """{path: leaf}; the port's per-unit lists are stacked on a leading
    axis, as the reference's unit caches are."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        per = [_leaves(v, prefix) for v in tree]
        return {k: torch.stack([p[k] for p in per]) for k in per[0]}
    return {prefix: tree}


@pytest.fixture(scope="module")
def runs():
    """The reference's bfloat16 results an arch, computed once."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = dataclasses.replace(RC.get_smoke_config(arch),
                                      dtype="bfloat16")
            tree = jax.tree.map(np.asarray,
                                RM.init_params(jax.random.PRNGKey(0), cfg))
            params = jax.tree.map(jnp.asarray, tree)
            rng = np.random.default_rng(1)
            x = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT + DECODE)
                                        ).astype(np.int32)}
            if cfg.family == "encdec":
                x["frames"] = rng.standard_normal(
                    (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
            batch = {"tokens": jnp.asarray(x["tokens"][:, :PROMPT])}
            if "frames" in x:
                batch["frames"] = jnp.asarray(x["frames"])
            fwd = jax.jit(RM.forward, static_argnums=2)(params, batch,
                                                        cfg)[0]
            step = jax.jit(RM.decode_step, static_argnums=3)
            c = RM.init_cache(cfg, B, MAX_LEN)
            last, c, extras = jax.jit(RM.prefill, static_argnums=2)(
                params, batch, cfg, c)
            steps = [last]
            for i in range(DECODE):
                tok = jnp.asarray(x["tokens"][:, PROMPT + i:PROMPT + i + 1])
                last, c = step(params, tok, PROMPT + i, cfg, c, extras=extras)
                steps.append(last)
            cache[arch] = dict(tree=tree, x=x, forward=fwd, steps=steps,
                               cache=_leaves(jax.tree.map(np.asarray, c)))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_model_matches_reference(arch, runs):
    ref = runs(arch)
    cfg = dataclasses.replace(TC.get_smoke_config(arch), dtype="bfloat16")
    model = params_from_numpy(cfg, ref["tree"], device="cpu")
    x = {k: torch.from_numpy(v) for k, v in ref["x"].items()}
    batch = {"tokens": x["tokens"][:, :PROMPT]}
    if "frames" in x:
        batch["frames"] = x["frames"]
    with torch.no_grad():
        _close(TM.forward(model, batch, cfg)[0], ref["forward"])
        c = TM.init_cache(cfg, B, MAX_LEN, device="cpu")
        last, c, extras = TM.prefill(model, batch, cfg, c)
        steps = [last]
        for i in range(DECODE):
            tok = x["tokens"][:, PROMPT + i:PROMPT + i + 1]
            last, c = TM.decode_step(model, tok, PROMPT + i, cfg, c,
                                     extras=extras)
            steps.append(last)
    _close(torch.stack(steps, 1), np.stack([_f32(s) for s in ref["steps"]],
                                           1))
    got = _leaves(c)
    assert sorted(got) == sorted(ref["cache"])
    for name, want in ref["cache"].items():
        assert str(got[name].dtype) == f"torch.{want.dtype}", name
        assert tuple(got[name].shape) == want.shape, name
        _close(got[name], want)
