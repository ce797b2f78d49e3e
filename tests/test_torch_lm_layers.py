"""The port's LM layers against the reference's, module by module, on the
CPU: norms, RoPE, MLPs, attention (direct, chunked with the block sizes
patched small in both packages, full and ring KV caches with a prompt
longer than the window, int8 KV), MoE with capacity drops, a dense
residual and token groups, the SSM and the RG-LRU with their decode
caches.

Weights cross over only through ``interop.params_from_numpy``: a
one-layer reference model is initialised, its tree perturbed in numpy
where init leaves a parameter zero, and carried into the port; each test
then takes the layer from both. Inputs are numpy arrays from a seed. The
bar is the reference's MoE bar, rtol = atol = 2e-4
(``tests/test_moe.py``), and the int8 KV cache's 0.05
(``tests/test_kv_quant.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import config as RCFG
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.models import rglru as RREC
from repro.models import ssm as RSSM
from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as TA
from repro_torch.models import config as TCFG
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TREC
from repro_torch.models import ssm as TSSM

TOL = dict(rtol=2e-4, atol=2e-4)
QUANT_TOL = dict(rtol=0.05, atol=0.05)


def _twin(kind="attn", window=None, **over):
    """The same one-unit config in both packages."""
    fields = dict(name="t", d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                  d_ff=128, vocab=128, n_units=1, dtype="float32")
    fields.update(over)
    ref = RCFG.ModelConfig(unit=(RCFG.LayerSpec(kind=kind, window=window),),
                           **fields)
    port = TCFG.ModelConfig(unit=(TCFG.LayerSpec(kind=kind, window=window),),
                            **fields)
    for name in ("moe", "ssm", "rec"):
        sub = getattr(ref, name)
        if sub is not None:
            port = dataclasses.replace(port, **{name: getattr(
                TCFG, type(sub).__name__)(**dataclasses.asdict(sub))})
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _perturb(tree, rng):
    """Give every all-zero leaf (norm scales, biases) random values, so
    that the paths they gate are compared too."""
    def one(a):
        a = np.asarray(a)
        if not a.any():
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(one, tree)


def _layer(ref_cfg, port_cfg, seed=0):
    """(reference layer tree, port layer module) of one shared model."""
    rng = np.random.default_rng(seed)
    tree = _perturb(RM.init_params(jax.random.PRNGKey(seed), ref_cfg), rng)
    model = params_from_numpy(port_cfg, tree, device="cpu")
    ref = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["units"]["l0"])
    return ref, model.units[0]["l0"], tree, model


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


# ------------------------------------------------------------ norms / MLP
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norm_matches_reference(norm):
    rc, tc = _twin(norm=norm)
    ref, port, _, _ = _layer(rc, tc)
    x = _x(np.random.default_rng(1), 2, 5, 64) * 3.0
    want = RL.apply_norm(ref["pre_norm"], jnp.asarray(x), rc)
    _close(TL.apply_norm(port.pre_norm, torch.from_numpy(x), tc), want)


def test_rope_matches_reference():
    rng = np.random.default_rng(2)
    x = _x(rng, 2, 7, 3, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    s, c = RL.rope_sincos(jnp.asarray(pos), 16, 1e4)
    ts, tcs = TL.rope_sincos(torch.from_numpy(pos), 16, 1e4)
    _close(ts, s, dict(rtol=1e-5, atol=1e-5))
    _close(tcs, c, dict(rtol=1e-5, atol=1e-5))
    want = RL.apply_rope(jnp.asarray(x), s, c)
    _close(TL.apply_rope(torch.from_numpy(x), ts, tcs), want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    rc, tc = _twin(mlp_kind=kind)
    ref, port, _, _ = _layer(rc, tc)
    x = _x(np.random.default_rng(3), 2, 5, 64)
    want = RL.apply_mlp(ref["mlp"], jnp.asarray(x), rc)
    _close(TL.apply_mlp(port.mlp, torch.from_numpy(x), tc), want)


@pytest.mark.parametrize("over", [dict(emb_scale=True),
                                  dict(pos_embed="learned", max_seq=64)],
                         ids=["emb_scale", "learned"])
def test_embed_matches_reference(over):
    rc, tc = _twin(**over)
    _, _, tree, model = _layer(rc, tc)
    toks = np.random.default_rng(4).integers(0, 128, (2, 9)).astype(np.int32)
    emb = jax.tree.map(jnp.asarray, tree["embed"])
    want = RL.embed_tokens(emb, jnp.asarray(toks), rc, pos_offset=5)
    _close(TL.embed_tokens(model.embed, torch.from_numpy(toks), tc,
                           pos_offset=5), want)


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("softcap", [None, 30.0], ids=["nocap", "softcap"])
def test_sdpa_matches_reference(softcap):
    rc, tc = _twin(attn_softcap=softcap)
    rng = np.random.default_rng(5)
    q, k, v = _x(rng, 2, 6, 4, 16), _x(rng, 2, 9, 2, 16), _x(rng, 2, 9, 2, 16)
    mask = rng.random((2, 6, 9)) < 0.7
    want = RA._sdpa(*map(jnp.asarray, (q, k, v, mask)), rc)
    got = TA._sdpa(*map(torch.from_numpy, (q, k, v, mask)), tc)
    _close(got, want)


@pytest.fixture
def small_blocks(monkeypatch):
    """Chunked attention's block sizes and threshold patched small in both
    packages, so S = 40 takes the chunked path with ragged blocks."""
    for mod in (RA, TA):
        monkeypatch.setattr(mod, "_BQ", 16)
        monkeypatch.setattr(mod, "_BK", 8)
        monkeypatch.setattr(mod, "_CHUNK_THRESHOLD", 256)


@pytest.mark.parametrize("window", [None, 12], ids=["global", "windowed"])
@pytest.mark.parametrize("softcap", [None, 30.0], ids=["nocap", "softcap"])
def test_chunked_attention_matches_reference(small_blocks, window, softcap):
    rc, tc = _twin(window=window, attn_softcap=softcap)
    ref, port, _, _ = _layer(rc, tc)
    x = _x(np.random.default_rng(6), 2, 40, 64)
    want, _ = RA.apply_attn(ref["attn"], jnp.asarray(x), rc, rc.unit[0], 3)
    got, _ = TA.apply_attn(port.attn, torch.from_numpy(x), tc, tc.unit[0], 3)
    _close(got, want)
    q = _x(np.random.default_rng(7), 1, 40, 4, 16)
    k = _x(np.random.default_rng(8), 1, 37, 2, 16)
    want = RA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k),
                            rc, q0=9, k0=6, causal=True, window=window)
    got = TA._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(k), tc, q0=9, k0=6, causal=True,
                           window=window)
    _close(got, want)


def _cached_run(apply, init_cache, p, x, spec, cfg, chunks, to):
    cache = init_cache(cfg, spec, x.shape[0], 24)
    outs, pos = [], 0
    for n in chunks:
        out, cache = apply(p, to(x[:, pos:pos + n]), cfg, spec, pos,
                           cache=cache)
        outs.append(np.asarray(out))
        pos += n
    return np.concatenate(outs, axis=1), cache


@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("window", [None, 8, 40],
                         ids=["full", "ring", "window-over-max-len"])
def test_cached_attention_matches_reference(window, kv_quant):
    """A 19-token prompt (longer than the ring of 8), then three decode
    steps: every output, and the caches' contents, against the reference
    (whose scatter keeps the last write to a repeated ring slot)."""
    rc, tc = _twin(window=window, kv_quant=kv_quant)
    ref, port, _, _ = _layer(rc, tc)
    x = _x(np.random.default_rng(9), 2, 22, 64)
    chunks = (19, 1, 1, 1)
    want, rcache = _cached_run(
        jax.jit(RA.apply_attn, static_argnums=(2, 3)), RA.init_attn_cache,
        ref["attn"], x, rc.unit[0], rc, chunks, jnp.asarray)
    got, tcache = _cached_run(
        TA.apply_attn, lambda *a: TA.init_attn_cache(*a, device="cpu"),
        port.attn, x, tc.unit[0], tc, chunks, torch.from_numpy)
    tol = QUANT_TOL if kv_quant else TOL
    np.testing.assert_allclose(got, want, **tol)
    assert set(tcache) == set(rcache)
    for key in rcache:
        assert tcache[key].dtype == getattr(torch, str(rcache[key].dtype))
        np.testing.assert_allclose(tcache[key].numpy().astype(np.float32),
                                   np.asarray(rcache[key], np.float32),
                                   **(dict(rtol=0, atol=1) if key in "kv"
                                      and kv_quant else TOL))


def test_kv_quantize_matches_reference():
    x = _x(np.random.default_rng(10), 2, 2, 8, 16) * 3.0
    q, s = RA._kv_quantize(jnp.asarray(x))
    tq, ts = TA._kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert np.abs(tq.numpy().astype(int) - np.asarray(q, int)).max() <= 1
    _close(ts, s, dict(rtol=1e-6, atol=0))
    _close(TA._kv_dequantize(tq, ts, torch.float32),
           RA._kv_dequantize(q, s, jnp.float32), QUANT_TOL)


def test_cross_attention_matches_reference():
    rc, tc = _twin(qkv_bias=True)
    ref, port, _, _ = _layer(rc, tc)
    rng = np.random.default_rng(11)
    mem, x = _x(rng, 2, 10, 64), _x(rng, 2, 3, 64)
    kv = RA.encode_memory_kv(ref["attn"], jnp.asarray(mem), rc)
    tkv = TA.encode_memory_kv(port.attn, torch.from_numpy(mem), tc)
    for key in ("k", "v"):
        _close(tkv[key], kv[key])
    want = RA.apply_cross_attn(ref["attn"], jnp.asarray(x), kv, rc)
    _close(TA.apply_cross_attn(port.attn, torch.from_numpy(x), tkv, tc),
           want)


# -------------------------------------------------------------------- MoE
@pytest.mark.parametrize("over", [
    dict(capacity_factor=0.5, dense_residual_ff=32),
    dict(capacity_factor=1.25),
    dict(capacity_factor=0.5, dispatch_groups=2)],
    ids=["drop-dense", "no-drop", "groups"])
@pytest.mark.parametrize("mlp_kind", ["swiglu", "geglu"])
def test_moe_matches_reference(over, mlp_kind):
    """Capacity 8 against 2 x 24 tokens x top-2 over 4 experts drops
    tokens at capacity factor 0.5; the dense residual MLP and pinned token
    groups take their own paths."""
    moe = dict(n_experts=4, top_k=2, d_ff_expert=32)
    moe.update(over)
    rc, tc = _twin(mlp_kind=mlp_kind, moe=RCFG.MoESpec(**moe))
    ref, port, _, _ = _layer(rc, tc)
    x = _x(np.random.default_rng(12), 2, 24, 64)
    want, aux = RMOE.apply_moe(ref["moe"], jnp.asarray(x), rc)
    got, taux = TMOE.apply_moe(port.moe, torch.from_numpy(x), tc)
    _close(got, want)
    _close(taux, aux, dict(rtol=1e-5, atol=1e-6))
    if over["capacity_factor"] < 1:
        xf = jnp.asarray(x.reshape(48, 64))
        cap = RMOE._capacity(48, rc)
        top_p, top_e, _ = RMOE._route(ref["moe"], xf, rc)
        _, dest, _, _ = RMOE._dispatch_compact(xf, top_p, top_e, 4, cap)
        assert int(jnp.sum(dest == 4 * cap)) > 0, "no token was dropped"


# ---------------------------------------------------------- SSM / RG-LRU
def _recurrent_case(kind, apply_r, apply_t, init_r, init_t, seed, **over):
    """The whole sequence without a cache, then 7 tokens prefilled into
    the cache and 4 decoded one at a time: each output against the
    reference's and the uncached output, and the caches at the end."""
    rc, tc = _twin(kind=kind, **over)
    ref, port, _, _ = _layer(rc, tc, seed)
    name = "ssm" if kind == "ssm" else "rec"
    apply_r = jax.jit(apply_r, static_argnums=2)
    x = _x(np.random.default_rng(seed), 2, 11, 64)
    want, _ = apply_r(ref[name], jnp.asarray(x), rc)
    got, _ = apply_t(getattr(port, name), torch.from_numpy(x), tc)
    _close(got, want)
    rcache, tcache = init_r(rc, 2), init_t(tc, 2, device="cpu")
    for lo, hi in [(0, 7)] + [(i, i + 1) for i in range(7, 11)]:
        w, rcache = apply_r(ref[name], jnp.asarray(x[:, lo:hi]), rc, rcache)
        g, tcache = apply_t(getattr(port, name),
                            torch.from_numpy(x[:, lo:hi]), tc, tcache)
        _close(g, w)
        _close(g, want[:, lo:hi])
    for key in rcache:
        _close(tcache[key], rcache[key])


@pytest.mark.parametrize("groups", [1, 2])
def test_ssm_matches_reference(groups):
    _recurrent_case("ssm", RSSM.apply_ssm, TSSM.apply_ssm,
                    RSSM.init_ssm_cache, TSSM.init_ssm_cache, 13,
                    ssm=RCFG.SSMSpec(d_state=16, head_dim=16, expand=2,
                                     chunk=8, n_groups=groups))


@pytest.mark.parametrize("d_rec", [None, 48])
def test_rglru_matches_reference(d_rec):
    _recurrent_case("rec", RREC.apply_rec, TREC.apply_rec,
                    RREC.init_rec_cache, TREC.init_rec_cache, 14,
                    rec=RCFG.RecSpec(d_rec=d_rec))


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(15)
    x, w, b = _x(rng, 2, 9, 6), _x(rng, 4, 6), _x(rng, 6)
    want = RSSM._causal_conv(*map(jnp.asarray, (x, w, b)))
    _close(TSSM._causal_conv(*map(torch.from_numpy, (x, w, b))), want)
