"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's
on the CPU, from seeded numpy parameters, gradients and moments:

  * ``update`` with float32 and int8 moments, with and without int8
    gradient compression: parameters, float32 moments, residuals and
    metrics within 1e-6 relative (atol 1e-6 x the leaf's largest entry,
    for entries that are a difference of larger terms; residuals at the
    scale of the corrected gradient they are the rounding of); int8
    moments ``q`` equal to the reference's except where the block's scale
    differs in its last bit, and there by at most 1, scales within 1e-6;
  * ``lr_schedule`` over 120 steps within 1e-6 relative;
  * the weight decay of the reference's stacked leaves (a per-unit vector
    here decays, as its (n_units, d) leaf does there);
  * and the reference's own checks of ``tests/test_optim.py`` on the port:
    convergence on a quadratic, the schedule's shape, the int8 round trip
    (and its property test), and error feedback unbiased."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import adamw as RA
from repro_torch.optim import adamw as TA

#: reference tree: a matrix, a vector, a stacked unit subtree ((2, ...)
#: leaves) and a leaf whose last axis is not a multiple of 128
SHAPES = {"w": (6, 300), "b": (7,), "units": {"n": (2, 5), "m": (2, 3, 130)}}
REL = 1e-6


def _tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        x = rng.random(shape) if positive else rng.standard_normal(shape)
        return (scale * x).astype(np.float32)

    return {k: ({kk: leaf(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else leaf(v))
            for k, v in SHAPES.items()}


def _port_names(tree):
    """The port's flat names of a reference tree: a stacked leaf's units
    apart, as ``units.<i>.<leaf>``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            for kk, arr in v.items():
                for i in range(arr.shape[0]):
                    out[f"{k}.{i}.{kk}"] = arr[i]
        else:
            out[k] = v
    return out


def _to_torch(tree):
    return {n: torch.from_numpy(np.array(a)) for n, a in
            _port_names(tree).items()}


def _ref_state(cfg, seed=3):
    """A reference state at step 7 with non-zero moments and residuals."""
    m, v = _tree(seed, 1e-2), _tree(seed + 1, 1e-4, positive=True)
    state = {"step": np.asarray(7, np.int32)}
    if cfg.quantize_moments:
        state["m"] = RA._q_tree(jax.tree.map(jnp.asarray, m))
        state["v"] = RA._q_tree(jax.tree.map(jnp.asarray, v))
    else:
        state["m"], state["v"] = m, v
    if cfg.compress_grads:
        state["ef"] = _tree(seed + 2, 1e-3)
    return jax.tree.map(np.asarray, state)


def _port_state(ref_state):
    state = {"step": torch.tensor(int(ref_state["step"]), dtype=torch.int32)}
    for key in ("m", "v", "ef"):
        if key not in ref_state:
            continue
        sub = ref_state[key]
        if set(sub) == {"q", "scale"}:
            state[key] = {k: _to_torch(sub[k]) for k in ("q", "scale")}
        else:
            state[key] = _to_torch(sub)
    return state


def _close(got: dict, want_tree, what, like=None):
    """Within REL relative, atol REL x the largest entry of the leaf of
    ``like`` (default: of ``want_tree``)."""
    want = _port_names(jax.tree.map(np.asarray, want_tree))
    like = want if like is None else _port_names(like)
    assert set(got) == set(want), what
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, rtol=REL,
                                   atol=REL * float(np.abs(like[n]).max()),
                                   err_msg=f"{what} {n}")


def _q_close(got: dict, want: dict, what):
    """int8 moments: scales within 1e-6; q equal where the block's scales
    are equal, else within 1 (a last-bit difference of a scale moves a
    rounding boundary)."""
    _close(got["scale"], want["scale"], f"{what} scale")
    g_scale = got["scale"]
    w_scale = _port_names(jax.tree.map(np.asarray, want["scale"]))
    for n, w in _port_names(jax.tree.map(np.asarray, want["q"])).items():
        g = got["q"][n].numpy().astype(np.int32)
        w = w.astype(np.int32)
        same = np.repeat(g_scale[n].numpy() == w_scale[n], 128, axis=-1)
        np.testing.assert_array_equal(g[same], w[same],
                                      err_msg=f"{what} q {n}")
        assert np.abs(g - w).max() <= 1, (what, n)


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("compress", [False, True],
                         ids=["plain-grads", "compressed-grads"])
def test_update_matches_reference(quant, compress):
    kw = dict(lr=1e-3, warmup_steps=3, total_steps=50,
              quantize_moments=quant, compress_grads=compress)
    params, grads = _tree(1), _tree(2, 0.1)
    ref_state = _ref_state(RA.AdamWConfig(**kw))
    r_params, r_state, r_metrics = jax.jit(
        lambda g, s, p: RA.update(RA.AdamWConfig(**kw), g, s, p))(
            jax.tree.map(jnp.asarray, grads),
            jax.tree.map(jnp.asarray, ref_state),
            jax.tree.map(jnp.asarray, params))

    t_params = _to_torch(params)
    t_params, t_state, t_metrics = TA.update(
        TA.AdamWConfig(**kw), _to_torch(grads), _port_state(ref_state),
        t_params)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(t_metrics[k].item(), float(r_metrics[k]),
                                   rtol=REL, err_msg=k)
    _close(t_params, r_params, "params")
    assert t_state["step"].item() == int(r_state["step"]) == 8
    for key in ("m", "v"):
        if quant:
            _q_close(t_state[key], r_state[key], key)
        else:
            _close(t_state[key], r_state[key], key)
    if compress:
        # a residual is the corrected gradient less its int8 round trip:
        # it is held at the corrected gradient's scale
        corrected = jax.tree.map(np.add, grads, ref_state["ef"])
        _close(t_state["ef"], r_state["ef"], "ef", like=corrected)
    else:
        assert "ef" not in t_state and "ef" not in r_state


def test_stacked_leaves_decay_as_in_the_reference():
    vec = {"b": torch.ones(4), "units.0.n": torch.ones(4),
           "w": torch.ones(2, 2)}
    assert [TA.decays(n, p) for n, p in vec.items()] == [False, True, True]


def test_lr_schedule_matches_reference():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = TA.lr_schedule(TA.AdamWConfig(**cfg), torch.arange(120)).numpy()
    want = np.asarray(jax.vmap(lambda s: RA.lr_schedule(
        RA.AdamWConfig(**cfg), s))(jnp.arange(120)))
    np.testing.assert_allclose(got, want, rtol=REL)


def test_init_matches_reference_structure():
    cfg = TA.AdamWConfig(quantize_moments=True, compress_grads=True)
    params = _to_torch(_tree(0))
    state = TA.init(cfg, params)
    ref = RA.init(RA.AdamWConfig(quantize_moments=True, compress_grads=True),
                  jax.tree.map(jnp.asarray, _tree(0)))
    assert set(state) == set(ref) == {"step", "m", "v", "ef"}
    _q_close(state["m"], ref["m"], "m")
    assert state["step"].dtype == torch.int32 and state["step"].item() == 0
    assert all(t.dtype == torch.float32 and not t.any()
               for t in state["ef"].values())


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_adamw_converges_on_quadratic(quant):
    cfg = TA.AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                         total_steps=400, min_lr_frac=1.0,
                         quantize_moments=quant)
    target = torch.tensor([1.5, -2.0, 0.5, 3.0])
    params = {"w": torch.zeros(4, requires_grad=True),
              "b": torch.zeros((), requires_grad=True)}
    state = TA.init(cfg, params)
    for _ in range(400):
        loss = torch.sum((params["w"] - target) ** 2) + (params["b"] - 1) ** 2
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        params, state, _ = TA.update(cfg, grads, state, params)
    np.testing.assert_allclose(params["w"].detach().numpy(), target.numpy(),
                               atol=0.05)
    assert abs(params["b"].item() - 1.0) < 0.05


def test_schedule_shape():
    cfg = TA.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                         min_lr_frac=0.1)
    lrs = [TA.lr_schedule(cfg, s).item() for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9          # warmup rises
    assert abs(lrs[10] - 1e-3) < 1e-4              # peak after warmup
    assert lrs[-1] < 0.2 * 1e-3                    # decays toward min
    assert lrs[-1] >= 0.1 * 1e-3 - 1e-9            # respects floor


def test_quantized_states_are_small_and_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (513, 300)).astype(np.float32)) * 0.01
    q, s = TA._quantize(x)
    assert q.dtype == torch.int8
    assert q.shape == (513, 384)                   # padded to 128
    assert s.shape == (513, 3)
    back = TA._dequantize(q, s, x.shape)
    assert back.shape == x.shape
    # blockwise absmax int8: relative error bounded by ~1/127 per block
    np.testing.assert_allclose(back.numpy(), x.numpy(),
                               atol=float(x.abs().max()) / 100)


def test_grad_compression_error_feedback_is_unbiased():
    """Sum of compressed grads ~ sum of true grads (the residual carries
    what each round trip loses)."""
    gen = torch.Generator().manual_seed(1)
    residual = torch.zeros(256)
    total_true = torch.zeros(256)
    total_hat = torch.zeros(256)
    for _ in range(50):
        g = torch.randn(256, generator=gen) * 0.1
        corrected = g + residual
        g_hat, residual = TA.compress_decompress(g, residual)
        # the residual is at most half a step of the round trip's grid
        step = float(corrected.abs().max()) / 127
        assert float(residual.abs().max()) <= 0.5 * step * (1 + 1e-5)
        total_true += g
        total_hat += g_hat
    # accumulated estimates track the true sum
    err = float((total_true - (total_hat + residual)).abs().max())
    assert err < 1e-4


@given(st.integers(min_value=1, max_value=400),
       st.integers(min_value=1, max_value=5))
@settings(max_examples=20, deadline=None)
def test_property_quantize_roundtrip_shape(n, m):
    x = torch.linspace(-1.0, 1.0, n * m).reshape(n, m)
    q, s = TA._quantize(x)
    back = TA._dequantize(q, s, x.shape)
    assert back.shape == x.shape
    assert float((back - x).abs().max()) <= 2.0 / 127 + 1e-6
