"""Input specs, placement plans for every (arch x shape) cell, and the
train / prefill / decode step builders: the port of the reference's
``launch/specs.py``.

Specs are tensors on ``torch.device("meta")`` (shape and dtype, no
storage: the counterpart of ``jax.ShapeDtypeStruct``). Placements are the
plans of ``utils/sharding.py`` -- tuples of mesh axes a dimension -- over
a ``launch/mesh.py`` description; nothing here moves a tensor.

Placement policy (see utils/sharding.py for the parameter side):
  * batch dim    -> ("pod", "data") when divisible;
  * KV heads     -> "model" when divisible, else the cache SEQUENCE dim
    goes to "model" (flash-decoding/split-K style sequence parallelism);
  * SSM/RG-LRU state channels -> "model" when divisible.

The port's caches and parameters hold one entry a unit where the
reference stacks them, so a unit's placement is the reference's less its
leading (unit-axis) None.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch import configs
from repro_torch.configs.common import SHAPES
from repro_torch.models import encdec
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime import spmd
from repro_torch.utils.sharding import MeshAxes, batch_axes_for, param_specs

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ======================================================================
# batch input specs
# ======================================================================
def batch_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    seq, gbatch, kind = SHAPES[shape_name]
    s_text = seq - (cfg.n_patches or 0)
    i32, f32 = torch.int32, torch.float32
    out: Dict[str, Any] = {}
    if kind == "train":
        out["tokens"] = _spec((gbatch, s_text), i32)
        out["labels"] = _spec((gbatch, s_text), i32)
    elif kind == "prefill":
        out["tokens"] = _spec((gbatch, s_text), i32)
    else:  # decode
        out["tokens"] = _spec((gbatch, 1), i32)
    if cfg.family == "encdec" and kind != "decode":
        out["frames"] = _spec((gbatch, cfg.enc_seq, cfg.d_model), f32)
    if cfg.n_patches and kind != "decode":
        out["prefix_embeds"] = _spec((gbatch, cfg.n_patches, cfg.d_model),
                                     f32)
    return out


def batch_shardings(specs, mesh) -> dict:
    return {k: (batch_axes_for(mesh, v.shape[0]),) + (None,) * (v.ndim - 1)
            for k, v in specs.items()}


# ======================================================================
# cache specs + placements
# ======================================================================
def cache_specs(cfg: ModelConfig, shape_name: str):
    """(cache, extras) on the meta device; extras hold enc-dec's
    ``memory_kv`` (one entry a decoder layer)."""
    seq, gbatch, kind = SHAPES[shape_name]
    if kind != "decode":
        raise ValueError(f"{shape_name} is a {kind} shape, not a decode one")
    cache = model_lib.init_cache(cfg, gbatch, seq, META)
    extras = {}
    if cfg.family == "encdec":
        model = model_lib.build_model(cfg, META, None)
        mem = _spec((gbatch, cfg.enc_seq, cfg.d_model),
                    getattr(torch, cfg.dtype))
        extras["memory_kv"] = encdec.encode_memory_kv(model, mem, cfg)
    return cache, extras


def _walk(tree, path=()):
    """(path of keys, leaf) for the tensors of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, leaves) for v in tree]
    return None if tree is None else next(leaves)


def cache_shardings(cache, cfg: ModelConfig, mesh):
    """Name/shape-driven placements for KV caches and recurrent states,
    in the cache's own structure."""
    model = MeshAxes().present(mesh).model
    msize = mesh.shape[model] if model else 1

    def one(keys, leaf):
        name = keys[-1] if keys else ""
        dims: list = [None] * leaf.ndim
        if leaf.shape[0] > 1:
            dims[0] = batch_axes_for(mesh, leaf.shape[0])
        rest = list(range(1, leaf.ndim))
        if name in ("k", "v") and len(rest) == 3:
            # cache layout (KVH, S, hd); memory_kv layout (T, KVH, hd)
            if leaf.shape[rest[0]] == cfg.n_kv_heads:
                kvh_d, s_d = rest[0], rest[1]
            else:
                s_d, kvh_d = rest[0], rest[1]
            if model and leaf.shape[kvh_d] % msize == 0:
                dims[kvh_d] = model
            elif model and leaf.shape[s_d] % msize == 0:
                dims[s_d] = model      # split-K sequence parallelism
        elif name in ("k_scale", "v_scale") and len(rest) == 2:
            kvh_d, s_d = rest
            if model and leaf.shape[kvh_d] % msize == 0:
                dims[kvh_d] = model
            elif model and leaf.shape[s_d] % msize == 0:
                dims[s_d] = model
        elif name == "state" and len(rest) == 3:
            if model and leaf.shape[rest[0]] % msize == 0:
                dims[rest[0]] = model
        elif name == "h" and len(rest) == 1:
            if model and leaf.shape[rest[0]] % msize == 0:
                dims[rest[0]] = model
        elif name == "conv" and len(rest) == 2:
            if model and leaf.shape[rest[1]] % msize == 0:
                dims[rest[1]] = model
        return tuple(dims)

    return _rebuild(cache, iter([one(k, v) for k, v in _walk(cache)]))


# ======================================================================
# step builders
# ======================================================================
def serve_config(cfg: ModelConfig) -> ModelConfig:
    """Serving runs bf16 params (no optimizer master copy)."""
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def opt_config(cfg: ModelConfig, **over) -> adamw.AdamWConfig:
    big = cfg.param_count() > 5e10
    kw = dict(quantize_moments=big)
    kw.update(over)
    return adamw.AdamWConfig(**kw)


def _grads_of(model, named, batch, cfg):
    loss, metrics = model_lib.train_loss(model, batch, cfg)
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(named.items(), grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, accum_steps: int = 1):
    """One optimizer step, ``train_step(model, opt_state, batch) -> (model,
    opt_state, metrics)``: gradients by autograd (the model's parameters
    are turned to ``requires_grad``), then ``adamw.update`` in place.
    ``accum_steps`` > 1 splits the batch along dim 0 into microbatches
    and sums their gradients, loss and metrics, times 1/accum_steps (the
    reference's scan of grad accumulations): the activation working set
    shrinks ~accum_steps x at equal math.

    With a local ``mesh`` the step runs split over it
    (``_sharded_train_step``)."""
    if mesh is not None:
        return _sharded_train_step(cfg, opt_cfg, mesh, accum_steps)

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        named = dict(model.named_parameters())
        if accum_steps == 1:
            loss, metrics, grads = _grads_of(model, named, batch, cfg)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} does not split into "
                                 f"{accum_steps} microbatches")
            mb = b // accum_steps
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in named.items()}
            loss, metrics = 0.0, {}
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, m, g = _grads_of(model, named, micro, cfg)
                for n in grads:
                    grads[n] += g[n]
                loss = loss + l
                metrics = {k: metrics.get(k, 0.0) + v for k, v in m.items()}
            scale = 1.0 / accum_steps
            grads = {n: g * scale for n, g in grads.items()}
            loss = loss * scale
            metrics = {k: v * scale for k, v in metrics.items()}
        _, opt_state, om = adamw.update(opt_cfg, grads, opt_state, named)
        return model, opt_state, {**metrics, **om, "loss": loss}
    return train_step


def _sharded_grads(sm, batch, cfg: ModelConfig):
    """(loss, metrics, grads: name -> each position's gradient of its
    slice) of one batch (whole tensors) on ``sm``'s mesh."""
    placed, rows = model_lib.place_batch(batch, sm.mesh)
    loss, metrics = model_lib.sharded_loss(sm, placed, cfg, rows)[0]
    flat = [(n, t) for n in sm.names for t in sm.shards(n)]
    got = torch.autograd.grad(loss, [t for _, t in flat], allow_unused=True)
    grads = {n: [] for n in sm.names}
    for (n, t), g in zip(flat, got):
        grads[n].append(torch.zeros_like(t) if g is None else g)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _sharded_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                        accum_steps: int):
    """The train step on a local mesh: the model (``models/model.
    ShardedModel``; a module is split on the way in), the moments
    (``opt_state_shardings``) and the batch (``batch_shardings``) are
    placed by the plans, each position differentiates the loss with
    respect to its own slices, a leaf that positions hold as copies gets
    the sum of their gradients (an all-reduce over the axes its placement
    does not name), and ``adamw.update`` runs on the slices. Microbatch i
    is rows i B/accum_steps to (i + 1) B/accum_steps of the batch, as in
    the unsplit step, each split over the batch axes. Returns the sharded
    model and state; metrics are the first position's."""

    def train_step(model, opt_state, batch):
        sm = model_lib.on_mesh(model, mesh, cfg)
        if not spmd.is_sharded(opt_state):
            opt_state = place_opt_state(opt_state, sm.specs, mesh)
        sm.requires_grad_(True)
        b = batch["tokens"].shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into {accum_steps} "
                             f"microbatches")
        mb = b // accum_steps
        loss, metrics, grads = 0.0, {}, None
        for i in range(accum_steps):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            l, m, g = _sharded_grads(sm, micro, cfg)
            if accum_steps == 1:
                loss, metrics, grads = l, m, g
                break
            if grads is None:
                grads = {n: [x.float() for x in xs] for n, xs in g.items()}
            else:
                for n in grads:
                    grads[n] = [a + x for a, x in zip(grads[n], g[n])]
            loss = loss + l
            metrics = {k: metrics.get(k, 0.0) + v for k, v in m.items()}
        if accum_steps > 1:
            scale = 1.0 / accum_steps
            grads = {n: [x * scale for x in xs] for n, xs in grads.items()}
            loss = loss * scale
            metrics = {k: v * scale for k, v in metrics.items()}
        summed = {}
        for n, xs in grads.items():
            spec = sm.specs[n]
            named = {a for e in spec for a in spmd.axes_of(e)}
            free = tuple(a for a in mesh.axis_names if a not in named)
            summed[n] = spmd.Sharded(spmd.all_reduce(xs, mesh, free), spec,
                                     mesh)
        _, opt_state, om = adamw.update(opt_cfg, summed, opt_state,
                                        dict(sm.named_parameters()))
        return sm, opt_state, {**metrics, **om, "loss": loss}
    return train_step


def make_prefill_fn(cfg: ModelConfig, mesh=None):
    @torch.no_grad()
    def prefill_fn(model, batch):
        logits, _, _ = model_lib.forward(model, batch, cfg, mesh=mesh)
        return logits[:, -1]
    return prefill_fn


def make_decode_fn(cfg: ModelConfig, mesh=None):
    @torch.no_grad()
    def decode_fn(model, tokens, pos, cache, extras):
        return model_lib.decode_step(model, tokens, pos, cfg, cache,
                                     extras=extras, mesh=mesh)
    return decode_fn


def param_shardings(model, mesh) -> dict:
    """Parameter name -> placement (``utils/sharding.param_specs``)."""
    return param_specs(model, mesh)


def place_opt_state(opt_state, p_specs: dict, mesh) -> dict:
    """An AdamW state of whole tensors split over a local ``mesh`` by
    ``opt_state_shardings`` (each position's slices in storage of its
    own)."""
    return spmd.shard_tree(opt_state, opt_state_shardings(
        opt_state, p_specs, mesh), mesh)


def opt_state_shardings(opt_state, p_specs: dict, mesh) -> dict:
    """m/v mirror the parameters' placements (the int8 layout is shape-
    preserving, so ``q`` takes the parameter's and ``scale`` that less its
    last dim); step replicates."""
    def build(sub):
        if isinstance(sub, dict) and set(sub) == {"q", "scale"}:
            return {"q": {n: p_specs[n] for n in sub["q"]},
                    "scale": {n: p_specs[n][:-1] + (None,)
                              if len(p_specs[n]) else ()
                              for n in sub["scale"]}}
        return {n: p_specs[n] for n in sub}

    out = {"step": ()}
    for k in ("m", "v", "ef"):
        if k in opt_state:
            out[k] = build(opt_state[k])
    return out


# ======================================================================
# the full cell assembly (used by dryrun)
# ======================================================================
def model_flops_for(cfg: ModelConfig, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (single forward/decode token),
    with N = active params for MoE."""
    seq, gbatch, kind = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * gbatch * seq
    if kind == "prefill":
        return 2.0 * n_active * gbatch * seq
    return 2.0 * n_active * gbatch * 1  # one decode token per sequence


def build_cell(arch: str, shape_name: str, mesh, seq_shard: bool = False,
               kv_quant: bool = False, accum_steps: int = 1):
    """Returns (fn, args, placements, donate_argnums, meta): the step
    function, its arguments on the meta device (the model, the optimizer
    state or cache, the batch), their plans, and the config and kind."""
    cfg = configs.get_config(arch)
    if seq_shard:
        cfg = dataclasses.replace(cfg, seq_shard=True)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    seq, gbatch, kind = SHAPES[shape_name]

    if kind == "train":
        model = model_lib.build_model(cfg, META, None)
        ocfg = opt_config(cfg)
        opt = adamw.init(ocfg, dict(model.named_parameters()))
        b_spec = batch_specs(cfg, shape_name)
        fn = make_train_step(cfg, ocfg, accum_steps=accum_steps)
        p_sh = param_shardings(model, mesh)
        plans = (p_sh, opt_state_shardings(opt, p_sh, mesh),
                 batch_shardings(b_spec, mesh))
        return (fn, (model, opt, b_spec), plans, (0, 1),
                {"cfg": cfg, "kind": kind})

    scfg = serve_config(cfg)
    model = model_lib.build_model(scfg, META, None)
    p_sh = param_shardings(model, mesh)

    if kind == "prefill":
        b_spec = batch_specs(scfg, shape_name)
        fn = make_prefill_fn(scfg)
        plans = (p_sh, batch_shardings(b_spec, mesh))
        return fn, (model, b_spec), plans, (), {"cfg": scfg, "kind": kind}

    # decode
    cache, extras = cache_specs(scfg, shape_name)
    tok = _spec((gbatch, 1), torch.int32)
    pos = _spec((), torch.int32)
    fn = make_decode_fn(scfg)
    plans = (p_sh, (batch_axes_for(mesh, gbatch), None), (),
             cache_shardings(cache, scfg, mesh),
             cache_shardings(extras, scfg, mesh))
    return (fn, (model, tok, pos, cache, extras), plans, (3,),
            {"cfg": scfg, "kind": kind})
