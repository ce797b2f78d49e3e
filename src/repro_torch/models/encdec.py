"""Encoder-decoder backbone (whisper-small): the port of the reference's
``models/encdec.py``. The conv/mel frontend is a STUB, as in the
reference: the encoder consumes precomputed frame embeddings (B, T_enc,
d); everything downstream (bidirectional encoder stack, causal decoder
with cross-attention, KV caches) is real. The stacks are
``nn.ModuleList``s run in a loop where the reference scans stacked
parameters; ``memory_kv`` and the decode cache hold one entry a decoder
layer. Under ``cfg.remat == "full"`` with gradients on, each encoder and
decoder layer is recomputed in the backward pass, as the reference's
``jax.checkpoint`` of its scan bodies.

On a local mesh (``forward_sharded``, ``train_loss_sharded``) both
stacks run as the decoder family's layers do, the activations split over
the batch axes alone (the reference pins them to ``batch_spec``); the
learned position tables split over ``model`` by rows, the cross weights
are replicated and the cross K/V placed as ``launch/specs.
cache_shardings`` places ``memory_kv`` (``encode_memory_kv_sharded``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (Head, MeshCtx, apply_mlp,
                                       apply_mlp_sharded, apply_norm,
                                       dtype_of, embed_tokens,
                                       embed_tokens_sharded, gather_fsdp,
                                       init_embed, init_mlp, init_norm,
                                       param, positions_sharded,
                                       trunc_normal, unembed,
                                       unembed_sharded)
from repro_torch.models.transformer import (loss_terms_sharded, masked_nll,
                                            remat, residual_sharded)

_SPEC = LayerSpec(kind="attn")


# ----------------------------------------------------------------- params
def _init_enc_layer(cfg: ModelConfig, device, gen) -> nn.ModuleDict:
    return nn.ModuleDict({"pre_norm": init_norm(cfg, device),
                          "attn": attn_mod.init_attn(gen, cfg, device),
                          "mlp_norm": init_norm(cfg, device),
                          "mlp": init_mlp(gen, cfg, device)})


def _init_dec_layer(cfg: ModelConfig, device, gen) -> nn.ModuleDict:
    return nn.ModuleDict({"pre_norm": init_norm(cfg, device),
                          "attn": attn_mod.init_attn(gen, cfg, device),
                          "cross_norm": init_norm(cfg, device),
                          "cross": attn_mod.init_cross_attn(gen, cfg, device),
                          "mlp_norm": init_norm(cfg, device),
                          "mlp": init_mlp(gen, cfg, device)})


class EncPos(nn.Module):
    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.pos_embed = param(trunc_normal(
            gen, (cfg.enc_seq, cfg.d_model), 0.02,
            dtype_of(cfg.param_dtype), device))


class EncDec(nn.Module):
    """``embed``, ``enc_pos``, ``enc_units``, ``dec_units``, ``enc_norm``,
    ``final_norm`` and ``head``: the reference's tree, with the layer index
    after ``enc_units`` / ``dec_units``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embed(gen, cfg, device)
        self.enc_pos = EncPos(cfg, device, gen)
        self.enc_units = nn.ModuleList(_init_enc_layer(cfg, device, gen)
                                       for _ in range(cfg.n_enc_units))
        self.dec_units = nn.ModuleList(_init_dec_layer(cfg, device, gen)
                                       for _ in range(cfg.n_units))
        self.enc_norm = init_norm(cfg, device)
        self.final_norm = init_norm(cfg, device)
        self.head = Head(cfg, device, gen)

    def forward(self, frames, tokens, *, pos_offset: int = 0, cache=None,
                memory_kv=None):
        return forward(self, frames, tokens, self.cfg, pos_offset=pos_offset,
                       cache=cache, memory_kv=memory_kv)


def init_params(gen, cfg: ModelConfig, device) -> EncDec:
    return EncDec(cfg, device, gen)


# ---------------------------------------------------------------- encoder
def _enc_layer(p_layer, x, cfg):
    h = apply_norm(p_layer["pre_norm"], x, cfg)
    a, _ = attn_mod.apply_attn(p_layer["attn"], h, cfg, _SPEC, 0,
                               causal=False)
    x = x + a
    h = apply_norm(p_layer["mlp_norm"], x, cfg)
    return x + apply_mlp(p_layer["mlp"], h, cfg)


def encode(params, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames (B, T, d) stub embeddings -> encoder memory (B, T, d)."""
    x = frames.to(dtype_of(cfg.dtype))
    t = x.shape[1]
    pos = params.enc_pos.pos_embed
    idx = torch.arange(t, device=x.device).clamp(0, pos.shape[0] - 1)
    x = x + pos[idx].to(x.dtype)[None]
    for p_layer in params.enc_units:
        if remat(cfg):
            x = checkpoint(_enc_layer, p_layer, x, cfg, use_reentrant=False)
        else:
            x = _enc_layer(p_layer, x, cfg)
    return apply_norm(params.enc_norm, x, cfg)


def encode_memory_kv(params, memory: torch.Tensor, cfg: ModelConfig):
    """Per-decoder-layer cross K/V (the decode cache's companion)."""
    return [attn_mod.encode_memory_kv(p_layer["cross"], memory, cfg)
            for p_layer in params.dec_units]


# ---------------------------------------------------------------- decoder
def _dec_layer(p_layer, x, memory_kv, cfg, pos_offset, cache):
    h = apply_norm(p_layer["pre_norm"], x, cfg)
    a, new_cache = attn_mod.apply_attn(p_layer["attn"], h, cfg, _SPEC,
                                       pos_offset, cache)
    x = x + a
    h = apply_norm(p_layer["cross_norm"], x, cfg)
    x = x + attn_mod.apply_cross_attn(p_layer["cross"], h, memory_kv, cfg)
    h = apply_norm(p_layer["mlp_norm"], x, cfg)
    x = x + apply_mlp(p_layer["mlp"], h, cfg)
    return x, new_cache


def forward(params, frames: Optional[torch.Tensor], tokens: torch.Tensor,
            cfg: ModelConfig, *, pos_offset: int = 0, cache=None,
            memory_kv=None):
    """Full enc-dec forward. For decode pass ``cache`` + ``memory_kv``
    (from encode_memory_kv) and frames=None.

    Returns (logits, new_cache, aux=0)."""
    if memory_kv is None:
        memory = encode(params, frames, cfg)
        memory_kv = encode_memory_kv(params, memory, cfg)

    x = embed_tokens(params.embed, tokens, cfg, pos_offset=pos_offset)
    has_cache = cache is not None
    new_units = [] if has_cache else None
    for i, p_layer in enumerate(params.dec_units):
        c = cache["units"][i] if has_cache else None
        if c is None and remat(cfg):
            x, new_c = checkpoint(_dec_layer, p_layer, x, memory_kv[i], cfg,
                                  pos_offset, None, use_reentrant=False)
        else:
            x, new_c = _dec_layer(p_layer, x, memory_kv[i], cfg, pos_offset,
                                  c)
        if has_cache:
            new_units.append(new_c)

    x = apply_norm(params.final_norm, x, cfg)
    logits = unembed(params.embed, params.head, x, cfg)
    new_cache = {"units": new_units} if has_cache else None
    return logits, new_cache, torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return {"units": [attn_mod.init_attn_cache(cfg, _SPEC, batch, max_len,
                                               device)
                      for _ in range(cfg.n_units)]}


def train_loss(params, batch, cfg: ModelConfig):
    """(ce + z-loss, metrics ``ce`` and ``moe_aux``; no ``z_loss``, as in
    the reference)."""
    logits, _, aux = forward(params, batch["frames"], batch["tokens"], cfg)
    lse = torch.logsumexp(logits, dim=-1)
    ce = masked_nll(logits, lse, batch["labels"])
    total = ce + 1e-4 * torch.mean(torch.square(lse))
    return total, {"ce": ce, "moe_aux": aux}


# ============================================================ on a mesh
def mesh_ctx(mesh, cfg: ModelConfig, n_rows: int, seq: int) -> MeshCtx:
    """The mesh as the enc-dec stacks see it: the reference pins their
    activations to the batch placement alone (no ``seq_shard``)."""
    return MeshCtx(mesh, dataclasses.replace(cfg, seq_shard=False), n_rows,
                   seq)


def _enc_layer_sharded(ps, xs, cfg, ctx):
    def attn(hs):
        out, partial, _ = attn_mod.apply_attn_sharded(
            [p.attn for p in ps], hs, cfg, ctx, _SPEC, 0, causal=False)
        return out, partial

    xs = residual_sharded(xs, [p.pre_norm for p in ps], cfg, ctx, attn)
    return residual_sharded(
        xs, [p.mlp_norm for p in ps], cfg, ctx,
        lambda hs: apply_mlp_sharded([p.mlp for p in ps], hs, cfg, ctx,
                                     cfg.d_ff))


def encode_sharded(sm, frames, cfg: ModelConfig, ctx: MeshCtx):
    """``encode`` on a local mesh: ``frames`` each position's rows; the
    position table split over ``model`` by rows (``positions_sharded``),
    each layer's fsdp gathers inside it, and under remat each layer,
    collectives included, recomputed in the backward pass. -> each
    position's encoder output (its rows, the whole sequence)."""
    pe = gather_fsdp(sm, "enc_pos.")
    t = frames[0].shape[1]
    pos = positions_sharded([p.pos_embed for p in pe], cfg.enc_seq, 0, t,
                            ctx)
    xs = [f.to(dtype_of(cfg.dtype)) + q.to(dtype_of(cfg.dtype))[None]
          for f, q in zip(frames, pos)]

    def layer(i, xs):
        return _enc_layer_sharded(gather_fsdp(sm, f"enc_units.{i}."), xs,
                                  cfg, ctx)

    for i in range(cfg.n_enc_units):
        if remat(cfg):
            xs = checkpoint(layer, i, xs, use_reentrant=False)
        else:
            xs = layer(i, xs)
    pn = gather_fsdp(sm, "enc_norm.")
    return [apply_norm(p, x, cfg) for p, x in zip(pn, xs)]


def encode_memory_kv_sharded(sm, mems, cfg: ModelConfig, ctx: MeshCtx,
                             specs=None):
    """Per decoder layer, each position's slice of the cross K/V under its
    placement ``specs[i]`` (``launch/specs.cache_shardings``' of
    ``memory_kv``; a training forward's ``attention.memory_kv_spec``
    where None) -> (K/V a layer, each a list of positions' dicts;
    placements a layer)."""
    specs = specs or [{"k": attn_mod.memory_kv_spec(cfg, ctx)}] \
        * cfg.n_units
    out = []
    for i, spec in enumerate(specs):
        ps = gather_fsdp(sm, f"dec_units.{i}.cross.")
        out.append(attn_mod.encode_memory_kv_sharded(ps, mems, cfg, ctx,
                                                     spec["k"]))
    return out, [s["k"] for s in specs]


def _dec_layer_sharded(ps, xs, mems, mem_spec, cfg, ctx, pos_offset,
                       caches, plan):
    new = None

    def attn(hs):
        nonlocal new
        out, partial, new = attn_mod.apply_attn_sharded(
            [p.attn for p in ps], hs, cfg, ctx, _SPEC, pos_offset, caches,
            plan)
        return out, partial

    xs = residual_sharded(xs, [p.pre_norm for p in ps], cfg, ctx, attn)
    xs = residual_sharded(
        xs, [p.cross_norm for p in ps], cfg, ctx,
        lambda hs: attn_mod.apply_cross_attn_sharded(
            [p.cross for p in ps], hs, mems, mem_spec, cfg, ctx))
    xs = residual_sharded(
        xs, [p.mlp_norm for p in ps], cfg, ctx,
        lambda hs: apply_mlp_sharded([p.mlp for p in ps], hs, cfg, ctx,
                                     cfg.d_ff))
    return xs, new


def forward_sharded(sm, frames, tokens, cfg: ModelConfig, *, n_rows: int,
                    pos_offset: int = 0, caches=None, plans=None,
                    memory=None):
    """``forward`` on a local mesh. ``frames`` / ``tokens``: each
    position's rows; ``memory``: (each layer's positions' cross K/V, their
    placements) from ``encode_memory_kv_sharded``, computed here from the
    frames when None. -> (logits, caches, aux, ctx, split) as
    ``transformer.forward_sharded``'s."""
    ctx = mesh_ctx(sm.mesh, cfg, n_rows, tokens[0].shape[1])
    if memory is None:
        mems = encode_sharded(sm, frames, cfg, ctx)
        memory = encode_memory_kv_sharded(sm, mems, cfg, ctx)
    kvs, mem_specs = memory
    pe = gather_fsdp(sm, "embed.")
    xs = embed_tokens_sharded(pe, tokens, cfg, ctx, pos_offset)
    has_cache = caches is not None
    new = [{"units": []} for _ in xs] if has_cache else None

    def layer(i, xs, c_layer=None, plan=None):
        return _dec_layer_sharded(gather_fsdp(sm, f"dec_units.{i}."), xs,
                                  kvs[i], mem_specs[i], cfg, ctx, pos_offset,
                                  c_layer, plan)

    for i in range(cfg.n_units):
        if not has_cache and remat(cfg):
            xs, _ = checkpoint(layer, i, xs, use_reentrant=False)
            continue
        xs, nc = layer(i, xs, [c["units"][i] for c in caches]
                       if has_cache else None,
                       plans["units"][i] if has_cache else None)
        if has_cache:
            for n, c in zip(new, nc):
                n["units"].append(c)
    pf = gather_fsdp(sm, "final_norm.")
    xs = [apply_norm(p, x, cfg) for p, x in zip(pf, xs)]
    logits, split = unembed_sharded(pe, gather_fsdp(sm, "head."), xs, cfg,
                                    ctx)
    aux = [torch.zeros((), device=x.device) for x in xs]
    return logits, new, aux, ctx, split


def train_loss_sharded(sm, batch, cfg: ModelConfig, n_rows: int):
    """``train_loss`` on a local mesh -> each position's (loss, metrics):
    the cross entropy over vocabulary slices and its sums over the batch
    axes as ``transformer.loss_terms_sharded`` takes them."""
    logits, _, aux, ctx, split = forward_sharded(
        sm, batch["frames"], batch["tokens"], cfg, n_rows=n_rows)
    return [(ce + zl, {"ce": ce, "moe_aux": a})
            for (ce, zl), a in zip(loss_terms_sharded(
                logits, batch["labels"], split, ctx, n_rows), aux)]
