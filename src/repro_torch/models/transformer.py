"""Decoder-only LM assembly: a repeating unit of layers run ``n_units``
times plus a tail, the port of the reference's ``models/transformer.py``.
The reference scans one stacked parameter tree over the units
(``lax.scan``); here the units are an ``nn.ModuleList`` and a loop.

Covers dense (tinyllama/qwen/smollm), local+global alternating (gemma2),
SWA MoE (mixtral), MoE + dense residual (arctic), hybrid RG-LRU (recurrent-
gemma), attention-free SSD (mamba2), and the VLM backbone (llava, patch-
prefix stub). The decode cache is ``{"units": [unit cache, ...], "tail":
{...}}``, a unit cache ``{"l0": layer cache, ...}``.

With ``cfg.remat == "full"`` and gradients on, each unit runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its scan
body): its activations are recomputed in the backward pass, not kept.

``forward_sharded`` and ``train_loss_sharded`` run a decoder on a local
mesh (``runtime/spmd.py``): a model whose parameters are split by
``utils/sharding.param_specs`` (``models/model.ShardedModel``),
activations split over the batch axes (and over ``model`` along the
sequence between layers under ``cfg.seq_shard``: ``activation_spec``),
each layer's mixer (``apply_attn_sharded``, ``apply_rec_sharded``,
``apply_ssm_sharded``) and MLP split over ``model``, the ``tail`` layers'
leaves moved to a unit's layout (``gather_unstacked``), the logits split
over the vocabulary, a unit's fsdp gathers inside it, and under remat a
whole sharded unit, collectives included, recomputed in the backward
pass.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (Head, MeshCtx, apply_mlp,
                                       apply_mlp_sharded, apply_norm,
                                       embed_tokens, embed_tokens_sharded,
                                       gather_fsdp, gather_unstacked,
                                       init_embed, init_mlp, init_norm,
                                       unembed, unembed_sharded)
from repro_torch.runtime import spmd


# ======================================================================
# single layer
# ======================================================================
class Layer(nn.Module):
    """``pre_norm``, the mixer (``attn`` / ``rec`` / ``ssm``),
    ``post_norm`` (gemma2), and unless the layer is an SSM ``mlp_norm``,
    ``mlp`` or ``moe``, ``mlp_post_norm``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device, gen=None):
        super().__init__()
        self.pre_norm = init_norm(cfg, device)
        if spec.kind == "attn":
            self.attn = attn_mod.init_attn(gen, cfg, device)
        elif spec.kind == "rec":
            self.rec = rec_mod.init_rec(gen, cfg, device)
        else:
            self.ssm = ssm_mod.init_ssm(gen, cfg, device)
        if cfg.post_norms:
            self.post_norm = init_norm(cfg, device)
        if spec.kind != "ssm":  # mamba2 layers are mixer-only
            self.mlp_norm = init_norm(cfg, device)
            if cfg.moe is not None:
                self.moe = moe_mod.init_moe(gen, cfg, device)
            else:
                self.mlp = init_mlp(gen, cfg, device)
            if cfg.post_norms:
                self.mlp_post_norm = init_norm(cfg, device)


def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, device) -> Layer:
    return Layer(cfg, spec, device, gen)


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int, device):
    if spec.kind == "attn":
        return attn_mod.init_attn_cache(cfg, spec, batch, max_len, device)
    if spec.kind == "rec":
        return rec_mod.init_rec_cache(cfg, batch, device)
    return ssm_mod.init_ssm_cache(cfg, batch, device)


def apply_layer(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                pos_offset: int, cache=None
                ) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """-> (x, new_cache, aux_loss)."""
    aux = torch.zeros((), device=x.device)
    h = apply_norm(p.pre_norm, x, cfg)
    if spec.kind == "attn":
        mixed, new_cache = attn_mod.apply_attn(p.attn, h, cfg, spec,
                                               pos_offset, cache)
    elif spec.kind == "rec":
        mixed, new_cache = rec_mod.apply_rec(p.rec, h, cfg, cache)
    else:
        mixed, new_cache = ssm_mod.apply_ssm(p.ssm, h, cfg, cache)
    if cfg.post_norms:
        mixed = apply_norm(p.post_norm, mixed, cfg)
    x = x + mixed

    if spec.kind != "ssm":
        h = apply_norm(p.mlp_norm, x, cfg)
        if cfg.moe is not None:
            m, aux = moe_mod.apply_moe(p.moe, h, cfg)
        else:
            m = apply_mlp(p.mlp, h, cfg)
        if cfg.post_norms:
            m = apply_norm(p.mlp_post_norm, m, cfg)
        x = x + m
    return x, new_cache, aux


# ======================================================================
# unit (the repeating group of layers) + the whole model
# ======================================================================
def init_unit(gen, cfg: ModelConfig, device) -> nn.ModuleDict:
    return nn.ModuleDict({f"l{i}": init_layer(gen, cfg, spec, device)
                          for i, spec in enumerate(cfg.unit)})


def init_unit_cache(cfg: ModelConfig, specs, batch: int, max_len: int,
                    device):
    return {f"l{i}": init_layer_cache(cfg, spec, batch, max_len, device)
            for i, spec in enumerate(specs)}


def apply_unit(p_unit, x: torch.Tensor, cfg: ModelConfig, specs,
               pos_offset: int, cache=None):
    aux = torch.zeros((), device=x.device)
    new_cache = {} if cache is not None else None
    for i, spec in enumerate(specs):
        li = f"l{i}"
        x, nc, a = apply_layer(p_unit[li], x, cfg, spec, pos_offset,
                               None if cache is None else cache[li])
        if cache is not None:
            new_cache[li] = nc
        aux = aux + a
    return x, new_cache, aux


def remat(cfg: ModelConfig) -> bool:
    """Whether a forward recomputes each unit in its backward pass: the
    config asks for it and gradients are being recorded (serving, under
    ``no_grad``, never does)."""
    return cfg.remat == "full" and torch.is_grad_enabled()


class Transformer(nn.Module):
    """``embed``, ``units`` (one ``ModuleDict`` of layers a unit),
    ``tail``, ``final_norm`` and, untied, ``head``. Parameter names are the
    reference's tree paths with the unit index after ``units``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.cfg = cfg
        self.embed = init_embed(gen, cfg, device)
        self.units = nn.ModuleList(init_unit(gen, cfg, device)
                                   for _ in range(cfg.n_units))
        if cfg.tail:
            self.tail = nn.ModuleDict({
                f"t{i}": init_layer(gen, cfg, spec, device)
                for i, spec in enumerate(cfg.tail)})
        self.final_norm = init_norm(cfg, device)
        if not cfg.tie_embeddings:
            self.head = Head(cfg, device, gen)

    def forward(self, tokens, *, pos_offset: int = 0, cache=None,
                prefix_embeds=None):
        return forward(self, tokens, self.cfg, pos_offset=pos_offset,
                       cache=cache, prefix_embeds=prefix_embeds)


def init_params(gen, cfg: ModelConfig, device) -> Transformer:
    return Transformer(cfg, device, gen)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    cache = {"units": [init_unit_cache(cfg, cfg.unit, batch, max_len, device)
                       for _ in range(cfg.n_units)]}
    if cfg.tail:
        cache["tail"] = {f"t{i}": init_layer_cache(cfg, spec, batch, max_len,
                                                   device)
                         for i, spec in enumerate(cfg.tail)}
    return cache


# ======================================================================
# forward
# ======================================================================
def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            pos_offset: int = 0, cache=None,
            prefix_embeds: Optional[torch.Tensor] = None):
    """tokens (B, S) int -> (logits (B, S_total, V), new_cache, aux)."""
    x = embed_tokens(params.embed, tokens, cfg, pos_offset=pos_offset)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)

    has_cache = cache is not None
    aux = torch.zeros((), device=x.device)
    new_units = [] if has_cache else None
    for i, p_unit in enumerate(params.units):
        c_unit = cache["units"][i] if has_cache else None
        if c_unit is None and remat(cfg):
            x, new_c, a = checkpoint(apply_unit, p_unit, x, cfg, cfg.unit,
                                     pos_offset, None, use_reentrant=False)
        else:
            x, new_c, a = apply_unit(p_unit, x, cfg, cfg.unit, pos_offset,
                                     c_unit)
        aux = aux + a
        if has_cache:
            new_units.append(new_c)

    new_cache = {"units": new_units} if has_cache else None
    if cfg.tail:
        if has_cache:
            new_cache["tail"] = {}
        for i, spec in enumerate(cfg.tail):
            ti = f"t{i}"
            c = cache["tail"][ti] if has_cache else None
            x, nc, a = apply_layer(params.tail[ti], x, cfg, spec, pos_offset,
                                   c)
            aux = aux + a
            if has_cache:
                new_cache["tail"][ti] = nc

    x = apply_norm(params.final_norm, x, cfg)
    logits = unembed(params.embed, getattr(params, "head", None), x, cfg)
    return logits, new_cache, aux


# ======================================================================
# losses
# ======================================================================
def masked_nll(logits: torch.Tensor, lse: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Mean of lse - the label's logit over positions with label >= 0,
    given the logsumexp ``lse`` (which the z-loss shares)."""
    label_logit = torch.gather(
        logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - label_logit) * mask).sum() / mask.sum().clamp_min(1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean CE over positions with label >= 0; logits fp32 (B,S,V).
    The reference selects the label's logit with an iota compare so a
    vocab-sharded tensor reduces locally; on one card a gather is the same
    function."""
    return masked_nll(logits, torch.logsumexp(logits, dim=-1), labels)


def train_loss(params, batch, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, dict]:
    """(ce + z-loss [+ MoE aux], metrics ``ce``, ``z_loss``, ``moe_aux``);
    the patch prefix's positions (llava) carry no label."""
    prefix = batch.get("prefix_embeds")
    logits, _, aux = forward(params, batch["tokens"], cfg,
                             prefix_embeds=prefix)
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    lse = torch.logsumexp(logits, dim=-1)
    ce = masked_nll(logits, lse, batch["labels"])
    # z-loss for logit drift control (PaLM-style)
    zl = 1e-4 * torch.mean(torch.square(lse))
    total = ce + zl
    if cfg.moe is not None:
        total = total + cfg.moe.aux_loss_weight * aux
    return total, {"ce": ce, "z_loss": zl, "moe_aux": aux}


# ======================================================================
# on a local mesh
# ======================================================================
def activation_spec(cfg: ModelConfig, mesh, x) -> tuple:
    """Inter-layer activation placement of a (B, S, d) ``x``: the batch
    over the batch axes (replicated where it does not divide them), plus
    the sequence over ``model`` when ``cfg.seq_shard`` is on and S
    divides (Megatron SP); ``MeshCtx``'s layout."""
    ctx = MeshCtx(mesh, cfg, x.shape[0], x.shape[1])
    return (ctx.batch, ctx.model if ctx.seq else None, None)


def residual_sharded(xs, norms, cfg: ModelConfig, ctx: MeshCtx, block,
                     post_norms=None):
    """x + block(norm(x)) on each position: the normed inputs gathered
    over the sequence where it splits, ``block(hs) -> (outputs,
    partial)``, its outputs reduced or sliced back to the activation
    layout (``MeshCtx.finish``) in the activations' dtype, and
    ``post_norms`` (gemma2) applied before the sum."""
    hs = ctx.gather_seq([apply_norm(p, x, cfg) for p, x in zip(norms, xs)])
    out, partial = block(hs)
    out = [m.to(x.dtype) for m, x in zip(ctx.finish(out, partial), xs)]
    if post_norms is not None:
        out = [apply_norm(p, m, cfg) for p, m in zip(post_norms, out)]
    return [x + m for x, m in zip(xs, out)]


def _layer_sharded(ps, xs, cfg: ModelConfig, ctx: MeshCtx, spec: LayerSpec,
                   pos_offset: int, n_rows: int, caches=None, plan=None):
    """``apply_layer`` on each position -> (xs, caches, aux): the mixer
    its ``spec.kind`` names, then, unless it is an SSM (mixer-only), the
    MLP or MoE block."""
    def post(name):
        return [getattr(p, name) for p in ps] if cfg.post_norms else None

    new = None

    def mixer(hs):
        nonlocal new
        if spec.kind == "attn":
            out, partial, new = attn_mod.apply_attn_sharded(
                [p.attn for p in ps], hs, cfg, ctx, spec, pos_offset, caches,
                plan)
        elif spec.kind == "rec":
            out, partial, new = rec_mod.apply_rec_sharded(
                [p.rec for p in ps], hs, cfg, ctx, caches)
        else:
            out, partial, new = ssm_mod.apply_ssm_sharded(
                [p.ssm for p in ps], hs, cfg, ctx, caches)
        return out, partial

    xs = residual_sharded(xs, [p.pre_norm for p in ps], cfg, ctx, mixer,
                          post("post_norm"))
    aux = [torch.zeros((), device=x.device) for x in xs]
    if spec.kind == "ssm":
        return xs, new, aux

    def mlp(hs):
        nonlocal aux
        if cfg.moe is not None:
            out, partial, aux = moe_mod.apply_moe_sharded(
                [p.moe for p in ps], hs, cfg, ctx, n_rows)
            return out, partial
        return apply_mlp_sharded([p.mlp for p in ps], hs, cfg, ctx,
                                 cfg.d_ff)

    xs = residual_sharded(xs, [p.mlp_norm for p in ps], cfg, ctx, mlp,
                          post("mlp_post_norm"))
    return xs, new, aux


def _unit_sharded(sm, i: int, xs, cfg: ModelConfig, ctx: MeshCtx,
                  pos_offset: int, n_rows: int, caches=None, plans=None):
    """Unit i on each position, its weights' fsdp gathers inside it (the
    reference pins each scan slice so the gather stays per unit)."""
    ps = gather_fsdp(sm, f"units.{i}.")
    aux = [torch.zeros((), device=x.device) for x in xs]
    new = None if caches is None else [{} for _ in xs]
    for li, spec in enumerate(cfg.unit):
        key = f"l{li}"
        xs, nc, a = _layer_sharded(
            [getattr(p, key) for p in ps], xs, cfg, ctx, spec, pos_offset,
            n_rows, None if caches is None else [c[key] for c in caches],
            None if plans is None else plans[key])
        aux = [u + v for u, v in zip(aux, a)]
        if caches is not None:
            for n, c in zip(new, nc):
                n[key] = c
    return xs, aux, new


def forward_sharded(sm, tokens, cfg: ModelConfig, *, n_rows: int,
                    pos_offset: int = 0, caches=None, plans=None,
                    prefix=None):
    """``forward`` on a local mesh. ``tokens`` (and ``prefix``): each
    position's rows of the batch of ``n_rows``, placed by
    ``launch/specs.batch_shardings``; ``caches``: each position's cache
    tree, ``plans`` their placement. -> (logits, caches, aux, ctx,
    split): each position's float32 logits over its whole sequence, of
    its vocabulary slice where ``split``."""
    s_total = tokens[0].shape[1] + (0 if prefix is None
                                    else prefix[0].shape[1])
    ctx = MeshCtx(sm.mesh, cfg, n_rows, s_total)
    pe = gather_fsdp(sm, "embed.")
    xs = embed_tokens_sharded(pe, tokens, cfg, ctx, pos_offset)
    if prefix is not None:
        xs = [torch.cat([q.to(x.dtype), x], dim=1)
              for q, x in zip(prefix, xs)]
    xs = ctx.slice_seq(xs)
    aux = [torch.zeros((), device=x.device) for x in xs]
    has_cache = caches is not None
    new_units = [] if has_cache else None
    for i in range(cfg.n_units):
        c_unit = [c["units"][i] for c in caches] if has_cache else None
        p_unit = plans["units"][i] if has_cache else None
        if not has_cache and remat(cfg):
            xs, a, nc = checkpoint(_unit_sharded, sm, i, xs, cfg, ctx,
                                   pos_offset, n_rows, use_reentrant=False)
        else:
            xs, a, nc = _unit_sharded(sm, i, xs, cfg, ctx, pos_offset,
                                      n_rows, c_unit, p_unit)
        aux = [u + v for u, v in zip(aux, a)]
        if has_cache:
            new_units.append(nc)
    new = [{"units": [u[p] for u in new_units]} for p in range(len(xs))] \
        if has_cache else None
    for ti, spec in ((f"t{i}", s) for i, s in enumerate(cfg.tail)):
        xs, nc, a = _layer_sharded(
            gather_unstacked(sm, f"tail.{ti}."), xs, cfg, ctx, spec,
            pos_offset, n_rows,
            [c["tail"][ti] for c in caches] if has_cache else None,
            plans["tail"][ti] if has_cache else None)
        aux = [u + v for u, v in zip(aux, a)]
        if has_cache:
            for n, c in zip(new, nc):
                n.setdefault("tail", {})[ti] = c
    pf = gather_fsdp(sm, "final_norm.")
    xs = ctx.gather_seq([apply_norm(p, x, cfg) for p, x in zip(pf, xs)])
    logits, split = unembed_sharded(
        pe, None if cfg.tie_embeddings else gather_fsdp(sm, "head."), xs,
        cfg, ctx)
    return logits, new, aux, ctx, split


def _ce_terms(logits, labels, split: bool, ctx: MeshCtx):
    """Each position's (logsumexp, label logit) over the vocabulary; over
    vocabulary slices a max, a sum of exponentials and the label's logit
    (zero where another position holds the label) reduce over
    ``model``."""
    if not split:
        lse = [torch.logsumexp(l, dim=-1) for l in logits]
        picked = [torch.gather(l, -1, y.clamp_min(0).long()[..., None])
                  [..., 0] for l, y in zip(logits, labels)]
        return lse, picked
    mesh, model = ctx.mesh, ctx.model
    mx = spmd.all_reduce([l.detach().amax(dim=-1) for l in logits], mesh,
                         model, op="max")
    se = spmd.all_reduce([torch.exp(l - m[..., None]).sum(dim=-1)
                          for l, m in zip(logits, mx)], mesh, model)
    lse = [torch.log(s) + m for s, m in zip(se, mx)]
    vl = logits[0].shape[-1]
    picked = []
    for i, (l, y) in enumerate(zip(logits, labels)):
        local = y.long() - ctx.m_index(i) * vl
        here = (local >= 0) & (local < vl)
        got = torch.gather(l, -1, local.clamp(0, vl - 1)[..., None])[..., 0]
        picked.append(torch.where(here, got, torch.zeros(
            (), dtype=got.dtype, device=got.device)))
    return lse, spmd.all_reduce(picked, mesh, model)


def loss_terms_sharded(logits, labels, split: bool, ctx: MeshCtx,
                       n_rows: int):
    """Each position's (mean CE over labels >= 0, z-loss) of its logits
    (``_ce_terms``); the sums over tokens reduce over the batch axes."""
    lse, picked = _ce_terms(logits, labels, split, ctx)
    sums = []
    for y, s_, p_ in zip(labels, lse, picked):
        mask = (y >= 0).float()
        sums.append(torch.stack([((s_ - p_) * mask).sum(), mask.sum(),
                                 torch.square(s_).sum()]))
    if ctx.batch:
        sums = spmd.all_reduce(sums, ctx.mesh, ctx.batch)
    n_tok = n_rows * labels[0].shape[1]
    return [(t[0] / t[1].clamp_min(1.0), 1e-4 * (t[2] / n_tok))
            for t in sums]


def train_loss_sharded(sm, batch, cfg: ModelConfig, n_rows: int):
    """``train_loss`` on a local mesh -> each position's (loss, metrics),
    equal on every position. ``batch``: name -> each position's rows.
    The cross entropy runs over vocabulary slices (``_ce_terms``); the
    sums over tokens reduce over the batch axes."""
    prefix = batch.get("prefix_embeds")
    logits, _, aux, ctx, split = forward_sharded(
        sm, batch["tokens"], cfg, n_rows=n_rows, prefix=prefix)
    if prefix is not None:
        logits = [l[:, prefix[0].shape[1]:] for l in logits]
    out = []
    for (ce, zl), a in zip(loss_terms_sharded(logits, batch["labels"], split,
                                              ctx, n_rows), aux):
        total = ce + zl
        if cfg.moe is not None:
            total = total + cfg.moe.aux_loss_weight * a
        out.append((total, {"ce": ce, "z_loss": zl, "moe_aux": a}))
    return out
