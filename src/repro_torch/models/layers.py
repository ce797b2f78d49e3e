"""Shared neural layers in plain PyTorch: norms, RoPE, embeddings,
dense/gated MLPs. The port of the reference's ``models/layers.py``.

Each layer kind is an ``nn.Module`` whose parameters carry the
reference's leaf names (``p["w_up"]`` there is ``p.w_up`` here), and each
``apply_*`` function is the reference's, taking that module as ``p``.
Parameters are drawn from an explicit ``torch.Generator`` on the module's
device (truncated normal: scale/sqrt(fan_in) for output projections,
``init_scale`` for the rest); with no generator a module's storage is
left empty for ``interop.params_from_numpy`` to fill. Parameters are built
without ``requires_grad``, so serving records no graph; the train step
turns gradients on for the model it trains.

On a local mesh (``runtime/spmd.py``) each layer kind has a ``*_sharded``
form over lists of position tensors: ``gather_fsdp`` gathers each
weight's fsdp dimension over ``data`` before use (ZeRO-3), the embedding
is a vocabulary-parallel lookup (a masked local gather, then a sum over
``model``; a learned position table the same by its rows),
``gather_unstacked`` moves the ``tail`` layers' leaves to a unit's
layout, ``unembed_sharded`` leaves the logits split over the
vocabulary as the reference pins them, and the MLP is column- then
row-parallel over its hidden dimension. ``MeshCtx`` says how a forward
sees the mesh.
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.runtime import spmd
from repro_torch.utils.sharding import (MeshAxes, batch_axes_for,
                                       spec_for_param)

#: the standard normal's CDF at the truncation points -2 and 2
_CDF_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
_CDF_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))


def dtype_of(name: str) -> torch.dtype:
    """``'float32'`` / ``'bfloat16'`` / ... -> the torch dtype."""
    return getattr(torch, name)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def trunc_normal(gen: Optional[torch.Generator], shape, scale: float, dtype,
                 device) -> torch.Tensor:
    """Normal values truncated to [-2, 2], times ``scale`` (inverse CDF of
    a uniform draw from ``gen``); empty storage when ``gen`` is None."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    u = _CDF_LO + u * (_CDF_HI - _CDF_LO)
    x = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    return (x.clamp(-2.0, 2.0) * scale).to(dtype)


def dense_init(gen, shape, cfg: ModelConfig, device, *, out: bool = False):
    fan_in = shape[0] if not out else max(1, math.prod(shape[:-1]))
    scale = cfg.init_scale if not out else cfg.init_scale / (fan_in ** 0.5)
    return param(trunc_normal(gen, shape, scale, dtype_of(cfg.param_dtype),
                              device))


def const(shape, value: float, cfg: ModelConfig, device) -> nn.Parameter:
    return param(torch.full(shape, value, dtype=dtype_of(cfg.param_dtype),
                            device=device))


# ------------------------------------------------------------------- norms
class Norm(nn.Module):
    """RMS norm, or layer norm with a bias (``cfg.norm == 'ln'``); the
    (1 + scale) parameterisation, scale zero at init."""

    def __init__(self, cfg: ModelConfig, device, d: Optional[int] = None):
        super().__init__()
        d = d or cfg.d_model
        self.scale = const((d,), 0.0, cfg, device)
        if cfg.norm == "ln":
            self.bias = const((d,), 0.0, cfg, device)


def init_norm(cfg: ModelConfig, device, d: Optional[int] = None) -> Norm:
    return Norm(cfg, device, d)


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "ln":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * (1.0 + p.scale.float()) + p.bias.float()
    else:  # rms, (1+scale) parameterisation (gemma/llama-compatible)
        ms = xf.square().mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps)
        out = out * (1.0 + p.scale.float())
    return out.to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_sincos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> (sin, cos) each (..., S, head_dim//2) f32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (idx / half))
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); sin/cos: (B, S, D//2) or (S, D//2)."""
    half = x.shape[-1] // 2
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    xf1 = x[..., :half].float()
    xf2 = x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# -------------------------------------------------------------- embeddings
class Embed(nn.Module):
    """The token table (``vocab_padded`` rows) and, for learned positions,
    the position table."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        pd = dtype_of(cfg.param_dtype)
        self.tok_embed = param(trunc_normal(
            gen, (cfg.vocab_padded, cfg.d_model), cfg.init_scale, pd, device))
        if cfg.pos_embed == "learned":
            self.pos_embed = param(trunc_normal(
                gen, (pos_table_rows(cfg), cfg.d_model), 0.02, pd, device))


def pos_table_rows(cfg: ModelConfig) -> int:
    """Rows of the learned position table."""
    return min(cfg.max_seq, 65536)


def init_embed(gen, cfg: ModelConfig, device) -> Embed:
    return Embed(cfg, device, gen)


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 pos_offset: int = 0) -> torch.Tensor:
    x = F.embedding(tokens, p.tok_embed).to(dtype_of(cfg.dtype))
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if cfg.pos_embed == "learned":
        s = tokens.shape[-1]
        pos = pos_offset + torch.arange(s, device=tokens.device)
        pos = pos.clamp(0, p.pos_embed.shape[0] - 1)
        x = x + p.pos_embed[pos].to(x.dtype)
    return x


class Head(nn.Module):
    """The untied output table."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        self.lm_head = param(trunc_normal(
            gen, (cfg.vocab_padded, cfg.d_model), cfg.init_scale,
            dtype_of(cfg.param_dtype), device))


def unembed(p_embed, p_head, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """(B, S, d) -> float32 logits (B, S, vocab_padded), soft-capped."""
    table = p_embed.tok_embed if cfg.tie_embeddings else p_head.lm_head
    logits = torch.matmul(x.float(), table.float().t())
    if cfg.logit_softcap is not None:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# --------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """``w_up`` / ``w_down``, and ``w_gate`` for the gated kinds."""

    def __init__(self, cfg: ModelConfig, device, gen=None,
                 d_ff: Optional[int] = None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_up = dense_init(gen, (d, f), cfg, device)
        self.w_down = dense_init(gen, (f, d), cfg, device, out=True)
        if cfg.mlp_kind in ("swiglu", "geglu"):
            self.w_gate = dense_init(gen, (d, f), cfg, device)


def init_mlp(gen, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> MLP:
    return MLP(cfg, device, gen, d_ff)


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``out_dtype``: the dtype the output projection computes and returns
    in (a row-parallel partial sum keeps float32 until it is reduced)."""
    dt = x.dtype
    up = torch.matmul(x, p.w_up.to(dt))
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.matmul(x, p.w_gate.to(dt))) * up
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(torch.matmul(x, p.w_gate.to(dt)),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    od = out_dtype or dt
    return torch.matmul(h.to(od), p.w_down.to(od))


# ================================================================ sharded
class MeshCtx:
    """How a sharded forward sees a local mesh: its model axis (None when
    absent or of size 1), the batch axes its ``batch`` rows split over
    (None: the batch replicates, as ``launch/specs.batch_shardings``
    places it), and whether the sequence of ``seq`` positions splits over
    ``model`` between layers (``cfg.seq_shard``, Megatron sequence
    parallelism, where ``seq`` divides)."""

    def __init__(self, mesh, cfg: ModelConfig, batch: int, seq: int):
        axes = MeshAxes().present(mesh)
        self.mesh = mesh
        self.model = axes.model if spmd.size(mesh, axes.model) > 1 else None
        self.m = spmd.size(mesh, self.model)
        self.batch = batch_axes_for(mesh, batch)
        self.seq = bool(cfg.seq_shard and self.model and seq % self.m == 0)

    def tp(self, dim: int) -> bool:
        """Whether a dimension of ``dim`` splits over ``model``."""
        return self.model is not None and dim % self.m == 0

    def m_index(self, p: int) -> int:
        return spmd.coord(self.mesh, p, self.model) if self.model else 0

    def gather_seq(self, xs):
        """Sequence shards -> the whole sequence, before a block."""
        if not self.seq:
            return list(xs)
        return spmd.all_gather(xs, self.mesh, self.model, 1)

    def slice_seq(self, xs):
        if not self.seq:
            return list(xs)
        return spmd.slice_along(xs, self.mesh, self.model, 1)

    def finish(self, xs, partial: bool):
        """A block's outputs back to the activation layout: partial sums
        over ``model`` are reduced (scattered over the sequence under
        ``seq_shard``); whole outputs keep their own sequence slice."""
        if partial:
            if self.seq:
                return spmd.reduce_scatter(xs, self.mesh, self.model, 1)
            return spmd.all_reduce(xs, self.mesh, self.model)
        return self.slice_seq(xs)


def _ns_set(ns, path: str, value) -> None:
    *parents, leaf = path.split(".")
    for key in parents:
        if not hasattr(ns, key):
            setattr(ns, key, SimpleNamespace())
        ns = getattr(ns, key)
    setattr(ns, leaf, value)


def gather_fsdp(sm, prefix: str) -> List:
    """Each position's parameters under ``prefix`` of a sharded model,
    as nested namespaces (``p.attn.wq``), each weight's fsdp dimension
    gathered over ``data``; ``model`` splits stay."""
    fsdp = (MeshAxes().present(sm.mesh).fsdp,)
    out = [SimpleNamespace() for _ in range(sm.mesh.size)]
    for name in sm.names:
        if not name.startswith(prefix):
            continue
        xs, spec = sm.shards(name), sm.specs[name]
        for dim, entry in enumerate(spec):
            axes = spmd.axes_of(entry)
            if axes == fsdp:
                xs = spmd.all_gather(xs, sm.mesh, axes, dim)
        for p, x in enumerate(xs):
            _ns_set(out[p], name[len(prefix):], x)
    return out


def gather_unstacked(sm, prefix: str) -> List:
    """``gather_fsdp`` for the ``tail`` layers: the reference places a
    tail leaf as if it were stacked (its first dimension whole, each rule
    moved one dimension on: ``w_x`` (None, 'data'), ``w_out`` (None,
    'model')), which no tensor-parallel pattern uses, so each leaf is
    moved (``spmd.relayout``, its all-gathers counted) to the placement a
    unit's leaf of its name has once ``gather_fsdp`` has gathered it."""
    mesh = sm.mesh
    axes = MeshAxes().present(mesh)
    out = [SimpleNamespace() for _ in range(mesh.size)]
    for name in sm.names:
        if not name.startswith(prefix):
            continue
        xs, spec = sm.shards(name), sm.specs[name]
        shape = spmd.full_shape(xs[0].shape, spec, mesh)
        unit = spec_for_param(name.replace(".", "/"), shape, mesh, axes)
        unit = tuple(None if spmd.axes_of(e) == (axes.fsdp,) else e
                     for e in unit)
        xs = spmd.relayout(xs, mesh, spec, unit)
        for p, x in enumerate(xs):
            _ns_set(out[p], name[len(prefix):], x)
    return out


def _lookup(table: torch.Tensor, ids: torch.Tensor, split: bool,
            m_index: int) -> torch.Tensor:
    """Rows ``ids`` of a table, or of this position's slice of a table
    split over ``model`` by rows (zero where another position holds the
    row)."""
    if not split:
        return F.embedding(ids, table)
    rows = table.shape[0]
    local = ids.long() - m_index * rows
    here = (local >= 0) & (local < rows)
    got = F.embedding(local.clamp(0, rows - 1), table)
    return torch.where(here[..., None], got, torch.zeros(
        (), dtype=got.dtype, device=got.device))


def lookup_sharded(tables, ids, ctx: MeshCtx, rows: int):
    """Rows ``ids`` (each position's) of a table of ``rows`` rows that
    splits over ``model`` by rows where they divide it: a masked local
    gather, then a sum over ``model``."""
    split = ctx.tp(rows)
    xs = [_lookup(t, i, split, ctx.m_index(p))
          for p, (t, i) in enumerate(zip(tables, ids))]
    return spmd.all_reduce(xs, ctx.mesh, ctx.model) if split else xs


def positions_sharded(tables, rows: int, start: int, n: int, ctx: MeshCtx):
    """Rows ``start`` to ``start + n`` (clamped to the last) of a learned
    position table of ``rows`` rows on each position, split over
    ``model`` by rows."""
    idx = [(start + torch.arange(n, device=t.device)).clamp(0, rows - 1)
           for t in tables]
    return lookup_sharded(tables, idx, ctx, rows)


def embed_tokens_sharded(ps, tokens, cfg: ModelConfig, ctx: MeshCtx,
                         pos_offset: int = 0):
    """``embed_tokens`` on each position: the vocabulary-parallel lookup
    (a masked local gather, then a sum over ``model``), and the learned
    position table's rows looked up the same way."""
    xs = lookup_sharded([p.tok_embed for p in ps], tokens, ctx,
                        cfg.vocab_padded)
    xs = [x.to(dtype_of(cfg.dtype)) for x in xs]
    if cfg.emb_scale:
        xs = [x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                               device=x.device) for x in xs]
    if cfg.pos_embed == "learned":
        pos = positions_sharded([p.pos_embed for p in ps],
                                pos_table_rows(cfg), pos_offset,
                                tokens[0].shape[-1], ctx)
        xs = [x + q.to(x.dtype) for x, q in zip(xs, pos)]
    return xs


def unembed_sharded(ps_embed, ps_head, xs, cfg: ModelConfig, ctx: MeshCtx):
    """``unembed`` on each position -> (logits, split): float32 logits of
    each position's vocabulary slice where ``vocab_padded`` splits over
    ``model`` (the reference pins them so), else whole."""
    out = []
    for i, x in enumerate(xs):
        table = ps_embed[i].tok_embed if cfg.tie_embeddings \
            else ps_head[i].lm_head
        logits = torch.matmul(x.float(), table.float().t())
        if cfg.logit_softcap is not None:
            c = cfg.logit_softcap
            logits = c * torch.tanh(logits / c)
        out.append(logits)
    return out, ctx.tp(cfg.vocab_padded)


def apply_mlp_sharded(ps, hs, cfg: ModelConfig, ctx: MeshCtx, d_ff: int):
    """``apply_mlp`` on each position -> (outputs, partial): column- then
    row-parallel where the hidden dimension ``d_ff`` splits over
    ``model``, the outputs then float32 partial sums over it (a bf16
    output is rounded once, after the sum, as the unsplit product rounds
    it)."""
    partial = ctx.tp(d_ff)
    od = torch.float32 if partial else None
    return [apply_mlp(p, h, cfg, od) for p, h in zip(ps, hs)], partial
