"""Mixture-of-Experts layer: top-k routing with capacity-bounded compact
dispatch (GShard-style), sort-based (no O(T*E*C) one-hot tensors). The
port of the reference's ``models/moe.py``: ``apply_moe`` is its
``mesh=None`` path, ``apply_moe_sharded`` its mesh path on a local mesh
(shard-local dispatch: a data position dispatches its own token groups;
experts split over ``model`` where ``n_experts`` divides it, else the
expert hidden dimension does).

Tokens live in the expanded [B*S] domain; experts compute in compact
[E, C] buffers; gather/scatter maps translate between the two. Supports
Mixtral (8e top-2) and Arctic (128e top-2 + parallel dense residual MLP).
Router in fp32; returns the switch-style load-balance aux loss.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, apply_mlp, apply_mlp_sharded,
                                       dense_init)
from repro_torch.runtime import spmd
from repro_torch.utils.sharding import MeshAxes


class MoE(nn.Module):
    """``router`` (d, E) and the stacked expert weights ``w_gate`` /
    ``w_up`` (E, d, f) and ``w_down`` (E, f, d); ``dense`` the residual
    MLP when ``moe.dense_residual_ff``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.n_experts, m.d_ff_expert
        self.router = dense_init(gen, (d, e), cfg, device)
        self.w_gate = dense_init(gen, (e, d, f), cfg, device)
        self.w_up = dense_init(gen, (e, d, f), cfg, device)
        self.w_down = dense_init(gen, (e, f, d), cfg, device, out=True)
        if m.dense_residual_ff:
            self.dense = MLP(cfg, device, gen, d_ff=m.dense_residual_ff)


def init_moe(gen, cfg: ModelConfig, device) -> MoE:
    return MoE(cfg, device, gen)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def _top(p, xf: torch.Tensor, cfg: ModelConfig):
    """Router in fp32: (probs, top_p, top_e). xf: (..., T, d)."""
    logits = torch.matmul(xf.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _route(p, xf: torch.Tensor, cfg: ModelConfig):
    """Router in fp32: (top_p, top_e, aux). xf: (..., T, d)."""
    e = cfg.moe.n_experts
    probs, top_p, top_e = _top(p, xf, cfg)
    # switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = F.one_hot(top_e, e).float().reshape(-1, e).mean(dim=0)
    p_e = probs.reshape(-1, e).mean(dim=0)
    aux = e * (f_e * p_e).sum()
    return top_p, top_e, aux


def _dispatch_compact(xf: torch.Tensor, top_p: torch.Tensor,
                      top_e: torch.Tensor, e: int, cap: int):
    """Sort-based capacity dispatch within ONE token group.

    xf (T, d) -> (expert_in (E, cap, d), dest (T*k,), st (T*k,), sg)."""
    t, d = xf.shape
    k = top_e.shape[-1]
    dev = xf.device
    flat_e = top_e.reshape(-1)
    flat_g = top_p.reshape(-1).to(xf.dtype)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = flat_t[order]
    sg = flat_g[order]
    start = torch.searchsorted(se, torch.arange(e, device=dev,
                                                dtype=se.dtype))
    pos_in_e = torch.arange(t * k, device=dev) - start[se]
    keep = pos_in_e < cap
    dest = torch.where(keep, se * cap + pos_in_e, e * cap)  # overflow: dump
    buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=dev)
    buf[dest] = xf[st]
    return buf[: e * cap].reshape(e, cap, d), dest, st, sg


def _combine_compact(expert_out: torch.Tensor, dest: torch.Tensor,
                     st: torch.Tensor, sg: torch.Tensor, t: int):
    e, cap, d = expert_out.shape
    out_flat = torch.cat([expert_out.reshape(e * cap, d),
                          expert_out.new_zeros((1, d))], dim=0)
    vals = out_flat[dest] * sg[:, None]
    return expert_out.new_zeros((t, d)).index_add_(0, st, vals)


def _expert_ffn(p, expert_in: torch.Tensor, cfg: ModelConfig,
                out_dtype=None):
    """(E, C, d) -> (E, C, d) via the stacked expert weights; ``out_dtype``
    as in ``layers.apply_mlp``."""
    dt = expert_in.dtype
    up = torch.matmul(expert_in, p.w_up.to(dt))
    gate = torch.matmul(expert_in, p.w_gate.to(dt))
    if cfg.mlp_kind == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.silu(gate) * up
    od = out_dtype or dt
    return torch.matmul(h.to(od), p.w_down.to(od))


def n_token_groups(cfg: ModelConfig, n_tokens: int, mesh=None) -> int:
    """Capacity-dispatch group count.

    ``cfg.moe.dispatch_groups`` pins it (the count is semantic: capacity
    is bounded per group, so different groupings drop different tokens).
    Unpinned, it is 1 without a mesh and the mesh's batch degree with one,
    so that every dispatch gather and scatter stays on a data position.
    A count that does not divide the tokens falls back to 1."""
    g = cfg.moe.dispatch_groups
    if g is None:
        if mesh is None:
            return 1
        g = 1
        for a in MeshAxes().present(mesh).batch:
            g *= mesh.shape[a]
    return g if (g > 1 and n_tokens % g == 0) else 1


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar). Capacity is
    bounded per token group; the groups run one after another."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_experts
    xf = x.reshape(t, d)

    top_p, top_e, aux = _route(p, xf, cfg)

    g = n_token_groups(cfg, t)
    t_local = t // g
    cap = _capacity(t_local, cfg)
    outs = []
    for i in range(g):
        rows = slice(i * t_local, (i + 1) * t_local)
        expert_in, dest, st, sg = _dispatch_compact(
            xf[rows], top_p[rows], top_e[rows], e, cap)
        expert_out = _expert_ffn(p, expert_in, cfg)
        outs.append(_combine_compact(expert_out, dest, st, sg, t_local))
    out = torch.cat(outs, dim=0).reshape(b, s, d)
    if m.dense_residual_ff:
        out = out + apply_mlp(p.dense, x, cfg)
    return out, aux.float()


def _combine_slice(expert_out: torch.Tensor, dest: torch.Tensor,
                   st: torch.Tensor, sg: torch.Tensor, t: int, first: int):
    """``_combine_compact`` of the experts from ``first`` on that
    ``expert_out`` holds: the other experts' slots go to the dump row."""
    el, cap, _ = expert_out.shape
    local = dest - first * cap
    local = torch.where((local >= 0) & (local < el * cap), local, el * cap)
    return _combine_compact(expert_out, local, st, sg, t)


def apply_moe_sharded(ps, hs, cfg: ModelConfig, ctx, n_rows: int):
    """``apply_moe`` on each position of a local mesh -> (outputs,
    partial, aux). ``hs``: each position's (b, S, d) tokens, ``n_rows``
    the batch's rows in all. Dispatch is shard-local: the token groups
    (``n_token_groups`` with the mesh) are consecutive rows, and a data
    position dispatches the groups of its own rows (a count that does not
    split over the data positions gathers the tokens first). Experts split
    over ``model`` where ``n_experts`` divides it, a position then
    running its own experts on its slice of each group's (E, C, d)
    buffer; else the expert hidden dimension splits (its products then
    float32 until reduced). Either way the outputs are partial sums over
    ``model``. The load-
    balance aux loss takes its expert fractions over every token."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    ep = ctx.tp(e)
    partial = ep or ctx.tp(m.d_ff_expert)
    # a split expert hidden dimension sums float32 partials; whole experts
    # on different positions add one expert's output each, exactly
    od = torch.float32 if partial and not ep else None
    s, d = hs[0].shape[1], hs[0].shape[2]
    t_all = n_rows * s
    g = n_token_groups(cfg, t_all, ctx.mesh)
    nb = spmd.size(ctx.mesh, ctx.batch)
    gathered = nb > 1 and g % nb != 0
    xs = spmd.all_gather(hs, ctx.mesh, ctx.batch, 0) if gathered else hs
    tg = t_all // g
    cap = _capacity(tg, cfg)
    outs, f_sums, p_sums = [], [], []
    for i, (p, x) in enumerate(zip(ps, xs)):
        xf = x.reshape(-1, d)
        probs, top_p, top_e = _top(p, xf, cfg)
        f_sums.append(F.one_hot(top_e, e).float().reshape(-1, e).sum(0))
        p_sums.append(probs.reshape(-1, e).sum(0))
        first = ctx.m_index(i) * (e // ctx.m) if ep else 0
        parts = []
        for j in range(xf.shape[0] // tg):
            rows = slice(j * tg, (j + 1) * tg)
            expert_in, dest, st, sg = _dispatch_compact(
                xf[rows], top_p[rows], top_e[rows], e, cap)
            if ep:
                expert_in = expert_in[first:first + e // ctx.m]
            parts.append(_combine_slice(
                _expert_ffn(p, expert_in, cfg, od), dest, st, sg, tg,
                first))
        outs.append(torch.cat(parts, dim=0).reshape(x.shape))
    if gathered:
        outs = spmd.slice_along(outs, ctx.mesh, ctx.batch, 0)
    elif nb > 1:
        f_sums = spmd.all_reduce(f_sums, ctx.mesh, ctx.batch)
        p_sums = spmd.all_reduce(p_sums, ctx.mesh, ctx.batch)
    aux = [e * ((fs / (t_all * k)) * (pe / t_all)).sum()
           for fs, pe in zip(f_sums, p_sums)]
    if m.dense_residual_ff:
        dense, d_partial = apply_mlp_sharded(
            [p.dense for p in ps], hs, cfg, ctx, m.dense_residual_ff)
        if d_partial != partial:   # bring the partial one to whole
            if partial:
                outs = spmd.all_reduce(outs, ctx.mesh, ctx.model)
            else:
                dense = spmd.all_reduce(dense, ctx.mesh, ctx.model)
            partial = False
        outs = [o + q for o, q in zip(outs, dense)]
    return outs, partial, aux
