"""Mixture-of-Experts layer: top-k routing with capacity-bounded compact
dispatch (GShard-style), sort-based (no O(T*E*C) one-hot tensors). The
port of the reference's ``models/moe.py`` on its ``mesh=None`` path: one
card has no mesh, so every sharding constraint of the reference is the
identity here.

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
from repro_torch.models.layers import MLP, apply_mlp, dense_init


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


def _route(p, xf: torch.Tensor, cfg: ModelConfig):
    """Router in fp32: (top_p, top_e, aux). xf: (..., T, d)."""
    m = cfg.moe
    e, k = m.n_experts, m.top_k
    logits = torch.matmul(xf.float(), p.router.float())
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
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


def _expert_ffn(p, expert_in: torch.Tensor, cfg: ModelConfig):
    """(E, C, d) -> (E, C, d) via the stacked expert weights."""
    dt = expert_in.dtype
    up = torch.matmul(expert_in, p.w_up.to(dt))
    gate = torch.matmul(expert_in, p.w_gate.to(dt))
    if cfg.mlp_kind == "geglu":
        h = F.gelu(gate, approximate="tanh") * up
    else:
        h = F.silu(gate) * up
    return torch.matmul(h, p.w_down.to(dt))


def n_token_groups(cfg: ModelConfig, n_tokens: int) -> int:
    """Capacity-dispatch group count: ``cfg.moe.dispatch_groups`` when it
    divides the tokens, else 1 (the reference's count with no mesh)."""
    g = cfg.moe.dispatch_groups or 1
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
