"""Griffin recurrent block with the RG-LRU cell [arXiv:2402.19427]
(RecurrentGemma's mixer): the port of the reference's ``models/rglru.py``.

Block: y = W_out( GeLU(W_gate x)  *  RGLRU( Conv1D_4( W_x x ) ) ).
RG-LRU: r_t, i_t gates from the branch input; a_t = exp(-c softplus(L) r_t);
h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t). The linear recurrence runs
as a doubling scan (log2 S vector steps of the reference's combine, where
the reference runs ``lax.associative_scan``: the same sums in another
order); decode carries (h, conv window) -- O(1)/token.
``apply_rec_sharded`` runs the block split over a local mesh's ``model``
axis by channel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import const, dense_init, dtype_of
from repro_torch.models.ssm import _causal_conv, _conv_window
from repro_torch.runtime import spmd

C_RGLRU = 8.0


def _d_rec(cfg: ModelConfig) -> int:
    return cfg.rec.d_rec or cfg.d_model


class Rec(nn.Module):
    """The branch and gate projections ``w_x`` / ``w_gate``, the conv
    ``conv_w``/``conv_b``, the RG-LRU gates ``w_rg``/``b_rg`` and
    ``w_ig``/``b_ig``, ``lambda_p`` and ``w_out``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, dr = cfg.d_model, _d_rec(cfg)
        k = cfg.rec.conv_width
        self.w_x = dense_init(gen, (d, dr), cfg, device)
        self.w_gate = dense_init(gen, (d, dr), cfg, device)
        self.conv_w = dense_init(gen, (k, dr), cfg, device)
        self.conv_b = const((dr,), 0.0, cfg, device)
        self.w_rg = dense_init(gen, (dr, dr), cfg, device)
        self.b_rg = const((dr,), 0.0, cfg, device)
        self.w_ig = dense_init(gen, (dr, dr), cfg, device)
        self.b_ig = const((dr,), 0.0, cfg, device)
        # softplus(lambda) ~ 0.105 -> a_max ~ exp(-0.84) at r=1
        self.lambda_p = const((dr,), -2.2, cfg, device)
        self.w_out = dense_init(gen, (dr, d), cfg, device, out=True)


def init_rec(gen, cfg: ModelConfig, device) -> Rec:
    return Rec(cfg, device, gen)


def init_rec_cache(cfg: ModelConfig, batch: int, device):
    dr = _d_rec(cfg)
    return {
        "h": torch.zeros((batch, dr), device=device),
        "conv": torch.zeros((batch, cfg.rec.conv_width - 1, dr),
                            dtype=dtype_of(cfg.dtype), device=device),
    }


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 with h_{-1} = 0: doubling
    steps of the combine (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _rglru(p, u: torch.Tensor, h0: Optional[torch.Tensor],
           u_all: Optional[torch.Tensor] = None, cols=slice(None)
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B,S,dr) post-conv branch input; h0 (B,dr) or None.
    Returns (h (B,S,dr) fp32, h_last). On a mesh ``u`` holds the channels
    ``cols`` of the whole ``u_all``, which the gates' products reduce
    over, and the gates are computed for those channels."""
    uf = u.float()
    ua = uf if u_all is None else u_all.float()
    r = torch.sigmoid(torch.matmul(ua, p.w_rg[:, cols].float())
                      + p.b_rg[cols].float())
    i = torch.sigmoid(torch.matmul(ua, p.w_ig[:, cols].float())
                      + p.b_ig[cols].float())
    log_a = -C_RGLRU * r * F.softplus(p.lambda_p[cols].float())
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h, h[:, -1]


def apply_rec(p, x: torch.Tensor, cfg: ModelConfig, cache=None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,d) -> (out, new_cache)."""
    dt_ = x.dtype
    u = torch.matmul(x, p.w_x.to(dt_))
    gate = F.gelu(torch.matmul(x, p.w_gate.to(dt_)), approximate="tanh")

    if cache is None:
        u = _causal_conv(u, p.conv_w, p.conv_b)
        h, _ = _rglru(p, u, None)
        new_cache = None
    else:
        u, conv = _conv_window(cache["conv"], u, p.conv_w, p.conv_b)
        h, h_last = _rglru(p, u, cache["h"])
        new_cache = {"h": h_last, "conv": conv}

    y = h.to(dt_) * gate
    return torch.matmul(y, p.w_out.to(dt_)), new_cache


def apply_rec_sharded(ps, hs, cfg: ModelConfig, ctx, caches=None):
    """``apply_rec`` on each position of a local mesh -> (outputs,
    partial, caches). Where ``d_rec`` splits over ``model`` (the plan
    splits ``w_x`` / ``w_gate`` by columns, ``w_out`` by rows and the
    ``h`` / ``conv`` caches by channel, and replicates the rest) each
    position computes its channels of the branch and the gate, convolves
    and scans them (both per channel), and gathers the whole branch input
    over ``model`` for the gates' products, which reduce over every
    channel; ``w_out``'s outputs are float32 partial sums over ``model``.
    Otherwise every position runs the whole block."""
    dr = _d_rec(cfg)
    if not ctx.tp(dr):
        done = [apply_rec(p, h, cfg, None if caches is None else c)
                for p, h, c in zip(ps, hs, caches or [None] * len(ps))]
        return ([o for o, _ in done], False,
                None if caches is None else [c for _, c in done])
    n = dr // ctx.m
    us, gates, convs = [], [], []
    for i, (p, x) in enumerate(zip(ps, hs)):
        cols = slice(ctx.m_index(i) * n, (ctx.m_index(i) + 1) * n)
        dt_ = x.dtype
        u = torch.matmul(x, p.w_x.to(dt_))
        gates.append(F.gelu(torch.matmul(x, p.w_gate.to(dt_)),
                            approximate="tanh"))
        if caches is None:
            u = _causal_conv(u, p.conv_w[:, cols], p.conv_b[cols])
        else:
            u, conv = _conv_window(caches[i]["conv"], u, p.conv_w[:, cols],
                                   p.conv_b[cols])
            convs.append(conv)
        us.append(u)
    whole = spmd.all_gather(us, ctx.mesh, ctx.model, 2)
    outs, new = [], []
    for i, (p, u) in enumerate(zip(ps, us)):
        cols = slice(ctx.m_index(i) * n, (ctx.m_index(i) + 1) * n)
        h, h_last = _rglru(p, u, None if caches is None else caches[i]["h"],
                           whole[i], cols)
        y = h.to(gates[i].dtype) * gates[i]
        outs.append(torch.matmul(y.float(), p.w_out.float()))
        if caches is not None:
            new.append({"h": h_last, "conv": convs[i]})
    return outs, True, (new if caches is not None else None)
