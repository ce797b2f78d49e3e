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
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig

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
                gen, (min(cfg.max_seq, 65536), cfg.d_model), 0.02, pd,
                device))


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


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    up = torch.matmul(x, p.w_up.to(dt))
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.matmul(x, p.w_gate.to(dt))) * up
    elif cfg.mlp_kind == "geglu":
        h = F.gelu(torch.matmul(x, p.w_gate.to(dt)),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.matmul(h, p.w_down.to(dt))
