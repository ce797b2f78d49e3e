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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (Head, apply_mlp, apply_norm,
                                       dtype_of, embed_tokens, init_embed,
                                       init_mlp, init_norm, param,
                                       trunc_normal, unembed)
from repro_torch.models.transformer import masked_nll, remat

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
