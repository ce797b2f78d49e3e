"""Family dispatch: one public API over decoder-only and enc-dec models,
the port of the reference's ``models/model.py``.

  init_params(gen, cfg, device)         -> the model (an ``nn.Module``)
  train_loss(params, batch, cfg)        -> (loss, metrics)
  init_cache(cfg, batch, max_len, device)
  forward / prefill / decode_step       -> serving
  generate / greedy_generate            -> the KV-cached decoding loop

The train step (optimizer in the loop) is assembled in
``launch/specs.py::make_train_step``.
Entry points run on the card unless the caller passes ``device="cpu"``;
``gen`` is a ``torch.Generator`` or an int seed of one on that device.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig

Gen = Union[int, torch.Generator]


def generator(seed: Gen, device) -> torch.Generator:
    """``seed`` if it is a generator, else a new one on ``device`` seeded
    with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def build_model(cfg: ModelConfig, device, gen: Optional[torch.Generator]):
    """The family's module on ``device``; parameters drawn from ``gen``,
    or left as empty storage when ``gen`` is None."""
    family = encdec if cfg.family == "encdec" else transformer
    return family.init_params(gen, cfg, device)


def init_params(gen: Gen, cfg: ModelConfig, device=None):
    device = resolve_device(device)
    return build_model(cfg, device, generator(gen, device))


def train_loss(params, batch, cfg: ModelConfig):
    if cfg.family == "encdec":
        return encdec.train_loss(params, batch, cfg)
    return transformer.train_loss(params, batch, cfg)


def device_of(params) -> torch.device:
    return params.embed.tok_embed.device


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    device = resolve_device(device)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, device)
    return transformer.init_cache(cfg, batch, max_len, device)


def forward(params, batch, cfg: ModelConfig):
    """Training/prefill-style forward for any family."""
    if cfg.family == "encdec":
        return encdec.forward(params, batch["frames"], batch["tokens"], cfg)
    return transformer.forward(params, batch["tokens"], cfg,
                               prefix_embeds=batch.get("prefix_embeds"))


def prefill(params, batch, cfg: ModelConfig, cache):
    """Fill the KV cache from a prompt; returns (last_logits, cache, extras).

    For enc-dec, also returns the per-layer cross K/V under extras."""
    if cfg.family == "encdec":
        memory = encdec.encode(params, batch["frames"], cfg)
        memory_kv = encdec.encode_memory_kv(params, memory, cfg)
        logits, cache, _ = encdec.forward(
            params, None, batch["tokens"], cfg, pos_offset=0, cache=cache,
            memory_kv=memory_kv)
        return logits[:, -1], cache, {"memory_kv": memory_kv}
    logits, cache, _ = transformer.forward(
        params, batch["tokens"], cfg, pos_offset=0, cache=cache,
        prefix_embeds=batch.get("prefix_embeds"))
    return logits[:, -1], cache, {}


def decode_step(params, tokens: torch.Tensor, pos_offset: int,
                cfg: ModelConfig, cache, *, extras=None):
    """One decode step: tokens (B, 1) at absolute position ``pos_offset``.
    Returns (logits (B, V), new_cache)."""
    if cfg.family == "encdec":
        logits, cache, _ = encdec.forward(
            params, None, tokens, cfg, pos_offset=pos_offset, cache=cache,
            memory_kv=(extras or {})["memory_kv"])
        return logits[:, -1], cache
    logits, cache, _ = transformer.forward(
        params, tokens, cfg, pos_offset=pos_offset, cache=cache)
    return logits[:, -1], cache


def _select_token(logits: torch.Tensor, gen: Optional[torch.Generator],
                  temperature: float, top_k: int) -> torch.Tensor:
    """Greedy (temperature<=0: the first maximum) or top-k temperature
    sampling (Gumbel-max over the logits past the k-th largest)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


@torch.no_grad()
def generate(params, batch, cfg: ModelConfig, *, max_new: int,
             max_len: int, temperature: float = 0.0, top_k: int = 0,
             seed: Gen = 0):
    """KV-cached decoding loop: greedy by default, top-k temperature
    sampling when temperature > 0 (draws from ``seed``, a generator or an
    int seed of one). Returns int32 tokens (B, max_new)."""
    b = batch["tokens"].shape[0]
    device = device_of(params)
    cache = init_cache(cfg, b, max_len, device)
    last, cache, extras = prefill(params, batch, cfg, cache)
    start = batch["tokens"].shape[1]
    gen = generator(seed, device) if temperature > 0.0 else None
    toks = []
    for i in range(max_new):
        tok = _select_token(last, gen, temperature, top_k)[:, None]
        last, cache = decode_step(params, tok, start + i, cfg, cache,
                                  extras=extras)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1)


def greedy_generate(params, batch, cfg: ModelConfig, *, max_new: int,
                    max_len: int):
    """Greedy decoding loop (serving example path)."""
    return generate(params, batch, cfg, max_new=max_new, max_len=max_len,
                    temperature=0.0)
