"""Family dispatch: one public API over decoder-only and enc-dec models,
the port of the reference's ``models/model.py``.

  init_params(gen, cfg, device)         -> the model (an ``nn.Module``)
  train_loss(params, batch, cfg, mesh)  -> (loss, metrics)
  init_cache(cfg, batch, max_len, device, mesh)
  forward / prefill / decode_step       -> serving
  generate / greedy_generate            -> the KV-cached decoding loop

The train step (optimizer in the loop) is assembled in
``launch/specs.py::make_train_step``.
Entry points run on the card unless the caller passes ``device="cpu"``;
``gen`` is a ``torch.Generator`` or an int seed of one on that device.

``mesh=`` (a local ``launch/mesh.Mesh``) runs every family sharded over
the mesh's positions in one process: the parameters split by
``utils/sharding.param_specs`` (``shard_model`` -> ``ShardedModel``; an
``nn.Module`` passed with a mesh is split on the way in), the batch
(``frames`` too) by ``launch/specs.batch_shardings``, the cache by
``cache_shardings`` (``init_cache(..., mesh=)`` -> ``ShardedCache``), and
an enc-dec prefill's ``extras["memory_kv"]`` by the same plan (a
``ShardedCache`` that ``decode_step`` reads). Logits come back whole on
the mesh's first device.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Union

import torch
from torch import nn

from repro_torch.core.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import spmd
from repro_torch.utils.sharding import batch_axes_for, param_specs

Gen = Union[int, torch.Generator]


def generator(seed: Gen, device) -> torch.Generator:
    """``seed`` if it is a generator, else a new one on ``device`` seeded
    with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def _family(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else transformer


def build_model(cfg: ModelConfig, device, gen: Optional[torch.Generator]):
    """The family's module on ``device``; parameters drawn from ``gen``,
    or left as empty storage when ``gen`` is None."""
    return _family(cfg).init_params(gen, cfg, device)


def init_params(gen: Gen, cfg: ModelConfig, device=None):
    device = resolve_device(device)
    return build_model(cfg, device, generator(gen, device))


# ====================================================================== mesh
META = torch.device("meta")


class ShardedModel:
    """A family module split over a local mesh: ``local[p]`` is a module
    of the family whose every parameter is position p's slice under
    ``specs`` (``utils/sharding.param_specs``), on ``mesh.devices[p]``."""

    def __init__(self, cfg: ModelConfig, mesh, local: List[nn.Module],
                 specs: Dict[str, tuple]):
        self.cfg, self.mesh, self.local, self.specs = cfg, mesh, local, specs
        self.names = list(specs)
        self._named = [dict(m.named_parameters()) for m in local]

    def shards(self, name: str) -> List[torch.Tensor]:
        return [named[name] for named in self._named]

    def named_parameters(self):
        for name in self.names:
            yield name, spmd.Sharded(self.shards(name), self.specs[name],
                                     self.mesh)

    def requires_grad_(self, flag: bool = True) -> "ShardedModel":
        for m in self.local:
            m.requires_grad_(flag)
        return self

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]


def _set_param(module: nn.Module, name: str, t: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    sub = module.get_submodule(owner) if owner else module
    sub._parameters[leaf] = nn.Parameter(t, requires_grad=False)


def sharded_model(cfg: ModelConfig, mesh, tensors) -> ShardedModel:
    """The model of ``cfg`` split over ``mesh`` from its whole parameters
    ``tensors`` (name -> tensor, on any device), each position's slice
    copied to its device in the config's parameter dtype."""
    meta = build_model(cfg, META, None)
    specs = param_specs(meta, mesh)
    if set(tensors) != set(specs):
        raise KeyError(f"parameter names differ: "
                       f"{sorted(set(tensors) ^ set(specs))[:4]}")
    local = [copy.deepcopy(meta) for _ in range(mesh.size)]
    named = dict(meta.named_parameters())
    for name, spec in specs.items():
        pieces = spmd.shard(tensors[name], spec, mesh,
                            dtype=named[name].dtype)
        for module, t in zip(local, pieces):
            _set_param(module, name, t)
    return ShardedModel(cfg, mesh, local, specs)


def shard_model(model, mesh) -> ShardedModel:
    """``model`` split over ``mesh`` (``jax.device_put`` of a tree with
    ``param_shardings``)."""
    return sharded_model(model.cfg, mesh, dict(model.named_parameters()))


def on_mesh(params, mesh, cfg: ModelConfig) -> ShardedModel:
    """``params`` on ``mesh``: a ``ShardedModel`` of that mesh as it is,
    a module split."""
    if isinstance(params, ShardedModel):
        if params.mesh != mesh:
            raise ValueError("the model is split over another mesh")
        return params
    return shard_model(params, mesh)


def place_batch(batch, mesh):
    """-> (name -> each position's rows, the batch's rows): each input
    split over the batch axes where its rows divide them, else whole on
    every position (``launch/specs.batch_shardings``)."""
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        spec = (batch_axes_for(mesh, v.shape[0]),) + (None,) * (v.ndim - 1)
        out[k] = spmd.shard(v, spec, mesh)
    return out, batch["tokens"].shape[0]


@dataclasses.dataclass
class ShardedCache:
    """A decode cache split over a local mesh: ``positions[p]`` is
    position p's cache tree, ``plan`` the placement of each leaf
    (``launch/specs.cache_shardings``)."""
    positions: list
    plan: dict
    mesh: object


def _zeros_local(tree, plan, mesh, p):
    if isinstance(tree, dict):
        return {k: _zeros_local(v, plan[k], mesh, p) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_local(v, s, mesh, p) for v, s in zip(tree, plan)]
    return torch.zeros(spmd.local_shape(tree.shape, plan, mesh),
                       dtype=tree.dtype, device=mesh.devices[p])


def _logits_spec(ctx, split: bool, ndim: int) -> tuple:
    return (ctx.batch,) + (None,) * (ndim - 2) + \
        (ctx.model if split else None,)


def _last_whole(logits, ctx, split):
    """The last position's logits (B, V), whole on the first device."""
    last = [l[:, -1] for l in logits]
    return spmd.gather(last, _logits_spec(ctx, split, 2), ctx.mesh)


def _memory_plan(cfg: ModelConfig, mesh, batch: int, frames: int) -> list:
    """The placement of each decoder layer's cross K/V (B, T, KVH, hd):
    ``launch/specs.cache_shardings``' of ``memory_kv``."""
    from repro_torch.launch.specs import cache_shardings
    shape = (batch, frames, cfg.n_kv_heads, cfg.head_dim_)
    meta = [{"k": torch.empty(shape, device=META),
             "v": torch.empty(shape, device=META)}
            for _ in range(cfg.n_units)]
    return cache_shardings({"memory_kv": meta}, cfg, mesh)["memory_kv"]


def sharded_loss(sm: ShardedModel, placed, cfg: ModelConfig, rows: int):
    """Each position's (loss, metrics) of a placed batch on ``sm``'s
    mesh."""
    return _family(cfg).train_loss_sharded(sm, placed, cfg, rows)


def _forward_placed(sm, placed, cfg, rows, **kw):
    if cfg.family == "encdec":
        return encdec.forward_sharded(sm, placed.get("frames"),
                                      placed["tokens"], cfg, n_rows=rows,
                                      **kw)
    return transformer.forward_sharded(sm, placed["tokens"], cfg,
                                       n_rows=rows,
                                       prefix=placed.get("prefix_embeds"),
                                       **kw)


# ================================================================ entries
def train_loss(params, batch, cfg: ModelConfig, mesh=None):
    if mesh is not None:
        sm = on_mesh(params, mesh, cfg)
        placed, rows = place_batch(batch, mesh)
        return sharded_loss(sm, placed, cfg, rows)[0]
    return _family(cfg).train_loss(params, batch, cfg)


def device_of(params) -> torch.device:
    if isinstance(params, ShardedModel):
        return params.device
    return params.embed.tok_embed.device


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               mesh=None):
    if mesh is not None:
        from repro_torch.launch.specs import cache_shardings
        meta = _family(cfg).init_cache(cfg, batch, max_len, META)
        plan = cache_shardings(meta, cfg, mesh)
        return ShardedCache([_zeros_local(meta, plan, mesh, p)
                             for p in range(mesh.size)], plan, mesh)
    return _family(cfg).init_cache(cfg, batch, max_len,
                                   resolve_device(device))


def forward(params, batch, cfg: ModelConfig, *, mesh=None):
    """Training/prefill-style forward for any family."""
    if mesh is not None:
        sm = on_mesh(params, mesh, cfg)
        placed, rows = place_batch(batch, mesh)
        logits, _, aux, ctx, split = _forward_placed(sm, placed, cfg, rows)
        return (spmd.gather(logits, _logits_spec(ctx, split, 3), mesh),
                None, aux[0])
    if cfg.family == "encdec":
        return encdec.forward(params, batch["frames"], batch["tokens"], cfg)
    return transformer.forward(params, batch["tokens"], cfg,
                               prefix_embeds=batch.get("prefix_embeds"))


def _step_sharded(params, batch, cfg, cache, mesh, pos_offset, memory=None):
    """A prefill (``pos_offset`` 0, the batch's frames encoded into the
    cross K/V) or decode step on a mesh -> (last logits, cache, the cross
    K/V as a ``ShardedCache`` or None)."""
    if not isinstance(cache, ShardedCache) or cache.mesh != mesh:
        raise ValueError("under a mesh the cache is init_cache(..., "
                         "mesh=mesh)'s")
    sm = on_mesh(params, mesh, cfg)
    placed, rows = place_batch(batch, mesh)
    kw = {}
    if cfg.family == "encdec":
        if memory is None:
            ctx = encdec.mesh_ctx(mesh, cfg, rows, 1)
            mems = encdec.encode_sharded(sm, placed["frames"], cfg, ctx)
            plan = _memory_plan(cfg, mesh, rows, mems[0].shape[1])
            kvs, _ = encdec.encode_memory_kv_sharded(sm, mems, cfg, ctx,
                                                     plan)
            memory = ShardedCache([[layer[p] for layer in kvs]
                                   for p in range(mesh.size)], plan, mesh)
        elif not isinstance(memory, ShardedCache) or memory.mesh != mesh:
            raise ValueError("under a mesh memory_kv is a mesh prefill's")
        kw["memory"] = ([[pos[i] for pos in memory.positions]
                         for i in range(cfg.n_units)],
                        [s["k"] for s in memory.plan])
    logits, new, _, ctx, split = _forward_placed(
        sm, placed, cfg, rows, pos_offset=pos_offset, caches=cache.positions,
        plans=cache.plan, **kw)
    cache = ShardedCache(new, cache.plan, mesh)
    return _last_whole(logits, ctx, split), cache, memory


def prefill(params, batch, cfg: ModelConfig, cache, *, mesh=None):
    """Fill the KV cache from a prompt; returns (last_logits, cache, extras).

    For enc-dec, also returns the per-layer cross K/V under extras."""
    if mesh is not None:
        last, cache, memory = _step_sharded(params, batch, cfg, cache, mesh,
                                            0)
        return last, cache, ({} if memory is None
                             else {"memory_kv": memory})
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
                cfg: ModelConfig, cache, *, extras=None, mesh=None):
    """One decode step: tokens (B, 1) at absolute position ``pos_offset``.
    Returns (logits (B, V), new_cache)."""
    if mesh is not None:
        memory = (extras or {}).get("memory_kv")
        if cfg.family == "encdec" and memory is None:
            raise ValueError("an enc-dec decode step needs the prefill's "
                             "extras['memory_kv']")
        return _step_sharded(params, {"tokens": tokens}, cfg, cache, mesh,
                             pos_offset, memory)[:2]
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
             seed: Gen = 0, mesh=None):
    """KV-cached decoding loop: greedy by default, top-k temperature
    sampling when temperature > 0 (draws from ``seed``, a generator or an
    int seed of one). Returns int32 tokens (B, max_new). Under a mesh the
    model runs split over it and the tokens are picked from the whole
    logits on its first device, so a sampled run draws as an unsplit
    one does."""
    if mesh is not None:
        params = on_mesh(params, mesh, cfg)
    b = batch["tokens"].shape[0]
    device = device_of(params)
    cache = init_cache(cfg, b, max_len, device, mesh=mesh)
    last, cache, extras = prefill(params, batch, cfg, cache, mesh=mesh)
    start = batch["tokens"].shape[1]
    gen = generator(seed, device) if temperature > 0.0 else None
    toks = []
    for i in range(max_new):
        tok = _select_token(last, gen, temperature, top_k)[:, None]
        last, cache = decode_step(params, tok, start + i, cfg, cache,
                                  extras=extras, mesh=mesh)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1)


def greedy_generate(params, batch, cfg: ModelConfig, *, max_new: int,
                    max_len: int, mesh=None):
    """Greedy decoding loop (serving example path)."""
    return generate(params, batch, cfg, max_new=max_new, max_len=max_len,
                    temperature=0.0, mesh=mesh)
