"""GQA attention with RoPE, sliding windows, logit softcap, and KV caches:
the port of the reference's ``models/attention.py`` in plain PyTorch.

Serving caches:
  * global-attention layers keep a full (B, KVH, S_max, hd) cache;
  * sliding-window layers keep a **ring buffer** of exactly ``window``
    slots (slot = pos % window): O(W) memory regardless of stream length.

Keys/values are RoPE-rotated *before* caching, so ring overwrites need no
re-rotation. A cache is a dict of tensors as in the reference; the port
writes the new positions into it in place and returns it.

On a local mesh (``apply_attn_sharded``) the query heads split over
``model``, and the key/value heads too where they divide it; where they do
not (smollm: 9 heads, 3 KV heads) the plan replicates them, and so does
their compute. Caches split as ``launch/specs.cache_shardings`` places
them; ``wo`` is row-parallel, its outputs then partial sums over
``model``.

Scores are float32 (the reference's ``preferred_element_type``): q and k
are upcast before their product, so bf16 compute does not round them.
The hand-written ``kernels.attention.flash_attention`` is not called here,
as the reference's models do not call its Pallas kernel.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (apply_rope, const, dense_init,
                                       dtype_of, rope_sincos)
from repro_torch.runtime import spmd

NEG = -1e30


class Attention(nn.Module):
    """``wq`` (d, H, hd), ``wk``/``wv`` (d, KVH, hd), ``wo`` (H, hd, d), and
    the biases ``bq``/``bk``/``bv`` when ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim_
        self.wq = dense_init(gen, (d, h, hd), cfg, device)
        self.wk = dense_init(gen, (d, kvh, hd), cfg, device)
        self.wv = dense_init(gen, (d, kvh, hd), cfg, device)
        self.wo = dense_init(gen, (h, hd, d), cfg, device, out=True)
        if cfg.qkv_bias:
            self.bq = const((h, hd), 0.0, cfg, device)
            self.bk = const((kvh, hd), 0.0, cfg, device)
            self.bv = const((kvh, hd), 0.0, cfg, device)


def init_attn(gen, cfg: ModelConfig, device) -> Attention:
    return Attention(cfg, device, gen)


def _has_bias(p) -> bool:
    return hasattr(p, "bq")


def init_attn_cache(cfg: ModelConfig, spec: LayerSpec, batch: int,
                    max_len: int, device):
    """Zeroed KV cache for one attention layer (optionally int8)."""
    size = min(spec.window, max_len) if spec.window else max_len
    shape = (batch, cfg.n_kv_heads, size, cfg.head_dim_)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], device=device),
                "v_scale": torch.zeros(shape[:-1], device=device)}
    dt = dtype_of(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _kv_quantize(x: torch.Tensor):
    """(B,KVH,S,hd) -> int8 values + per-(b,h,s) absmax scales."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(dt))
    if _has_bias(p):
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    if cfg.pos_embed == "rope":
        sin, cos = rope_sincos(positions, cfg.head_dim_, cfg.rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    return q, k, v


def _softcap(s: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.attn_softcap is None:
        return s
    c = cfg.attn_softcap
    return c * torch.tanh(s / c)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """q: (B,Sq,H,hd); k/v: (B,Skv,KVH,hd); mask: (B|1,Sq,Skv) bool."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float())
    s = _softcap(s * (1.0 / (hd ** 0.5)), cfg)
    s = torch.where(mask[:, None, None], s, NEG)
    p_attn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p_attn.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


# ---------------------------------------------------------------- chunked
#: switch to the online-softmax path above this many score elements
_CHUNK_THRESHOLD = 4 * 1024 * 1024
_BQ = 1024
_BK = 1024


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig, *, q0: int, k0: int, causal: bool,
                  window: Optional[int]) -> torch.Tensor:
    """Flash-style online-softmax attention: loops over query blocks x
    key blocks keep the materialised score tile at (B, H, BQ, BK) instead
    of (B, H, S, S), block for block the reference's ``lax`` scans.

    Positions: qpos = q0 + i, kpos = k0 + j; padded keys (j >= Skv) are
    masked."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    kvh = k.shape[2]
    g = h // kvh
    scale = 1.0 / (hd ** 0.5)
    dev = q.device

    pad_q = (-sq) % _BQ
    pad_k = (-skv) % _BK
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    nq, nk = (sq + pad_q) // _BQ, (skv + pad_k) // _BK

    qb = qp.reshape(b, nq, _BQ, kvh, g, hd).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(b, nk, _BK, kvh, hd).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(b, nk, _BK, kvh, hd).permute(1, 0, 3, 2, 4)
    # qb: (nq, B, KVH, G, BQ, hd); kb/vb: (nk, B, KVH, BK, hd)

    outs = []
    for qi in range(nq):
        qpos = q0 + qi * _BQ + torch.arange(_BQ, device=dev)
        q_tile = qb[qi].float()
        m_prev = torch.full((b, kvh, g, _BQ), NEG, device=dev)
        l_prev = torch.zeros((b, kvh, g, _BQ), device=dev)
        acc = torch.zeros((b, kvh, g, _BQ, hd), device=dev)
        for ki in range(nk):
            j = ki * _BK + torch.arange(_BK, device=dev)   # local index
            kpos = k0 + j
            s = torch.einsum("bkgqd,bktd->bkgqt", q_tile,
                             kb[ki].float()) * scale
            s = _softcap(s, cfg)
            mask = (j[None, :] < skv).expand(_BQ, _BK)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = torch.where(mask, s, NEG)
            m_cur = torch.maximum(m_prev, s.amax(dim=-1))
            alpha = torch.exp(m_prev - m_cur)
            p = torch.exp(s - m_cur[..., None])
            l_prev = l_prev * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqt,bktd->bkgqd", p, vb[ki].float())
            m_prev = m_cur
        outs.append(acc / l_prev.clamp_min(1e-30)[..., None])

    # (nq, B, KVH, G, BQ, hd) -> (B, nq*BQ, H, hd)
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(
        b, nq * _BQ, h, hd)
    return out[:, :sq].to(q.dtype)


def _ring_write(buf: torch.Tensor, new: torch.Tensor,
                qpos: torch.Tensor) -> None:
    """Write positions ``qpos`` of ``new`` (axis 2) into the ring ``buf``
    (slot = pos % size). Where a prompt is longer than the ring, only the
    last ``size`` positions land, which is what the reference's scatter
    with repeated slots keeps (its last write to each slot)."""
    size = buf.shape[2]
    n = min(new.shape[2], size)
    buf[:, :, qpos[-n:] % size] = new[:, :, -n:].to(buf.dtype)


def _linear_write(buf: torch.Tensor, new: torch.Tensor, start: int) -> None:
    """``dynamic_update_slice`` along axis 2: the start is clamped so that
    the update fits, as XLA clamps it."""
    sq = new.shape[2]
    start = max(0, min(start, buf.shape[2] - sq))
    buf[:, :, start:start + sq] = new.to(buf.dtype)


def apply_attn(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
               pos_offset: int, cache=None, causal: bool = True,
               kv_heads: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention. cache=None: training/prefill-no-cache mode.
    With cache: writes the S new positions then attends over the cache
    (ring semantics for windowed layers). causal=False: encoder
    (bidirectional, no cache). ``kv_heads``: the key/value head each
    query head of ``p`` reads, where the query heads are a slice over
    ``model`` and the key/value heads are not; ``out_dtype``: the dtype
    ``wo``'s product computes and returns in (``apply_attn_sharded``)."""
    b, sq, _ = x.shape
    dev = x.device
    qpos = pos_offset + torch.arange(sq, device=dev)     # (Sq,)
    q, k_new, v_new = _qkv(p, x, cfg, qpos[None].expand(b, sq))

    def read(t):
        return t if kv_heads is None else t.index_select(2, kv_heads)

    if not causal:
        mask = torch.ones((1, sq, sq), dtype=torch.bool, device=dev)
        out = _sdpa(q, read(k_new), read(v_new), mask, cfg)
        new_cache = None
    elif cache is None:
        if sq * sq > _CHUNK_THRESHOLD:
            out = _sdpa_chunked(q, read(k_new), read(v_new), cfg,
                                q0=pos_offset, k0=pos_offset, causal=True,
                                window=spec.window)
        else:
            kpos = qpos
            mask = kpos[None, None, :] <= qpos[None, :, None]
            if spec.window is not None:
                mask &= kpos[None, None, :] > qpos[None, :, None] \
                    - spec.window
            out = _sdpa(q, read(k_new), read(v_new), mask, cfg)
        new_cache = None
    else:
        size = cache["k"].shape[2]
        k_t = k_new.transpose(1, 2)  # (B,KVH,S,hd)
        v_t = v_new.transpose(1, 2)
        quant = cfg.kv_quant
        if quant:
            k_w, ks_w = _kv_quantize(k_t)
            v_w, vs_w = _kv_quantize(v_t)
        else:
            k_w, v_w = k_t, v_t
        kc, vc = cache["k"], cache["v"]
        ksc, vsc = cache.get("k_scale"), cache.get("v_scale")
        if spec.window is not None and size == spec.window:
            _ring_write(kc, k_w, qpos)
            _ring_write(vc, v_w, qpos)
            if quant:
                _ring_write(ksc[..., None], ks_w[..., None], qpos)
                _ring_write(vsc[..., None], vs_w[..., None], qpos)
            new_len = pos_offset + sq
            # slot s holds position p = largest p' < new_len, p' % W == s
            last = new_len - 1
            slot_ids = torch.arange(size, device=dev)
            held = last - ((last - slot_ids) % size)
            valid = (held >= 0) & (held >= new_len - size)
            mask = (held[None, None, :] <= qpos[None, :, None]) & \
                (held[None, None, :] > qpos[None, :, None] - spec.window) \
                & valid[None, None, :]
        else:
            _linear_write(kc, k_w, pos_offset)
            _linear_write(vc, v_w, pos_offset)
            if quant:
                _linear_write(ksc[..., None], ks_w[..., None], pos_offset)
                _linear_write(vsc[..., None], vs_w[..., None], pos_offset)
            kpos = torch.arange(size, device=dev)
            mask = kpos[None, None, :] <= qpos[None, :, None]
            if spec.window is not None:
                mask &= kpos[None, None, :] > qpos[None, :, None] \
                    - spec.window
        if quant:
            k_read = _kv_dequantize(kc, ksc, x.dtype)
            v_read = _kv_dequantize(vc, vsc, x.dtype)
            new_cache = {"k": kc, "v": vc, "k_scale": ksc, "v_scale": vsc}
        else:
            k_read, v_read = kc, vc
            new_cache = {"k": kc, "v": vc}
        out = _sdpa(q, read(k_read.transpose(1, 2)),
                    read(v_read.transpose(1, 2)), mask, cfg)

    od = out_dtype or x.dtype
    return torch.einsum("bshk,hkd->bsd", out.to(od), p.wo.to(od)), new_cache


def _local_heads(p, m: int, hl: Optional[int], kvl: Optional[int]):
    """``p`` with its replicated biases cut to the heads position ``m``
    computes (``hl`` query and ``kvl`` key/value heads a position, None
    where those heads do not split)."""
    if not _has_bias(p) or hl is None:
        return p
    out = SimpleNamespace(**vars(p))
    out.bq = p.bq.narrow(0, m * hl, hl)
    if kvl is not None:
        out.bk = p.bk.narrow(0, m * kvl, kvl)
        out.bv = p.bv.narrow(0, m * kvl, kvl)
    return out


def apply_attn_sharded(ps, hs, cfg: ModelConfig, ctx, spec: LayerSpec,
                       pos_offset: int, caches=None, plan=None,
                       causal: bool = True):
    """``apply_attn`` on each position of a local mesh -> (outputs,
    partial, caches). ``ps``: the positions' parameters (fsdp gathered),
    ``hs``: their inputs over the whole sequence, ``caches``: their layer
    caches, ``plan``: the layer cache's placement. Query heads split over
    ``model`` where they divide it (then ``wo``'s outputs are partial
    sums), key/value heads where theirs do; a position whose query heads
    split while the key/value heads do not reads the key/value heads its
    query heads use; ``wo``'s partial sums stay float32 until reduced. A
    cache whose sequence splits over ``model`` (split-K placement) is
    gathered for the step, and each position keeps its slice.
    ``causal=False``: the encoder's bidirectional attention (no cache)."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    q_split = ctx.tp(h)
    kv_split = ctx.tp(kvh)
    seq_split = plan is not None and ctx.model is not None and \
        ctx.model in spmd.axes_of(plan["k"][2])
    hl = h // ctx.m if q_split else None
    kvl = kvh // ctx.m if kv_split else None
    whole = None
    if seq_split:
        whole = [{} for _ in ps]
        for key in caches[0]:
            got = spmd.all_gather([c[key] for c in caches], ctx.mesh,
                                  ctx.model, 2)
            for w, t in zip(whole, got):
                w[key] = t
    outs, new = [], []
    for i, (p, x) in enumerate(zip(ps, hs)):
        m = ctx.m_index(i)
        kv_index = None
        if q_split and not kv_split:
            kv_index = (m * hl + torch.arange(hl, device=x.device)) \
                // (h // kvh)
        cache = None if caches is None else \
            (whole[i] if seq_split else caches[i])
        o, c = apply_attn(_local_heads(p, m, hl, kvl), x, cfg, spec,
                          pos_offset, cache, causal, kv_heads=kv_index,
                          out_dtype=torch.float32 if q_split else None)
        if seq_split:
            for key, t in c.items():
                mine = caches[i][key]
                n = mine.shape[2]
                mine.copy_(t.narrow(2, m * n, n))
            c = caches[i]
        outs.append(o)
        new.append(c)
    return outs, q_split, (new if caches is not None else None)


# ---------------------------------------------------------- cross-attention
def init_cross_attn(gen, cfg: ModelConfig, device) -> Attention:
    return Attention(cfg, device, gen)


def apply_cross_attn(p, x: torch.Tensor, memory_kv,
                     cfg: ModelConfig) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V
    (memory_kv = {"k": (B,T,KVH,hd), "v": ...})."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    if _has_bias(p):
        q = q + p.bq.to(dt)
    t = memory_kv["k"].shape[1]
    mask = torch.ones((1, x.shape[1], t), dtype=torch.bool, device=x.device)
    out = _sdpa(q, memory_kv["k"], memory_kv["v"], mask, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p.wo.to(dt))


def encode_memory_kv(p, mem: torch.Tensor, cfg: ModelConfig):
    """Precompute cross-attention K/V from encoder output (no RoPE)."""
    dt = mem.dtype
    k = torch.einsum("bsd,dhk->bshk", mem, p.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", mem, p.wv.to(dt))
    if _has_bias(p):
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return {"k": k, "v": v}


def memory_kv_spec(cfg: ModelConfig, ctx) -> tuple:
    """The placement of a (B, T, KVH, hd) cross K/V that no cache plan
    gives (a training or cacheless forward): the batch over its axes, the
    key/value heads over ``model`` where they divide it."""
    return (ctx.batch, None, ctx.model if ctx.tp(cfg.n_kv_heads) else None,
            None)


def encode_memory_kv_sharded(ps, mems, cfg: ModelConfig, ctx, spec):
    """``encode_memory_kv`` on each position -> its slice under ``spec``
    of the (B, T, KVH, hd) K/V: from the batch rows of the encoder output
    it holds, the key/value heads and frames ``spec`` gives it, each from
    those heads' columns of the replicated ``wk`` / ``wv`` (no data
    moves)."""
    out = []
    for i, (p, mem) in enumerate(zip(ps, mems)):
        heads = (spec[2], None)
        dt = mem.dtype
        mem = spmd.local_slice(mem, (None, spec[1]), ctx.mesh, i)
        kv = {}
        for name in ("k", "v"):
            w = spmd.local_slice(getattr(p, f"w{name}"), (None,) + heads,
                                 ctx.mesh, i)
            t = torch.einsum("bsd,dhk->bshk", mem, w.to(dt))
            if _has_bias(p):
                t = t + spmd.local_slice(getattr(p, f"b{name}"), heads,
                                         ctx.mesh, i).to(dt)
            kv[name] = t
        out.append(kv)
    return out


def apply_cross_attn_sharded(ps, hs, mems, spec, cfg: ModelConfig, ctx):
    """``apply_cross_attn`` on each position -> (outputs, partial). The
    cross weights are replicated (no rule of the plan names them); the
    K/V ``mems`` are each position's slices under ``spec``. Where the
    query heads split over ``model`` each position takes its heads'
    columns of ``wq`` and rows of ``wo`` (the outputs then float32 partial
    sums over ``model``) and reads its own K/V heads, or where those do
    not split the heads its query heads use; K/V split over the frames
    (the split-K placement) are gathered first."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    q_split = ctx.tp(h)
    model = (ctx.model,) if ctx.model else ()
    kv_split = bool(model) and spmd.axes_of(spec[2]) == model
    if model and spmd.axes_of(spec[1]) == model:
        mems = [dict(zip(("k", "v"), kv)) for kv in zip(*(
            spmd.all_gather([m[n] for m in mems], ctx.mesh, ctx.model, 1)
            for n in ("k", "v")))]
    hl = h // ctx.m if q_split else h
    outs = []
    for i, (p, x, mem) in enumerate(zip(ps, hs, mems)):
        dt = x.dtype
        m = ctx.m_index(i) if q_split else 0
        wq = p.wq.narrow(1, m * hl, hl)
        q = torch.einsum("bsd,dhk->bshk", x, wq.to(dt))
        if _has_bias(p):
            q = q + p.bq.narrow(0, m * hl, hl).to(dt)
        k, v = mem["k"], mem["v"]
        if q_split and not kv_split:
            idx = (m * hl + torch.arange(hl, device=x.device)) // (h // kvh)
            k, v = k.index_select(2, idx), v.index_select(2, idx)
        mask = torch.ones((1, x.shape[1], k.shape[1]), dtype=torch.bool,
                          device=x.device)
        out = _sdpa(q, k, v, mask, cfg)
        od = torch.float32 if q_split else dt
        outs.append(torch.einsum("bshk,hkd->bsd", out.to(od),
                                 p.wo.narrow(0, m * hl, hl).to(od)))
    return outs, q_split
