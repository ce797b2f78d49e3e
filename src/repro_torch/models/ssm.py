"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060]: the port of
the reference's ``src/repro/models/ssm.py`` in plain PyTorch.

Prefill without a cache runs the chunked SSD algorithm (intra-chunk
quadratic block + inter-chunk linear state recurrence, ``_ssd_chunked``);
with a cache the tokens run through the recurrence one at a time, carrying
the (B, H, P, N) state and the depthwise-conv window -- O(1) per token.

``_ssd_chunked`` is also the oracle the SSD chunk kernel is held to
(``kernels/ssd_chunk.py``), as ``ref.ssd_ref`` holds the Pallas kernel;
the mixer does not call that kernel, as the reference's does not call its
Pallas kernel. The causal conv is the reference's sum of shifted products
(no ``conv1d``, whose TF32 mode would change its float32 products on the
card).

``apply_ssm_sharded`` runs the mixer split over a local mesh's ``model``
axis by heads.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import const, dense_init, dtype_of
from repro_torch.runtime import spmd


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


class SSM(nn.Module):
    """``in_proj``, the depthwise conv ``conv_w``/``conv_b``, ``A_log``,
    ``D``, ``dt_bias``, the gated norm's ``norm_scale`` and ``out_proj``."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_in, nh, conv_dim = _dims(cfg)
        d_proj = 2 * d_in + 2 * s.n_groups * s.d_state + nh
        self.in_proj = dense_init(gen, (d, d_proj), cfg, device)
        self.conv_w = dense_init(gen, (s.conv_width, conv_dim), cfg, device)
        self.conv_b = const((conv_dim,), 0.0, cfg, device)
        self.A_log = const((nh,), 0.0, cfg, device)  # A = -exp(0) = -1
        self.D = const((nh,), 1.0, cfg, device)
        self.dt_bias = const((nh,), 0.0, cfg, device)
        self.norm_scale = const((d_in,), 0.0, cfg, device)
        self.out_proj = dense_init(gen, (d_in, d), cfg, device, out=True)


def init_ssm(gen, cfg: ModelConfig, device) -> SSM:
    return SSM(cfg, device, gen)


def init_ssm_cache(cfg: ModelConfig, batch: int, device):
    s = cfg.ssm
    d_in, nh, conv_dim = _dims(cfg)
    return {
        "state": torch.zeros((batch, nh, s.head_dim, s.d_state),
                             device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim),
                            dtype=dtype_of(cfg.dtype), device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv; x (B,S,C), w (K,C): the window below from
    K-1 zero inputs."""
    zeros = x.new_zeros((x.shape[0], w.shape[0] - 1, x.shape[2]))
    return _conv_window(zeros, x, w, b)[0]


def _conv_window(cache_conv: torch.Tensor, u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor):
    """The causal conv of ``u`` (B,S,C) continued from the cached last
    K-1 inputs, a sum of K shifted products as the reference writes it:
    (conv output, the new cached window)."""
    k = w.shape[0]
    s = u.shape[1]
    window = torch.cat([cache_conv, u], dim=1)   # (b, k-1+s, c)
    out = torch.zeros_like(u)
    for j in range(k):
        out = out + window[:, j:j + s] * w[j][None, None].to(u.dtype)
    return out + b[None, None].to(u.dtype), window[:, -(k - 1):]


def _ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 bm: torch.Tensor, cm: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """Chunked SSD scan. xh (B,S,H,P); dt (B,S,H); a (H,) negative;
    bm/cm (B,S,G,N), G groups of H/G heads. Returns (B,S,H,P), fp32."""
    b, s, h, p = xh.shape
    g = bm.shape[2]
    hpg = h // g
    pad = (-s) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc, ll = sp // chunk, chunk

    xc = xh.reshape(b, nc, ll, h, p).float()
    dtc = dt.reshape(b, nc, ll, h).float()
    bc = bm.reshape(b, nc, ll, g, 1, -1).float()
    cc = cm.reshape(b, nc, ll, g, 1, -1).float()
    bh = bc.expand(b, nc, ll, g, hpg, bc.shape[-1]).reshape(b, nc, ll, h, -1)
    ch = cc.expand(b, nc, ll, g, hpg, cc.shape[-1]).reshape(b, nc, ll, h, -1)

    da = dtc * a.float()[None, None, None, :]          # (b,nc,L,h)
    da_t = torch.cumsum(da, dim=2).permute(0, 1, 3, 2)  # (b,nc,h,L)
    dt_t = dtc.permute(0, 1, 3, 2)                      # (b,nc,h,L)

    # intra-chunk (the "duality" quadratic block)
    cb = torch.einsum("bclhn,bcmhn->bchlm", ch, bh)
    seg = da_t[..., :, None] - da_t[..., None, :]       # (b,nc,h,L,L)
    tri = torch.ones((ll, ll), dtype=torch.bool, device=xh.device).tril()
    # masked before the exp: above the diagonal seg is a growing positive
    # sum whose exp overflows to inf once a chunk's decay passes ~88, and
    # the gradient of the reference's where(tri, exp(seg), 0) there is
    # 0 * inf = NaN (mamba2-780m at full width); the values are the same
    decay = torch.exp(seg.masked_fill(~tri, float("-inf")))
    scores = cb * decay * dt_t[..., None, :]
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", scores, xc)

    # chunk-final states
    w = torch.exp(da_t[..., -1:] - da_t) * dt_t         # (b,nc,h,L)
    states = torch.einsum("bchm,bcmhp,bcmhn->bchpn", w, xc, bh)

    # inter-chunk recurrence (sequential over chunks): the state before
    # each chunk
    chunk_decay = torch.exp(da_t[..., -1])              # (b,nc,h)
    prev = torch.empty_like(states)
    carry = torch.zeros((b, h, p, bh.shape[-1]), dtype=torch.float32,
                        device=xh.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]

    y_off = torch.einsum("bclhn,bchpn->bclhp", ch, prev) \
        * torch.exp(da_t).permute(0, 1, 3, 2)[..., None]
    y = (y_diag + y_off).reshape(b, sp, h, p)
    return y[:, :s]


def _scan(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
          bm: torch.Tensor, cm: torch.Tensor, cfg: ModelConfig,
          state: Optional[torch.Tensor]):
    """The SSD mixer's scan of heads xs (B,S,H,P) -> (y (B,S,H,P) fp32,
    the new state): the chunked scan without a state, else the
    recurrence from ``state`` (B,H,P,N) one token at a time."""
    if state is None:
        return _ssd_chunked(xs, dt, a, bm, cm, cfg.ssm.chunk), None
    s = xs.shape[1]
    hpg = xs.shape[2] // bm.shape[2]
    bh = bm.repeat_interleave(hpg, dim=2).float()       # (b,s,h,n)
    chh = cm.repeat_interleave(hpg, dim=2).float()
    ys = []
    for i in range(s):  # s == 1 in decode
        da = torch.exp(dt[:, i] * a[None])                # (b,h)
        upd = torch.einsum("bh,bhp,bhn->bhpn", dt[:, i],
                           xs[:, i].float(), bh[:, i])
        state = state * da[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", state, chh[:, i]))
    return torch.stack(ys, dim=1), state


def apply_ssm(p, x: torch.Tensor, cfg: ModelConfig, cache=None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """x (B,S,d) -> (out (B,S,d), new_cache)."""
    s_cfg = cfg.ssm
    b, s, _ = x.shape
    d_in, nh, conv_dim = _dims(cfg)
    g, n = s_cfg.n_groups, s_cfg.d_state
    hd = s_cfg.head_dim
    dt_ = x.dtype

    zxbcdt = torch.matmul(x, p.in_proj.to(dt_))
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + conv_dim]
    dt_raw = zxbcdt[..., d_in + conv_dim:]

    if cache is None:
        xbc = _causal_conv(xbc, p.conv_w, p.conv_b)
        new_conv = None
    else:
        xbc, new_conv = _conv_window(cache["conv"], xbc, p.conv_w, p.conv_b)
    xbc = F.silu(xbc)

    xs = xbc[..., :d_in].reshape(b, s, nh, hd)
    bm = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    cm = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    a = -torch.exp(p.A_log.float())

    y, new_state = _scan(xs, dt, a, bm, cm, cfg,
                         None if cache is None else cache["state"])

    y = y + xs.float() * p.D.float()[None, None, :, None]
    y = y.reshape(b, s, d_in)
    # gated RMSNorm (mamba2)
    y = y * F.silu(z.float())
    ms = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(ms + 1e-6) * (1.0 + p.norm_scale.float())
    out = torch.matmul(y.to(dt_), p.out_proj.to(dt_))
    new_cache = None if cache is None else {"state": new_state,
                                            "conv": new_conv}
    return out, new_cache


def apply_ssm_sharded(ps, hs, cfg: ModelConfig, ctx, caches=None):
    """``apply_ssm`` on each position of a local mesh -> (outputs,
    partial, caches). The plan splits ``in_proj`` over ``model`` by
    columns, across the z | xBC | dt boundaries, and the ``conv`` cache by
    channel, which is not a whole number of heads; ``state`` and
    ``out_proj``'s rows split by heads. So ``in_proj``'s output is
    gathered over ``model`` and each position takes its heads of z, x and
    dt and all of B and C; a decode step gathers the conv window, steps it
    and keeps its own slice; the gated RMSNorm's mean of squares over
    ``d_in`` sums each position's over ``model``; ``out_proj``'s outputs
    are float32 partial sums. Where the heads do not split every position
    mixes them all."""
    s_cfg = cfg.ssm
    d_in, nh, conv_dim = _dims(cfg)
    g, n, hd = s_cfg.n_groups, s_cfg.d_state, s_cfg.head_dim
    heads = ctx.tp(nh)
    hl = nh // ctx.m if heads else nh
    zx = [torch.matmul(x, p.in_proj.to(x.dtype)) for p, x in zip(ps, hs)]
    if ctx.tp(d_in + conv_dim + nh):
        zx = spmd.all_gather(zx, ctx.mesh, ctx.model, 2)
    windows = None if caches is None else [c["conv"] for c in caches]
    if caches is not None and ctx.tp(conv_dim):
        windows = spmd.all_gather(windows, ctx.mesh, ctx.model, 2)
    ys, sqs, new = [], [], []
    for i, (p, zxi) in enumerate(zip(ps, zx)):
        b, s, _ = zxi.shape
        h0 = ctx.m_index(i) * hl if heads else 0
        ch = slice(h0 * hd, (h0 + hl) * hd)
        xbc = zxi[..., d_in:d_in + conv_dim]
        if caches is None:
            # this position's x channels, then all of B and C
            xbc = _causal_conv(
                torch.cat([xbc[..., ch], xbc[..., d_in:]], dim=-1),
                torch.cat([p.conv_w[:, ch], p.conv_w[:, d_in:]], dim=-1),
                torch.cat([p.conv_b[ch], p.conv_b[d_in:]]))
        else:
            xbc, window = _conv_window(windows[i], xbc, p.conv_w, p.conv_b)
            xbc = torch.cat([xbc[..., ch], xbc[..., d_in:]], dim=-1)
            if ctx.tp(conv_dim):
                c = conv_dim // ctx.m
                window = window[..., ctx.m_index(i) * c:
                                (ctx.m_index(i) + 1) * c].contiguous()
        xbc = F.silu(xbc)
        xs = xbc[..., :hl * hd].reshape(b, s, hl, hd)
        bm = xbc[..., hl * hd:hl * hd + g * n].reshape(b, s, g, n)
        cm = xbc[..., hl * hd + g * n:].reshape(b, s, g, n)
        if g > 1 and heads:   # this position's heads' groups, one a head
            bm = bm.repeat_interleave(nh // g, dim=2)[:, :, h0:h0 + hl]
            cm = cm.repeat_interleave(nh // g, dim=2)[:, :, h0:h0 + hl]
        dt_raw = zxi[..., d_in + conv_dim + h0:d_in + conv_dim + h0 + hl]
        dt = F.softplus(dt_raw.float() + p.dt_bias.float()[h0:h0 + hl])
        a = -torch.exp(p.A_log.float()[h0:h0 + hl])
        y, state = _scan(xs, dt, a, bm, cm, cfg,
                         None if caches is None else caches[i]["state"])
        y = y + xs.float() * p.D.float()[h0:h0 + hl][None, None, :, None]
        y = y.reshape(b, s, hl * hd) * F.silu(zxi[..., ch].float())
        ys.append(y)
        sqs.append(y.square().sum(dim=-1, keepdim=True))
        if caches is not None:
            new.append({"state": state, "conv": window})
    if heads:
        sqs = spmd.all_reduce(sqs, ctx.mesh, ctx.model)
    partial = ctx.tp(d_in)
    outs = []
    for i, (p, y, sq, x) in enumerate(zip(ps, ys, sqs, hs)):
        h0 = ctx.m_index(i) * hl if heads else 0
        y = y * torch.rsqrt(sq / d_in + 1e-6) \
            * (1.0 + p.norm_scale.float()[h0 * hd:(h0 + hl) * hd])
        y = y.to(x.dtype)
        if not partial:
            outs.append(torch.matmul(y, p.out_proj.to(x.dtype)))
            continue
        if not heads:   # every head here; this position's rows of out_proj
            r = d_in // ctx.m
            y = y[..., ctx.m_index(i) * r:(ctx.m_index(i) + 1) * r]
        outs.append(torch.matmul(y.float(), p.out_proj.float()))
    return outs, partial, (new if caches is not None else None)
