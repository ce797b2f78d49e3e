"""AdamW with the distributed-optimization extras the big MoE configs
need, the port of the reference's ``optim/adamw.py``:

  * optional **int8 moment quantization** (per-last-axis-block scales,
    shape-preserving storage) -- halves-to-quarters the dominant
    optimizer-state memory term for 100B+ models;
  * optional **int8 gradient compression with error feedback** (1-bit-
    Adam-style residual accumulation): the quantization residual is
    carried in optimizer state, so the scheme is unbiased over time;
  * global-norm clipping, decoupled weight decay, cosine schedule with
    linear warmup.

Parameters are a dict of named tensors (``dict(model.named_parameters())``)
and the state is plain tensors on their device: ``{"step": int32 scalar,
"m": {name: float32}, "v": ...}`` (``{"q": {name: int8}, "scale": {name:
float32}}`` for int8 moments) and, with compression, ``"ef"``. It is
checkpointable with the generic manager. ``update`` writes the parameters
and the float32 moments in place.

This is not ``torch.optim.AdamW``, which decays every tensor and has no
int8 moments and no error feedback.

On a local mesh (``runtime/spmd.Sharded`` parameters, gradients and
state) ``init`` and ``update`` run on each position's slices. The global
gradient norm counts each element once (one position for each distinct
slice), and the int8 quantization of the moments and of the compressed
gradients keeps its 128-wide blocks of the whole leaf: where a slice of
the last dimension is a whole number of blocks each position quantizes its
own and the scales are gathered, else the leaf is gathered along that
dimension and quantized whole. ``q`` then takes the parameter's placement
and ``scale`` holds every block of the last dimension
(``launch/specs.opt_state_shardings``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.runtime import spmd

Named = Mapping[str, torch.Tensor]

#: name prefixes of the parameters the reference stacks over units: its
#: leaf there has one more axis than the port's per-unit tensor
STACKED = ("units.", "enc_units.", "dec_units.")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    quantize_moments: bool = False   # int8 m/v
    compress_grads: bool = False     # int8 error-feedback grads


# ------------------------------------------------------ int8 block quant
# Shape-preserving layout: q keeps the parameter's shape (int8, last axis
# padded to the block size), scales are (..., last/BLOCK), so the
# quantized state takes the parameter's placement (launch/specs.py
# ``opt_state_shardings``).
_QBLOCK = 128


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.ndim == 0:
        x = x.reshape(1)
    last = x.shape[-1]
    pad = (-last) % _QBLOCK
    xp = F.pad(x, (0, pad))
    blocks = xp.reshape(*xp.shape[:-1], -1, _QBLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-12)
    # torch.round, as jnp.round, rounds half to even
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return (q.reshape(*xp.shape[:-1], last + pad),
            scale[..., 0].to(torch.float32))


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    last = shape[-1] if len(shape) else 1
    blocks = q.reshape(*q.shape[:-1], -1, _QBLOCK).to(torch.float32)
    out = blocks * scale[..., None]
    out = out.reshape(*q.shape[:-1], q.shape[-1])[..., :last]
    return out.reshape(shape)


def _q_tree(tree: Named) -> dict:
    pairs = {name: _quantize(x) for name, x in tree.items()}
    return {"q": {n: p[0] for n, p in pairs.items()},
            "scale": {n: p[1] for n, p in pairs.items()}}


# -------------------------------------------------------------- schedule
def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The float32 learning rate at ``step`` (an int or an integer tensor,
    whose device the result takes)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# ------------------------------------------------------------- optimizer
def init(cfg: AdamWConfig, params: Named) -> dict:
    """Zero moments (and residuals) on each parameter's device; distinct
    tensors a leaf."""
    if spmd.is_sharded(params):
        return _init_sharded(cfg, params)

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    device = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.quantize_moments:
        state["m"] = _q_tree(zeros())
        state["v"] = _q_tree(zeros())
    else:
        state["m"] = zeros()
        state["v"] = zeros()
    if cfg.compress_grads:
        state["ef"] = zeros()
    return state


def compress_decompress(g: torch.Tensor, residual: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 round-trip: returns (g_hat, new_residual).
    In deployment the int8 payload is what crosses the interconnect."""
    corrected = g + residual
    q, s = _quantize(corrected)
    g_hat = _dequantize(q, s, g.shape)
    return g_hat, corrected - g_hat


def decays(name: str, p: torch.Tensor) -> bool:
    """Decoupled weight decay applies to the reference's leaves of two or
    more axes. Its unit leaves carry the stacked unit axis, so a per-unit
    vector here (a norm scale) is a matrix there and decays."""
    return p.ndim + name.startswith(STACKED) >= 2


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Named, state: dict, params: Named):
    """-> (params, new_state, metrics ``grad_norm`` and ``lr``, float32
    device scalars). One parameter at a time, so the peak is the
    parameters, gradients and moments and one parameter's temporaries:
    ``params`` and float32 moments are updated in place (int8 moments
    are replaced) and returned."""
    if spmd.is_sharded(params):
        return _update_sharded(cfg, grads, state, params)
    step = state["step"]
    metrics = {}

    new_ef = None
    if cfg.compress_grads:
        pairs = {n: compress_decompress(g, state["ef"][n])
                 for n, g in grads.items()}
        grads = {n: pr[0] for n, pr in pairs.items()}
        new_ef = {n: pr[1] for n, pr in pairs.items()}

    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in grads.values()))
    metrics["grad_norm"] = gnorm
    clip = None
    if cfg.clip_norm is not None:
        clip = torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12), max=1.0)

    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)
    lr = lr_schedule(cfg, step)
    metrics["lr"] = lr

    if cfg.quantize_moments:
        new_m = {"q": {}, "scale": {}}
        new_v = {"q": {}, "scale": {}}
    else:
        new_m, new_v = state["m"], state["v"]
    for n, p in params.items():
        g = grads[n].to(torch.float32)
        if clip is not None:
            g = g * clip
        if cfg.quantize_moments:
            mm = _dequantize(state["m"]["q"][n], state["m"]["scale"][n],
                             p.shape)
            vv = _dequantize(state["v"]["q"][n], state["v"]["scale"][n],
                             p.shape)
            mm = cfg.b1 * mm + (1 - cfg.b1) * g
            vv = cfg.b2 * vv + (1 - cfg.b2) * torch.square(g)
            for tree, x in ((new_m, mm), (new_v, vv)):
                tree["q"][n], tree["scale"][n] = _quantize(x)
        else:
            mm = new_m[n].mul_(cfg.b1).add_((1 - cfg.b1) * g)
            vv = new_v[n].mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        wd = cfg.weight_decay if decays(n, p) else 0.0
        p.copy_(pf - lr * (delta + wd * pf))

    new_state = {"step": step + 1, "m": new_m, "v": new_v}
    if new_ef is not None:
        new_state["ef"] = new_ef
    return params, new_state, metrics


# ------------------------------------------------------------- on a mesh
def _scale_spec(spec) -> tuple:
    return tuple(spec[:-1]) + (None,) if len(spec) else ()


def _split_last(spec, ndim: int, mesh):
    """(axes, ways) the last dimension of a leaf splits over."""
    axes = spmd.axes_of(spec[ndim - 1]) if ndim and len(spec) >= ndim else ()
    return axes, spmd.size(mesh, axes)


def _quantize_shards(xs, spec, shape, mesh):
    """``_quantize`` of a leaf of whole ``shape`` from its slices ``xs``
    -> (each position's q slice, each position's scales of every block
    of the last dimension)."""
    nd = len(shape)
    axes, n = _split_last(spec, nd, mesh)
    if n == 1:
        pairs = [_quantize(x) for x in xs]
        return [q for q, _ in pairs], [s for _, s in pairs]
    if (shape[-1] // n) % _QBLOCK == 0:
        pairs = [_quantize(x) for x in xs]
        scales = spmd.all_gather([s for _, s in pairs], mesh, axes, nd - 1)
        return [q for q, _ in pairs], [s.clone() for s in scales]
    whole = spmd.all_gather(xs, mesh, axes, nd - 1)
    done, qs, ss = {}, [], []
    for p, x in enumerate(whole):
        if id(x) not in done:
            done[id(x)] = _quantize(x)
        q, s = done[id(x)]
        c = q.shape[-1] // n
        qs.append(q.narrow(nd - 1, spmd.coord(mesh, p, axes) * c, c).clone())
        ss.append(s.clone())
    return qs, ss


def _dequantize_shards(qs, scales, spec, shape, mesh):
    """Each position's float32 slice of a leaf of whole ``shape`` from its
    q slices and whole-row scales."""
    nd = len(shape)
    local = spmd.local_shape(shape, spec, mesh)
    axes, n = _split_last(spec, nd, mesh)
    if n == 1:
        return [_dequantize(q, s, local) for q, s in zip(qs, scales)]
    last = shape[-1] // n
    if last % _QBLOCK == 0:
        nb = last // _QBLOCK
        return [_dequantize(q, s.narrow(-1, spmd.coord(mesh, p, axes) * nb,
                                        nb), local)
                for p, (q, s) in enumerate(zip(qs, scales))]
    whole = spmd.all_gather(qs, mesh, axes, nd - 1)
    rows = local[:-1] + (shape[-1],)
    return [_dequantize(q, s, rows).narrow(
        nd - 1, spmd.coord(mesh, p, axes) * last, last)
        for p, (q, s) in enumerate(zip(whole, scales))]


def _q_tree_sharded(tree: dict) -> dict:
    out = {"q": {}, "scale": {}}
    for n, x in tree.items():
        q, s = _quantize_shards(x.shards, x.spec, tuple(x.shape), x.mesh)
        out["q"][n] = spmd.Sharded(q, x.spec, x.mesh)
        out["scale"][n] = spmd.Sharded(s, _scale_spec(x.spec), x.mesh)
    return out


def _init_sharded(cfg: AdamWConfig, params) -> dict:
    mesh = next(iter(params.values())).mesh

    def zeros():
        return {n: spmd.Sharded([torch.zeros(t.shape, dtype=torch.float32,
                                             device=t.device)
                                 for t in p.shards], p.spec, mesh)
                for n, p in params.items()}

    state = {"step": spmd.Sharded(
        [torch.zeros((), dtype=torch.int32, device=d)
         for d in spmd.devices(mesh)], (), mesh)}
    if cfg.quantize_moments:
        state["m"] = _q_tree_sharded(zeros())
        state["v"] = _q_tree_sharded(zeros())
    else:
        state["m"] = zeros()
        state["v"] = zeros()
    if cfg.compress_grads:
        state["ef"] = zeros()
    return state


def _update_sharded(cfg: AdamWConfig, grads, state: dict, params):
    """``update`` on a local mesh: ``grads`` hold each position's
    gradient of its slices, summed over the positions holding copies."""
    mesh = next(iter(params.values())).mesh
    devs = spmd.devices(mesh)
    gs = {n: list(g.shards) for n, g in grads.items()}
    metrics = {}

    new_ef = None
    if cfg.compress_grads:
        new_ef = {}
        for n, p in params.items():
            shape = tuple(p.shape)
            fixed = [g + r for g, r in zip(gs[n], state["ef"][n].shards)]
            q, sc = _quantize_shards(fixed, p.spec, shape, mesh)
            gs[n] = _dequantize_shards(q, sc, p.spec, shape, mesh)
            new_ef[n] = spmd.Sharded([c - h for c, h in zip(fixed, gs[n])],
                                     p.spec, mesh)

    total = 0.0
    for n, p in params.items():
        for i in spmd.representatives(mesh, p.spec):
            total = total + torch.sum(torch.square(
                gs[n][i].to(torch.float32))).to(devs[0])
    gnorm = torch.sqrt(total)
    metrics["grad_norm"] = gnorm
    step = state["step"].shards[0]
    t = (step + 1).to(torch.float32)
    lr = lr_schedule(cfg, step)
    metrics["lr"] = lr
    scalars = [1 - torch.pow(cfg.b1, t), 1 - torch.pow(cfg.b2, t), lr]
    if cfg.clip_norm is not None:
        scalars.append(torch.clamp(cfg.clip_norm / gnorm.clamp_min(1e-12),
                                   max=1.0))
    on = {d: [x.to(d) for x in scalars] for d in set(devs)}

    quant = cfg.quantize_moments
    new_m = {"q": {}, "scale": {}} if quant else state["m"]
    new_v = {"q": {}, "scale": {}} if quant else state["v"]
    for n, p in params.items():
        shape = tuple(p.shape)
        if quant:
            mms = _dequantize_shards(state["m"]["q"][n].shards,
                                     state["m"]["scale"][n].shards, p.spec,
                                     shape, mesh)
            vvs = _dequantize_shards(state["v"]["q"][n].shards,
                                     state["v"]["scale"][n].shards, p.spec,
                                     shape, mesh)
        wd = cfg.weight_decay if decays(n, p.shards[0]) else 0.0
        for i, w in enumerate(p.shards):
            bc1, bc2, lr_d, *clip = on[w.device]
            g = gs[n][i].to(torch.float32)
            if clip:
                g = g * clip[0]
            if quant:
                mm = cfg.b1 * mms[i] + (1 - cfg.b1) * g
                vv = cfg.b2 * vvs[i] + (1 - cfg.b2) * torch.square(g)
                mms[i], vvs[i] = mm, vv
            else:
                mm = new_m[n].shards[i].mul_(cfg.b1).add_((1 - cfg.b1) * g)
                vv = new_v[n].shards[i].mul_(cfg.b2).add_(
                    (1 - cfg.b2) * torch.square(g))
            delta = (mm / bc1) / (torch.sqrt(vv / bc2) + cfg.eps)
            wf = w.to(torch.float32)
            w.copy_(wf - lr_d * (delta + wd * wf))
        if quant:
            for tree, xs in ((new_m, mms), (new_v, vvs)):
                q, sc = _quantize_shards(xs, p.spec, shape, mesh)
                tree["q"][n] = spmd.Sharded(q, p.spec, mesh)
                tree["scale"][n] = spmd.Sharded(sc, _scale_spec(p.spec), mesh)

    new_state = {"step": spmd.Sharded([s + 1 for s in state["step"].shards],
                                      (), mesh),
                 "m": new_m, "v": new_v}
    if new_ef is not None:
        new_state["ef"] = new_ef
    return params, new_state, metrics
