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
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

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
