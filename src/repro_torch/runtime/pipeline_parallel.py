"""GPipe-style pipeline parallelism: stage-sharded layer stacks, a
microbatched schedule, activations forwarded from stage to stage -- the
port of the reference's ``runtime/pipeline_parallel.py``.

One process drives every stage, stage s on ``devices[s]``, as the
distributed engines drive their shards (``core/distributed.py``): an
activation crosses to the next stage's device by a copy. On one card
every stage is ``cuda:0``. The schedule is the reference's GPipe ticks:
at tick t stage s runs microbatch t - s, so P stages finish M microbatches
in M + P - 1 ticks; the reference's stages also compute in their idle
ticks (its SPMD program runs every stage every tick), whose results it
drops, and here they skip.

PP exchanges only (microbatch, seq, d_model) activations per tick instead
of full gradients, which suits links much slower than the ones within a
host.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   devices: Sequence, n_microbatches: int) -> torch.Tensor:
    """Run ``y = stage_P-1( ... stage_0(x))`` with GPipe microbatching.

    stage_params: nested dicts of tensors with leading dim P (one entry a
    stage, ``stack_stages``); stage_fn(params_stage, x_mb) -> y_mb, same
    shape. x: (B, ...) with B % n_microbatches == 0. The output is on
    ``x``'s device.
    """
    n_stages = len(devices)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} does not split into {n_microbatches} "
                         f"microbatches")
    mb = b // n_microbatches
    params = [_map(stage_params, lambda a, s=s: a[s].to(devices[s]))
              for s in range(n_stages)]
    mbs = x.reshape(n_microbatches, mb, *x.shape[1:])
    outs = [None] * n_microbatches
    inbox = [None] * n_stages       # each stage's input at this tick
    for t in range(n_microbatches + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            i = t - s
            if not 0 <= i < n_microbatches:
                continue            # a bubble: no microbatch here
            inp = mbs[i].to(devices[0]) if s == 0 else inbox[s]
            out = stage_fn(params[s], inp)
            if s == n_stages - 1:
                outs[i] = out.to(x.device)
            else:
                nxt[s + 1] = out.to(devices[s + 1])
        inbox = nxt
    return torch.cat(outs).reshape(b, *x.shape[1:])


def stack_stages(layer_params_stacked, n_stages: int):
    """Reshape (L, ...) stacked layer params into (P, L/P, ...) stages."""
    def r(a):
        nl = a.shape[0]
        if nl % n_stages:
            raise ValueError(f"{nl} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape(n_stages, nl // n_stages, *a.shape[1:])
    return _map(layer_params_stacked, r)
