"""Training driver: checkpointed, watchdogged, restartable -- the port of
the reference's ``launch/train.py``.

    python -m repro_torch.launch.train --arch smollm-135m --steps 200
        [--smoke] [--batch 8] [--seq 256] [--lr 3e-4] [--ckpt-dir DIR]
        [--device cpu] [--mesh DATAxMODEL]

trains on the card unless ``--device cpu`` is given, and raises without
one. ``--mesh 2x4`` (``train(..., mesh=)``) trains split over a local
(data=2, model=4) mesh, any family; checkpoints hold the gathered tree,
so a run saved on one mesh resumes on another or on none.
Weights are random, from a seed; the data is the stateless synthetic
Markov corpus: nothing is downloaded.

The loop is structured for fault tolerance:
  * the data pipeline is stateless (batch = f(seed, step)), so resuming
    at step N replays nothing and skips nothing;
  * checkpoints are atomic and carry (params, opt_state, step);
  * a PreemptionHandler turns SIGTERM into checkpoint-and-exit;
  * runtime.fault.run_with_restarts supervises (tests kill mid-run and
    assert bit-exact continuation).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.device import resolve_device
from repro_torch.launch import specs as specs_lib
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw
from repro_torch.launch.mesh import make_local_mesh, parse_mesh
from repro_torch.runtime import spmd
from repro_torch.runtime.fault import (PreemptionHandler, SimulatedFailure,
                                       Watchdog)


@dataclasses.dataclass
class TrainResult:
    step: int
    losses: list
    stragglers: int
    restored_from: Optional[int]
    #: wall seconds of each step run (the step and the loss read back)
    step_seconds: List[float] = dataclasses.field(default_factory=list)
    #: the trained model (a ``ShardedModel`` under a mesh) and its AdamW
    #: state, as the run left them
    model: Any = None
    opt_state: Any = None


def _plan(tree):
    """The placements of a tree of ``Sharded`` leaves."""
    if isinstance(tree, dict):
        return {k: _plan(v) for k, v in tree.items()}
    return tree.spec


def _to_device(batch: dict, device: torch.device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, data, *,
          steps: int, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, mesh=None, seed: int = 0,
          fail_at: Optional[int] = None,
          preemption: Optional[PreemptionHandler] = None,
          log_every: int = 10,
          on_step: Optional[Callable] = None,
          device=None) -> TrainResult:
    """Run (or resume) training to ``steps`` total steps on ``device``
    (``None`` = the card), or split over a local ``mesh``: the weights
    are drawn on its first device from ``seed``, as an unsplit run draws
    them, then split."""
    if mesh is not None:
        device = mesh.devices[0]
    device = resolve_device(device)
    model = model_lib.init_params(seed, cfg, device)
    if mesh is not None:
        model = model_lib.shard_model(model, mesh)
    params = dict(model.named_parameters())
    opt_state = adamw.init(opt_cfg, params)
    start_step = 0
    restored_from = None

    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager and manager.latest_step() is not None:
        restored_from = manager.latest_step()
        if mesh is None:
            state = manager.restore(
                {"params": params, "opt": opt_state},
                put=lambda _name, a: torch.from_numpy(a).to(device))
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(state["params"][name])
            opt_state = state["opt"]
        else:
            state = manager.restore({"params": params, "opt": opt_state})
            model = model_lib.sharded_model(
                cfg, mesh, {n: torch.from_numpy(a)
                            for n, a in state["params"].items()})
            params = dict(model.named_parameters())
            opt_state = spmd.shard_tree(state["opt"], _plan(opt_state), mesh)
        start_step = restored_from

    def save(step):
        tree = {"params": params, "opt": opt_state}
        manager.save(step, tree if mesh is None else spmd.gather_tree(tree))

    step_fn = specs_lib.make_train_step(cfg, opt_cfg, mesh=mesh)
    watchdog = Watchdog()
    losses, seconds = [], []
    for step in range(start_step, steps):
        batch = _to_device(data.batch(step), device)
        watchdog.start_step()
        model, opt_state, metrics = step_fn(model, opt_state, batch)
        loss = float(metrics["loss"])
        seconds.append(watchdog.end_step())
        losses.append(loss)
        if on_step:
            on_step(step, metrics)
        if log_every and (step % log_every == 0 or step == steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
        done = step + 1
        want_ckpt = manager and (done % ckpt_every == 0 or done == steps)
        if preemption is not None and preemption.requested:
            if manager:
                save(done)
            print(f"preempted at step {done}; checkpointed and exiting")
            return TrainResult(done, losses, watchdog.stragglers,
                               restored_from, seconds, model, opt_state)
        if want_ckpt:
            save(done)
        if fail_at is not None and done == fail_at:
            raise SimulatedFailure(f"injected failure after step {done}")
    return TrainResult(steps, losses, watchdog.stragglers, restored_from,
                       seconds, model, opt_state)


def main(argv=None) -> TrainResult:
    import argparse
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticMarkov

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU; the card by default")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train split over a local mesh, e.g. 2x4")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        mesh = make_local_mesh(*parse_mesh(args.mesh), device=args.device)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=20,
                                total_steps=args.steps)
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch)
    t0 = time.time()
    with PreemptionHandler() as preemption:
        res = train(cfg, opt_cfg, data, steps=args.steps,
                    ckpt_dir=args.ckpt_dir, preemption=preemption,
                    device=args.device, mesh=mesh)
    dt = time.time() - t0
    print(f"done: {res.step} steps in {dt:.1f}s; "
          f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}")
    first, last = np.mean(res.losses[:5]), np.mean(res.losses[-5:])
    if not last < first:
        raise AssertionError(f"loss did not decrease: {first} -> {last}")
    return res


if __name__ == "__main__":
    main()
