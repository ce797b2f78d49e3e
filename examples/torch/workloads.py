"""Beyond the paper's case study: four workloads on one compact fractal,
and a batched runtime serving 8 concurrent simulations per workload from
one cached engine each.

Spec-first: an ``EngineSpec`` names the configuration once and the
runner, the engine and the tuning table all key on it. With
``fusion_k=None`` the shipped tuning table resolves the fusion depth
(falling back to the static heuristic off-table).

    PYTHONPATH=src python examples/torch/workloads.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch.core import SIERPINSKI
from repro_torch.tuning import EngineSpec
from repro_torch.workloads import (GRAY_SCOTT, HEAT, HIGHLIFE, LIFE,
                                   BatchedRunner)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=6)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    r, m, steps, batch = args.r, args.m, args.steps, args.batch

    runner = BatchedRunner(device=args.device)
    stats = {}
    for wl in (LIFE, HIGHLIFE, HEAT, GRAY_SCOTT):
        spec = EngineSpec.from_args("cuda-fused", SIERPINSKI, r, m, wl)
        states = runner.init_batch(spec, range(batch))
        states = runner.run(spec, states, steps)
        if wl.dtype == torch.uint8:
            stats[wl.name] = float(states.sum(dtype=torch.int64)) / batch
            stat = f"mean population {stats[wl.name]:.0f}"
        else:
            stats[wl.name] = float(states.float().mean())
            stat = f"mean field {stats[wl.name]:.4f}"
        k = runner.engine_for(spec).effective_fusion_k
        print(f"{wl.name:>10}: {batch} sims x {steps} steps (fusion k={k}), "
              f"state {tuple(states.shape)} {wl.dtype}, {stat}")
    print(f"engines built: {runner.stats.builds} (one per workload) on "
          f"{runner.device}; each batch of {batch} sims shares one")

    # the v5 tensor-core path: the whole batch advances through ONE
    # kernel launch a fused step (the Moore sums as banded products)
    spec = EngineSpec.from_args("cuda-mxu", SIERPINSKI, r, m, HEAT)
    states = runner.run(spec, runner.init_batch(spec, range(batch)), steps)
    stats["cuda-mxu"] = float(states.mean())
    print(f"cuda-mxu: {batch} sims x {steps} steps in batched launches, "
          f"mean field {stats['cuda-mxu']:.4f}")
    return stats


if __name__ == "__main__":
    main()
