"""Quickstart: Conway's game of life on a compact Sierpinski triangle --
the paper's case study, end to end on the port.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given. The expanded
bounding-box engine, the cell engine, the plain block engine and the
Hopper kernel engine (``cuda-fused``: on a CUDA device the v3/v4 kernels,
on the CPU their plain versions) start from one random state and must
end in the same state.
"""
import argparse

import torch

from repro_torch.core import (SIERPINSKI, BBEngine, BlockLayout,
                              SqueezeBlockEngine, SqueezeCellEngine,
                              expanded_to_compact, make_engine)
from repro_torch.core.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=7,
                    help="fractal level: n = 2^r, 3^r cells")
    ap.add_argument("--m", type=int, default=3, help="block level (rho=2^m)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # classic expanded bounding-box (the baseline the paper beats)
    bb = BBEngine(SIERPINSKI, args.r, device=dev)
    # Squeeze: same simulation, compact memory (k^r cells instead of n^2)
    cell = SqueezeCellEngine(SIERPINSKI, args.r, device=dev)
    # block-level Squeeze (rho=2^m), plain and on the Hopper kernels
    block = SqueezeBlockEngine(BlockLayout(SIERPINSKI, args.r, args.m),
                               device=dev)
    kernel = make_engine("cuda-fused", SIERPINSKI, args.r, args.m,
                         device=dev)

    s_bb = bb.init_random(seed=0)
    starts = {"bb": s_bb,
              "squeeze-cell": expanded_to_compact(SIERPINSKI, args.r, s_bb),
              "squeeze-block": block.layout.from_expanded(s_bb),
              "cuda-fused": kernel.layout.from_expanded(s_bb)}
    engines = {"bb": bb, "squeeze-cell": cell, "squeeze-block": block,
               "cuda-fused": kernel}
    finals, pops = {}, {}
    for name, eng in engines.items():
        state = eng.run(starts[name], args.steps)
        finals[name] = state if eng is bb else eng.to_expanded(state)
        pops[name] = int(state.sum(dtype=torch.int64))
    print(f"after {args.steps} steps on {dev}: population " +
          " ".join(f"{k}={v}" for k, v in pops.items()))
    assert all(torch.equal(f, finals["bb"]) for f in finals.values()), \
        "engines must agree"

    mrf_cell = bb.memory_bytes() / cell.memory_bytes()
    mrf_blk = bb.memory_bytes() / block.memory_bytes()
    print(f"memory: bb={bb.memory_bytes()}B  compact={cell.memory_bytes()}B "
          f"(MRF {mrf_cell:.1f}x)  block={block.memory_bytes()}B "
          f"(MRF {mrf_blk:.1f}x)")
    print("equal trajectories in compact space -- P1 and P2 solved "
          "(paper Section 1.1)")
    return pops


if __name__ == "__main__":
    main()
