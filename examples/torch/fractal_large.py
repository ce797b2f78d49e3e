"""The paper's capability claim (Section 4.3): Squeeze processes fractal
levels whose bounding-box embedding could never fit. We run a level the
BB engine would need ~16 GiB for (r = 17), in a few hundred MiB of compact
state, on the kernel engine; with ``--distributed`` the same level runs
sharded over ``--shards`` shards (on one card, all on it).

    PYTHONPATH=src python examples/torch/fractal_large.py [--r 17]
        [--distributed --shards 4] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.core import SIERPINSKI, BlockLayout, make_engine
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.core.distributed import make_distributed_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=14,
                    help="fractal level (n = 2^r); BB needs 4^r bytes")
    ap.add_argument("--m", type=int, default=4, help="block level (rho=2^m)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    frac = SIERPINSKI
    layout = BlockLayout(frac, args.r, args.m)
    bb_bytes = frac.side(args.r) ** 2
    sq_bytes = layout.memory_bytes()
    print(f"level r={args.r}: n={frac.side(args.r)}, "
          f"BB would need {bb_bytes / 2**30:.2f} GiB; "
          f"Squeeze uses {sq_bytes / 2**20:.1f} MiB "
          f"(MRF {bb_bytes / sq_bytes:.0f}x)")

    if args.distributed:
        eng = make_distributed_engine(layout, n_shards=args.shards,
                                      device=dev, compute="fused")
        print(f"distributed over {eng.n_shards} shards on {dev} "
              f"({eng.exchange_mode} strip halo exchange)")
        state = eng.init_random(seed=0)
    else:
        eng = make_engine("cuda-fused", frac, args.r, args.m, device=dev)
        state = eng.init_random(seed=0)
    state = eng.run(state, 1)   # warm-up: kernel build and tables
    synchronize(state)
    t0 = time.perf_counter()
    state = eng.run(state, args.steps)
    synchronize(state)
    dt = time.perf_counter() - t0
    cells = frac.volume(args.r)
    dense = eng.to_dense(state) if args.distributed else state
    live = int(dense.sum(dtype=torch.int64))
    print(f"{args.steps} steps over {cells:,} fractal cells in {dt:.4f}s "
          f"on {dev} ({args.steps * cells / dt / 1e6:.1f} "
          f"Mcell-updates/s, after one warm-up step)")
    print(f"live cells: {live:,}")
    return live


if __name__ == "__main__":
    main()
