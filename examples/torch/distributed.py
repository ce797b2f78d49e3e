"""Distributed Squeeze end to end: one compact fractal sharded over
``--shards`` shards along its block axis, k-fused strip halo exchange
(neighbor-only sends by default, all-gather fallback), single-device
parity, and the k-fusion knob's effect on the exchange count and bytes.

    PYTHONPATH=src python examples/torch/distributed.py [--device cpu]

Each shard is a tensor on its own device: on one card all shards sit on
it, on several cards they go round them; with ``--device cpu`` they all
sit on the CPU. Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import torch

from repro_torch.core import SIERPINSKI
from repro_torch.core.compact import BlockLayout
from repro_torch.core.device import resolve_device
from repro_torch.core.distributed import make_distributed_engine
from repro_torch.core.stencil import SqueezeBlockEngine
from repro_torch.tuning import EngineSpec
from repro_torch.workloads import GRAY_SCOTT, LIFE, BatchedRunner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--r", type=int, default=7)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    r, m, steps, shards = args.r, args.m, args.steps, args.shards
    dev = resolve_device(args.device)
    print(f"{shards} shards on {dev}")

    layout = BlockLayout(SIERPINSKI, r, m)
    print(f"sierpinski r={r}, m={m}: {layout.n_blocks} blocks of "
          f"{layout.rho}x{layout.rho} cells "
          f"({layout.memory_bytes()} compact bytes vs "
          f"{SIERPINSKI.side(r) ** 2} dense)")

    # ---- single-device oracle ----------------------------------------------
    ref_engine = SqueezeBlockEngine(layout, LIFE, fusion_k=1, device=dev)
    ref = ref_engine.run(ref_engine.init_random(42), steps)

    # ---- distributed: the k-fusion knob ------------------------------------
    # k=1 exchanges a halo every step; fused k>=2 exchanges depth-k strips
    # once per k steps, bit-exact for CA workloads. 'auto' sends to the
    # neighbors only whenever the strip decomposition is valid (it is
    # here), and all-gathers otherwise.
    exact = {}
    for k in (1, 2, 4):
        dist = make_distributed_engine(layout, n_shards=shards, device=dev,
                                       workload=LIFE, compute="jnp",
                                       fusion_k=k)
        out = dist.run(dist.init_random(42), steps)
        exact[k] = bool(torch.equal(dist.to_dense(out), ref))
        st = dist.exchange_stats()
        noun = ("neighbor sends" if dist.exchange_mode == "p2p"
                else "all-gathers")
        print(f"k={k}: {st.collectives:2d} {noun} for {steps} steps "
              f"({st.collectives_per_step:.2f}/step, "
              f"{st.bytes_per_step / 1024:.1f} KiB exchanged/step), "
              f"shard-local state {dist.memory_bytes() // dist.n_shards} B, "
              f"bit-exact vs single device: {exact[k]}")
    assert all(exact.values())

    # ---- shard-local kernel computes + multi-channel PDE --------------------
    # 'mxu' runs the v5 tensor-core kernel (shard-local: kernel 7) on each
    # shard's blocks; on the CPU its plain version
    dist = make_distributed_engine(layout, n_shards=shards, device=dev,
                                   workload=GRAY_SCOTT, compute="mxu",
                                   fusion_k=2)
    out = dist.run(dist.init_random(7), steps)
    gs_ref_engine = SqueezeBlockEngine(layout, GRAY_SCOTT, fusion_k=1,
                                       device=dev)
    gs_ref = gs_ref_engine.run(gs_ref_engine.init_random(7), steps)
    close = bool(torch.allclose(dist.to_dense(out), gs_ref, rtol=1e-5,
                                atol=1e-5))
    print(f"gray-scott via shard-local MXU kernel, k=2: allclose vs single "
          f"device: {close}")
    assert close

    # ---- the runner: many small fractals and one big one --------------------
    runner = BatchedRunner(device=dev)
    big = EngineSpec.from_args("dist-block", SIERPINSKI, r, m, LIFE,
                               fusion_k=2, n_shards=shards)
    states = runner.run(big, runner.init_batch(big, range(4)), steps)
    print(f"runner: 4 sims x {steps} steps, block-axis sharded over "
          f"{len(states)} shards of {tuple(states[0].shape)} -- one batched "
          f"strip exchange per fused launch")
    small_spec = EngineSpec.from_args("block", SIERPINSKI, 5, m, LIFE)
    small = runner.run(small_spec, runner.init_batch(small_spec, range(8)),
                       steps)
    print(f"runner: 8 small sims batched on {dev}, state "
          f"{tuple(small.shape)}, population "
          f"{int(small.sum(dtype=torch.int64))}")
    return exact


if __name__ == "__main__":
    main()
