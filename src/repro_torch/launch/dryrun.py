"""Dry run of every (architecture x input-shape x mesh) cell: the port of
the reference's ``launch/dryrun.py``.

Each cell is built on ``torch.device("meta")`` (shapes and dtypes, no
storage: the counterpart of ``jax.eval_shape``), so a 480 B-parameter
model costs no memory. For each cell it reports the per-device bytes of
the parameters, gradients and optimizer state under the placement plans
of ``launch/specs.py``, plus ``utils/analytic.bytes_model``'s activations
and KV cache, and the analytic roofline row; ``ok`` says whether that sum
fits one H100's 80 GB. These bytes are a plan's, not a compiler's: the
port compiles nothing here (the reference lowers and compiles each cell
with XLA and reads its memory analysis), so no compile time is reported
and temporaries a compiler would add are not counted.

Run one cell:
    python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
                                        [--multi-pod]
Run the matrix in one process (meta tensors cost no memory):
    python -m repro_torch.launch.dryrun --all [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.utils import analytic
from repro_torch.utils.sharding import shard_factor

#: one H100's device memory
DEVICE_BYTES = 80e9


def _walk(tree, plan):
    """(tensor, placement) pairs of a tree and its plan (nested dicts and
    lists in the same structure)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, plan[k])
    elif isinstance(tree, (list, tuple)):
        for v, p in zip(tree, plan):
            yield from _walk(v, p)
    elif tree is not None:
        yield tree, plan


def planned_bytes(tree, plan, mesh) -> float:
    """Per-device bytes of ``tree``'s tensors under ``plan``."""
    return float(sum(t.numel() * t.element_size() / shard_factor(p, mesh)
                     for t, p in _walk(tree, plan)))


def run_cell(arch: str, shape: str, mesh, *, seq_shard: bool = False,
             kv_quant: bool = False, accum: int = 1) -> dict:
    t0 = time.time()
    fn, args, plans, _, meta = specs_lib.build_cell(
        arch, shape, mesh, seq_shard=seq_shard, kv_quant=kv_quant,
        accum_steps=accum)
    cfg = meta["cfg"]
    params = dict(args[0].named_parameters())
    p_bytes = planned_bytes(params, plans[0], mesh)
    row = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(n) for n in mesh.sizes),
           "n_chips": mesh.size, "params_bytes": p_bytes}
    if meta["kind"] == "train":
        row["grads_bytes"] = p_bytes
        row["opt_bytes"] = planned_bytes(args[1], plans[1], mesh)
    mm = analytic.MeshModel(**mesh.shape)
    by = analytic.bytes_model(cfg, shape, mm)
    row["acts_bytes"] = by.get("acts", 0.0) + by.get("logits", 0.0)
    row["kv_bytes"] = by.get("kv", 0.0)
    row["per_device_bytes"] = (p_bytes + row.get("grads_bytes", 0.0)
                               + row.get("opt_bytes", 0.0)
                               + row["acts_bytes"] + row["kv_bytes"])
    row["ok"] = row["per_device_bytes"] <= DEVICE_BYTES
    roof = analytic.analytic_roofline(cfg, shape, mm)
    roof.model_flops = specs_lib.model_flops_for(cfg, shape)
    row.update(roof.row())
    row["build_s"] = time.time() - t0
    return row


ALL_CELLS_NOTE = """Matrix: 10 archs x 4 shapes, long_500k only for
sub-quadratic archs, x the meshes asked for."""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--data", type=int, default=16,
                    help="data-axis size (perf experiments)")
    ap.add_argument("--model", type=int, default=16,
                    help="model-axis size (perf experiments)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="Megatron-SP activation boundaries (perf)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (perf; decode cells)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (perf)")
    ap.add_argument("--all", action="store_true", help=ALL_CELLS_NOTE)
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--meshes", default="single,multi",
                    help="comma list: single,multi")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape, mp == "multi")
                 for arch, shape, _ in configs.cells()
                 for mp in args.meshes.split(",")]
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]
    rows = []
    for arch, shape, multi_pod in cells:
        mesh = mesh_lib.make_production_mesh(
            multi_pod=multi_pod, data=args.data, model=args.model)
        row = run_cell(arch, shape, mesh, seq_shard=args.seq_shard,
                       kv_quant=args.kv_quant, accum=args.accum)
        print(json.dumps(row), flush=True)
        rows.append(row)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
