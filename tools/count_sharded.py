"""Count what the sharded language-model path moves and holds at an
architecture's full width, without a card: the model, its cache and the
batch on ``torch.device("meta")`` (shapes, no storage), split over a local
mesh of meta positions, then one prefill, one decode step and one
training forward, each with ``runtime/spmd.COUNTS`` reset before it.
Prints each position's planned parameter bytes (``launch/dryrun``'s plan)
and the collectives' elements of each call, as one JSON line an
architecture.

    PYTHONPATH=src python tools/count_sharded.py [--arch mamba2-780m]
        [--mesh 2x4] [--batch 4] [--prompt 16] [--train-batch 2]
        [--train-seq 1024]
"""
import argparse
import dataclasses
import json

import torch

from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_local_mesh, parse_mesh
from repro_torch.models import model as lm
from repro_torch.runtime import spmd

META = torch.device("meta")


def _batch(cfg, rows: int, seq: int, labels: bool) -> dict:
    out = {"tokens": torch.zeros((rows, seq), dtype=torch.int32,
                                 device=META)}
    if labels:
        out["labels"] = torch.zeros_like(out["tokens"])
    if cfg.family == "encdec":
        out["frames"] = torch.zeros((rows, cfg.enc_seq, cfg.d_model),
                                    dtype=getattr(torch, cfg.dtype),
                                    device=META)
    return out


def count(arch: str, mesh, batch: int, prompt: int, train_batch: int,
          train_seq: int) -> dict:
    scfg = specs.serve_config(configs.get_config(arch))
    sm = lm.shard_model(lm.build_model(scfg, META, None), mesh)
    cache = lm.init_cache(scfg, batch, prompt + 1, mesh=mesh)
    row = {"arch": arch, "mesh": "x".join(map(str, mesh.sizes)),
           "serve_params_bytes_a_position":
               dryrun.run_cell(arch, "decode_32k", mesh)["params_bytes"]}
    with torch.no_grad():
        spmd.reset_counts()
        _, cache, extras = lm.prefill(sm, _batch(scfg, batch, prompt, False),
                                      scfg, cache, mesh=mesh)
        row["prefill_elements"] = spmd.counts()
        spmd.reset_counts()
        lm.decode_step(sm, torch.zeros((batch, 1), dtype=torch.int32,
                                       device=META), prompt, scfg, cache,
                       extras=extras, mesh=mesh)
        row["decode_elements_a_token"] = spmd.counts()
    tcfg = dataclasses.replace(configs.get_config(arch), dtype="float32")
    plan = dryrun.run_cell(arch, "train_4k", mesh)
    row["train_params_bytes_a_position"] = plan["params_bytes"]
    row["train_opt_bytes_a_position"] = plan["opt_bytes"]
    sm = lm.shard_model(lm.build_model(tcfg, META, None), mesh)
    sm.requires_grad_(True)
    spmd.reset_counts()
    lm.train_loss(sm, _batch(tcfg, train_batch, train_seq, True), tcfg,
                  mesh)
    row["train_forward_elements"] = spmd.counts()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--mesh", default="2x4", metavar="DATAxMODEL")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--train-batch", type=int, default=2)
    ap.add_argument("--train-seq", type=int, default=1024)
    args = ap.parse_args(argv)
    mesh = make_local_mesh(*parse_mesh(args.mesh), device=META)
    row = count(args.arch, mesh, args.batch, args.prompt, args.train_batch,
                args.train_seq)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
