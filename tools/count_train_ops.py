"""Count the operations one training step dispatches, on the CPU: a
``make_train_step`` step of a model with an architecture's full depth,
layer kinds, compute dtype and remat, at the smoke width (``reduced()``'s
d=64), counted by a ``TorchDispatchMode`` below autograd (the forward,
the remat recomputation, the backward and the optimizer; views count).
The count depends on the depth and the code path, not the width, so it
predicts the host work of a full-width step on the card, where each
non-view operation is a kernel launch.

    PYTHONPATH=src python tools/count_train_ops.py [--arch smollm-135m]
        [--batch 2] [--seq 32]
"""
import argparse
import collections
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.launch import specs
from repro_torch.models import model as lm
from repro_torch.optim import adamw


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    full = configs.get_config(args.arch)
    cfg = dataclasses.replace(configs.reduced(full), n_units=full.n_units,
                              dtype=full.dtype, remat=full.remat)
    model = lm.init_params(0, cfg, device="cpu")
    ocfg = adamw.AdamWConfig()
    state = adamw.init(ocfg, dict(model.named_parameters()))
    step = specs.make_train_step(cfg, ocfg)
    gen = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (args.batch, args.seq),
                              generator=gen, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step(model, state, batch)                 # the first step allocates
    count = _Count()
    with count:
        step(model, state, batch)
    total = sum(count.ops.values())
    print(f"{args.arch}: {cfg.n_units} units, {total} ops a step, "
          f"{len(list(model.parameters()))} parameters; most common "
          f"{count.ops.most_common(8)}")
    return total


if __name__ == "__main__":
    main()
