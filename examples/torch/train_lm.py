"""End-to-end training example: train a reduced smollm-135m on the
synthetic Markov corpus for a few hundred steps with the full loop --
stateless data, AdamW, checkpointing, watchdog, preemption hook -- and
check that the loss drops toward the corpus entropy.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300]
        [--device cpu]

Trains on the card unless ``--device cpu`` is given. The weights are
random, from a seed.
"""
import argparse
import math
import tempfile

import numpy as np

from repro_torch import configs
from repro_torch.data.pipeline import SyntheticMarkov
from repro_torch.launch.train import train
from repro_torch.optim import adamw
from repro_torch.runtime.fault import PreemptionHandler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--p-signal", type=float, default=0.9)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config("smollm-135m")
    data = SyntheticMarkov(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch,
                           p_signal=args.p_signal, seed=1)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=30,
                                total_steps=args.steps)

    # entropy of the channel: -p log p - (1-p) log((1-p)/V)
    p = args.p_signal
    v = cfg.vocab
    h = -p * math.log(p) - (1 - p) * math.log((1 - p) / v)
    print(f"corpus entropy ~ {h:.3f} nats; ln(V) = {math.log(v):.3f}")

    with tempfile.TemporaryDirectory() as ckpt, \
            PreemptionHandler() as preemption:
        res = train(cfg, opt_cfg, data, steps=args.steps, ckpt_dir=ckpt,
                    ckpt_every=100, preemption=preemption, log_every=25,
                    device=args.device)
    first = float(np.mean(res.losses[:10]))
    last = float(np.mean(res.losses[-10:]))
    print(f"loss: {first:.3f} -> {last:.3f} "
          f"(corpus entropy {h:.3f})")
    if not last < first - 0.5:
        raise AssertionError(f"expected a clear loss drop: {first:.3f} -> "
                             f"{last:.3f}")
    print("OK: model learned the Markov structure")
    return first, last


if __name__ == "__main__":
    main()
