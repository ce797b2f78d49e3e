"""Batched serving example: prefill + KV-cached greedy decode with the
BatchServer (ring buffers on windowed layers), on a reduced gemma2-2b --
exercising sliding-window + softcap + tied embeddings in the serve path.

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

Runs on the card unless ``--device cpu`` is given. The weights are random,
from a seed.
"""
import argparse

import numpy as np

from repro_torch import configs
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models import model as model_lib


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke_config("gemma2-2b")
    params = model_lib.init_params(0, cfg, device=args.device)
    server = BatchServer(cfg, params, max_len=256)

    rng = np.random.default_rng(0)
    requests = [
        Request(prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                max_new=12)
        for n in (24, 17, 31, 8)   # ragged prompts, left-padded batch
    ]
    server.serve(requests)
    for i, r in enumerate(requests):
        assert r.out is not None and len(r.out) == 12
        print(f"request {i} (prompt {len(r.prompt)} toks) -> {r.out}")
    print("OK: batched prefill+decode served all requests")
    return requests


if __name__ == "__main__":
    main()
