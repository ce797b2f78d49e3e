"""Serving driver: batched greedy decoding of a language model, the port
of the reference's ``launch/serve.py``.

Requests arrive with prompts, are left-padded into one batch, prefilled
once, then decoded step by step with the per-layer KV caches (ring
buffers on windowed layers). Batching amortizes the weights read (the
dominant decode roofline term). The decode loop is a Python loop of
``decode_step`` calls, where the reference's is one jitted scan.

    python -m repro_torch.launch.serve --arch smollm-135m [--smoke]
        [--device cpu] [--mesh DATAxMODEL]

serves on the card unless ``--device cpu`` is given, and raises without
one. Weights are random, from a seed: nothing is downloaded.
``--mesh 2x4`` (``BatchServer(..., mesh=)``) serves the model split over a
local (data=2, model=4) mesh (``launch/mesh.make_local_mesh``: on one
card all eight positions share it), any family.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.device import synchronize
from repro_torch.launch.mesh import make_local_mesh, parse_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    temperature: float = 0.0    # 0 = greedy
    top_k: int = 0
    out: Optional[np.ndarray] = None


class BatchServer:
    """Serves a list of requests as one batch on the model's device, or
    split over a local ``mesh`` (a module given with one is split once,
    here)."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 4096,
                 mesh=None):
        self.cfg = cfg
        self.params = params if mesh is None else \
            model_lib.on_mesh(params, mesh, cfg)
        self.max_len = max_len
        self.mesh = mesh
        self.device = model_lib.device_of(self.params)

    def serve(self, requests: List[Request]) -> List[Request]:
        cfg = self.cfg
        b = len(requests)
        s_max = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, s_max), np.int32)
        for i, r in enumerate(requests):
            toks[i, s_max - len(r.prompt):] = r.prompt  # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model),
                                          dtype=dtype_of(cfg.dtype),
                                          device=self.device)

        max_new = max(r.max_new for r in requests)
        temperature = max(r.temperature for r in requests)
        top_k = max(r.top_k for r in requests)
        synchronize(batch["tokens"])
        t0 = time.perf_counter()
        out = model_lib.generate(
            self.params, batch, cfg, max_new=max_new,
            max_len=min(self.max_len, s_max + max_new),
            temperature=temperature, top_k=top_k, mesh=self.mesh)
        out = out.cpu().numpy()
        dt = time.perf_counter() - t0
        for i, r in enumerate(requests):
            r.out = out[i, :r.max_new]
        tput = b * max_new / dt
        where = self.device if self.mesh is None else \
            f"a {'x'.join(map(str, self.mesh.sizes))} mesh"
        print(f"served {b} requests x {max_new} tokens "
              f"in {dt:.2f}s ({tput:.1f} tok/s) on {where}")
        return requests


def main(argv=None):
    import argparse
    from repro_torch import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve split over a local mesh, e.g. 2x4")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    mesh = None
    if args.mesh:
        mesh = make_local_mesh(*parse_mesh(args.mesh), device=args.device)
    params = model_lib.init_params(0, cfg, device=args.device)
    server = BatchServer(cfg, params, mesh=mesh)
    del params
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=args.prompt_len
                                        ).astype(np.int32),
                    max_new=args.max_new)
            for _ in range(args.batch)]
    server.serve(reqs)
    for i, r in enumerate(reqs[:2]):
        print(f"req {i}: {r.out[:10]}")
    return reqs


if __name__ == "__main__":
    main()
