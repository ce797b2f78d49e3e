"""The port's device rule: entry points run on the card unless the caller
asks for another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``, and raises when there is no CUDA device;
    the CPU is used only when the caller passes ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(state) -> None:
    """Wait until the cards holding ``state`` (a tensor or a tuple of
    shard tensors) have finished its work; nothing to wait for on the
    CPU."""
    shards = state if isinstance(state, tuple) else (state,)
    for dev in {t.device for t in shards}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
