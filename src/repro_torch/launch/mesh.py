"""Mesh descriptions, the port of the reference's ``launch/mesh.py``.

A ``Mesh`` names its axes and their sizes, and, where it stands for
devices of this host, lists them. It is a description for placement
plans (``utils/sharding.py``, ``launch/specs.py``, ``launch/dryrun.py``):
the port has no multi-process transport, since one card cannot check one,
so a production mesh of 256 or 512 chips exists only as a plan.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    #: the devices of a local mesh, in axis order; empty for a plan
    devices: Tuple[torch.device, ...] = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False, data: int = 16,
                         model: int = 16) -> Mesh:
    """Single pod: (data=16, model=16) = 256 chips.
    Multi-pod:  (pod=2, data=16, model=16) = 512 chips.

    ``data``/``model`` may be re-split (same chip count) -- e.g. (data=64,
    model=4) narrows TP, which shrinks the per-device activation
    all-reduce payload linearly at equal compute."""
    if data * model != 256:
        raise ValueError(f"a pod is 256 chips, not {data} x {model}")
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, data, model))
    return Mesh(("data", "model"), (data, model))


def make_local_mesh(model_axis: int = 1, device=None) -> Mesh:
    """Mesh over this host's cards (``device=None``; raises without CUDA),
    or over the one CPU (``device="cpu"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        devices = (dev,)
    n = len(devices)
    if n % model_axis:
        raise ValueError(f"{n} devices do not split into a model axis of "
                         f"{model_axis}")
    return Mesh(("data", "model"), (n // model_axis, model_axis), devices)
