"""Meshes, the port of the reference's ``launch/mesh.py``.

A ``Mesh`` names its axes and their sizes and, where it stands for
positions of this host, lists one ``torch.device`` a position in row-major
axis order. A mesh without devices is a plan (``utils/sharding.py``,
``launch/specs.py``, ``launch/dryrun.py``): a production mesh of 256 or
512 chips exists only as one. A local mesh (``make_local_mesh``) is run:
one process drives every position, and a position may repeat a device
(all eight of a (2, 4) mesh on ``cuda:0`` on one card), as the
distributed stencil engines drive their shards. ``runtime/spmd.py`` holds
its collectives; ``mesh=`` on the language-model entry points
(``models/model.py``, ``launch/specs.py``, ``launch/serve.py``,
``launch/train.py``) runs a model sharded over it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

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


def make_local_mesh(model_axis: int = 1, data_axis: Optional[int] = None,
                    device=None) -> Mesh:
    """A (data, model) mesh of this host's cards (``device=None``; raises
    without CUDA) or of the one CPU (``device="cpu"``).

    Without ``data_axis`` there is one position a card (the reference's
    ``make_local_mesh(model_axis)``: data = cards / model_axis). With it
    the mesh has ``data_axis * model_axis`` positions spread over the
    cards in contiguous blocks, so a model group stays on one card where
    the counts allow; on one card, or on the CPU, every position shares
    the one device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        cards = [dev]
    if data_axis is None:
        n = len(cards)
        if n % model_axis:
            raise ValueError(f"{n} devices do not split into a model axis "
                             f"of {model_axis}")
        return Mesh(("data", "model"), (n // model_axis, model_axis),
                    tuple(cards))
    n = data_axis * model_axis
    if n <= len(cards):
        devices = cards[:n]
    else:
        devices = [cards[i * len(cards) // n] for i in range(n)]
    return Mesh(("data", "model"), (data_axis, model_axis), tuple(devices))


def parse_mesh(text: str) -> Tuple[int, int]:
    """``"DATAxMODEL"`` (the CLIs' ``--mesh``) -> (model_axis, data_axis),
    ``make_local_mesh``'s first two arguments."""
    try:
        data, model = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxMODEL, e.g. 2x4, not "
                         f"{text!r}") from None
    return model, data
