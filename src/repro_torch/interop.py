"""Carrying the reference's state and rules across to the port.

The system has no weights; what crosses over is simulation state and
workload parameters:

  * ``state_from_numpy`` / ``state_to_numpy`` move a state in the shared
    ``(B?, C?, n_blocks, rho, rho)`` layout, the 3D ``(B?, n_blocks, rho,
    rho, rho)`` one, or any other engine layout, between numpy and a torch
    tensor on a device;
  * ``workload_from_fields(kind, **fields)`` builds the port's twin of a
    reference ``TotalisticCA``, ``HeatDiffusion`` or ``GrayScott`` from its
    dataclass fields (``dataclasses.asdict`` of the reference object),
    the 3D ``LIFE3D`` and ``HEAT3D`` included.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.workloads.rules import GrayScott, HeatDiffusion, TotalisticCA

#: reference workload class name -> port class
_WORKLOAD_KINDS = {
    "TotalisticCA": TotalisticCA, "HeatDiffusion": HeatDiffusion,
    "GrayScott": GrayScott,
}


def state_from_numpy(arr, device=None) -> torch.Tensor:
    """A contiguous tensor with ``arr``'s dtype and layout on ``device``
    (``None`` = the card)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        resolve_device(device))


def state_to_numpy(state: torch.Tensor) -> np.ndarray:
    return state.detach().cpu().numpy()


def workload_from_fields(kind: str, **fields):
    """The port's workload of class ``kind`` ('TotalisticCA',
    'HeatDiffusion' or 'GrayScott') with the given dataclass fields."""
    try:
        cls = _WORKLOAD_KINDS[kind]
    except KeyError:
        raise KeyError(f"unknown workload kind {kind!r}; have "
                       f"{sorted(_WORKLOAD_KINDS)}") from None
    if cls is TotalisticCA:
        for key in ("born", "survive"):
            if key in fields:
                fields[key] = frozenset(int(c) for c in fields[key])
    return cls(**fields)
