"""Carrying the reference's state, rules and weights across to the port.

What crosses over is simulation state, workload parameters and language-
model parameters:

  * ``state_from_numpy`` / ``state_to_numpy`` move a state in the shared
    ``(B?, C?, n_blocks, rho, rho)`` layout, the 3D ``(B?, n_blocks, rho,
    rho, rho)`` one, or any other engine layout, between numpy and a torch
    tensor on a device;
  * ``workload_from_fields(kind, **fields)`` builds the port's twin of a
    reference ``TotalisticCA``, ``HeatDiffusion`` or ``GrayScott`` from its
    dataclass fields (``dataclasses.asdict`` of the reference object),
    the 3D ``LIFE3D`` and ``HEAT3D`` included;
  * ``params_from_numpy(cfg, tree)`` builds the port's model from the
    reference's parameter tree (nested dicts of arrays), splitting the
    leading unit axis of the stacked ``units`` / ``enc_units`` /
    ``dec_units`` subtrees into one module a unit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.workloads.rules import GrayScott, HeatDiffusion, TotalisticCA

#: subtrees whose leaves the reference stacks over units (a leading axis)
_STACKED = ("units", "enc_units", "dec_units")

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


def _flatten(tree, prefix=""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The port's model for ``cfg`` on ``device`` (``None`` = the card)
    holding the reference's parameters ``tree``; every leaf goes through
    ``np.asarray``. Leaf ``units.l0.attn.wq`` of shape (n_units, ...) lands
    in ``units.<i>.l0.attn.wq`` for each unit i. Raises KeyError when the
    names differ and ValueError when a shape does."""
    device = resolve_device(device)
    leaves = {}
    for path, arr in _flatten(tree):
        top, _, rest = path.partition(".")
        if top in _STACKED:
            for i in range(arr.shape[0]):
                leaves[f"{top}.{i}.{rest}"] = arr[i]
        else:
            leaves[path] = arr
    model = build_model(cfg, device, None)
    own = model.state_dict()
    if set(own) != set(leaves):
        raise KeyError(f"parameter names differ: only in the port "
                       f"{sorted(set(own) - set(leaves))}, only in the tree "
                       f"{sorted(set(leaves) - set(own))}")
    for name, tensor in own.items():
        arr = leaves[name]
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{name}: shape {arr.shape} in the tree, "
                             f"{tuple(tensor.shape)} in the port")
        tensor.copy_(torch.from_numpy(np.array(arr)))
    return model
