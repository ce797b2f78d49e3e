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
    ``dec_units`` subtrees into one module a unit; ``params_to_numpy``
    stacks them back into the reference's tree;
  * ``opt_state_from_numpy`` / ``opt_state_to_numpy`` do the same for an
    AdamW state (``step``, the moments ``m`` and ``v`` -- float32, or int8
    ``q`` with their ``scale`` -- and the residuals ``ef``), so both
    packages can start a step from the same parameters and moments.

With ``mesh=`` (a local ``launch/mesh.Mesh``) the ``*_from_numpy``
functions split what they build over it by the plans of
``launch/specs.py`` (``models/model.ShardedModel``, ``runtime/spmd.
Sharded`` leaves); the ``*_to_numpy`` ones gather sharded state whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build_model, sharded_model
from repro_torch.runtime import spmd
from repro_torch.utils.sharding import param_specs
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


def state_to_numpy(state) -> np.ndarray:
    """A tensor, or a ``Sharded`` gathered whole, as a numpy array."""
    if isinstance(state, spmd.Sharded):
        state = state.full()
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


def _split_stacked(tree) -> dict:
    """Port name -> array: a leaf of a stacked subtree, ``units.l0.wq``
    of shape (n, ...), becomes ``units.<i>.l0.wq`` for each i."""
    leaves = {}
    for path, arr in _flatten(tree):
        top, _, rest = path.partition(".")
        if top in _STACKED:
            for i in range(arr.shape[0]):
                leaves[f"{top}.{i}.{rest}"] = arr[i]
        else:
            leaves[path] = arr
    return leaves


def _stack_units(cfg: ModelConfig, named) -> dict:
    """The reference's nested tree of numpy arrays from port names: the
    per-unit entries of a stacked subtree stacked along a new first axis,
    in unit order; raises ValueError when a unit is missing."""
    counts = {"units": cfg.n_units, "enc_units": cfg.n_enc_units,
              "dec_units": cfg.n_units}
    flat, units = {}, {}
    for name, arr in named.items():
        top, _, rest = name.partition(".")
        if top in _STACKED:
            i, _, leaf = rest.partition(".")
            units.setdefault(f"{top}.{leaf}", {})[int(i)] = arr
        else:
            flat[name] = arr
    for path, by_unit in units.items():
        n = counts[path.partition(".")[0]]
        if sorted(by_unit) != list(range(n)):
            raise ValueError(f"{path}: units {sorted(by_unit)}, want {n}")
        flat[path] = np.stack([by_unit[i] for i in range(n)])
    tree = {}
    for path, arr in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = arr
    return tree


def params_from_numpy(cfg: ModelConfig, tree, device=None, mesh=None):
    """The port's model for ``cfg`` on ``device`` (``None`` = the card)
    holding the reference's parameters ``tree``; every leaf goes through
    ``np.asarray``. Leaf ``units.l0.attn.wq`` of shape (n_units, ...) lands
    in ``units.<i>.l0.attn.wq`` for each unit i. Raises KeyError when the
    names differ and ValueError when a shape does. With a local ``mesh``
    the model is split over it (``ShardedModel``): each position gets
    only its slices."""
    leaves = _split_stacked(tree)
    if mesh is not None:
        meta = dict(build_model(cfg, torch.device("meta"),
                                None).named_parameters())
        for name, arr in leaves.items():
            if name in meta and tuple(arr.shape) != tuple(meta[name].shape):
                raise ValueError(f"{name}: shape {arr.shape} in the tree, "
                                 f"{tuple(meta[name].shape)} in the port")
        return sharded_model(cfg, mesh, {n: torch.from_numpy(np.array(a))
                                         for n, a in leaves.items()})
    device = resolve_device(device)
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


def params_to_numpy(cfg: ModelConfig, model) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays) of
    the port's ``model``: the inverse of ``params_from_numpy``."""
    return _stack_units(cfg, {n: state_to_numpy(p)
                              for n, p in model.named_parameters()})


def _quantized(sub) -> bool:
    """Whether a moment tree is int8 (``{"q": ..., "scale": ...}``)."""
    return set(sub) == {"q", "scale"}


def opt_state_from_numpy(cfg: ModelConfig, tree, device=None,
                         mesh=None) -> dict:
    """The port's AdamW state (``repro_torch.optim.adamw``) on ``device``
    (``None`` = the card) from the reference's: its step, and each
    parameter tree of moments or residuals split into port names, copied
    (``adamw.update`` writes the moments in place). Raises KeyError when a
    tree's names are not ``cfg``'s parameters. With a local ``mesh`` the
    state is split over it (``launch/specs.place_opt_state``)."""
    meta = build_model(cfg, torch.device("meta"), None)
    names = set(meta.state_dict())
    if mesh is not None:
        from repro_torch.launch.specs import place_opt_state
        whole = opt_state_from_numpy(cfg, tree, "cpu")
        return place_opt_state(whole, param_specs(meta, mesh), mesh)
    device = resolve_device(device)

    def put(sub):
        leaves = _split_stacked(sub)
        if set(leaves) != names:
            raise KeyError(f"moment names differ from the parameters': "
                           f"{sorted(set(leaves) ^ names)[:4]}")
        return {n: state_from_numpy(np.array(a), device)
                for n, a in leaves.items()}

    state = {"step": state_from_numpy(np.asarray(tree["step"]), device)}
    for key in ("m", "v", "ef"):
        if key not in tree:
            continue
        sub = tree[key]
        if _quantized(sub):
            state[key] = {k: put(sub[k]) for k in ("q", "scale")}
        else:
            state[key] = put(sub)
    return state


def opt_state_to_numpy(cfg: ModelConfig, state) -> dict:
    """The reference's AdamW state tree of the port's ``state``."""
    def get(sub):
        return _stack_units(cfg, {n: state_to_numpy(t)
                                  for n, t in sub.items()})

    tree = {"step": state_to_numpy(state["step"])}
    for key in ("m", "v", "ef"):
        if key not in state:
            continue
        sub = state[key]
        if _quantized(sub):
            tree[key] = {k: get(sub[k]) for k in ("q", "scale")}
        else:
            tree[key] = get(sub)
    return tree
