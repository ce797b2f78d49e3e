"""Sharding rules: map parameter names and activation roles onto
placements for a mesh, the port of the reference's ``utils/sharding.py``.

A placement is a plain tuple with one entry a dimension: a mesh axis name,
a tuple of axis names, or None (that dimension is replicated); ``()``
places a scalar. A mesh is anything with ``axis_names`` and ``shape``
(axis name -> size), such as ``launch/mesh.py``'s ``Mesh``. The rules
are plans; ``shard``, ``gather`` and ``constraint`` carry them out on a
local mesh (one with devices) through ``runtime/spmd.py``, in one process.

Philosophy (MaxText-style, divisibility-safe):
  * batch shards over ("pod", "data") -- DP across pods, DP/FSDP within;
  * "model" is the tensor-parallel axis: attention heads, ffn hidden,
    vocab, experts;
  * parameters additionally FSDP-shard their d_model-sized axis over
    "data" (ZeRO-3);
  * every rule degrades to replication when the dimension does not divide
    the axis size (e.g. 12 heads on a 16-wide model axis).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import torch

from repro_torch.runtime import spmd

Spec = Tuple


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical roles of the mesh axes (None = role absent in this mesh)."""
    batch: Tuple[str, ...] = ("pod", "data")
    fsdp: Optional[str] = "data"
    model: Optional[str] = "model"

    def present(self, mesh) -> "MeshAxes":
        names = set(mesh.axis_names)
        return MeshAxes(
            batch=tuple(a for a in self.batch if a in names),
            fsdp=self.fsdp if self.fsdp in names else None,
            model=self.model if self.model in names else None,
        )


def axis_size(mesh, axis: Optional[str]) -> int:
    if axis is None or axis not in mesh.axis_names:
        return 1
    return mesh.shape[axis]


def _fits(dim: int, mesh, axis) -> bool:
    """Can `dim` be sharded over `axis` (str or tuple) on this mesh?"""
    if axis is None:
        return False
    if isinstance(axis, str):
        size = axis_size(mesh, axis)
    else:
        size = 1
        for a in axis:
            size *= axis_size(mesh, a)
    return size > 1 and dim % size == 0


# --------------------------------------------------------------- param rules
#: (path-regex, per-dim axis roles). Roles: "model", "fsdp", None.
#: First match wins; checked against the reference's "/"-joined tree path.
_PARAM_RULES = (
    # embeddings / unembedding: vocab model-sharded, d_model fsdp-sharded
    (r"(tok_embed|pos_embed|lm_head)$", ("model", "fsdp")),
    # attention projections: wq/wkv (d_model, heads, head_dim);
    # wo (heads, head_dim, d_model)
    (r"attn/wq$", ("fsdp", "model", None)),
    (r"attn/w[kv]$", ("fsdp", "model", None)),
    (r"attn/wo$", ("model", None, "fsdp")),
    (r"attn/b[qkv]$", (None, None)),
    # MoE experts: (E, d_model, d_ff) -- EP over model if E divides, else
    # fall through to ffn TP on the hidden dim
    (r"moe/(w_gate|w_up)$", ("model_or_none", "fsdp", "model_if_free")),
    (r"moe/w_down$", ("model_or_none", "model_if_free", "fsdp")),
    (r"moe/router$", ("fsdp", None)),
    # arctic-style dense residual MLP nested under moe/dense/
    (r"dense/(w_gate|w_up)$", ("fsdp", "model")),
    (r"dense/w_down$", ("model", "fsdp")),
    # dense ffn: hidden dim model-sharded
    (r"mlp/(w_gate|w_up)$", ("fsdp", "model")),
    (r"mlp/w_down$", ("model", "fsdp")),
    # recurrent (RG-LRU) and SSM: inner dim model-sharded
    (r"(rec|ssm)/(w_x|w_gate|in_proj)$", ("fsdp", "model")),
    (r"(rec|ssm)/(out_proj|w_out)$", ("model", "fsdp")),
    (r"(rec|ssm)/", (None,)),  # small per-channel params: replicate
    # norms, biases, scalars: replicated
    (r"", (None,)),
)


def spec_for_param(path: str, shape: Tuple[int, ...], mesh,
                   axes: MeshAxes, stacked: bool = False) -> Spec:
    """The placement of one parameter at the reference's tree ``path``.
    ``stacked`` strips the leading dim of ``shape`` and leaves it
    unsharded (the reference's layer stacks)."""
    dims = list(shape[1:] if stacked else shape)
    for pattern, roles in _PARAM_RULES:
        if re.search(pattern, path):
            spec = []
            model_used = False
            roles = list(roles) + [None] * (len(dims) - len(roles))
            for dim, role in zip(dims, roles):
                if role == "model" and _fits(dim, mesh, axes.model):
                    spec.append(axes.model)
                    model_used = True
                elif role == "model_or_none" and _fits(dim, mesh, axes.model):
                    spec.append(axes.model)
                    model_used = True
                elif role == "fsdp" and _fits(dim, mesh, axes.fsdp):
                    spec.append(axes.fsdp)
                elif role == "model_if_free" and not model_used \
                        and _fits(dim, mesh, axes.model):
                    spec.append(axes.model)
                    model_used = True
                else:
                    spec.append(None)
            if stacked:
                spec = [None] + spec
            return tuple(spec)
    return ()


#: the port's per-unit modules: ``units.<i>.`` and the like hold one slice
#: of the reference's stacked leaf, so the rule sees the slice's shape
_UNIT = re.compile(r"^(units|enc_units|dec_units)\.\d+\.")


def param_specs(named_shapes, mesh, axes: Optional[MeshAxes] = None) -> dict:
    """Parameter name -> placement, for ``named_shapes`` (a module, or a
    mapping of names to tensors or shapes). A unit's parameter gets the
    reference's spec of its stacked leaf less the leading None; ``tail``
    leaves, which the reference also treats as stacked although it keeps
    them apart, get the reference's spec as it stands."""
    axes = (axes or MeshAxes()).present(mesh)
    if hasattr(named_shapes, "named_parameters"):
        named_shapes = dict(named_shapes.named_parameters())
    out = {}
    for name, leaf in named_shapes.items():
        shape = tuple(getattr(leaf, "shape", leaf))
        path = _UNIT.sub(r"\1.", name).replace(".", "/")
        out[name] = spec_for_param(path, shape, mesh, axes,
                                   stacked=name.startswith("tail."))
    return out


# ---------------------------------------------------------- activation specs
def batch_spec(mesh, axes: Optional[MeshAxes] = None, *,
               extra_dims: int = 1) -> Spec:
    """(batch_axes, None * extra_dims) for (B, S, ...) activations."""
    axes = (axes or MeshAxes()).present(mesh)
    lead = axes.batch if axes.batch else None
    return (lead,) + (None,) * extra_dims


def batch_axes_for(mesh, dim: int) -> Optional[Tuple[str, ...]]:
    """The batch axes a batch of ``dim`` rows splits over, or None where
    it does not divide them (it then replicates)."""
    axes = MeshAxes().present(mesh).batch
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return axes if (axes and size > 1 and dim % size == 0) else None


def shard_factor(spec: Spec, mesh) -> int:
    """How many ways a tensor under ``spec`` is split on ``mesh``: the
    product of the sizes of the axes it names."""
    n = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            n *= axis_size(mesh, a)
    return n


# ------------------------------------------------------------- placement
@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A placement on a mesh, the counterpart of ``jax.sharding.
    NamedSharding``."""
    mesh: object
    spec: Spec


def named(mesh, spec: Spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def shard(tensor: torch.Tensor, spec: Spec, mesh) -> spmd.Sharded:
    """``tensor`` placed on a local ``mesh``: each position's slice under
    ``spec``, on its device, in storage of its own (``jax.device_put``
    with a ``NamedSharding``)."""
    return spmd.Sharded.place(tensor, spec, mesh)


def gather(shards, spec: Optional[Spec] = None, mesh=None,
           device=None) -> torch.Tensor:
    """The whole tensor from a ``Sharded`` (or from a list of position
    slices, its ``spec`` and ``mesh``), bit for bit."""
    if isinstance(shards, spmd.Sharded):
        return shards.full(device)
    return spmd.gather(shards, spec, mesh, device)


def constraint(x, mesh, spec: Spec):
    """The reference's ``with_sharding_constraint`` that is the identity
    without a mesh: a ``Sharded`` moved to ``spec`` on its mesh."""
    if mesh is None:
        return x
    if x.mesh != mesh:
        raise ValueError("the tensor lies on another mesh")
    spec = tuple(spec)
    return spmd.Sharded(spmd.relayout(x.shards, mesh, x.spec, spec), spec,
                        mesh)
