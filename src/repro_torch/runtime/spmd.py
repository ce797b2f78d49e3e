"""One-process SPMD over a local mesh: the part XLA's SPMD partitioner
does for the reference (``jax.jit`` of a step whose inputs carry
``NamedSharding``s, ``with_sharding_constraint`` inside it), done by hand
for the port.

A tensor placed on a mesh is a list with one entry a position: position
p holds, on ``mesh.devices[p]``, the slice that its placement (a
``utils/sharding.py`` spec: one entry a dimension, a mesh axis, a tuple
of axes or None) gives it. Positions are numbered in row-major order of
``mesh.axis_names``; a tuple of axes splits a dimension row-major over
them, as ``PartitionSpec`` does.

The collectives (``all_gather``, ``all_reduce``, ``reduce_scatter`` over
one axis or a tuple of axes, and ``relayout`` for the reference's
``constraint``) are built of copies between devices, concatenations, sums
and slices, so autograd differentiates them exactly: a value that
positions hold as copies gets the sum of the copies' gradients. Positions
that share a device share a collective's result tensor (on one card every
position is ``cuda:0``, and a sum is taken once). Sums of bf16 or fp16
tensors accumulate in float32.

``COUNTS`` holds the elements each collective moved since
``reset_counts()``: what the positions receive from one another when the
collective runs as a ring (an all-gather of n shards of s elements moves
n (n - 1) s, a reduce-scatter of an n-position group of tensors of F
elements (n - 1) F, an all-reduce twice that), and under
``"<name>.grad"`` the same for the collective's adjoint in the backward
pass (an all-gather's is a reduce-scatter of the same size). A unit under
remat recomputes its collectives in the backward pass, and they count
again.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Dict, List, Sequence, Tuple

import torch

Spec = Tuple

#: elements moved by each collective since ``reset_counts()``
COUNTS: Dict[str, int] = {}


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, int]:
    return dict(COUNTS)


def _count(key: str, n: int) -> None:
    COUNTS[key] = COUNTS.get(key, 0) + int(n)


class _Tally(torch.autograd.Function):
    """Identity whose backward adds ``n`` to ``COUNTS[key]``: marks the
    input of a collective, whose adjoint moves ``n`` elements to it."""

    @staticmethod
    def forward(ctx, x, key, n):
        ctx.key, ctx.n = key, n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        _count(ctx.key, ctx.n)
        return g, None, None


def _tally(xs, key: str, totals: Sequence[int], group_of):
    """``xs`` with each input that records a gradient marked to count its
    share of its group's backward ``totals``."""
    if not torch.is_grad_enabled():
        return list(xs)
    out = list(xs)
    for gi, group in enumerate(group_of):
        n = len(group)
        for i, p in enumerate(group):
            if out[p].requires_grad:
                share = totals[gi] * (i + 1) // n - totals[gi] * i // n
                out[p] = _Tally.apply(out[p], key, share)
    return out


# ------------------------------------------------------------ coordinates
def axes_of(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (``()`` for None)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def devices(mesh) -> Tuple[torch.device, ...]:
    if not mesh.devices:
        raise ValueError("a mesh without devices is a plan; build a local "
                         "one with launch.mesh.make_local_mesh")
    return mesh.devices


@functools.lru_cache(maxsize=None)
def _coords(sizes: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    return tuple(itertools.product(*(range(n) for n in sizes)))


def size(mesh, axes) -> int:
    """How many ways ``axes`` (an entry) split a dimension."""
    return math.prod(mesh.shape.get(a, 1) for a in axes_of(axes))


def coord(mesh, p: int, axes) -> int:
    """Position p's index along ``axes`` (row-major over them)."""
    c = _coords(tuple(mesh.sizes))[p]
    idx = 0
    for a in axes_of(axes):
        if a in mesh.axis_names:
            i = mesh.axis_names.index(a)
            idx = idx * mesh.sizes[i] + c[i]
    return idx


@functools.lru_cache(maxsize=None)
def groups(mesh, axes) -> Tuple[Tuple[int, ...], ...]:
    """The positions that differ only along ``axes``, a group each,
    ordered by their index along ``axes``."""
    axes = axes_of(axes)
    keep = [i for i, a in enumerate(mesh.axis_names) if a not in axes]
    by_rest: Dict[tuple, list] = {}
    for p, c in enumerate(_coords(tuple(mesh.sizes))):
        by_rest.setdefault(tuple(c[i] for i in keep), []).append(p)
    return tuple(tuple(sorted(g, key=lambda p: coord(mesh, p, axes)))
                 for g in by_rest.values())


def representatives(mesh, spec: Spec) -> List[int]:
    """One position for each distinct slice under ``spec``: those at
    index 0 of every axis the spec does not name."""
    named = {a for e in spec for a in axes_of(e)}
    free = tuple(a for a in mesh.axis_names if a not in named)
    return [p for p in range(mesh.size) if coord(mesh, p, free) == 0]


def local_slice(t, spec: Spec, mesh, p: int):
    """The slice of the whole ``t`` that position p holds under
    ``spec`` (a view)."""
    for dim, entry in enumerate(spec):
        n = size(mesh, entry)
        if n > 1:
            t = _narrow(t, dim, n, coord(mesh, p, entry))
    return t


def _narrow(t, dim: int, n: int, i: int):
    length = t.shape[dim]
    if length % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not "
                         f"split {n} ways")
    c = length // n
    return t.narrow(dim, i * c, c)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = size(mesh, entry)
        if out[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"split {n} ways")
        out[dim] //= n
    return tuple(out)


def full_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] *= size(mesh, entry)
    return tuple(out)


# -------------------------------------------------------------- placement
def shard(t: torch.Tensor, spec: Spec, mesh, dtype=None) -> List[torch.Tensor]:
    """Each position's slice of ``t`` in storage of its own on its
    device (``dtype`` converts it)."""
    out = []
    for p, dev in enumerate(devices(mesh)):
        piece = local_slice(t, spec, mesh, p)
        out.append(torch.empty(piece.shape, dtype=dtype or piece.dtype,
                               device=dev).copy_(piece))
    return out


def gather(shards: Sequence[torch.Tensor], spec: Spec, mesh,
           device=None) -> torch.Tensor:
    """The whole tensor from its positions' slices, on ``device`` (the
    first position's by default), bit for bit."""
    first = shards[0]
    out = torch.empty(full_shape(first.shape, spec, mesh), dtype=first.dtype,
                      device=device or first.device)
    for p in representatives(mesh, spec):
        local_slice(out, spec, mesh, p).copy_(shards[p])
    return out


@dataclasses.dataclass
class Sharded:
    """One tensor placed on a local mesh: ``shards[p]`` is position p's
    slice under ``spec``."""
    shards: List[torch.Tensor]
    spec: Spec
    mesh: object

    @property
    def shape(self) -> torch.Size:
        return torch.Size(full_shape(self.shards[0].shape, self.spec,
                                     self.mesh))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def full(self, device=None) -> torch.Tensor:
        return gather(self.shards, self.spec, self.mesh, device)

    @classmethod
    def place(cls, t: torch.Tensor, spec: Spec, mesh, dtype=None):
        return cls(shard(t, spec, mesh, dtype), tuple(spec), mesh)


def shard_tree(tree, plan, mesh):
    """Nested dicts/lists of tensors -> the same of ``Sharded`` under the
    plan of the same structure."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, plan[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shard_tree(v, s, mesh) for v, s in zip(tree, plan)]
    if isinstance(tree, Sharded):
        return tree
    return Sharded.place(torch.as_tensor(tree), plan, mesh)


def gather_tree(tree, device=None):
    """Nested dicts/lists with ``Sharded`` leaves -> the whole tensors."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [gather_tree(v, device) for v in tree]
    if isinstance(tree, Sharded):
        return tree.full(device)
    return tree


def is_sharded(tree) -> bool:
    """Whether a tree's first leaf is ``Sharded``."""
    while isinstance(tree, (dict, list, tuple)):
        if not tree:
            return False
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return isinstance(tree, Sharded)


# ------------------------------------------------------------ collectives
def _sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    dt = parts[0].dtype
    if dt in (torch.bfloat16, torch.float16):
        acc = parts[0].float()
        for q in parts[1:]:
            acc = acc + q.float()
        return acc.to(dt)
    acc = parts[0]
    for q in parts[1:]:
        acc = acc + q
    return acc


def _per_device(group, devs, make):
    """``make(dev)`` once for each device among the group's positions:
    position -> result."""
    done = {}
    out = {}
    for p in group:
        dev = devs[p]
        if dev not in done:
            done[dev] = make(dev)
        out[p] = done[dev]
    return out


def all_gather(xs: Sequence[torch.Tensor], mesh, axes,
               dim: int) -> List[torch.Tensor]:
    """Each position gets the concatenation along ``dim`` of its group's
    slices (the group: the positions that differ only along ``axes``)."""
    n = size(mesh, axes)
    if n == 1:
        return list(xs)
    devs, grp = devices(mesh), groups(mesh, axes_of(axes))
    xs = _tally(xs, "all_gather.grad",
                [n * (n - 1) * xs[g[0]].numel() for g in grp], grp)
    out = [None] * len(xs)
    for g in grp:
        got = _per_device(g, devs, lambda dev, g=g: torch.cat(
            [xs[q].to(dev) for q in g], dim))
        for p in g:
            out[p] = got[p]
        _count("all_gather", n * (n - 1) * xs[g[0]].numel())
    return out


def all_reduce(xs: Sequence[torch.Tensor], mesh, axes,
               op: str = "sum") -> List[torch.Tensor]:
    """Each position gets its group's sum (``op="max"``: elementwise
    maximum, which records no gradient)."""
    n = size(mesh, axes)
    if n == 1:
        return list(xs)
    devs, grp = devices(mesh), groups(mesh, axes_of(axes))
    if op == "max":
        def make(dev, g):
            return torch.stack([xs[q].detach().to(dev) for q in g]).amax(0)
    elif op == "sum":
        xs = _tally(xs, "all_reduce.grad",
                    [2 * (n - 1) * xs[g[0]].numel() for g in grp], grp)

        def make(dev, g):
            return _sum([xs[q].to(dev) for q in g])
    else:
        raise ValueError(f"unknown reduction {op!r}")
    out = [None] * len(xs)
    for g in grp:
        got = _per_device(g, devs, lambda dev, g=g: make(dev, g))
        for p in g:
            out[p] = got[p]
        _count("all_reduce", 2 * (n - 1) * xs[g[0]].numel())
    return out


def reduce_scatter(xs: Sequence[torch.Tensor], mesh, axes,
                   dim: int) -> List[torch.Tensor]:
    """Each position gets its own slice along ``dim`` (by its index along
    ``axes``) of its group's sum."""
    n = size(mesh, axes)
    if n == 1:
        return list(xs)
    devs, grp = devices(mesh), groups(mesh, axes_of(axes))
    xs = _tally(xs, "reduce_scatter.grad",
                [(n - 1) * xs[g[0]].numel() for g in grp], grp)
    out = [None] * len(xs)
    for g in grp:
        got = _per_device(g, devs, lambda dev, g=g: _sum(
            [xs[q].to(dev) for q in g]))
        for i, p in enumerate(g):
            out[p] = _narrow(got[p], dim, n, i)
        _count("reduce_scatter", (n - 1) * xs[g[0]].numel())
    return out


def slice_along(xs: Sequence[torch.Tensor], mesh, axes,
                dim: int) -> List[torch.Tensor]:
    """Each position keeps its own slice along ``dim`` of a value it holds
    whole (no data moves)."""
    n = size(mesh, axes)
    if n == 1:
        return list(xs)
    return [_narrow(x, dim, n, coord(mesh, p, axes))
            for p, x in enumerate(xs)]


def relayout(xs: Sequence[torch.Tensor], mesh, from_spec: Spec,
             to_spec: Spec) -> List[torch.Tensor]:
    """The reference's ``constraint``: the same tensor moved from one
    placement to another (an all-gather for each dimension that loses its
    axes, then a local slice for each that gains some: a slice taken
    first would hand the gather of an axis that moves from one dimension
    to another the positions' different slices)."""
    nd = xs[0].ndim
    a_spec = tuple(from_spec) + (None,) * (nd - len(from_spec))
    b_spec = tuple(to_spec) + (None,) * (nd - len(to_spec))
    moved = [dim for dim, (a, b) in enumerate(zip(a_spec, b_spec))
             if axes_of(a) != axes_of(b)]
    out = list(xs)
    for dim in moved:
        if axes_of(a_spec[dim]):
            out = all_gather(out, mesh, axes_of(a_spec[dim]), dim)
    for dim in moved:
        if axes_of(b_spec[dim]):
            out = slice_along(out, mesh, axes_of(b_spec[dim]), dim)
    return out


def resident_bytes(tree, p: int) -> int:
    """Bytes position p holds of a tree with ``Sharded`` leaves."""
    if isinstance(tree, dict):
        return sum(resident_bytes(v, p) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(resident_bytes(v, p) for v in tree)
    if isinstance(tree, Sharded):
        t = tree.shards[p]
        return t.numel() * t.element_size()
    return 0


__all__ = ["COUNTS", "Sharded", "all_gather", "all_reduce", "axes_of",
           "coord", "counts", "devices", "full_shape", "gather",
           "gather_tree", "groups", "is_sharded", "local_shape",
           "local_slice", "reduce_scatter", "relayout", "representatives",
           "reset_counts", "resident_bytes", "shard", "shard_tree",
           "size", "slice_along"]
