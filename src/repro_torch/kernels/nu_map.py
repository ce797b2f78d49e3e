"""nu(w) with fractal membership on the card: the CUDA wrapper and its
plain PyTorch version.

``nu_map_tc`` replaces the Pallas ``src/repro/kernels/nu_map.py::
nu_map_pallas`` (kernel ``sq_nu_map`` in ``csrc/squeeze_maps.cu``). Its plain
version is ``maps.nu_with_membership``, exact in int64; the kernel sums in
int32 and equals it at every level the wrapper accepts. A CPU tensor takes
the plain version; a CUDA tensor launches the kernel or raises.

The kernel takes the levels ``group_levels(s)`` at a time, one lookup a
group in tables built here (``nu_plan``, ``nu_group_table``,
``nu_tables``: pure and CPU-tested): the table of a group of L levels
holds, for each pair of L-digit coordinates, the group's partial cx and cy
and whether every level of it is a member; the top group, over the levels
left, has a table of its own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import maps
from repro_torch.core.fractals import NBBFractal
from repro_torch.kernels import build

#: the reference's largest r (its padded contraction width)
MAX_R = 128

build.LAUNCHES.setdefault("nu_map_tc", 0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ex, ey, cx, cy, valid, count, r, s, k, levels, tables, entries, stream
_ARGS = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _I, _P]

#: levels one lookup of the kernel covers, by s (``kLevels2``, ``kLevels3``
#: in the source); any other s takes 2
LEVELS = {2: 4, 3: 2}
#: int32 table entries one CTA's shared memory holds
MAX_ENTRIES = build.MAX_SMEM // 4
#: a table entry: the partial cx in bits 0-14, the hole bit, the partial cy
#: from bit 16
HOLE, FIELD = 1 << 15, (1 << 15) - 1


def check_level(frac: NBBFractal, r: int, max_r: int) -> None:
    """Raise ``ValueError`` unless 0 <= r <= max_r and the expanded side
    s^r and both compact sides fit int32."""
    if not 0 <= r <= max_r:
        raise ValueError(f"r={r} is outside [0, {max_r}]")
    side = max(frac.side(r), *frac.compact_dims(r))
    if side >= 2 ** 31:
        raise ValueError(f"{frac.name} at r={r}: a side of {side} does not "
                         "fit int32 coordinates")


def max_int32_level(frac: NBBFractal) -> int:
    """The largest r ``check_level`` accepts for ``frac``."""
    r = 0
    while max(frac.side(r + 1), *frac.compact_dims(r + 1)) < 2 ** 31:
        r += 1
    return r


def check_coords(a: torch.Tensor, b: torch.Tensor) -> None:
    """Both CUDA int32 tensors of one shape on one device."""
    if a.shape != b.shape:
        raise ValueError(f"coordinate shapes differ: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"the CUDA kernels take CUDA or CPU tensors, got "
                         f"{a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"coordinates must be int32, got {a.dtype} and "
                        f"{b.dtype}")


def group_levels(s: int) -> int:
    """L, the levels one lookup of the nu kernel covers (even, so every
    group starts at an odd level)."""
    return LEVELS.get(s, 2)


class NuPlan(NamedTuple):
    """How the nu kernel takes r levels apart (``nu_plan``)."""
    levels: int   # L, the levels of a group
    groups: int   # ceil(r / L)
    top: int      # the top group's levels, r - (groups - 1) L (0 at r = 0)
    entries: int  # int32 entries of the tables (``nu_tables``)


def nu_plan(frac: NBBFractal, r: int, levels: int = 0) -> NuPlan:
    """The groups of ``levels`` (default ``group_levels(s)``) levels the
    kernel takes r levels in, the top one over what is left, and its
    tables' size: s^(2L), and s^(2 top) more where top < L. Raises where
    they exceed one CTA's shared memory (s > 15)."""
    s, big_l = frac.s, levels or group_levels(frac.s)
    groups = -(-r // big_l)
    top = r - (groups - 1) * big_l if groups else 0
    entries = s ** (2 * big_l) + (s ** (2 * top) if 0 < top < big_l else 0)
    if entries > MAX_ENTRIES:
        raise ValueError(f"{frac.name}: nu's tables over {big_l} levels of "
                         f"s={s} take {entries} entries, over one CTA's "
                         f"{MAX_ENTRIES}")
    return NuPlan(big_l, groups, top, entries)


def nu_group_table(frac: NBBFractal, levels: int) -> np.ndarray:
    """The (s^L)^2 int32 entries of a group of L = ``levels`` consecutive
    levels starting at an odd level, at index ux + s^L uy for the group's
    L-digit coordinates (ux, uy): the group's partial cx (its odd levels'
    codes times k^((j-1)/2), j = 1..L) in bits 0-14, ``HOLE`` where any of
    its levels is a hole (whose code counts 0), the partial cy (its even
    levels', times k^((j-2)/2)) from bit 16."""
    s, k = frac.s, frac.k
    u = np.arange(s ** levels, dtype=np.int64)
    ux, uy = np.meshgrid(u, u)   # [uy, ux]: row-major is ux + s^L uy
    part, hole = [np.zeros_like(ux), np.zeros_like(ux)], np.zeros_like(
        ux, dtype=bool)
    for j in range(levels):
        scale = s ** j
        code = frac.h_nu[(uy // scale) % s, (ux // scale) % s]
        hole |= code < 0
        part[j % 2] += np.maximum(code, 0) * k ** (j // 2)
    if max(int(part[0].max()), int(part[1].max())) > FIELD:
        raise ValueError(f"{frac.name}: a group of {levels} levels does not "
                         "fit a table entry")
    return (part[0] | hole * HOLE | part[1] << 16).astype(np.int32).ravel()


def nu_tables(frac: NBBFractal, levels: int, top: int) -> np.ndarray:
    """The kernel's tables, one int32 array: a group of ``levels`` levels,
    then, where the top group has 0 < ``top`` < ``levels`` levels, the
    top group's."""
    group = nu_group_table(frac, levels)
    if 0 < top < levels:
        return np.concatenate([group, nu_group_table(frac, top)])
    return group


@functools.lru_cache(maxsize=None)
def device_tables(frac: NBBFractal, levels: int, top: int,
                  device: str) -> torch.Tensor:
    """``nu_tables`` on ``device``."""
    return torch.from_numpy(nu_tables(frac, levels, top)).to(device)


def nu_map_tc_plain(frac: NBBFractal, r: int, ex, ey):
    """(cx, cy, valid): int64 digit sums, cast to int32."""
    return maps.nu_with_membership(frac, r, ex, ey)


def nu_map_tc(frac: NBBFractal, r: int, ex: torch.Tensor, ey: torch.Tensor):
    """nu(w) and membership of expanded coordinates (clipped to the grid;
    off the grid is not a member): int32 cx, cy and bool valid in the
    input's shape."""
    obs.inc("kernel.entry", op="nu_map_tc")
    check_level(frac, r, MAX_R)
    if ex.device.type == "cpu" and ey.device.type == "cpu":
        return nu_map_tc_plain(frac, r, ex, ey)
    fn = build.c_function("squeeze_maps", "sq_nu_map", _ARGS)
    check_coords(ex, ey)
    plan = nu_plan(frac, r)
    ex, ey = ex.contiguous(), ey.contiguous()
    cx, cy = torch.empty_like(ex), torch.empty_like(ey)
    valid = torch.empty(ex.shape, dtype=torch.bool, device=ex.device)
    if ex.numel() == 0:
        return cx, cy, valid
    tables = device_tables(frac, plan.levels, plan.top, str(ex.device))
    with torch.cuda.device(ex.device):
        stream = torch.cuda.current_stream(ex.device).cuda_stream
        rc = fn(ex.data_ptr(), ey.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                valid.data_ptr(), ex.numel(), r, frac.s, frac.k, plan.levels,
                tables.data_ptr(), plan.entries, stream)
    build.finish_launch(rc, "nu_map_tc")
    return cx, cy, valid
