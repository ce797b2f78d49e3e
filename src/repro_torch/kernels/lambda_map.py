"""lambda(w) on the card: the CUDA wrapper and its plain PyTorch version.

``lambda_map_tc`` replaces the Pallas ``src/repro/kernels/lambda_map.py::
lambda_map_pallas`` (kernel ``sq_lambda_map`` in ``csrc/squeeze_maps.cu``).
Its plain version is ``maps.lambda_map``. lambda does not clip: negative
and past-the-edge compact coordinates take floor division and a
non-negative modulus in both. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

The kernel takes the levels L at a time (``lambda_plan``): one floor
division of cx and of cy by k^(L/2) a group, and one lookup in a table
built here (``lambda_group_table``, ``lambda_tables``: pure and
CPU-tested) that holds, for each pair of L/2-digit remainders, the group's
partial ex and ey; the top group, over the levels left, has a table of its
own where they are fewer than L.
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
from repro_torch.kernels.nu_map import MAX_ENTRIES, check_coords, check_level

#: the reference's largest r (2r code columns in its 128-wide operand)
MAX_R = 64

build.LAUNCHES.setdefault("lambda_map_tc", 0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# cx, cy, ex, ey, count, r, s, k, levels, tables, entries, stream
_ARGS = [_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _I, _P]

#: levels one lookup of the kernel covers, by s (``kLambdaL2``,
#: ``kLambdaL3`` in the source); any other s starts from 2
LEVELS = {2: 8, 3: 4}
#: a table entry: the partial ex in bits 0-15, the partial ey from bit 16
FIELD = (1 << 16) - 1


class LambdaPlan(NamedTuple):
    """How the lambda kernel takes r levels apart (``lambda_plan``)."""
    levels: int   # L, the levels of a group (even)
    groups: int   # ceil(r / L)
    top: int      # the top group's levels, r - (groups - 1) L (0 at r = 0)
    entries: int  # int32 entries of the tables (``lambda_tables``)


def lambda_plan(frac: NBBFractal, r: int, levels: int = 0) -> LambdaPlan:
    """The groups of ``levels`` levels (default: ``LEVELS`` by s, less by
    two while the tables would not fit one CTA's shared memory or a
    partial sum its 16 bits) the kernel takes r levels in, the top one
    over what is left, and its tables' size: k^L, twice where 0 < top <
    L. Raises where a given ``levels`` is odd or does not fit."""
    s, k = frac.s, frac.k
    big_l = levels or LEVELS.get(s, 2)

    def size(lv):
        groups = -(-r // lv)
        top = r - (groups - 1) * lv if groups else 0
        return groups, top, k ** lv * (2 if 0 < top < lv else 1)
    while not levels and big_l > 2 and (size(big_l)[2] > MAX_ENTRIES
                                        or s ** big_l > FIELD + 1):
        big_l -= 2
    groups, top, entries = size(big_l)
    if big_l < 2 or big_l % 2 or entries > MAX_ENTRIES or \
            s ** big_l > FIELD + 1:
        raise ValueError(f"{frac.name}: lambda's tables over {big_l} levels "
                         f"of s={s}, k={k} take {entries} entries (one CTA "
                         f"holds {MAX_ENTRIES}) of two {s ** big_l - 1}-wide "
                         "fields")
    return LambdaPlan(big_l, groups, top, entries)


def lambda_group_table(frac: NBBFractal, levels: int,
                       used: int) -> np.ndarray:
    """The k^L int32 entries of a group of L = ``levels`` consecutive
    levels starting at an odd level, at index rx + k^(L/2) ry for the
    group's L/2 base-k digits of cx (rx) and of cy (ry): level j of the
    group (0-based; even j a digit of rx, odd j of ry) adds tau(digit)
    s^j to the partial ex and ey, for j < ``used`` only (the top group's
    levels); the partial ex in bits 0-15, ey from bit 16. The even levels
    read rx alone and the odd ones ry alone, so the table is the outer sum
    of two k^(L/2)-entry parts."""
    s, k = frac.s, frac.k
    u = np.arange(k ** (levels // 2), dtype=np.int64)
    tau = np.asarray(frac.h_lambda, np.int64)

    def part(odd):
        """(ex, ey) of the group's even (odd) levels, by their digits u."""
        ex, ey = np.zeros_like(u), np.zeros_like(u)
        for j in range(int(odd), used, 2):
            digit = (u // k ** (j // 2)) % k
            ex += tau[digit, 0] * s ** j
            ey += tau[digit, 1] * s ** j
        return ex, ey
    (xx, xy), (yx, yy) = part(False), part(True)
    ex = xx[None, :] + yx[:, None]   # [ry, rx]: row-major is rx + d ry
    ey = xy[None, :] + yy[:, None]
    if max(int(ex.max()), int(ey.max())) > FIELD:
        raise ValueError(f"{frac.name}: a group of {levels} levels does not "
                         "fit a table entry")
    return (ex | ey << 16).astype(np.uint32).view(np.int32).ravel()


def lambda_tables(frac: NBBFractal, levels: int, top: int) -> np.ndarray:
    """The kernel's tables, one int32 array: a group of ``levels`` levels,
    then, where the top group has 0 < ``top`` < ``levels`` levels, the top
    group's (the same index over the digits of only its levels)."""
    group = lambda_group_table(frac, levels, levels)
    if 0 < top < levels:
        return np.concatenate([group, lambda_group_table(frac, levels, top)])
    return group


@functools.lru_cache(maxsize=None)
def device_tables(frac: NBBFractal, levels: int, top: int,
                  device: str) -> torch.Tensor:
    """``lambda_tables`` on ``device``."""
    return torch.from_numpy(lambda_tables(frac, levels, top)).to(device)


def lambda_map_tc_plain(frac: NBBFractal, r: int, cx, cy):
    """(ex, ey): int64 digit sums, cast to int32."""
    return maps.lambda_map(frac, r, cx, cy)


def lambda_map_tc(frac: NBBFractal, r: int, cx: torch.Tensor,
                  cy: torch.Tensor):
    """lambda(w) of compact coordinates: int32 (ex, ey) in the input's
    shape."""
    obs.inc("kernel.entry", op="lambda_map_tc")
    check_level(frac, r, MAX_R)
    if cx.device.type == "cpu" and cy.device.type == "cpu":
        return lambda_map_tc_plain(frac, r, cx, cy)
    fn = build.c_function("squeeze_maps", "sq_lambda_map", _ARGS)
    check_coords(cx, cy)
    plan = lambda_plan(frac, r)
    cx, cy = cx.contiguous(), cy.contiguous()
    ex, ey = torch.empty_like(cx), torch.empty_like(cy)
    if cx.numel() == 0:
        return ex, ey
    tables = device_tables(frac, plan.levels, plan.top, str(cx.device))
    with torch.cuda.device(cx.device):
        stream = torch.cuda.current_stream(cx.device).cuda_stream
        rc = fn(cx.data_ptr(), cy.data_ptr(), ex.data_ptr(), ey.data_ptr(),
                cx.numel(), r, frac.s, frac.k, plan.levels,
                tables.data_ptr(), plan.entries, stream)
    build.finish_launch(rc, "lambda_map_tc")
    return ex, ey
