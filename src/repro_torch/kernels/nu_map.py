"""nu(w) with fractal membership on the card: the CUDA wrapper and its
plain PyTorch version.

``nu_map_tc`` replaces the Pallas ``src/repro/kernels/nu_map.py::
nu_map_pallas`` (kernel ``sq_nu_map`` in ``csrc/squeeze_maps.cu``). Its plain
version is ``maps.nu_with_membership``, exact in int64; the kernel sums in
integers and equals it at every level the wrapper accepts. A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import maps
from repro_torch.core.fractals import NBBFractal
from repro_torch.kernels import build

#: the reference's largest r (its padded contraction width)
MAX_R = 128

build.LAUNCHES.setdefault("nu_map_tc", 0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# ex, ey, cx, cy, valid, count, r, s, k, n, h_nu, stream
_ARGS = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P, _P]


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


@functools.lru_cache(maxsize=None)
def code_table(frac: NBBFractal, which: str, device: str) -> torch.Tensor:
    """``frac.h_nu`` (s, s) or ``frac.h_lambda`` (k, 2) as int32 on
    ``device``."""
    host = frac.h_nu if which == "nu" else frac.h_lambda
    return torch.from_numpy(np.ascontiguousarray(host, np.int32)).to(device)


def nu_map_tc_plain(frac: NBBFractal, r: int, ex, ey):
    """(cx, cy, valid): int64 digit sums, cast to int32."""
    return maps.nu_with_membership(frac, r, ex, ey)


def nu_map_tc(frac: NBBFractal, r: int, ex: torch.Tensor, ey: torch.Tensor):
    """nu(w) and membership of expanded coordinates (clipped to the grid;
    off the grid is not a member): int32 cx, cy and bool valid in the
    input's shape."""
    check_level(frac, r, MAX_R)
    if ex.device.type == "cpu" and ey.device.type == "cpu":
        return nu_map_tc_plain(frac, r, ex, ey)
    fn = build.c_function("squeeze_maps", "sq_nu_map", _ARGS)
    check_coords(ex, ey)
    ex, ey = ex.contiguous(), ey.contiguous()
    cx, cy = torch.empty_like(ex), torch.empty_like(ey)
    valid = torch.empty(ex.shape, dtype=torch.bool, device=ex.device)
    if ex.numel() == 0:
        return cx, cy, valid
    table = code_table(frac, "nu", str(ex.device))
    with torch.cuda.device(ex.device):
        stream = torch.cuda.current_stream(ex.device).cuda_stream
        rc = fn(ex.data_ptr(), ey.data_ptr(), cx.data_ptr(), cy.data_ptr(),
                valid.data_ptr(), ex.numel(), r, frac.s, frac.k,
                frac.side(r), table.data_ptr(), stream)
    build.finish_launch(rc, "nu_map_tc")
    return cx, cy, valid
