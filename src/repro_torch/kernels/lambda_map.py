"""lambda(w) on the card: the CUDA wrapper and its plain PyTorch version.

``lambda_map_tc`` replaces the Pallas ``src/repro/kernels/lambda_map.py::
lambda_map_pallas`` (kernel ``sq_lambda_map`` in ``csrc/squeeze_maps.cu``).
Its plain version is ``maps.lambda_map``. lambda does not clip: negative
and past-the-edge compact coordinates take floor division and a
non-negative modulus in both. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import maps
from repro_torch.core.fractals import NBBFractal
from repro_torch.kernels import build
from repro_torch.kernels.nu_map import check_coords, check_level

#: the reference's largest r (2r code columns in its 128-wide operand)
MAX_R = 64

build.LAUNCHES.setdefault("lambda_map_tc", 0)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# cx, cy, ex, ey, count, r, s, k, h_lambda, stream
_ARGS = [_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P]


@functools.lru_cache(maxsize=None)
def code_table(frac: NBBFractal, device: str) -> torch.Tensor:
    """``frac.h_lambda`` (k, 2) as int32 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(frac.h_lambda,
                                                 np.int32)).to(device)


def lambda_map_tc_plain(frac: NBBFractal, r: int, cx, cy):
    """(ex, ey): int64 digit sums, cast to int32."""
    return maps.lambda_map(frac, r, cx, cy)


def lambda_map_tc(frac: NBBFractal, r: int, cx: torch.Tensor,
                  cy: torch.Tensor):
    """lambda(w) of compact coordinates: int32 (ex, ey) in the input's
    shape."""
    check_level(frac, r, MAX_R)
    if cx.device.type == "cpu" and cy.device.type == "cpu":
        return lambda_map_tc_plain(frac, r, cx, cy)
    fn = build.c_function("squeeze_maps", "sq_lambda_map", _ARGS)
    check_coords(cx, cy)
    cx, cy = cx.contiguous(), cy.contiguous()
    ex, ey = torch.empty_like(cx), torch.empty_like(cy)
    if cx.numel() == 0:
        return ex, ey
    table = code_table(frac, str(cx.device))
    with torch.cuda.device(cx.device):
        stream = torch.cuda.current_stream(cx.device).cuda_stream
        rc = fn(cx.data_ptr(), cy.data_ptr(), ex.data_ptr(), ey.data_ptr(),
                cx.numel(), r, frac.s, frac.k, table.data_ptr(), stream)
    build.finish_launch(rc, "lambda_map_tc")
    return ex, ey
