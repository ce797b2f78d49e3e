"""How the autotuner measures.

* :func:`time_interleaved`: interleaved min-of-rounds timing. Every
  candidate is warmed first (kernel builds and first-touch uploads
  excluded), then the field is timed round-robin for ``rounds`` passes; a
  candidate's score is its minimum over the rounds. Interleaving spreads
  slow drift (clocks, power, other tenants) over the whole field, and the
  minimum rejects one-sided noise: a measurement can only be too slow.
* :func:`measured_bandwidth_gbs`: the device's copy bandwidth, and
  :func:`roofline_step_seconds`, a memory-bandwidth lower bound on one
  advanced step of a fused launch from it. A candidate faster than the
  bound did not do the work, and the search flags it instead of trusting
  it.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from repro_torch.core.device import resolve_device

_bandwidth_cache: Dict[tuple, float] = {}

#: copy sizes of ``measured_bandwidth_gbs``: on the card well over the 50
#: MB L2, so the copy reads device memory and not the cache
_CUDA_COPY_BYTES = 1 << 30
_HOST_COPY_BYTES = 1 << 24


def geomean(xs: Iterable[float]) -> float:
    vals = [float(x) for x in xs]
    if not vals:
        return 1.0
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def _wait(out) -> None:
    """Wait for the card work behind ``out`` (tensors, possibly nested in
    tuples or lists); nothing to wait for on the CPU."""
    stack, devices = [out], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


def time_interleaved(fns: Mapping[str, Callable[[], object]],
                     rounds: int = 5,
                     warmup: int = 2) -> Dict[str, float]:
    """Best-of-``rounds`` wall seconds per zero-argument callable,
    interleaved: each callable runs ``warmup`` times unmeasured, then the
    field is timed round-robin. Each call is closed with
    ``torch.cuda.synchronize()`` of the cards its result lives on, so the
    launch queue does not undercount."""
    for fn in fns.values():
        for _ in range(max(1, warmup)):
            _wait(fn())
    best = {name: float("inf") for name in fns}
    for _ in range(max(1, rounds)):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            _wait(fn())
            best[name] = min(best[name], time.perf_counter() - t0)
    return best


def measured_bandwidth_gbs(nbytes: Optional[int] = None, rounds: int = 5,
                           device=None) -> float:
    """The device's copy bandwidth in GB/s (read and write counted): a
    float32 ``a + 1`` over ``nbytes`` (default 1 GiB on the card, 16 MiB on
    the CPU), best of ``rounds``, on CUDA events on the card; measured once
    a process per device and size. ``device=None`` is the card."""
    dev = resolve_device(device)
    if nbytes is None:
        nbytes = _CUDA_COPY_BYTES if dev.type == "cuda" else _HOST_COPY_BYTES
    key = (str(dev), int(nbytes))
    if key in _bandwidth_cache:
        return _bandwidth_cache[key]
    x = torch.arange(nbytes // 4, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    torch.add(x, 1.0, out=out)
    best = float("inf")
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            for _ in range(max(1, rounds)):
                start.record()
                torch.add(x, 1.0, out=out)
                stop.record()
                stop.synchronize()
                best = min(best, start.elapsed_time(stop) / 1e3)
    else:
        for _ in range(max(1, rounds)):
            t0 = time.perf_counter()
            torch.add(x, 1.0, out=out)
            best = min(best, time.perf_counter() - t0)
    gbs = 2 * (nbytes // 4) * 4 / best / 1e9
    _bandwidth_cache[key] = gbs
    return gbs


def roofline_step_seconds(n_blocks: int, rho: int, k: int,
                          itemsize: int = 4,
                          bandwidth_gbs: Optional[float] = None) -> float:
    """Memory-bandwidth lower bound on one advanced step of a depth-k fused
    launch over ``n_blocks`` blocks of side ``rho``: the launch reads at
    least the (rho+2k)-wide haloed state and writes the rho-wide core,
    spread over the k steps it advances. Loose on purpose: it only has to
    catch measurements that are impossibly fast. ``bandwidth_gbs=None``
    measures the card's."""
    if bandwidth_gbs is None:
        bandwidth_gbs = measured_bandwidth_gbs()
    w = rho + 2 * k
    bytes_moved = n_blocks * (w * w + rho * rho) * itemsize
    return bytes_moved / (bandwidth_gbs * 1e9) / k
