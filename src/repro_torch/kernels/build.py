"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use and
load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (the hash covers the source and the flags, so an edit
rebuilds). Sources expose a plain C interface, so a build takes seconds:
nothing here includes PyTorch's headers. ``build_all`` starts one ``nvcc``
per source, all together. Nothing is imported or compiled when this module
is imported. ``LAUNCHES`` counts the launches of every kernel wrapper.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v",
)

#: bytes of shared memory one Hopper CTA can use
MAX_SMEM = 232448
#: CTAs of a persistent grid: two per SM of an H100 (132 SMs)
PERSISTENT_CTAS = 2 * 132

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}

#: kernel name -> launches since the last ``reset_launches``. Each wrapper
#: module registers its kernels' names; ``finish_launch`` adds one where a
#: kernel launched, and nowhere else.
LAUNCHES: Dict[str, int] = {}


class KernelBuildError(RuntimeError):
    """A kernel source could not be compiled or loaded."""


def nvcc_path() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def sources() -> Dict[str, Path]:
    """name -> path of every CUDA source of the package."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def target(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` process per source, all started together. Returns
    ``{name: {"path", "seconds", "log"}}``; raises ``KernelBuildError``
    naming every source that failed."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KernelBuildError(f"no CUDA source named {unknown} in {CSRC}")
    todo = {n: target(srcs[n]) for n in names}
    todo = {n: t for n, t in todo.items() if not t.exists()}
    results = {n: {"path": str(target(srcs[n])), "seconds": 0.0, "log": ""}
               for n in names}
    if not todo:
        return results
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        results[n]["seconds"] = time.perf_counter() - t0
        results[n]["log"] = log
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelBuildError("CUDA build failed: " + "\n".join(failed))
    return results


def load_library(name: str) -> ctypes.CDLL:
    """The compiled library of ``csrc/<name>.cu``, built at first use and
    loaded once per process."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]["path"]
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            _LIBS[name] = lib
        return lib


def c_function(lib_name: str, fn_name: str, argtypes):
    """``fn_name`` of the library of ``csrc/<lib_name>.cu`` (built at first
    use), with its argument types declared and an int (CUDA error code)
    result."""
    f = getattr(load_library(lib_name), fn_name)
    if f.argtypes is None:
        f.argtypes, f.restype = argtypes, ctypes.c_int
    return f


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def finish_launch(rc: int, name: str) -> None:
    """Raise on a C entry point's nonzero CUDA error code, else count one
    launch of ``name``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
