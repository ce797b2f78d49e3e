"""Checkpointing: atomic, checksummed, keep-last-k, elastic.

Layout:  <dir>/step_00000042/  — one ``.npy`` per leaf (path-mangled
names) + ``meta.json`` (leaf names, shapes, dtypes, per-leaf crc32,
step). Writes are crash-atomic: every leaf and the meta go to a
``.tmp`` sibling directory, each file is fsync'd, then one os.replace
(atomic on POSIX) publishes the step and the parent directory is
fsync'd — a preemption or power cut mid-save can never corrupt the
latest complete step, only leave an invisible ``.tmp``.

Integrity: ``meta.json`` carries a crc32 per leaf, verified on
``restore`` (set ``verify=False`` to skip). A flipped bit or truncated
file raises :class:`CheckpointCorruptError`;
``restore_with_fallback`` walks back to the newest *intact* step
instead — the serving layer's answer to disk rot under chaos
injection (counted on ``checkpoint.{corrupt,fallbacks}``).

Arrays are stored *unsharded* (tensors go to the host on save); restore
hands each array to ``put``, which places it for whatever shard count the
restoring engine has — the elastic-rescale path: a checkpoint written by
8 shards restores onto 4 or 1 unchanged.

The format is the reference package's, byte for byte: a checkpoint
written by either package restores in the other. Leaves are the
tensors, arrays and scalars of nested dicts, lists and tuples, named by
their dict keys and sequence indices joined with ``__``, dict keys in
sorted order (the order ``jax.tree_util`` flattens in).

Sharded checkpoints (``save_sharded``) split every leaf into per-shard
chunks along a chosen axis — one ``.npy`` + one crc32 *per shard* per
leaf, written through the same crash-atomic ``_write``. ``meta.json``
records the split (``sharded: {leaf: {n_shards, axis}}``) and
``restore`` reassembles transparently, so a checkpoint written by an
8-shard engine restores under a 4-shard (or 1-shard) one with no format
conversion — the elastic-reshard path of the distributed engine. A
single damaged shard chunk fails only its own crc, and
``restore_with_fallback`` walks to the previous intact step as usual.

With telemetry enabled (``SQUEEZE_TELEMETRY``), saves and restores
count on the default registry (``checkpoint.saves`` /
``checkpoint.restores``) with wall-time histograms
(``checkpoint.save_seconds`` — recorded by the writer, including the
async thread — and ``checkpoint.restore_seconds``) and a
``checkpoint.bytes`` gauge of the last save's payload.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

_STEP_RE = re.compile(r"^step_(\d{8})$")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed its integrity check (bad crc32, unreadable or
    truncated leaf/meta file)."""


def _flatten_with_names(tree):
    """(names, leaves): the leaves of nested dicts, lists and tuples in the
    reference's order (dict keys sorted), each named by its path; ``None``
    holds no leaf."""
    names, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (str(key),))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (str(i),))
        else:
            names.append("__".join(path))
            leaves.append(node)

    walk(tree, ())
    return names, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(child) for child in node)
        return next(it)

    return build(like)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


def _crc32(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = True) -> str:
        """Atomic checkpoint of an arbitrary pytree at ``step``."""
        names, leaves = _flatten_with_names(tree)
        host_leaves = [_to_host(x) for x in leaves]
        if blocking:
            return self._write(step, names, host_leaves)
        self.wait()
        self._async_thread = threading.Thread(
            target=self._write, args=(step, names, host_leaves), daemon=True)
        self._async_thread.start()
        return self._final_path(step)

    def save_sharded(self, step: int, tree: Any, n_shards: int,
                     axis: int = 0, blocking: bool = True) -> str:
        """Atomic checkpoint with every leaf split into ``n_shards``
        chunks along ``axis`` — one file + one crc32 per shard per leaf
        (``<name>@sNNN``), so damage to one shard's bytes is localized
        to one chunk's integrity check. ``meta.json`` records the
        split; :meth:`restore` reassembles transparently, making the
        checkpoint restorable under any shard count (the shard axis
        is a storage detail, not a layout commitment)."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        names, leaves = _flatten_with_names(tree)
        out_names, out_leaves, sharded = [], [], {}
        for name, leaf in zip(names, leaves):
            arr = _to_host(leaf)
            if arr.ndim == 0 or n_shards == 1:
                out_names.append(name)
                out_leaves.append(arr)
                continue
            sharded[name] = {"n_shards": n_shards, "axis": axis}
            for j, chunk in enumerate(
                    np.array_split(arr, n_shards, axis=axis)):
                out_names.append(f"{name}@s{j:03d}")
                out_leaves.append(np.ascontiguousarray(chunk))
        if blocking:
            return self._write(step, out_names, out_leaves,
                               sharded=sharded)
        self.wait()
        self._async_thread = threading.Thread(
            target=self._write, args=(step, out_names, out_leaves),
            kwargs={"sharded": sharded}, daemon=True)
        self._async_thread.start()
        return self._final_path(step)

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _final_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _write(self, step: int, names: List[str], leaves,
               sharded: Optional[dict] = None) -> str:
        t0 = time.perf_counter() if obs.enabled() else None
        final = self._final_path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        meta = {"step": step, "leaves": []}
        if sharded:
            meta["sharded"] = sharded
        for name, arr in zip(names, leaves):
            fn = f"{len(meta['leaves']):05d}.npy"
            with open(os.path.join(tmp, fn), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            meta["leaves"].append({"name": name, "file": fn,
                                   "shape": list(arr.shape),
                                   "dtype": str(arr.dtype),
                                   "crc32": _crc32(arr)})
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        # make the rename itself durable: without the directory fsync a
        # crash can undo the publish even though every file was synced
        _fsync_dir(self.dir)
        self._gc()
        if t0 is not None:
            obs.observe("checkpoint.save_seconds",
                        time.perf_counter() - t0)
            obs.inc("checkpoint.saves")
            obs.set_gauge("checkpoint.bytes",
                          sum(int(a.nbytes) for a in leaves))
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._final_path(s), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            m = _STEP_RE.match(d)
            if m and os.path.exists(os.path.join(self.dir, d, "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                put: Optional[Callable[[str, np.ndarray], Any]] = None,
                verify: bool = True) -> Any:
        """Restore into the structure of ``like``.

        ``put(name, array)`` may place each array on a device or in
        shards (elastic restore); by default the leaves stay numpy arrays
        on the host.
        ``verify=True`` checks each leaf against the crc32 recorded at
        save time and raises :class:`CheckpointCorruptError` on any
        mismatch or unreadable file (checkpoints written before
        checksums existed verify trivially). Leaves written by
        :meth:`save_sharded` are reassembled from their per-shard
        chunks — the restoring shard count need not match the saving one.
        """
        t0 = time.perf_counter() if obs.enabled() else None
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self._final_path(step)
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable meta.json: {e}") from e
        by_name = {d["name"]: d for d in meta["leaves"]}
        sharded = meta.get("sharded", {})

        def read(name):
            if name not in by_name:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            d = by_name[name]
            try:
                arr = np.load(os.path.join(path, d["file"]))
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointCorruptError(
                    f"step {step}: unreadable leaf {name!r}: {e}") from e
            if verify and "crc32" in d and _crc32(arr) != d["crc32"]:
                obs.inc("checkpoint.corrupt")
                raise CheckpointCorruptError(
                    f"step {step}: leaf {name!r} failed its crc32 check")
            return arr

        names, leaves = _flatten_with_names(like)
        out = []
        for name, ref in zip(names, leaves):
            if name in sharded:
                info = sharded[name]
                arr = np.concatenate(
                    [read(f"{name}@s{j:03d}")
                     for j in range(int(info["n_shards"]))],
                    axis=int(info["axis"]))
            else:
                arr = read(name)
            if tuple(arr.shape) != _shape(ref):
                raise ValueError(
                    f"{name}: checkpoint shape {arr.shape} != {_shape(ref)}")
            out.append(put(name, arr) if put else arr)
        tree = _unflatten(like, out)
        if t0 is not None:
            obs.observe("checkpoint.restore_seconds",
                        time.perf_counter() - t0)
            obs.inc("checkpoint.restores")
        return tree

    def restore_with_fallback(
            self, like: Any,
            put: Optional[Callable[[str, np.ndarray], Any]] = None
    ) -> Tuple[int, Any]:
        """Restore the newest *intact* step: try the latest checkpoint,
        and on a failed integrity check fall back to the previous step
        (and so on). Returns ``(step, tree)``.

        Raises ``FileNotFoundError`` if no checkpoint exists at all and
        :class:`CheckpointCorruptError` if every step is damaged.
        Fallbacks count on ``checkpoint.fallbacks``.
        """
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        last_err: Optional[Exception] = None
        for step in reversed(steps):
            try:
                return step, self.restore(like, step=step, put=put)
            except CheckpointCorruptError as e:
                last_err = e
                obs.inc("checkpoint.fallbacks")
                continue
        raise CheckpointCorruptError(
            f"every checkpoint under {self.dir} is corrupt "
            f"(last error: {last_err})")
