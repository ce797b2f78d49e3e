"""Data pipeline: stateless, step-indexed token batches -- the port's own
copy of the reference's ``data/pipeline.py``, numpy through and through,
so a batch is bit for bit the reference's for the same seed, step and
shard; the trainer moves it to the device.

Every batch is a pure function of (seed, step, shard) — no iterator state
to checkpoint, so restart-from-step-N is bit-exact by construction (the
fault-tolerance property the runtime tests rely on). Two sources:

  * ``SyntheticMarkov`` — Zipf-ish unigrams driven through a fixed random
    permutation bigram channel (next = perm[cur] w.p. ``p_signal``); has
    ~ -p log p + ... learnable structure so example training shows a real
    loss drop;
  * ``MemmapCorpus``  — a flat uint16/uint32 token file, random crops.

Batches are (tokens, labels) with labels the next-token shift. A
double-buffered background prefetcher overlaps host batch synthesis with
device compute (straggler mitigation at the input layer).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticMarkov:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    p_signal: float = 0.8
    #: this host's shard of the global batch
    shard: int = 0
    n_shards: int = 1

    def __post_init__(self):
        assert self.global_batch % self.n_shards == 0

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_shards

    def _perm(self) -> np.ndarray:
        return np.random.default_rng(self.seed ^ 0xC0FFEE).permutation(
            self.vocab).astype(np.int32)

    def batch(self, step: int) -> dict:
        """Batch for global ``step`` (stateless; shard-disjoint)."""
        perm = self._perm()
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, s = self.local_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        noise = rng.random((b, s)) >= self.p_signal
        rand_next = rng.integers(0, self.vocab, size=(b, s))
        for t in range(s):
            nxt = perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_next[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class MemmapCorpus:
    """Flat binary token file; random crops, stateless per step."""
    path: str
    vocab: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0
    shard: int = 0
    n_shards: int = 1

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_shards

    def batch(self, step: int) -> dict:
        data = np.memmap(self.path, dtype=self.dtype, mode="r")
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, s = self.local_batch, self.seq_len
        starts = rng.integers(0, len(data) - s - 1, size=b)
        toks = np.stack([data[i:i + s + 1] for i in starts]).astype(np.int32)
        toks = np.minimum(toks, self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Double-buffered background prefetch of step-indexed batches."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._source.batch(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
