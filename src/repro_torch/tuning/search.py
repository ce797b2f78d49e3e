"""The autotuner's search: sweep the discrete knobs of one EngineSpec.

For one configuration identity (kind, fractal, r, m, workload, shards) the
tunable space is

* the fusion depth ``k`` in 1..rho,
* the packing ``P`` of the MXU kinds: the port's heuristic at that k
  (``BlockLayout.macro_tiles_for``: ``MXU_CELLS_PER_CTA`` window cells a
  CTA), and 1, its half and its double, clamped to [1, n_blocks],
* the halo exchange of the dist kinds, p2p or gather.

Every candidate is held against the heuristic engine on the same initial
state before it may win (bit for bit for the uint8 CA workloads, within
rtol = atol = 1e-4 for the float ones), comparing compact states on the
device: a fast wrong kernel is not a winner. All candidates are built on
the one ``shared_layout`` of the configuration. Timing is interleaved
min-of-rounds (``tuning/measure.py``), and the winner is checked against
the memory-bandwidth roofline: a time under the bound is a measurement
artifact, logged and flagged ``suspect`` rather than trusted.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.tuning.measure import (measured_bandwidth_gbs,
                                        roofline_step_seconds,
                                        time_interleaved)
from repro_torch.tuning.spec import EngineSpec
from repro_torch.tuning.table import TableEntry, TuningTable

log = logging.getLogger("repro_torch.tuning")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One concrete knob assignment of the sweep (``macro_p=None``: the
    heuristic packing at ``fusion_k``; ``exchange='auto'``: not a dist
    kind)."""

    fusion_k: int
    macro_p: Optional[int] = None
    exchange: str = "auto"

    @property
    def label(self) -> str:
        parts = [f"k{self.fusion_k}"]
        if self.macro_p is not None:
            parts.append(f"P{self.macro_p}")
        if self.exchange != "auto":
            parts.append(self.exchange)
        return "-".join(parts)


@dataclasses.dataclass
class TuneResult:
    """What tuning one spec found: the winner, the heuristic baseline, the
    whole timing matrix and the gates that vouch for it."""

    spec: EngineSpec               # canonical identity (knobs cleared)
    best: Candidate
    baseline: Candidate
    times: Dict[str, float]        # candidate label -> best seconds a step
    speedup: float                 # baseline time / best time (>= 1.0)
    parity_failures: List[str]     # labels the parity gate rejected
    roofline_s: float              # lower bound, seconds a step
    suspect: bool                  # the winner beat the roofline bound

    def entry(self) -> TableEntry:
        return TableEntry(
            fusion_k=self.best.fusion_k, macro_p=self.best.macro_p,
            exchange=self.best.exchange,
            meta={"speedup": round(self.speedup, 4),
                  "baseline": self.baseline.label,
                  "best_s": self.times[self.best.label],
                  "suspect": self.suspect})


def _heuristic_candidate(spec: EngineSpec) -> Candidate:
    """The knobs the static heuristics pick: the baseline every winner is
    scored against (p2p for the dist kinds, as in the reference)."""
    resolved = spec.normalize(table=None)
    return Candidate(fusion_k=resolved.fusion_k, macro_p=None,
                     exchange="p2p" if spec.is_dist else "auto")


def _layout_class(spec: EngineSpec):
    if spec.is_3d:
        from repro_torch.core.compact3d import BlockLayout3D
        return BlockLayout3D
    from repro_torch.core.compact import BlockLayout
    return BlockLayout


def candidate_space(spec: EngineSpec, n_blocks: int,
                    max_candidates: Optional[int] = None
                    ) -> List[Candidate]:
    """The bounded sweep of ``spec`` (see the module docstring). It always
    holds the heuristic baseline, so the winner is never slower than it on
    the same timing matrix."""
    spec = spec.canonical()
    if not spec.is_block:
        raise ValueError(
            f"kind {spec.kind!r} has no tunable knobs (non-block kind)")
    exchanges = ["p2p", "gather"] if spec.is_dist else ["auto"]
    layout = _layout_class(spec)(spec.build_frac(), spec.r, spec.m) \
        if spec.is_mxu else None
    cands: List[Candidate] = []
    for k in range(1, spec.rho + 1):
        ps: List[Optional[int]] = [None]
        if layout is not None:
            h = layout.macro_tiles_for(n_blocks, k)[0]
            for p in sorted({1, h // 2, min(2 * h, n_blocks)} - {h}):
                if p >= 1:
                    ps.append(int(p))
        cands += [Candidate(k, p, ex) for p in ps for ex in exchanges]
    base = _heuristic_candidate(spec)
    if base not in cands:
        cands.insert(0, base)
    if max_candidates is not None and len(cands) > max_candidates:
        cands = ([base] + [c for c in cands if c != base])[:max_candidates]
    return cands


def _states_equal(workload, a: torch.Tensor, b: torch.Tensor) -> bool:
    """The reference's gate on the device: bit for bit for uint8 states,
    within rtol = atol = 1e-4 for floats."""
    if workload.dtype == torch.uint8:
        return bool(torch.equal(a, b))
    return bool(torch.allclose(a, b, rtol=1e-4, atol=1e-4))


def tune_spec(spec: EngineSpec, *, steps: int = 8, rounds: int = 3,
              seed: int = 0, max_candidates: Optional[int] = None,
              parity_steps: Optional[int] = None,
              device=None) -> TuneResult:
    """Sweep, parity-gate, time and pick the winner for one spec on
    ``device`` (``None`` is the card).

    ``steps`` is the run length of each timed call (scores are seconds per
    advanced step); ``parity_steps`` defaults to ``steps``. Every engine is
    built with the tuning table off: the sweep measures knobs and must not
    read its own output."""
    from repro_torch.core.stencil import make_engine
    dev = resolve_device(device)
    base = dataclasses.replace(spec.canonical(), fusion_k=None,
                               macro_p=None, exchange="auto")
    baseline = _heuristic_candidate(base)
    n_blocks = _n_blocks_for(base)
    cands = candidate_space(base, n_blocks, max_candidates=max_candidates)
    frac, workload = base.build_frac(), base.build_workload()

    engines = {c.label: make_engine(
        dataclasses.replace(base, fusion_k=c.fusion_k, macro_p=c.macro_p,
                            exchange=c.exchange),
        frac=frac, workload=workload, device=dev, table=None)
        for c in cands}

    def compact(eng, state):
        return eng.to_dense(state) if base.is_dist else state

    # each candidate starts from its own engine's state of ``seed``: the
    # same compact state, in the engine's own shard order for the dist
    # kinds
    states0 = {label: eng.init_random(seed)
               for label, eng in engines.items()}
    n_parity = parity_steps if parity_steps is not None else steps
    ref_engine = engines[baseline.label]
    ref_out = compact(ref_engine, ref_engine.run(states0[baseline.label],
                                                 n_parity))
    parity_failures: List[str] = []
    for cand in cands:
        if cand.label == baseline.label:
            continue
        eng = engines[cand.label]
        out = compact(eng, eng.run(states0[cand.label], n_parity))
        if not _states_equal(workload, ref_out, out):
            parity_failures.append(cand.label)
            log.error("tuning parity FAILED for %s candidate %s; excluded "
                      "from the sweep", spec.tuning_key(), cand.label)
        del out
    del ref_out
    ok = [c for c in cands if c.label not in parity_failures]

    fns = {c.label: (lambda e=engines[c.label], s0=states0[c.label]:
                     e.run(s0, steps)) for c in ok}
    raw = time_interleaved(fns, rounds=rounds)
    times = {label: t / steps for label, t in raw.items()}

    roofline = roofline_step_seconds(
        n_blocks, base.rho, baseline.fusion_k,
        itemsize=workload.dtype.itemsize,
        bandwidth_gbs=measured_bandwidth_gbs(device=dev))
    best = min(ok, key=lambda c: times[c.label])
    suspect = bool(times[best.label] < roofline)
    if suspect:
        log.warning(
            "tuning winner %s for %s measured %.3g s/step, below the "
            "roofline bound %.3g s/step; a measurement artifact is likely",
            best.label, spec.tuning_key(), times[best.label], roofline)
    return TuneResult(spec=base, best=best, baseline=baseline, times=times,
                      speedup=times[baseline.label] / times[best.label],
                      parity_failures=parity_failures, roofline_s=roofline,
                      suspect=suspect)


def tune_many(specs, *, steps: int = 8, rounds: int = 3, seed: int = 0,
              max_candidates: Optional[int] = None,
              table: Optional[TuningTable] = None, device=None
              ) -> Tuple[TuningTable, List[TuneResult]]:
    """Tune each spec and put its winner into ``table`` (a fresh one by
    default). Winners under the roofline are still recorded, flagged
    ``suspect`` in the entry's meta."""
    table = table if table is not None else TuningTable()
    results = []
    for spec in specs:
        res = tune_spec(spec, steps=steps, rounds=rounds, seed=seed,
                        max_candidates=max_candidates, device=device)
        table.put(res.spec, res.entry())
        results.append(res)
        log.info("tuned %s: best=%s (%.2fx vs heuristic %s)",
                 res.spec.tuning_key(), res.best.label, res.speedup,
                 res.baseline.label)
    return table, results


def _n_blocks_for(spec: EngineSpec) -> int:
    """Block count of the spec's layout (no tables built)."""
    return _layout_class(spec)(spec.build_frac(), spec.r, spec.m).n_blocks
