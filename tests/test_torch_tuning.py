"""The port's autotuner against the reference's ``repro.tuning``.

* ``EngineSpec.tuning_key`` equals the reference's once the kind is mapped
  (``REFERENCE_KINDS``) and ``axis`` (which the port's spec has not) is
  dropped, for every kind, registry and mask identities alike; ``to_json``
  / ``from_json`` round-trip exactly;
* knob resolution, explicit > table hit > heuristic, with the k clamp to
  rho, gives the reference's outcomes from one table file that holds the
  same entries under both packages' keys, and counts the same
  ``engine.tune.{hit,miss,fallback}`` call for call (normalize, make_engine,
  the runner, serving buckets, the kill switch, a corrupt table);
* ``TuningTable.diff`` gives the reference's output for the same tables;
* ``roofline_step_seconds`` equals the reference's at a given bandwidth,
  ``time_interleaved`` is min of rounds on a fake clock;
* the sweep on the CPU (the kernels' plain versions): candidates in bounds,
  a winner bit for bit with the heuristic engine (LIFE; HEAT within the
  search's own rtol = atol = 1e-4 gate) and no slower than it on its own
  matrix, ``tune_many``'s table hit by ``make_engine``;
* the shipped table loads, names its card, and covers the ``default``
  preset.

Sizes: sierpinski r <= 5, carpet r = 4, Menger r = 3, <= 3 steps, one
round.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.core import fractals as rf
from repro.core.stencil import make_engine as ref_make_engine
from repro.serving import SimRequest as RefRequest
from repro.tuning import measure as rmeasure
from repro.tuning import table as rtable
from repro.tuning.spec import EngineSpec as RefSpec
from repro.workloads import rules as rrules
from repro.workloads.runner import BatchedRunner as RefRunner
from repro_torch import obs
from repro_torch.core import fractals as tf
from repro_torch.core.stencil import default_fusion_k, make_engine
from repro_torch.serving import SimRequest
from repro_torch.tuning import (Candidate, EngineSpec, TableEntry,
                                TuningTable, candidate_space, default_table,
                                measure, preset_specs,
                                reset_default_table_cache, tune_many,
                                tune_spec)
from repro_torch.tuning.__main__ import main as cli
from repro_torch.tuning.search import _n_blocks_for
from repro_torch.tuning.spec import REFERENCE_KINDS
from repro_torch.tuning.table import DEFAULT_TABLE_PATH, TABLE_VERSION
from repro_torch.workloads import BatchedRunner
from repro_torch.workloads import rules as trules

PORT_OF = {ref: port for port, ref in REFERENCE_KINDS.items()}
#: a custom 2D and 3D fractal, identified by their slot masks
MASK2 = ((0, 0), (1, 1), (2, 0))
MASK3 = ((0, 0, 0), (1, 1, 1))

#: the precedence cases: (port spec, table entry); rho 2, 4, 4, 3
BLOCK = EngineSpec("block", 2, "sierpinski", 4, 1, "life")
MXU = EngineSpec("cuda-mxu", 2, "sierpinski", 5, 2, "life")
DIST = EngineSpec("dist-fused", 2, "sierpinski", 5, 2, "life",
                  mesh_shape=(4,))
FUSED3 = EngineSpec("cuda-3d", 3, "menger", 3, 1, "life3d")
ENTRIES = [(BLOCK, TableEntry(fusion_k=1)),
           (MXU, TableEntry(fusion_k=99, macro_p=5)),   # k clamped to 4
           (DIST, TableEntry(fusion_k=3, exchange="gather")),
           (FUSED3, TableEntry(fusion_k=1))]


def _ref(spec: EngineSpec) -> RefSpec:
    """The reference spec of a port spec."""
    d = spec.to_json()
    d["kind"] = REFERENCE_KINDS[d["kind"]]
    return RefSpec.from_json(d)


def _port_key(ref_key: str) -> str:
    """A reference table key as the port writes it."""
    d = json.loads(ref_key)
    d.pop("axis")
    d["kind"] = PORT_OF[d["kind"]]
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def _tune_series(registry, kinds):
    """engine.tune.* by (name, port kind), zeros included."""
    return {(n, PORT_OF.get(k, k)): registry.value(n, kind=k)
            for n in ("engine.tune.hit", "engine.tune.miss",
                      "engine.tune.fallback") for k in kinds}


@pytest.fixture
def regs():
    """Both packages' registries, on and empty."""
    prev, rprev = obs.enabled(), robs.enabled()
    obs.enable(True)
    robs.enable(True)
    obs.reset()
    robs.reset()
    try:
        yield obs.default_registry(), robs.default_registry()
    finally:
        obs.reset()
        robs.reset()
        obs.enable(prev)
        robs.enable(rprev)


@pytest.fixture(autouse=True)
def _fresh_tables(monkeypatch):
    monkeypatch.delenv("SQUEEZE_TUNING", raising=False)
    monkeypatch.delenv("SQUEEZE_TUNING_TABLE", raising=False)
    reset_default_table_cache()
    rtable.reset_default_table_cache()
    yield
    reset_default_table_cache()
    rtable.reset_default_table_cache()


@pytest.fixture
def both_table(tmp_path, monkeypatch):
    """One table file holding ENTRIES under both packages' keys, made the
    active table of both."""
    port, ref = TuningTable(), rtable.TuningTable()
    for spec, e in ENTRIES:
        port.put(spec, e)
        ref.put(_ref(spec), rtable.TableEntry(e.fusion_k, e.macro_p,
                                              e.exchange))
    doc = port.to_json()
    doc["entries"].update(ref.to_json()["entries"])
    path = tmp_path / "both.json"
    path.write_text(json.dumps(doc))
    monkeypatch.setenv("SQUEEZE_TUNING_TABLE", str(path))
    return str(path)


# ------------------------------------------------------------ the identity
def _identities(kind):
    if kind in ("bb3d", "cell3d", "block3d", "cuda-3d", "cuda-3d-mxu"):
        return [(3, "menger"), (2, MASK3)]
    return [(2, "sierpinski"), (3, MASK2)]


@pytest.mark.parametrize("kind", sorted(REFERENCE_KINDS))
def test_tuning_key_equals_reference(kind):
    mesh = (4,) if kind.startswith("dist-") else None
    for s, frac in _identities(kind):
        spec = EngineSpec(kind, s, frac, 3, 1, "life", fusion_k=2,
                          mesh_shape=mesh)
        assert spec.tuning_key() == _port_key(_ref(spec).tuning_key())
        assert json.loads(spec.tuning_key())["mesh_shape"] == \
            (None if mesh is None else [4])


def test_kind_predicates_match_reference():
    from repro.tuning import spec as rspec
    from repro_torch.tuning.spec import is_block_kind, is_dist_kind
    for kind, ref_kind in REFERENCE_KINDS.items():
        assert is_block_kind(kind) == rspec.is_block_kind(ref_kind), kind
        assert is_dist_kind(kind) == rspec.is_dist_kind(ref_kind), kind


@pytest.mark.parametrize("spec", [
    BLOCK, MXU, DIST, FUSED3,
    EngineSpec("cuda-mxu", 3, MASK2, 4, 1, "heat", 2, 7),
    EngineSpec("block3d", 2, MASK3, 3, 1, "life3d", None, None),
    EngineSpec("dist-mxu", 2, "sierpinski", 6, 2, "gray-scott", 3, 4,
               "p2p", (2,)),
    EngineSpec("cell", 2, "sierpinski", 5)], ids=str)
def test_json_round_trip_is_exact(spec):
    d = spec.to_json()
    back = EngineSpec.from_json(json.loads(json.dumps(d)))
    assert back == spec and hash(back) == hash(spec)
    assert back.tuning_key() == spec.tuning_key()


# ------------------------------------------------------------- precedence
def _resolved(spec):
    return (spec.fusion_k, spec.exchange)


def test_precedence_matches_reference(both_table, regs):
    reg, rreg = regs
    heur_calls = []
    for spec, e in ENTRIES:
        ref = _ref(spec)
        mine, theirs = spec.normalize(), ref.normalize()
        assert _resolved(mine) == _resolved(theirs), spec
        assert mine.fusion_k == max(1, min(e.fusion_k, spec.rho))
        if spec.is_mxu:           # the table's P on the MXU kinds
            assert mine.macro_p == theirs.macro_p == e.macro_p
        # explicit knobs win; a spec with every knob set is not consulted
        expl = dataclasses.replace(spec, fusion_k=spec.rho, macro_p=2 if
                                   spec.is_mxu else None, exchange="p2p"
                                   if spec.is_dist else "auto")
        assert _resolved(expl.normalize()) == \
            _resolved(_ref(expl).normalize()) == \
            (spec.rho, "p2p" if spec.is_dist else "auto")
        # no entry: a miss, and the heuristic
        other = dataclasses.replace(spec, r=spec.r - 1)
        miss = other.normalize()
        assert _resolved(miss) == _resolved(_ref(other).normalize())
        assert miss.fusion_k == default_fusion_k(spec.rho)
        # table=None: the heuristic, silent
        heur_calls.append((spec.normalize(table=None),
                           ref.normalize(table=None)))
    for mine, theirs in heur_calls:
        assert _resolved(mine) == _resolved(theirs)
    kinds = [REFERENCE_KINDS[s.kind] for s, _ in ENTRIES]
    want = _tune_series(rreg, kinds)
    assert _tune_series(reg, [s.kind for s, _ in ENTRIES]) == want
    assert want[("engine.tune.hit", "block")] == 1
    assert want[("engine.tune.miss", "cuda-mxu")] == 1


def test_explicit_table_object_and_clamp_match_reference(regs):
    reg, rreg = regs
    mine, theirs = TuningTable(), rtable.TuningTable()
    for spec, e in ENTRIES:
        mine.put(spec, e)
        theirs.put(_ref(spec), rtable.TableEntry(e.fusion_k, e.macro_p,
                                                 e.exchange))
    for spec, _ in ENTRIES:
        a, b = spec.normalize(table=mine), _ref(spec).normalize(table=theirs)
        assert _resolved(a) == _resolved(b)
        if spec is MXU:
            assert a.fusion_k == MXU.rho                  # 99 -> rho
    kinds = [s.kind for s, _ in ENTRIES]
    assert _tune_series(reg, kinds) == \
        _tune_series(rreg, [REFERENCE_KINDS[k] for k in kinds])


def test_tune_counts_match_reference_call_for_call(both_table, tmp_path,
                                                   monkeypatch, regs):
    """make_engine, the runner (one consult a call, none a build), serving
    buckets, the kill switch and a corrupt SQUEEZE_TUNING_TABLE."""
    reg, rreg = regs
    frac, rfrac = tf.SIERPINSKI, rf.SIERPINSKI

    def script(mk, runner, request, life):
        mk(BLOCK)                                     # hit
        mk(dataclasses.replace(BLOCK, fusion_k=2))    # explicit: none
        mk(dataclasses.replace(BLOCK, r=3))           # miss
        eng = runner.engine_for("block", frac_of[runner], 4, m=1)  # hit
        assert eng.effective_fusion_k == 1            # the table's k
        assert runner.engine_for("block", frac_of[runner], 4, m=1,
                                 k=1) is eng          # explicit, one slot
        states = runner.init_batch("block", frac_of[runner], 4,
                                   seeds=[0, 1], m=1, workload=life)
        runner.run("block", frac_of[runner], 4, states, steps=3, m=1,
                   workload=life)                     # two more hits
        b = request(frac=frac_of[runner], r=4, m=1, steps=3).bucket
        assert b.fusion_k == 1
        monkeypatch.setenv("SQUEEZE_TUNING", "off")
        assert mk(BLOCK).effective_fusion_k == 2      # fallback
        monkeypatch.delenv("SQUEEZE_TUNING")
        bad = tmp_path / "corrupt.json"
        bad.write_text("{not json")
        monkeypatch.setenv("SQUEEZE_TUNING_TABLE", str(bad))
        assert mk(BLOCK).effective_fusion_k == 2      # fallback
        mk(BLOCK)                                     # fallback, no raise
        monkeypatch.setenv("SQUEEZE_TUNING_TABLE", both_table)

    port_runner, ref_runner = BatchedRunner(device="cpu"), RefRunner()
    frac_of = {port_runner: frac, ref_runner: rfrac}
    script(lambda s: make_engine(s, device="cpu"), port_runner, SimRequest,
           trules.LIFE)
    script(lambda s: ref_make_engine(_ref(s)), ref_runner, RefRequest,
           rrules.LIFE)
    mine = _tune_series(reg, ["block"])
    assert mine == _tune_series(rreg, ["block"])
    assert mine == {("engine.tune.hit", "block"): 5,
                    ("engine.tune.miss", "block"): 1,
                    ("engine.tune.fallback", "block"): 3}


def test_dist_exchange_from_the_table_reaches_the_engine(both_table):
    eng = make_engine(DIST, device="cpu")
    assert (eng.exchange, eng.exchange_mode, eng.fusion_k) == \
        ("gather", "gather", 3)
    other = make_engine(dataclasses.replace(DIST, r=4), device="cpu")
    assert other.exchange == "auto"   # no entry: the engine resolves it
    assert other.exchange_mode == "p2p"


def test_diff_matches_reference():
    old, new = TuningTable(), TuningTable()
    rold, rnew = rtable.TuningTable(), rtable.TuningTable()
    keep = EngineSpec("block", 3, "carpet", 4, 1, "life")
    gone = EngineSpec("block", 2, "sierpinski", 5, 2, "heat")
    added = EngineSpec("cuda-fused", 2, MASK2, 4, 1, "life")
    for table, rt, spec, e in [
            (old, rold, keep, TableEntry(2, meta={"speedup": 1.1})),
            (new, rnew, keep, TableEntry(1, meta={"speedup": 1.3})),
            (old, rold, gone, TableEntry(3)),
            (new, rnew, added, TableEntry(2)),
            (old, rold, MXU, TableEntry(2, 7)),
            (new, rnew, MXU, TableEntry(2, 7, meta={"x": 1}))]:
        table.put(spec, e)
        rt.put(_ref(spec), rtable.TableEntry(e.fusion_k, e.macro_p,
                                             e.exchange, dict(e.meta)))
    mine, theirs = new.diff(old), rnew.diff(rold)
    assert mine == {"added": [_port_key(k) for k in theirs["added"]],
                    "removed": [_port_key(k) for k in theirs["removed"]],
                    "changed": {_port_key(k): v for k, v in
                                theirs["changed"].items()}}
    assert mine["changed"] == {keep.tuning_key(): {
        "old": {"fusion_k": 2, "macro_p": None, "exchange": "auto"},
        "new": {"fusion_k": 1, "macro_p": None, "exchange": "auto"}}}


def test_table_round_trip_version_and_file_format(tmp_path):
    t = TuningTable(meta={"generator": "test"})
    for spec, e in ENTRIES:
        t.put(spec, dataclasses.replace(e, meta={"speedup": 1.25}))
    path = str(tmp_path / "t.json")
    t.save(path)
    back = TuningTable.load(path)
    assert back.to_json() == t.to_json() and len(back) == len(ENTRIES)
    assert back.get(MXU).macro_p == 5 and back.get(DIST).exchange == \
        "gather"
    # the reference reads the same file (its keys differ, its schema not)
    assert rtable.TuningTable.load(path).to_json() == t.to_json()
    bad = tmp_path / "v2.json"
    bad.write_text(json.dumps({"version": TABLE_VERSION + 1,
                               "entries": {}}))
    with pytest.raises(ValueError, match="version"):
        TuningTable.load(str(bad))


def test_missing_override_path_falls_back(monkeypatch, tmp_path, regs):
    reg, _ = regs
    monkeypatch.setenv("SQUEEZE_TUNING_TABLE", str(tmp_path / "none.json"))
    assert default_table() is None
    assert BLOCK.normalize().fusion_k == 2
    assert reg.value("engine.tune.fallback", kind="block") == 1


# ------------------------------------------------------------ measurement
@pytest.mark.parametrize("args", [(27, 4, 1, 1), (4782969, 4, 2, 1),
                                  (100, 9, 3, 4), (1, 2, 2, 4)])
def test_roofline_equals_reference(args):
    n, rho, k, item = args
    for bw in (1.0, 3350.0):
        assert measure.roofline_step_seconds(n, rho, k, item, bw) == \
            rmeasure.roofline_step_seconds(n, rho, k, item, bw)


def test_time_interleaved_is_min_of_rounds(monkeypatch):
    clock, order = [0.0], []
    durations = {"a": iter([9.0, 9.0, 3.0, 1.0, 2.0]),
                 "b": iter([7.0, 7.0, 0.5, 4.0, 0.25])}

    def fn(name):
        def call():
            order.append(name)
            clock[0] += next(durations[name])
            return torch.zeros(1)
        return call
    monkeypatch.setattr(measure.time, "perf_counter", lambda: clock[0])
    best = measure.time_interleaved({"a": fn("a"), "b": fn("b")},
                                    rounds=3, warmup=2)
    assert best == {"a": 1.0, "b": 0.25}
    assert order == ["a", "a", "b", "b"] + ["a", "b"] * 3
    assert measure.geomean([2.0, 8.0]) == pytest.approx(4.0)
    assert measure.geomean([]) == rmeasure.geomean([]) == 1.0


def test_measured_bandwidth_on_the_cpu():
    gbs = measure.measured_bandwidth_gbs(nbytes=1 << 20, rounds=2,
                                         device="cpu")
    assert gbs > 0 and measure.measured_bandwidth_gbs(
        nbytes=1 << 20, device="cpu") == gbs          # once a process


# ------------------------------------------------------------- the sweep
def test_candidate_space_holds_baseline_and_bounds():
    cands = candidate_space(BLOCK, n_blocks=27)
    assert Candidate(BLOCK.normalize(table=None).fusion_k) in cands
    assert {c.fusion_k for c in cands} == {1, 2}            # 1..rho
    assert all(c.macro_p is None for c in cands)
    mxu = candidate_space(MXU, n_blocks=27)
    assert {c.fusion_k for c in mxu} == {1, 2, 3, 4}
    assert Candidate(default_fusion_k(4)) in mxu
    assert any(c.macro_p is not None for c in mxu)
    assert all(c.macro_p is None or 1 <= c.macro_p <= 27 for c in mxu)
    assert len({c.label for c in mxu}) == len(mxu)
    dist = candidate_space(DIST, n_blocks=27)
    assert {c.exchange for c in dist} == {"p2p", "gather"}
    assert Candidate(2, None, "p2p") in dist
    assert [c.label for c in dist][:2] == ["k1-p2p", "k1-gather"]
    assert len(candidate_space(MXU, 27, max_candidates=3)) == 3
    with pytest.raises(ValueError, match="no tunable knobs"):
        candidate_space(EngineSpec("cell", 2, "sierpinski", 4), 27)


@pytest.mark.parametrize("spec", [
    BLOCK, EngineSpec("cuda-mxu", 3, "carpet", 4, 1, "heat"),
    dataclasses.replace(DIST, mesh_shape=(2,))], ids=lambda s: s.kind)
def test_tune_spec_winner_is_parity_exact_and_not_slower(spec):
    res = tune_spec(spec, steps=3, rounds=1, seed=3, device="cpu")
    assert not res.parity_failures
    assert res.baseline.label in res.times
    assert res.speedup >= 1.0 and res.roofline_s > 0
    assert set(res.times) == {c.label for c in candidate_space(
        spec, _n_blocks_for(spec))}
    # the winner against the heuristic engine: LIFE bit for bit, HEAT at
    # the search's gate (rtol = atol = 1e-4)
    win = dataclasses.replace(spec, fusion_k=res.best.fusion_k,
                              macro_p=res.best.macro_p,
                              exchange=res.best.exchange)
    e_win = make_engine(win, device="cpu", table=None)
    e_base = make_engine(spec, device="cpu", table=None)
    out_w = e_win.to_expanded(e_win.run(e_win.init_random(3), 3))
    out_b = e_base.to_expanded(e_base.run(e_base.init_random(3), 3))
    if spec.workload == "life":
        np.testing.assert_array_equal(out_w.numpy(), out_b.numpy())
    else:
        np.testing.assert_allclose(out_w.numpy(), out_b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    entry = res.entry()
    assert entry.meta["baseline"] == res.baseline.label
    assert set(entry.meta) == {"best_s", "baseline", "speedup", "suspect"}


def test_tune_many_writes_a_table_make_engine_hits(tmp_path, monkeypatch,
                                                   regs):
    reg, _ = regs
    table, results = tune_many([BLOCK], steps=2, rounds=1, device="cpu")
    assert len(table) == 1 and len(results) == 1
    entry = table.get(BLOCK)
    assert entry.fusion_k == results[0].best.fusion_k
    path = str(tmp_path / "tuned.json")
    table.save(path)
    monkeypatch.setenv("SQUEEZE_TUNING_TABLE", path)
    obs.reset()
    eng = make_engine(BLOCK, device="cpu")
    assert reg.value("engine.tune.hit", kind="block") == 1
    assert eng.effective_fusion_k == entry.fusion_k


def test_cli_tune_show_and_diff(tmp_path, capsys):
    out = str(tmp_path / "cli.json")
    assert cli(["tune", "--device", "cpu", "--steps", "2", "--rounds", "1",
                "--spec", json.dumps(BLOCK.to_json()), "--out", out]) == 0
    table = TuningTable.load(out)
    assert table.get(BLOCK) is not None
    assert table.meta["generator"] == "python -m repro_torch.tuning"
    assert table.meta["device"] == "cpu" and "date" in table.meta
    capsys.readouterr()
    assert cli(["show", out]) == 0
    assert json.loads(capsys.readouterr().out) == table.to_json()
    assert cli(["diff", out, out]) == 0
    other = TuningTable(table.entries)
    other.put(BLOCK, TableEntry(fusion_k=3 - table.get(BLOCK).fusion_k))
    other_path = str(tmp_path / "other.json")
    other.save(other_path)
    capsys.readouterr()
    assert cli(["diff", out, other_path]) == 1
    diff = json.loads(capsys.readouterr().out)
    assert list(diff["changed"]) == [BLOCK.tuning_key()]
    assert cli(["tune"]) == 2


# ------------------------------------------------------- the shipped table
def test_shipped_table_loads_and_covers_the_default_preset():
    shipped = TuningTable.load(DEFAULT_TABLE_PATH)
    assert shipped.meta["generator"] == "python -m repro_torch.tuning"
    assert "H100" in shipped.meta["card"] and "W" in shipped.meta["card"]
    assert shipped.meta["date"]
    for spec in preset_specs("default"):
        e = shipped.get(spec)
        assert e is not None, spec.tuning_key()
        assert set(e.meta) == {"best_s", "baseline", "speedup", "suspect"}
        assert 1 <= e.fusion_k <= spec.rho
    assert all(not s.is_dist for s in preset_specs("default"))


def test_presets_are_the_reference_sets():
    from repro.tuning.presets import preset_specs as ref_presets
    for name in ("ci", "default"):
        assert [s.tuning_key() for s in preset_specs(name)] == \
            [_port_key(s.tuning_key()) for s in ref_presets(name)]
    with pytest.raises(KeyError):
        preset_specs("nope")


def test_make_engine_hits_the_shipped_table(regs):
    reg, _ = regs
    spec = preset_specs("ci")[0]
    eng = make_engine(spec, device="cpu")
    assert reg.value("engine.tune.hit", kind=spec.kind) == 1
    want = TuningTable.load(DEFAULT_TABLE_PATH).get(spec).fusion_k
    assert eng.effective_fusion_k == max(1, min(want, spec.rho))
