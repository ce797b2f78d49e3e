"""The port's distributed engine against the reference, on the CPU.

Every ``StripDecomposition`` table equals the reference's bit for bit (the
reference builds them in pure numpy, no mesh needed); the strip helpers
equal the reference's; the plain versions of the shard-local kernels equal
the reference's Pallas entries in interpret mode (one case each); and the
dist kinds at 8 CPU shards, both exchanges, equal the reference
single-device ``block`` engine: CA bit-exact, floats within rtol=atol=1e-5
(the reference's bar, ``tests/test_distributed_fused.py:46``). The
exchange accounting is held to the reference's byte model and its
collective counts (one all-gather per gather launch, two neighbor permutes
per p2p launch: ``tests/test_distributed_fused.py:161-186``). The CUDA
kernels are held against these plain versions in ``test_torch_cuda.py``.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compact as rc
from repro.core import fractals as rf
from repro.core.stencil import SqueezeBlockEngine as RefBlockEngine
from repro.kernels import squeeze_stencil as rsk
from repro.tuning.spec import EngineSpec as RefSpec
from repro.workloads import rules as rrules
from repro.workloads.runner import BatchedRunner as RefRunner
from repro_torch.core import compact as tc
from repro_torch.core import fractals as tf
from repro_torch.core.distributed import (DistributedSqueezeEngine,
                                          make_distributed_engine,
                                          shard_devices)
from repro_torch.core.stencil import make_engine
from repro_torch.kernels import squeeze_stencil as sk
from repro_torch.tuning.spec import EngineSpec
from repro_torch.workloads import BatchedRunner
from repro_torch.workloads import rules as trules

WORKLOADS = ["life", "highlife", "heat", "gray-scott"]
#: the parity case: sierpinski r=6, m=2 (81 blocks of 4x4, 16 occupied
#: block rows, so 8 shards make a valid decomposition)
FRAC, R, M = "sierpinski", 6, 2
NS = 8
STEPS = 7
DECOMP_CASES = [("sierpinski", 5, 1), ("carpet", 4, 1), ("vicsek", 5, 1)]
TABLES = ["valid", "nb_local", "nb_padded", "perm", "shard_of", "local_of",
          "send_prev_idx", "send_next_idx", "table", "interior_idx",
          "boundary_idx", "n_interior", "n_boundary", "ms_prev", "ms_next",
          "real_sends"]


def _tol(wl):
    return dict(rtol=0, atol=0) if wl.dtype == torch.uint8 \
        else dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _layouts(name, r, m):
    return (rc.BlockLayout(rf.REGISTRY[name], r, m),
            tc.BlockLayout(tf.REGISTRY[name], r, m))


def _assert_tables_equal(ref, port, names):
    for name in names:
        want, got = getattr(ref, name), getattr(port, name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got == want, name


# ------------------------------------------------------- decomposition
@pytest.mark.parametrize("ns", [1, 2, 3, 8])
@pytest.mark.parametrize("case", DECOMP_CASES,
                         ids=[f"{f}-r{r}-m{m}" for f, r, m in DECOMP_CASES])
def test_strip_decomposition_tables_match_reference(case, ns):
    ref, port = (lay.strip_decomposition(ns) for lay in _layouts(*case))
    assert port.valid
    _assert_tables_equal(ref, port, TABLES)
    assert port is _layouts(*case)[1].strip_decomposition(ns)   # memoised
    for k in (1, 2):
        for item in (1, 4):
            args = (k, item, 3)
            assert port.wire_bytes_per_exchange(*args) == \
                ref.wire_bytes_per_exchange(*args)
            assert port.wire_bytes_per_device_per_exchange(*args) == \
                ref.wire_bytes_per_device_per_exchange(*args)
            assert port.slot_bytes(k, item) == ref.slot_bytes(k, item)


@pytest.mark.parametrize("case,ns", [(("vicsek", 3, 2), 8),
                                     (("sierpinski", 4, 3), 3)])
def test_degenerate_decomposition_matches_reference(case, ns):
    ref, port = (lay.strip_decomposition(ns) for lay in _layouts(*case))
    assert not ref.valid and not port.valid
    _assert_tables_equal(ref, port, TABLES[:6])


def test_balanced_contiguous_partition_matches_reference():
    rng = np.random.default_rng(3)
    for n, groups in ((16, 4), (33, 8), (5, 5), (40, 1)):
        counts = rng.integers(1, 50, n)
        assert tc._balanced_contiguous_partition(counts, groups) == \
            rc._balanced_contiguous_partition(counts, groups)
    with pytest.raises(ValueError, match="nonempty"):
        tc._balanced_contiguous_partition(np.ones(3, int), 4)


def test_macro_tiles_for():
    _, lay = _layouts(FRAC, R, M)
    assert lay.macro_tiles_for(lay.n_blocks, 2) == lay.macro_tiles(2)
    for nb in (1, 7, 50):
        p, n_macro, nb_pad = lay.macro_tiles_for(nb, 2)
        assert p * n_macro == nb_pad >= nb and nb_pad - nb < n_macro
        assert (n_macro - 1) * p < nb
    assert lay.macro_tiles_for(7, 2, p=3) == (3, 3, 9)
    assert lay.macro_tiles_for(2, 2, p=5) == (2, 1, 2)
    with pytest.raises(ValueError, match="halo depth"):
        lay.macro_tiles_for(7, 0)


# ------------------------------------------------------- strip helpers
def _random_state(lay, lead, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, lead + (lay.n_blocks, lay.rho, lay.rho)
                        ).astype(np.uint8)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_strip_helpers_match_reference(k):
    ref_lay, lay = _layouts(FRAC, R, M)
    x = _random_state(lay, (2,))
    want = ref_lay.pack_edge_strips(jnp.asarray(x), k)
    got = lay.pack_edge_strips(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    strips = np.concatenate([np.asarray(want),
                             np.zeros((2, 1, 4, k, lay.rho), np.uint8)], 1)
    table = np.where(lay.neighbor_table == lay.ghost, lay.n_blocks,
                     lay.neighbor_table).astype(np.int32)
    want = ref_lay.halo_from_strips_k(jnp.asarray(strips),
                                      jnp.asarray(table), k)
    got = lay.halo_from_strips_k(torch.from_numpy(strips),
                                 torch.from_numpy(table), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="k <= rho"):
        lay.pack_edge_strips(torch.from_numpy(x), lay.rho + 1)


def test_pack_edge_strips_for_matches_reference():
    ref_lay, lay = _layouts(FRAC, R, M)
    ref, port = ref_lay.strip_decomposition(NS), lay.strip_decomposition(NS)
    rng = np.random.default_rng(1)
    strips = rng.integers(0, 9, (2, port.nb_local + 1, 4, 2, lay.rho)
                          ).astype(np.uint8)
    for neighbor in ("prev", "next"):
        for shard in (0, 3, NS - 1):
            np.testing.assert_array_equal(
                port.pack_edge_strips_for(torch.from_numpy(strips),
                                          neighbor, shard).numpy(),
                np.asarray(ref.pack_edge_strips_for(jnp.asarray(strips),
                                                    neighbor, shard)))


# ------------------------------------------- shard-local kernels (plain)
def _local_inputs(lay, wl, lead, k, seed):
    rng = np.random.default_rng(seed)
    nc, rho, w, nbl = wl.n_channels, lay.rho, lay.rho + 2 * k, 11

    def draw(*tail):
        shape = lead + (nc, nbl) + tail
        return rng.integers(0, 2, shape).astype(np.uint8) \
            if wl.dtype == torch.uint8 \
            else rng.random(shape).astype(np.float32)
    state = draw(rho, rho)
    halo = (draw(k, w), draw(k, w), draw(rho, k), draw(rho, k))
    existence = rng.integers(0, 2, (nbl, 8)).astype(np.int32)
    return state, halo, existence


@pytest.mark.parametrize("entry", ["fused_k_local", "mxu_k_local"])
@pytest.mark.parametrize("wl_name", ["life", "gray-scott"])
def test_local_plain_matches_reference_interpret(entry, wl_name):
    """One small case per kernel against the reference's Pallas entry in
    interpret mode: random pieces, random existence rows."""
    ref_lay, lay = _layouts(FRAC, 5, 1)
    ref_lay.materialize()
    wl, k = trules.WORKLOADS[wl_name], 2
    lead = () if entry == "fused_k_local" else (2,)
    state, halo, existence = _local_inputs(lay, wl, lead, k, seed=4)
    want = getattr(rsk, f"stencil_step_{entry}")(
        ref_lay, jnp.asarray(state), tuple(map(jnp.asarray, halo)),
        jnp.asarray(existence), rrules.WORKLOADS[wl_name], k=k,
        interpret=True)
    got = getattr(sk, f"stencil_step_{entry}")(
        lay, torch.from_numpy(state), tuple(map(torch.from_numpy, halo)),
        torch.from_numpy(existence), wl, k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(wl))


# ------------------------------------------------- the engine, 8 shards
@functools.lru_cache(maxsize=None)
def _start(wl_name, batch):
    """(B, C?, n_blocks, rho, rho) initial states from each workload's own
    distribution, holes zeroed. Gray-Scott starts at (1, 0) with 2% seeds
    at (0.5, 0.25), as its ``init`` draws: uniform (u, v) lies outside its
    stable regime, where values reach ~1e9 in 7 steps and a change of
    summation order alone (k fused steps against single steps) moves them
    past any relative bar."""
    _, lay = _layouts(FRAC, R, M)
    wl = trules.WORKLOADS[wl_name]
    rng = np.random.default_rng(7)
    shape = (batch, lay.n_blocks, lay.rho, lay.rho)
    if wl.dtype == torch.uint8:
        x = rng.integers(0, 2, shape).astype(np.uint8)
    elif wl.n_channels > 1:
        seeds = (rng.random(shape) < 0.02).astype(np.float32)
        x = np.stack([1.0 - 0.5 * seeds, 0.25 * seeds], axis=1)
    else:
        x = rng.random(shape).astype(np.float32)
    return x * lay.micro_mask


@functools.lru_cache(maxsize=None)
def _reference(wl_name, batch, steps):
    """``steps`` single steps of the reference block engine."""
    ref_lay, _ = _layouts(FRAC, R, M)
    eng = RefBlockEngine(ref_lay, rrules.WORKLOADS[wl_name], fusion_k=1)
    out = []
    for s in _start(wl_name, batch):
        s = jnp.asarray(s)
        for _ in range(steps):
            s = eng.step(s)
        out.append(np.asarray(s))
    return np.stack(out)


def _engine(compute, exchange, wl_name, ns=NS, **kw):
    _, lay = _layouts(FRAC, R, M)
    return make_distributed_engine(
        lay, n_shards=ns, device="cpu", workload=trules.WORKLOADS[wl_name],
        compute=compute, exchange=exchange, **kw)


def _assert_dead_zero(eng, state):
    dead = torch.from_numpy(eng.dead_mask())
    native = torch.cat(state, dim=-3)
    assert int((native.double() * dead).abs().sum()) == 0


@pytest.mark.parametrize("exchange", ["p2p", "gather"])
@pytest.mark.parametrize("compute", ["jnp", "fused", "mxu"])
@pytest.mark.parametrize("wl_name", WORKLOADS)
def test_dist_engine_matches_reference_block(wl_name, compute, exchange):
    eng = _engine(compute, exchange, wl_name)
    assert eng.exchange_mode == exchange and eng.n_shards == NS
    out = eng.run(eng.from_dense(_start(wl_name, 1)[0]), STEPS)
    assert all(s.shape[-3] == eng.nb_local for s in out)
    np.testing.assert_allclose(eng.to_dense(out).numpy(),
                               _reference(wl_name, 1, STEPS)[0],
                               **_tol(eng.workload))
    _assert_dead_zero(eng, out)


@pytest.mark.parametrize("compute", ["jnp", "fused", "mxu"])
def test_dist_engine_batched_matches_reference(compute):
    for wl_name, exchange in (("life", "p2p"), ("gray-scott", "gather")):
        eng = _engine(compute, exchange, wl_name, fusion_k=3)
        out = eng.run(eng.from_dense(_start(wl_name, 3)), STEPS)
        np.testing.assert_allclose(eng.to_dense(out).numpy(),
                                   _reference(wl_name, 3, STEPS),
                                   **_tol(eng.workload))
        _assert_dead_zero(eng, out)


@pytest.mark.parametrize("exchange", ["p2p", "gather"])
def test_local_inputs_reproduce_the_launch(exchange):
    """Kernel 6's plain version on ``local_inputs`` of every shard gives
    that shard's step_k result under the center mask: every block in
    gather mode, the interior blocks in p2p mode (its boundary blocks are
    recomputed after the transfers). Two shards, so each has interior
    blocks."""
    ns, k = 2, 2
    eng = _engine("fused", exchange, "life", ns=ns)
    x = eng.from_dense(_start("life", 1)[0])
    want = eng.step_k(x, k)
    center = torch.from_numpy(1 - eng.dead_mask()).reshape(
        ns, eng.nb_local, eng.layout.rho, eng.layout.rho)
    for shard in range(ns):
        s5, halo, existence = eng.local_inputs(x, k, shard)
        assert s5.shape == (1, 1, eng.nb_local, 4, 4)
        assert existence.shape == (eng.nb_local, 8)
        got = sk.stencil_step_fused_k_local_plain(
            eng.layout, s5, halo, existence, eng.workload, k=k)[0, 0]
        got = got * center[shard]
        rows = slice(None)
        if exchange == "p2p":
            d = eng.decomp
            rows = torch.from_numpy(d.interior_idx[shard][
                :d.n_interior[shard]].astype(np.int64))
            assert len(rows) > 0
        assert torch.equal(got[rows], want[shard][rows])


def test_native_order_is_the_reference_decomposition():
    ref_lay, _ = _layouts(FRAC, R, M)
    perm = ref_lay.strip_decomposition(NS).perm
    eng = _engine("fused", "p2p", "life")
    x = _random_state(eng.layout, (), seed=2)
    shards = eng.from_dense(x)
    native = torch.cat(shards, dim=-3).numpy()
    np.testing.assert_array_equal(native[perm >= 0], x[perm[perm >= 0]])
    assert not native[perm < 0].any()
    np.testing.assert_array_equal(eng.to_dense(shards).numpy(), x)
    dead = eng.dead_mask()
    assert dead.shape == (eng.nb_padded, 4, 4)
    assert (dead[perm < 0] == 1).all()
    np.testing.assert_array_equal(dead[perm >= 0],
                                  np.broadcast_to(1 - ref_lay.micro_mask,
                                                  dead[perm >= 0].shape))
    gather = _engine("fused", "gather", "life")
    np.testing.assert_array_equal(
        torch.cat(gather.from_dense(x), -3).numpy()[:eng.layout.n_blocks], x)


@pytest.mark.parametrize("steps,k", [(7, 2), (6, 3), (1, 4)])
@pytest.mark.parametrize("exchange", ["p2p", "gather"])
def test_exchange_stats_match_reference_model(exchange, steps, k):
    """ceil(steps/k) exchanges; bytes by the reference's decomposition and
    strip formulas; one strip gather per gather launch, two neighbor
    permutes (2 (ns-1) sends) per p2p launch."""
    ref_lay, _ = _layouts(FRAC, R, M)
    ref = ref_lay.strip_decomposition(NS)
    eng = _engine("fused", exchange, "gray-scott", fusion_k=k)
    b, nc, item = 2, 2, 4
    eng.run(eng.from_dense(_start("gray-scott", b)), steps)
    st, launches = eng.exchange_stats(), math.ceil(steps / k)
    depths = [k] * (steps // k) + ([steps % k] if steps % k else [])
    assert st.steps == steps and st.collectives == launches
    transfers = eng.transfer_counts()
    if exchange == "p2p":
        assert st.bytes_gathered == 0
        assert st.bytes_permuted == sum(
            ref.wire_bytes_per_exchange(d, item, b * nc) for d in depths)
        assert st.neighbor_sends == launches * 2 * (NS - 1)
        assert transfers == dict(all_gather=0, permute=2 * launches,
                                 send=2 * (NS - 1) * launches)
        assert eng.wire_bytes_per_device(k, b) == \
            ref.wire_bytes_per_device_per_exchange(k, item, b * nc)
    else:
        nbp = -(-ref_lay.n_blocks // NS) * NS
        assert st.bytes_gathered == sum(
            b * nc * nbp * 4 * d * ref_lay.rho * item for d in depths)
        assert st.bytes_permuted == st.neighbor_sends == 0
        assert transfers == dict(all_gather=launches, permute=0, send=0)
        assert eng.wire_bytes_per_device(k, b) == \
            b * nc * (nbp - nbp // NS) * 4 * k * ref_lay.rho * item
    assert st.exchanged_bytes == st.bytes_gathered + st.bytes_permuted
    eng.reset_exchange_stats()
    assert eng.exchange_stats().collectives == 0
    assert sum(eng.transfer_counts().values()) == 0


def test_step_k_run_keeps_the_input_and_memory_bytes():
    eng = _engine("fused", "p2p", "life", fusion_k=2)
    x = eng.from_dense(_start("life", 1)[0])
    kept = tuple(s.clone() for s in x)
    one = eng.step_k(x, 3)
    np.testing.assert_array_equal(eng.to_dense(one).numpy(),
                                  _reference("life", 1, 3)[0])
    out = eng.run(x, STEPS)
    assert all(torch.equal(a, b) for a, b in zip(x, kept))   # not written
    again = eng.run(x, STEPS)   # a second run from the kept input
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert eng.run(kept, 0) is kept
    assert eng.memory_bytes() == eng.nb_padded * 16
    with pytest.raises(ValueError, match="steps"):
        eng.run(kept, -1)
    with pytest.raises(ValueError, match="shards"):
        eng.run(kept[:3], 1)


def test_fusion_k_bounds_and_degenerate_meshes():
    with pytest.raises(ValueError, match="fusion_k"):
        _engine("fused", "auto", "life", fusion_k=5)
    with pytest.raises(ValueError, match="fusion_k"):
        _engine("jnp", "auto", "life", fusion_k=0)
    with pytest.raises(ValueError, match="k <= rho"):
        _engine("fused", "p2p", "life").step_k(
            _engine("fused", "p2p", "life").init_random(0), 5)
    with pytest.raises(ValueError, match="macro_p"):
        _engine("fused", "auto", "life", macro_p=2)
    with pytest.raises(ValueError, match="compute"):
        _engine("pallas", "auto", "life")
    with pytest.raises(ValueError, match="exchange"):
        _engine("jnp", "ring", "life")
    # 32 shards over 16 occupied block rows: degenerate
    with pytest.raises(ValueError, match="degenerate"):
        _engine("fused", "p2p", "life", ns=32)
    eng = _engine("fused", "auto", "life", ns=32)
    assert eng.exchange_mode == "gather" and not eng.decomp.valid
    out = eng.run(eng.from_dense(_start("life", 1)[0]), STEPS)
    np.testing.assert_array_equal(eng.to_dense(out).numpy(),
                                  _reference("life", 1, STEPS)[0])
    assert _engine("fused", "auto", "life").exchange_mode == "p2p"


def test_devices_default_to_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        shard_devices(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_engine("dist-fused", tf.SIERPINSKI, R, M)
    assert shard_devices(3, "cpu") == (torch.device("cpu"),) * 3
    assert shard_devices(None, "cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="n_shards"):
        shard_devices(0, "cpu")


# ------------------------------------------------- kinds, spec, runner
@pytest.mark.parametrize("kind,compute", [("dist-block", "jnp"),
                                          ("dist-fused", "fused"),
                                          ("dist-mxu", "mxu")])
def test_make_engine_dist_kinds(kind, compute, monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    eng = make_engine(kind, tf.SIERPINSKI, R, M, workload=trules.HEAT,
                      device="cpu", n_shards=NS, exchange="gather")
    assert isinstance(eng, DistributedSqueezeEngine)
    assert (eng.compute, eng.n_shards, eng.exchange_mode) == \
        (compute, NS, "gather")
    assert eng.effective_fusion_k == 2
    out = eng.run(eng.from_dense(_start("heat", 1)[0]), STEPS)
    np.testing.assert_allclose(eng.to_dense(out).numpy(),
                               _reference("heat", 1, STEPS)[0],
                               rtol=1e-5, atol=1e-5)


def test_spec_dist_knobs_match_reference_canonical(monkeypatch):
    monkeypatch.setenv("SQUEEZE_TUNING", "off")  # pin the heuristic k
    for kind in ("dist-mxu", "dist-block", "cuda-fused", "cell"):
        ref_kind = kind.replace("cuda", "pallas")
        ref = RefSpec(ref_kind, 2, FRAC, R, M, "life", None, 3, "gather",
                      (4,)).canonical()
        port = EngineSpec(kind, 2, FRAC, R, M, "life", None, 3, "gather",
                          (4,)).canonical()
        assert (port.m, port.fusion_k, port.macro_p, port.exchange,
                port.mesh_shape) == (ref.m, ref.fusion_k, ref.macro_p,
                                     ref.exchange, ref.mesh_shape)
    norm = EngineSpec.from_args("dist-mxu", tf.SIERPINSKI, R, M,
                                n_shards=4).normalize()
    assert norm.fusion_k == 2 and norm.macro_p is None
    assert norm.n_shards == 4 and norm.exchange == "auto"
    with pytest.raises(ValueError, match="exchange"):
        EngineSpec("dist-fused", 2, FRAC, R, M, exchange="ring").canonical()
    with pytest.raises(ValueError, match="mesh_shape"):
        EngineSpec("dist-fused", 2, FRAC, R, M,
                   mesh_shape=(0,)).canonical()


def test_runner_dist_kind_matches_engine():
    runner = BatchedRunner(device="cpu")
    spec = EngineSpec.from_args("dist-mxu", tf.SIERPINSKI, R, M,
                                trules.LIFE, n_shards=NS)
    states = runner.init_batch(spec, [0, 1])
    assert len(states) == NS and states[0].shape[0] == 2
    eng = runner.engine_for(spec)
    want = torch.stack([make_engine("block", tf.SIERPINSKI, R, M,
                                    device="cpu").run(s, 5)
                        for s in eng.to_dense(states)])
    out = runner.run(spec, states, 5)
    assert torch.equal(eng.to_dense(out), want)
    assert torch.equal(eng.to_dense(runner.step(spec, states)),
                       torch.stack([make_engine(
                           "block", tf.SIERPINSKI, R, M,
                           device="cpu").step(s)
                           for s in eng.to_dense(states)]))
    assert runner.to_expanded(spec, out).shape == (2, 64, 64)
    assert runner.stats.builds == 1


def _cache_sequence(runner, key, run):
    """is_cached before and after ``run()``, then invalidate twice."""
    seq = [runner.is_cached(*key)]
    run()
    return seq + [runner.is_cached(*key), runner.invalidate(*key),
                  runner.is_cached(*key), runner.invalidate(*key),
                  runner.cache_size()]


@pytest.mark.parametrize("kind", ["block", "dist-fused"])
def test_runner_is_cached_and_invalidate_match_reference(kind):
    """The port's runner answers the reference runner's sequence of calls
    (cold, warm after a run, dropped once) the same way, for a plain kind
    and a dist kind."""
    ref_runner, ref_frac = RefRunner(), rf.REGISTRY[FRAC]
    ref_key = ("block", ref_frac, R, M)
    want = _cache_sequence(ref_runner, ref_key, lambda: ref_runner.run(
        *ref_key[:3], ref_runner.init_batch(*ref_key[:3], [0], M), 2, M))
    runner, frac = BatchedRunner(device="cpu"), tf.REGISTRY[FRAC]
    if kind == "block":
        key = (kind, frac, R, M)
        run = lambda: runner.run(  # noqa: E731
            kind, frac, R, runner.init_batch(kind, frac, R, [0], M), 2, M)
    else:
        key = (EngineSpec.from_args(kind, frac, R, M, n_shards=NS),)
        run = lambda: runner.run(  # noqa: E731
            key[0], runner.init_batch(key[0], [0]), 2)
    assert _cache_sequence(runner, key, run) == want == \
        [False, True, True, False, False, 0]


def test_place_batch_spreads_whole_simulations():
    runner = BatchedRunner(device="cpu")
    eng = make_engine("cuda-fused", tf.SIERPINSKI, R, M, device="cpu")
    states = torch.stack([eng.init_random(i) for i in range(3)])
    parts = runner.place_batch(states, ["cpu", "cpu"])
    assert [p.shape[0] for p in parts] == [2, 1]
    out = [runner.run("cuda-fused", tf.SIERPINSKI, R, p, 5, m=M)
           for p in parts]
    want = runner.run("cuda-fused", tf.SIERPINSKI, R, states, 5, m=M)
    assert torch.equal(torch.cat(out), want)
    stepped = [runner.step("cuda-fused", tf.SIERPINSKI, R, p, m=M)
               for p in parts]
    assert torch.equal(torch.cat(stepped),
                       runner.step("cuda-fused", tf.SIERPINSKI, R, states,
                                   m=M))


def test_dist_engine_is_a_frozen_dataclass_with_its_own_stats():
    a = _engine("fused", "p2p", "life")
    b = _engine("fused", "p2p", "life")
    a.run(a.init_random(0), 2)
    assert a.exchange_stats().collectives == 1
    assert b.exchange_stats().collectives == 0
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.compute = "mxu"
