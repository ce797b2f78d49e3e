"""The port's data pipeline (``repro_torch.data.pipeline``) against the
reference's: batches bit for bit equal for the same seed, step and shard;
``MemmapCorpus`` crops of one file equal; the ``Prefetcher`` yields in
order and ``close()`` ends its thread."""
import numpy as np
import pytest

from repro.data import pipeline as R
from repro_torch.data import pipeline as T


@pytest.mark.parametrize("seed", [0, 5, 1234])
@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 4), (3, 4)])
def test_synthetic_batches_equal_reference(seed, shard, n_shards):
    kw = dict(vocab=97, seq_len=24, global_batch=8, seed=seed,
              p_signal=0.8, shard=shard, n_shards=n_shards)
    mine, ref = T.SyntheticMarkov(**kw), R.SyntheticMarkov(**kw)
    np.testing.assert_array_equal(mine._perm(), ref._perm())
    for step in (0, 1, 17, 1000):
        got, want = mine.batch(step), ref.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_batches_are_stateless_shifted_and_shard_disjoint():
    d = T.SyntheticMarkov(vocab=50, seq_len=16, global_batch=2, seed=0)
    b = d.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert not np.array_equal(d.batch(0)["tokens"], d.batch(1)["tokens"])
    shards = [T.SyntheticMarkov(vocab=97, seq_len=8, global_batch=8, seed=1,
                                shard=i, n_shards=4).batch(0)["tokens"]
              for i in range(4)]
    assert all(s.shape == (2, 8) for s in shards)
    assert len({s.tobytes() for s in shards}) == 4


def test_markov_signal_present():
    d = T.SyntheticMarkov(vocab=64, seq_len=512, global_batch=4, seed=2,
                          p_signal=0.9)
    b = d.batch(0)
    hits = (d._perm()[b["tokens"]] == b["labels"]).mean()
    assert 0.85 < hits < 0.95


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_memmap_corpus_equals_reference(tmp_path, dtype):
    path = str(tmp_path / "toks.bin")
    (np.arange(10000) % 300).astype(dtype).tofile(path)
    kw = dict(path=path, vocab=256, seq_len=64, global_batch=4, seed=3,
              dtype=dtype)
    for step in (0, 9):
        got = T.MemmapCorpus(**kw).batch(step)
        want = R.MemmapCorpus(**kw).batch(step)
        assert got["tokens"].shape == (4, 64)
        assert got["tokens"].max() <= 255          # clipped to the vocab
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_yields_in_order_and_closes():
    d = T.SyntheticMarkov(vocab=31, seq_len=8, global_batch=2, seed=4)
    pf = T.Prefetcher(d, start_step=10)
    try:
        for want in (10, 11, 12):
            step, batch = pf.next()
            assert step == want
            np.testing.assert_array_equal(batch["tokens"],
                                          d.batch(want)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()
