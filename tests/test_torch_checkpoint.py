"""The port's checkpoint manager against the reference's: the same files
on disk (leaf names and order, ``meta.json``, the ``.npy`` bytes, crc32,
``@sNNN`` shards), a checkpoint written by either package restored by the
other bit for bit (sharded too), and crc32 damage, truncation and the
fallback to the previous intact step agreeing."""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint.manager import (CheckpointCorruptError as RefCorrupt,
                                      CheckpointManager as RefManager)
from repro.runtime import fault as rfault
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager)
from repro_torch.runtime import fault

RNG = np.random.default_rng(0)
TREES = {
    "state": {"state": RNG.integers(0, 2, (27, 4, 4)).astype(np.uint8)},
    "nested": {"w": RNG.random((3, 5)).astype(np.float32),
               "b": [np.arange(4, dtype=np.int64),
                     (np.float32(2.5), RNG.random((2, 2, 6)))],
               "a": {"z": np.array(7, np.int32), "y": None}},
    "heat": {"state": RNG.random((2, 9, 3, 3)).astype(np.float32)},
}


def _as_torch(tree):
    """The same tree with torch tensors for leaves."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return None if tree is None else torch.as_tensor(np.asarray(tree))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def _assert_same(got, want):
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _files(path):
    return {fn: open(os.path.join(path, fn), "rb").read()
            for fn in sorted(os.listdir(path))}


@pytest.mark.parametrize("sharded", [0, 3])
@pytest.mark.parametrize("name", sorted(TREES))
def test_same_files_on_disk(tmp_path, name, sharded):
    """The port writes what the reference writes: file names, meta.json
    (leaf names, shapes, dtypes, crc32, the shard split) and the .npy
    bytes, from torch tensors or numpy arrays alike."""
    tree = TREES[name]
    mine, ref = tmp_path / "mine", tmp_path / "ref"
    for mgr, t in ((CheckpointManager(str(mine)), _as_torch(tree)),
                   (RefManager(str(ref)), tree)):
        if sharded:
            mgr.save_sharded(5, t, n_shards=sharded, axis=0)
        else:
            mgr.save(5, t)
    got, want = _files(mine / "step_00000005"), \
        _files(ref / "step_00000005")
    assert got == want
    meta = json.loads(got["meta.json"])
    assert meta["step"] == 5 and ("sharded" in meta) == bool(sharded)


@pytest.mark.parametrize("sharded", [0, 2, 4])
@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("name", sorted(TREES))
def test_restores_across_packages(tmp_path, name, writer, sharded):
    tree = TREES[name]
    mgr_w = (CheckpointManager if writer == "port" else RefManager)(
        str(tmp_path))
    mgr_r = (RefManager if writer == "port" else CheckpointManager)(
        str(tmp_path))
    src = _as_torch(tree) if writer == "port" else tree
    if sharded:
        mgr_w.save_sharded(3, src, n_shards=sharded, axis=0)
    else:
        mgr_w.save(3, src)
    like = tree if writer == "port" else _as_torch(tree)
    _assert_same(mgr_r.restore(like), tree)
    assert mgr_r.latest_step() == 3


def test_restore_into_the_structure_and_put_hook(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = TREES["nested"]
    mgr.save(1, tree)
    names = []
    back = mgr.restore(_as_torch(tree), put=lambda n, a: (
        names.append(n), torch.from_numpy(a))[1])
    assert names == ["a__z", "b__0", "b__1__0", "b__1__1", "w"]
    assert isinstance(back["b"][1], tuple) and back["a"]["y"] is None
    assert isinstance(back["w"], torch.Tensor)
    _assert_same(back, tree)


def test_keep_k_partial_writes_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = TREES["state"]
    for s in (1, 2, 3):
        mgr.save(s, tree, blocking=(s != 2))
        mgr.wait()
    os.makedirs(tmp_path / "step_00000009.tmp")   # a crash mid-save
    assert mgr.all_steps() == [2, 3] == RefManager(str(tmp_path)).all_steps()
    assert mgr.latest_step() == 3
    mgr.save_sharded(4, _as_torch(tree), n_shards=3, blocking=False)
    mgr.wait()
    _assert_same(RefManager(str(tmp_path)).restore(tree, step=4), tree)
    with pytest.raises(ValueError):
        mgr.save_sharded(5, tree, n_shards=0)
    with pytest.raises(ValueError):
        mgr.restore({"state": np.zeros((3, 4, 4), np.uint8)})


@pytest.mark.parametrize("sharded", [0, 3])
@pytest.mark.parametrize("mode", ["corrupt", "truncate"])
@pytest.mark.parametrize("damager", ["port", "reference"])
def test_damage_and_fallback_agree(tmp_path, damager, mode, sharded):
    """Damage the newest step (all its leaves, or one shard chunk): both
    packages refuse it and fall back to the same previous step."""
    tree = {"state": TREES["state"]["state"], "w": TREES["nested"]["w"]}
    mgr = CheckpointManager(str(tmp_path))
    for step in (1, 2):
        t = {k: v + step for k, v in tree.items()}
        if sharded:
            mgr.save_sharded(step, t, n_shards=sharded, axis=0)
        else:
            mgr.save(step, t)
    path = tmp_path / "step_00000002"
    if sharded:       # one chunk of one leaf
        meta = json.loads((path / "meta.json").read_text())
        chunk = [d["file"] for d in meta["leaves"]
                 if d["name"] == "state@s001"][0]
        keep = {fn: (path / fn).read_bytes() for fn in os.listdir(path)
                if fn.endswith(".npy") and fn != chunk}
    (fault if damager == "port" else rfault).damage_checkpoint(
        str(path), mode=mode)
    if sharded:
        for fn, data in keep.items():
            (path / fn).write_bytes(data)
    for mgr_cls, err in ((CheckpointManager, CheckpointCorruptError),
                         (RefManager, RefCorrupt)):
        m = mgr_cls(str(tmp_path))
        with pytest.raises(err):
            m.restore(tree)
        step, back = m.restore_with_fallback(tree)
        assert step == 1
        _assert_same(back, {k: v + 1 for k, v in tree.items()})
    (fault if damager == "port" else rfault).damage_checkpoint(
        str(tmp_path / "step_00000001"), mode=mode)
    with pytest.raises(CheckpointCorruptError):
        CheckpointManager(str(tmp_path)).restore_with_fallback(tree)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore_with_fallback(tree)
