"""The port's checkpoint manager (`repro_torch.checkpoint`) against the
JAX package's: the twins of `tests/test_substrate.py`'s four checkpoint
tests, the same `manifest.json` byte for byte for a tree of the same
structure, and each package restoring the other's checkpoint."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.checkpoint import CheckpointManager as RefManager
from repro.optim import adamw_init as ref_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten_with_names
from repro_torch.optim import adamw_init


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": [torch.ones((2,), dtype=torch.int32), torch.zeros((5,))]}
    mgr.save(10, tree)
    back = mgr.restore(10, tree)
    for x, y in zip(pytree.tree_leaves(tree), pytree.tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"x": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.arange(1000.0)}
    mgr.save(5, tree, blocking=False)
    tree["x"].add_(1.0)            # the next step writes in place: the
    mgr.wait()                     # snapshot was taken at save
    assert mgr.latest_step() == 5
    back = mgr.restore(5, tree)
    assert torch.equal(back["x"], torch.arange(1000.0))


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros((4,))})
    with pytest.raises(ValueError):
        mgr.restore(1, {"x": torch.zeros((5,))})


def _pair_trees():
    """A train state of the same structure in both packages: (params,
    AdamWState) with nested dicts, a list and mixed key orders."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "layers": [{"b": rng.standard_normal(4).astype(np.float32),
                          "a": rng.standard_normal((2, 2)).astype(
                              np.float32)}],
              "emb": rng.standard_normal((5, 3)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    tp = pytree.tree_map(torch.from_numpy, params)
    return (jp, ref_adamw_init(jp)), (tp, adamw_init(tp))


def test_manifest_is_the_references_byte_for_byte(tmp_path):
    """The reference's leaf order (dict keys sorted) and `keystr` names."""
    jtree, ttree = _pair_trees()
    RefManager(str(tmp_path / "ref")).save(7, jtree)
    CheckpointManager(str(tmp_path / "port")).save(7, ttree)
    want = (tmp_path / "ref" / "step_7" / "manifest.json").read_bytes()
    got = (tmp_path / "port" / "step_7" / "manifest.json").read_bytes()
    assert got == want
    names = list(json.loads(got)["leaves"])
    assert names[:2] == ["[0]['emb']", "[0]['layers'][0]['a']"]
    assert "[1].step" in names and "[1].mu['w']" in names
    assert [n for n, _ in flatten_with_names(ttree)] == names
    for i in range(len(names)):
        a = np.load(tmp_path / "ref" / "step_7" / f"leaf_{i}.npy")
        b = np.load(tmp_path / "port" / "step_7" / f"leaf_{i}.npy")
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_each_package_restores_the_others_checkpoint(tmp_path):
    jtree, ttree = _pair_trees()
    jtree = jax.tree.map(lambda x: x + 1, jtree)        # distinct values
    RefManager(str(tmp_path / "ref")).save(3, jtree)
    CheckpointManager(str(tmp_path / "port")).save(3, ttree)
    got = CheckpointManager(str(tmp_path / "ref")).restore(3, ttree)
    assert isinstance(got[1], type(ttree[1]))
    # leaf for leaf by name (torch's pytree keeps dict insertion order,
    # jax's sorts)
    for (n, g), (m, w), (_, like) in zip(flatten_with_names(got),
                                         flatten_with_names(jtree),
                                         flatten_with_names(ttree)):
        assert n == m
        assert isinstance(g, torch.Tensor) and g.dtype == like.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = RefManager(str(tmp_path / "port")).restore(3, jtree)
    for b, t in zip(jax.tree.leaves(back), flatten_with_names(ttree)):
        np.testing.assert_array_equal(np.asarray(b), t[1].numpy())


def test_restore_takes_likes_dtype_and_refuses_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.arange(4.0), "n": torch.tensor(3,
                                                          dtype=torch.int32)})
    back = mgr.restore(1, {"x": torch.zeros(4, dtype=torch.float64),
                           "n": torch.zeros((), dtype=torch.int32)})
    assert back["x"].dtype == torch.float64 and int(back["n"]) == 3
    with pytest.raises(TypeError, match="numpy cannot hold"):
        mgr.save(2, {"x": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(1, {"y": torch.zeros(4)})


def test_async_writer_error_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_1.tmp").write_text("in the way")  # not a directory
    mgr.save(1, {"x": torch.zeros(2)}, blocking=False)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                          # raised once
    assert mgr.steps() == []
