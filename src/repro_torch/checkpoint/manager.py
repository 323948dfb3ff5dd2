"""Checkpoint manager: atomic, async-capable save and restore of tensor
trees, the twin of `repro.checkpoint.manager`.

Layout:  <dir>/step_<k>/{manifest.json, leaf_<i>.npy ...}

* **The reference's files** — leaves are visited in the reference's tree
  order (dict keys sorted; lists, tuples and NamedTuples in order; None
  holds no leaf) and named as its `jax.tree_util.keystr` names them
  (``[0]['embed']``, ``[1].mu['embed']``), so a tree of the same
  structure gives a byte-identical `manifest.json`, and either package
  restores the other's checkpoint.
* **Atomicity** — a checkpoint is written to `step_<k>.tmp` and renamed
  into place; `steps()` sees only completed directories.
* **Async** — `save(..., blocking=False)` snapshots the tree to host
  memory synchronously (`.detach().cpu().numpy()`: the next step writes
  the parameters in place) and writes the files on a thread; `wait()`
  joins it and raises the writer's error.
* **Resume** — `latest_step()` + `restore(step, like=tree)` rebuild the
  tree with `like`'s dtypes, shapes and devices.
* **Retention** — the `keep_last` newest checkpoints are kept after each
  save.

A leaf dtype numpy cannot hold (bf16: this package does not depend on
`ml_dtypes`) raises; a train state is fp32 and int32.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten_with_names"]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_names(tree: Any, prefix: str = ""
                       ) -> List[Tuple[str, Any]]:
    """`(name, leaf)` pairs in the reference's order and with its
    `keystr` names."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in flatten_with_names(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [pair for f in tree._fields
                for pair in flatten_with_names(getattr(tree, f),
                                               f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, t in enumerate(tree)
                for pair in flatten_with_names(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten_like(like: Any, leaves) -> Any:
    """`like`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {k: _unflatten_like(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_unflatten_like(getattr(like, f), leaves)
                            for f in like._fields])
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten_like(t, leaves) for t in like)
    return next(leaves)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype in (torch.bfloat16, torch.float8_e4m3fn,
                          torch.float8_e5m2):
            raise TypeError(f"a {leaf.dtype} leaf: numpy cannot hold it "
                            "(checkpoint fp32 and int32 state)")
        # a copy even on the CPU: the next step writes the leaf in place
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        self.wait()                       # one in-flight save at a time
        # snapshot to host memory now: the next step writes the params and
        # moments in place
        named = [(n, _to_numpy(leaf)) for n, leaf in flatten_with_names(tree)]

        def _write():
            try:
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                manifest = {}
                for i, (name, arr) in enumerate(named):
                    fn = f"leaf_{i}.npy"
                    np.save(tmp / fn, arr)
                    manifest[name] = {"file": fn, "dtype": str(arr.dtype),
                                      "shape": list(arr.shape)}
                (tmp / "manifest.json").write_text(json.dumps(
                    {"step": step, "leaves": manifest}))
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
                self._gc()
            except BaseException as e:    # surfaced on the next wait()
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------- restore
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> Any:
        """The checkpoint of `step` in `like`'s structure: each leaf a
        tensor with the dtype and device of `like`'s leaf (numpy arrays
        where `like` holds numpy arrays), its shape checked."""
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())["leaves"]
        leaves = []
        for name, ref_leaf in flatten_with_names(like):
            if name not in manifest:
                raise KeyError(f"checkpoint missing leaf {name!r}")
            arr = np.load(d / manifest[name]["file"])
            want = tuple(getattr(ref_leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {name!r}: "
                                 f"{arr.shape} vs {want}")
            if isinstance(ref_leaf, torch.Tensor):
                arr = torch.from_numpy(arr).to(device=ref_leaf.device,
                                               dtype=ref_leaf.dtype)
            leaves.append(arr)
        return _unflatten_like(like, iter(leaves))
