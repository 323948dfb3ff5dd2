"""qwen2-0.5b's `train_loop` settings (fp32, 8 x 512, lr 3e-4, warmup
steps // 10, 12 steps) run by both packages on the CPU, from the same
initial parameters and the same data, to tell a fault of the port from
the reference's own behaviour at full vocabulary.

The model is qwen2-0.5b at its published width and vocabulary (d 896,
14 / 2 heads of 64, d_ff 4864, 151,936 tokens, tied) cut to `--layers`
layers (default 2; the full 24 need some tens of GB on the CPU).  Each
package runs in a process of its own, so neither imports the other:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/train_parity_cpu.py \\
        --package jax --out DIR      # the reference's train_loop; saves
                                     # its initial params and losses
    PYTHONPATH=src python tools/train_parity_cpu.py --package torch \\
        --out DIR                    # the port's train step from those
                                     # params, over the same batches
    python tools/train_parity_cpu.py --compare --out DIR

Each package also saves its gradients at the initial parameters on the
first batch (`grads_<package>.npz`) and its parameters after the last
step (`final_<package>.npz`).  `--compare` prints one JSON line: both
loss trajectories, their largest step-for-step gap, each run's mean of
the first and last five losses with the learning criterion of
`tests/test_system.py::test_train_loop_reduces_loss` (a fall of 0.05),
and, leaf by leaf in the port's layout, the largest element gap of the
two packages' gradients and of their final parameters over the leaf's
largest magnitude in the reference, with the count of elements past
`LEAF_TOL` of it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH = "qwen2-0.5b"
RUN = {"steps": 12, "global_batch": 8, "seq_len": 512, "lr": 3e-4,
       "seed": 0}
LEARNS_BY = 0.05
# the bar of chip_smoke's train phase: an element's gap over its leaf's
# largest magnitude
LEAF_TOL = 1e-5


def run_jax(layers: int, out: Path) -> dict:
    import jax

    from repro import configs
    from repro.data import SyntheticLMDataset
    from repro.launch.steps import build_model
    from repro.launch.train import train_loop
    from repro.models.layers import Runtime

    def save(name, tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        np.savez(out / name, **{jax.tree_util.keystr(k): np.asarray(v)
                                for k, v in leaves})

    arch = dataclasses.replace(configs.get_arch(ARCH), num_layers=layers)
    model = build_model(arch)
    rt = Runtime(compute_dtype=np.float32)
    # train_loop's own initial parameters: PRNGKey(seed), fp32
    init = model.init(jax.random.PRNGKey(RUN["seed"]), rt)
    save("init.npz", init)
    # the train step's gradients at them, on the first batch
    batch = _dataset(SyntheticLMDataset, arch).global_batch_at(0)
    _, grads = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss(p, b, rt)))(
            init, {k: jax.numpy.asarray(v) for k, v in batch.items()})
    save("grads_jax.npz", grads)
    del init, grads
    t0 = time.time()
    res = train_loop(arch, steps=RUN["steps"],
                     global_batch=RUN["global_batch"],
                     seq_len=RUN["seq_len"], lr=RUN["lr"], seed=RUN["seed"],
                     log_every=1)
    seconds = time.time() - t0
    save("final_jax.npz", res["params"])
    return {"losses": [float(x) for x in res["losses"]],
            "seconds": seconds, "n_params": res["n_params"]}


def _dataset(cls, arch):
    return cls(vocab_size=arch.vocab_size, seq_len=RUN["seq_len"],
               global_batch=RUN["global_batch"], seed=RUN["seed"])


def _nest(flat: dict) -> dict:
    """The reference's parameter tree from `keystr` names such as
    ``['groups'][0][0]['attn']['wq']``."""
    import re

    tree: dict = {}
    for name, arr in flat.items():
        keys = [int(k) if k.isdigit() else k.strip("'")
                for k in re.findall(r"\[([^\]]+)\]", name)]
        node = tree
        for k, nxt in zip(keys[:-1], keys[1:]):
            node = node.setdefault(k, {})
        node[keys[-1]] = arr

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def run_torch(layers: int, out: Path) -> dict:
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import SyntheticLMDataset, make_batch_iterator
    from repro_torch.launch.steps import (build_model, loss_and_grads,
                                          make_train_step)
    from repro_torch.launch.train import to_device
    from repro_torch.models.layers import Runtime
    from repro_torch.optim import adamw_init

    arch = dataclasses.replace(configs.get_arch(ARCH), num_layers=layers)
    with np.load(out / "init.npz") as z:
        params = params_from_numpy(arch, _nest(dict(z)))
    model = build_model(arch)
    rt = Runtime(compute_dtype=torch.float32)
    steps = RUN["steps"]
    # as train_loop: warmup steps // 10, total steps
    step_fn = make_train_step(model, rt, base_lr=RUN["lr"],
                              warmup_steps=max(steps // 10, 1),
                              total_steps=steps)
    opt_state = adamw_init(params)

    def save(name, tree):
        leaves, _ = pytree.tree_flatten_with_path(tree)
        np.savez(out / name, **{pytree.keystr(k): v.detach().numpy()
                                for k, v in leaves})

    it = make_batch_iterator(_dataset(SyntheticLMDataset, arch),
                             start_step=0)
    _, grads = loss_and_grads(model, rt, params, to_device(
        _dataset(SyntheticLMDataset, arch).global_batch_at(0), "cpu"))
    save("grads_torch.npz", pytree.tree_unflatten(
        grads, pytree.tree_structure(params)))
    del grads
    losses = []
    t0 = time.time()
    for step in range(steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             to_device(next(it), "cpu"))
        losses.append(float(metrics["loss"]))
        print(f"[torch] step={step:3d} loss={losses[-1]:.6f} "
              f"({time.time() - t0:.1f}s)", flush=True)
    seconds = time.time() - t0
    save("final_torch.npz", params)
    return {"losses": losses, "seconds": seconds,
            "n_params": sum(p.numel() for p in pytree.tree_leaves(params))}


def leaf_gaps(layers: int, out: Path, what: str) -> dict:
    """For `what` ("grads" or "final"), by leaf of the port's layout: the
    largest gap of the two packages' elements over the reference leaf's
    largest magnitude, and the elements past `LEAF_TOL` of it."""
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.convert import params_from_numpy

    arch = dataclasses.replace(configs.get_arch(ARCH), num_layers=layers)
    with np.load(out / f"{what}_jax.npz") as z:
        ref = params_from_numpy(arch, _nest(dict(z)))
    with np.load(out / f"{what}_torch.npz") as z:
        port = dict(z)
    gaps = {}
    for path, r in pytree.tree_flatten_with_path(ref)[0]:
        r = r.double().numpy()
        err = np.abs(port[pytree.keystr(path)].astype(np.float64) - r)
        scale = max(float(np.abs(r).max()), 1e-30)
        gaps[pytree.keystr(path)] = {
            "gap": float(err.max()) / scale,
            "past": int((err > LEAF_TOL * scale).sum()), "size": r.size}
    return gaps


def summary(losses) -> dict:
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    return {"first5": first, "last5": last, "fall": first - last,
            "learns": bool(last < first - LEARNS_BY)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--package", choices=("jax", "torch"))
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.compare:
        runs = {p: json.loads((out / f"{p}.json").read_text())
                for p in ("jax", "torch")}
        gap = max(abs(a - b) for a, b in zip(runs["jax"]["losses"],
                                             runs["torch"]["losses"]))
        layers = runs["jax"]["layers"]
        print(json.dumps({
            "arch": ARCH, **RUN, "layers": layers,
            "max_abs_loss_gap": gap,
            **{p: {**r, **summary(r["losses"])} for p, r in runs.items()},
            **{what: leaf_gaps(layers, out, what)
               for what in ("grads", "final")}}))
        return 0
    run = run_jax if args.package == "jax" else run_torch
    res = {"layers": args.layers, **run(args.layers, out)}
    (out / f"{args.package}.json").write_text(json.dumps(res))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
