"""Trainer CLI, the twin of `repro.launch.train`.

Runs a real training loop (synthetic data pipeline -> train step ->
checkpoint manager) for any `--arch`, at smoke scale with `--smoke` so it
runs on the CPU; without it at the published widths on the card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --smoke --steps 60 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
      --smoke --steps 30 --resume --ckpt-dir /tmp/ck --device cpu

The reference's flags plus `--device` (default `cuda`: without a GPU the
CLI raises unless `--device cpu` is passed).  The parameters come from a
`torch.Generator` seeded with `--seed`, so the losses are not the
reference's from the same seed; its data are (`data.SyntheticLMDataset`).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.costmodel import resolve_device
from repro_torch.data import SyntheticLMDataset, make_batch_iterator
from repro_torch.launch.steps import build_model, make_train_step
from repro_torch.models.layers import Runtime
from repro_torch.optim import adamw_init

__all__ = ["train_loop", "to_device", "main"]


def to_device(batch, device) -> dict:
    """A numpy batch as tensors on `device`, integer arrays as int64 (the
    index dtype of the embedding and the one-hot)."""
    return {k: torch.from_numpy(np.asarray(
        v, np.int64 if np.asarray(v).dtype.kind in "iu" else None)).to(device)
        for k, v in batch.items()}


def train_loop(arch, *, steps: int, global_batch: int, seq_len: int,
               ckpt_dir: str | None = None, resume: bool = False,
               save_every: int = 0, lr: float = 3e-4, seed: int = 0,
               microbatches: int = 1, log_every: int = 10,
               compute_dtype=torch.float32, device="cuda") -> dict:
    dev = resolve_device(device)
    rt = Runtime(compute_dtype=compute_dtype)
    model = build_model(arch)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), rt)
    opt_state = adamw_init(params)
    n_params = sum(p.numel() for p in pytree.tree_leaves(params))

    step_fn = make_train_step(model, rt, base_lr=lr,
                              warmup_steps=max(steps // 10, 1),
                              total_steps=steps, microbatches=microbatches)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr and resume:
        last = mgr.latest_step()
        if last is not None:
            params, opt_state = mgr.restore(last, (params, opt_state))
            start_step = last
            print(f"[train] resumed from step {start_step}")

    extras = None
    if arch.frontend == "vit_stub":
        rng = np.random.default_rng(seed)
        def extras(step):
            return {"patch_embeds": rng.standard_normal(
                (global_batch, arch.num_patches, arch.d_model),
                dtype=np.float32)}
        seq_text = seq_len - arch.num_patches
    else:
        seq_text = seq_len
    if arch.is_encdec:
        rng = np.random.default_rng(seed)
        def extras(step):
            return {"frames": rng.standard_normal(
                (global_batch, arch.encoder_seq, arch.d_model),
                dtype=np.float32)}

    ds = SyntheticLMDataset(vocab_size=arch.vocab_size, seq_len=seq_text,
                            global_batch=global_batch, seed=seed)
    it = make_batch_iterator(ds, start_step=start_step, extras_fn=extras)

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch = to_device(next(it), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t0
            print(f"[train] step={step:5d} loss={loss:8.4f} "
                  f"gnorm={float(metrics['grad_norm']):7.3f} "
                  f"lr={float(metrics['lr']):.2e} ({dt:.1f}s)")
        if mgr and save_every and (step + 1) % save_every == 0:
            mgr.save(step + 1, (params, opt_state), blocking=False)
    if mgr:
        mgr.save(steps, (params, opt_state), blocking=True)
    return {"losses": losses, "n_params": n_params,
            "final_loss": losses[-1] if losses else float("nan"),
            "params": params}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU scale)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    arch = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_arch(args.arch)
    res = train_loop(arch, steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     resume=args.resume, save_every=args.save_every,
                     lr=args.lr, seed=args.seed,
                     microbatches=args.microbatches, device=args.device)
    print(f"[train] done: {res['n_params']/1e6:.2f}M params, "
          f"loss {res['losses'][0]:.4f} -> {res['final_loss']:.4f}")


if __name__ == "__main__":
    main()
