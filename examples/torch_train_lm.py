"""End-to-end training driver on the PyTorch port: data pipeline -> train
step -> checkpointing -> resume, for any --arch at a configurable scale.

CPU demo (seconds):
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu

~100M-parameter run on the card:
  PYTHONPATH=src python examples/torch_train_lm.py --d-model 768 \\
      --layers 12 --vocab 32768 --steps 300 --batch 8 --seq 512

The reference example's flags (`examples/train_lm.py`) plus `--device`
(default `cuda`: without a GPU the run fails unless `--device cpu`).
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.launch.train import train_loop


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (scales the smoke config up)")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda or cpu)")
    args = ap.parse_args()

    arch = configs.get_smoke(args.arch)
    over = {}
    if args.d_model:
        over.update(d_model=args.d_model, head_dim=args.d_model // 12,
                    num_heads=12, num_kv_heads=4, d_ff=4 * args.d_model)
    if args.layers:
        over["num_layers"] = args.layers
    if args.vocab:
        over["vocab_size"] = args.vocab
    if over:
        arch = dataclasses.replace(arch, **over)

    res = train_loop(arch, steps=args.steps, global_batch=args.batch,
                     seq_len=args.seq, ckpt_dir=args.ckpt_dir,
                     resume=args.resume, save_every=max(args.steps // 4, 1),
                     lr=args.lr, device=args.device)
    print(f"\n{res['n_params']/1e6:.1f}M params | "
          f"loss {res['losses'][0]:.4f} -> {res['final_loss']:.4f} "
          f"over {len(res['losses'])} steps | checkpoints in "
          f"{args.ckpt_dir}")


if __name__ == "__main__":
    main()
