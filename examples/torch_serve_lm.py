"""End-to-end serving example on the PyTorch port: batched requests through
the slot-based continuous-batching loop (prefill + per-step decode with KV
caches).

  PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2-0.5b \\
      --requests 10 --batch 4 --max-new 12

The reference example's flags (`examples/serve_lm.py`) plus `--device`
(default `cuda`: without a GPU the run fails unless `--device cpu`).  The
weights are random, drawn from `--seed` by a `torch.Generator`, so the
generated tokens are not the reference example's.
"""

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.launch.serve import serve_requests


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-0.5b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run (cuda or cpu)")
    args = ap.parse_args()

    arch = configs.get_smoke(args.arch)
    rng = np.random.default_rng(args.seed)
    prompts = [list(map(int, rng.integers(1, arch.vocab_size,
                                          size=int(rng.integers(4, 16)))))
               for _ in range(args.requests)]

    t0 = time.time()
    results = serve_requests(arch, prompts, batch=args.batch,
                             max_new=args.max_new, seed=args.seed,
                             device=args.device)
    dt = time.time() - t0
    n_tok = sum(len(r.generated) for r in results)
    print(f"{len(results)} requests, {n_tok} tokens, {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s, pool={args.batch})")
    for r in results:
        print(f"  req{r.request_id:02d} prompt[{len(r.prompt):2d}] -> "
              f"{r.generated}")


if __name__ == "__main__":
    main()
