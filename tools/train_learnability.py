"""How learnable the synthetic training stream is for a short run of
`train_loop`, and whether such a run learns it.

`SyntheticLMDataset` draws each step's batch with one multiplier `mix`
(1-6) and Zipf(1.2) increments `z` clipped to V - 1: tok[t] = (tok[t-1] *
mix + z[t]) mod V.  Given the previous token and `mix`, the next token is
a bijection of `z`, so its entropy is the clipped Zipf's, far below ln V;
but a model learns that map context by context, and a run sees each
(previous token, mix) context only as often as its tokens allow.

    python tools/train_learnability.py            # numpy and scipy only

prints one JSON line for each run shape in `SHAPES`: ln V; the entropy of
the next token given the previous one and `mix` (exact); the unigram
cross-entropy of 60 held-out batches under smoothed counts of 200 others;
the run's transitions per distinct context; and the share of the last
five steps' transitions whose context came up in an earlier step of the
run, all that a memorising model could have fitted before it.

    python tools/train_learnability.py --sweep    # on a CUDA device

also runs `train_loop` for qwen2-0.5b at full width (fp32, 8 x 512, the
CLI's warmup, steps // 10) at each (lr, steps) of `SWEEP` and prints its
losses, the means of the first and last five and their fall, the learning
criterion of `tests/test_system.py::test_train_loop_reduces_loss` (a fall
of at least 0.05).
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.data import SyntheticLMDataset  # noqa: E402

ZIPF_A = 1.2
# (name, vocab, steps, global batch, seq): qwen2-0.5b's full vocabulary at
# chip_smoke.py's `train_loop` run and the sweep's longest, and the smoke
# config's at tests/test_system.py's learning test
SHAPES = [("full", 151_936, 12, 8, 512), ("full", 151_936, 60, 8, 512),
          ("smoke", 512, 40, 8, 64)]
# (lr, steps) of train_loop at full width, 8 x 512
SWEEP = [(3e-4, 12), (3e-4, 30), (1e-3, 30), (3e-3, 30), (1e-3, 60)]


def zipf_entropy(vocab: int, a: float = ZIPF_A) -> float:
    """Entropy in nats of min(Zipf(a), vocab - 1): P(k) = k^-a / zeta(a)
    below vocab - 1, the rest of the mass at vocab - 1."""
    from scipy.special import zeta

    k = np.arange(1, vocab - 1, dtype=np.float64)
    p = k ** -a / zeta(a, 1)
    tail = zeta(a, vocab - 1) / zeta(a, 1)
    return float(-(p * np.log(p)).sum() - tail * math.log(tail))


def unigram_cross_entropy(vocab: int, batch: int, seq: int) -> float:
    """Targets of batches 200-259 under counts of batches 0-199's, each
    count smoothed by 0.01."""
    ds = SyntheticLMDataset(vocab_size=vocab, seq_len=seq,
                            global_batch=batch, seed=0)
    counts = np.zeros(vocab)
    for i in range(200):
        np.add.at(counts, ds.global_batch_at(i)["tokens"][:, 1:].ravel(), 1)
    logp = np.log((counts + 0.01) / (counts + 0.01).sum())
    return float(np.mean([-logp[ds.global_batch_at(i)["tokens"][:, 1:]]
                          .mean() for i in range(200, 260)]))


def contexts(vocab: int, steps: int, batch: int, seq: int) -> dict:
    """The run's (previous token, mix) contexts: transitions per distinct
    context, and the share of the last five steps' transitions whose
    context came up in an earlier step."""
    ds = SyntheticLMDataset(vocab_size=vocab, seq_len=seq,
                            global_batch=batch, seed=0)
    seen: set = set()
    n_all, seen_late, n_late = 0, 0, 0
    for step in range(steps):
        # the batch's multiplier, drawn after its increments (shard_batch)
        rng = ds._rng_for(step, 0)
        rng.zipf(ds.zipf_a, size=(batch, seq))
        mix = int(rng.integers(1, 7))
        prev = ds.global_batch_at(step)["tokens"][:, :-1].ravel()
        keys = prev.astype(np.int64) * 8 + mix
        if step >= steps - 5:
            seen_late += int(np.isin(keys, list(seen)).sum())
            n_late += keys.size
        n_all += keys.size
        seen.update(np.unique(keys).tolist())
    return {"transitions": n_all, "contexts": len(seen),
            "transitions_per_context": n_all / len(seen),
            "last5_seen_before": seen_late / n_late}


def stream_report() -> None:
    for name, vocab, steps, batch, seq in SHAPES:
        print(json.dumps({
            "stream": name, "vocab": vocab, "steps": steps, "batch": batch,
            "seq": seq, "ln_vocab": math.log(vocab),
            "entropy_given_prev_and_mix": zipf_entropy(vocab),
            "unigram_cross_entropy": unigram_cross_entropy(vocab, batch,
                                                           seq),
            **contexts(vocab, steps, batch, seq)}), flush=True)


def sweep() -> None:
    import subprocess

    import torch

    from repro_torch import configs
    from repro_torch.launch.train import train_loop

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), torch.__version__, flush=True)
    full = configs.get_arch("qwen2-0.5b")
    for lr, steps in SWEEP:
        t0 = time.perf_counter()
        losses = train_loop(full, steps=steps, global_batch=8, seq_len=512,
                            lr=lr, log_every=1000, device="cuda")["losses"]
        torch.cuda.empty_cache()
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        print(json.dumps({"sweep": "qwen2-0.5b 8 x 512 fp32", "lr": lr,
                          "steps": steps, "first5_mean": first,
                          "last5_mean": last, "learned_by": first - last,
                          "meets_criterion": first - last >= 0.05,
                          "seconds": time.perf_counter() - t0,
                          "losses": losses}), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also run SWEEP's train_loop runs on the card")
    args = ap.parse_args(argv)
    stream_report()
    if args.sweep:
        sweep()


if __name__ == "__main__":
    main()
