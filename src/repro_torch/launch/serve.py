"""Batched serving loop with slot-based continuous batching (the port's
twin of `repro.launch.serve`).

A fixed pool of `batch` decode slots; each incoming request claims a free
slot, is prefilled token by token through the decode step, then decodes
one token per step.  Finished slots (EOS or max_new) are refilled from the
queue at once.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --device cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --smoke --device cpu --requests 12 --batch 4 --max-new 16

Every arch serves, the encoder-decoder (`--arch whisper-medium`) through
`EncDecLM` as the reference's server runs it: its cross caches are zeroed
by `init_cache` and the encoder never runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.costmodel import resolve_device
from repro_torch.launch.steps import build_model, make_serve_step
from repro_torch.models.layers import Runtime

__all__ = ["ServeResult", "serve_requests", "main"]


@dataclasses.dataclass
class ServeResult:
    request_id: int
    prompt: List[int]
    generated: List[int]
    latency_s: float


def serve_requests(arch, prompts: List[List[int]], *, batch: int = 4,
                   max_len: int = 256, max_new: int = 16,
                   eos_id: Optional[int] = None, seed: int = 0,
                   device="cuda", params=None) -> List[ServeResult]:
    """Serve `prompts` greedily on `device`.  The weights are random,
    drawn from `seed`, unless `params` hands in a parameter dict (a test
    uses it to serve the reference's weights)."""
    dev = resolve_device(device)
    rt = Runtime(compute_dtype=torch.float32)
    model = build_model(arch)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = model.init(gen, rt)
    decode = make_serve_step(model, rt)

    def token(t):
        return torch.full((1, 1), int(t), dtype=torch.int64, device=dev)

    def position(p):
        return torch.full((), p, dtype=torch.int64, device=dev)

    results: List[ServeResult] = []
    queue = list(enumerate(prompts))
    # one position per slot; slots decode one after another
    pool: List[Optional[dict]] = [None] * batch

    while queue or any(s is not None for s in pool):
        for i in range(batch):
            if pool[i] is None and queue:
                rid, prompt = queue.pop(0)
                cache = model.init_cache(1, max_len, rt, dev)
                t0 = time.perf_counter()
                # prefill token by token (cache-correct and simple; the
                # batched prefill path is `make_prefill_step`)
                for pos, t in enumerate(prompt):
                    logits, cache = decode(params, cache, token(t),
                                           position(pos))
                pool[i] = {"rid": rid, "prompt": prompt, "cache": cache,
                           "pos": len(prompt), "out": [], "t0": t0,
                           "next": int(torch.argmax(logits[0, -1]))}
        for i in range(batch):
            s = pool[i]
            if s is None:
                continue
            logits, s["cache"] = decode(params, s["cache"], token(s["next"]),
                                        position(s["pos"]))
            s["out"].append(s["next"])
            s["pos"] += 1
            s["next"] = int(torch.argmax(logits[0, -1]))
            done = len(s["out"]) >= max_new or \
                (eos_id is not None and s["out"][-1] == eos_id) or \
                s["pos"] >= max_len - 1
            if done:
                results.append(ServeResult(
                    request_id=s["rid"], prompt=s["prompt"],
                    generated=s["out"],
                    latency_s=time.perf_counter() - s["t0"]))
                pool[i] = None
    results.sort(key=lambda r: r.request_id)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a GPU) or cpu")
    args = ap.parse_args(argv)

    arch = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_arch(args.arch)
    rng = np.random.default_rng(args.seed)
    prompts = [list(rng.integers(1, arch.vocab_size,
                                 size=rng.integers(4, 12)))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    results = serve_requests(arch, prompts, batch=args.batch,
                             max_new=args.max_new, seed=args.seed,
                             device=args.device)
    dt = time.perf_counter() - t0
    tok = sum(len(r.generated) for r in results)
    print(f"[serve] {len(results)} requests, {tok} tokens in {dt:.1f}s "
          f"({tok/dt:.1f} tok/s) on {args.device}")
    for r in results[:4]:
        print(f"  req{r.request_id}: prompt[{len(r.prompt)}] -> "
              f"{r.generated[:8]}... ({r.latency_s:.2f}s)")


if __name__ == "__main__":
    main()
