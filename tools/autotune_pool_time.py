"""Wall time of `CellEvaluator.score_batch` on a pool of 4 points: serial,
on 4 threads and on 4 spawned processes, each run from an empty cache.

The dry-run is Python on fake tensors, so threads take turns at the GIL;
spawned processes overlap, at the cost of starting an interpreter and
importing torch each.  A mesh cell (`--multi-pod`) makes a fake process
group of 256 (512) ranks a dry-run, one a process: it has no thread pool.

Usage:
  PYTHONPATH=src python tools/autotune_pool_time.py [--device cuda|cpu]
      [--arch qwen2-0.5b] [--shape decode_32k] [--multi-pod single|multi]

Prints one JSON object: seconds by pool kind, the scores (equal in every
kind), the dry-runs run and any record that failed.
"""

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.autotune import CellEvaluator, ExecPoint  # noqa: E402


def points(multi_pod):
    """Four points of four different steps: the KV tile on one card (it
    moves a decode's record, not its score), the rules over a mesh."""
    base = ExecPoint(sharding_mode="tp", remat="none")
    if multi_pod is None:
        return [dataclasses.replace(base, attn_kv_block=b)
                for b in (512, 1024, 2048, 4096)]
    return [dataclasses.replace(base, extra_rules=r, attn_kv_block=b)
            for r in ((), (("kv_seq", None),)) for b in (1024, 2048)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multi-pod", choices=["single", "multi"])
    args = ap.parse_args(argv)
    multi_pod = None if args.multi_pod is None else args.multi_pod == "multi"
    pts = points(multi_pod)
    kinds = [("serial", 1), ("processes", 4)]
    if multi_pod is None:
        kinds.insert(1, ("threads", 4))
    out = {"arch": args.arch, "shape": args.shape,
           "multi_pod": multi_pod, "points": len(pts), "seconds": {},
           "dry_runs": {}}
    scores = {}
    for name, workers in kinds:
        with tempfile.TemporaryDirectory() as tmp:
            ev = CellEvaluator(args.arch, args.shape, tmp,
                               device=args.device, multi_pod=multi_pod,
                               compile_workers=workers)
            t0 = time.perf_counter()
            if name == "threads":
                with ThreadPoolExecutor(workers) as pool:
                    scores[name] = list(pool.map(ev.score, pts))
            else:
                scores[name] = ev.score_batch(pts)
            out["seconds"][name] = time.perf_counter() - t0
            out["dry_runs"][name] = ev.n_compiles
            failed = [r.get("error") for r in map(ev.evaluate, pts)
                      if r.get("status") != "OK"]
            if failed:
                out.setdefault("failed", {})[name] = failed
    out["scores"] = scores["serial"]
    out["scores_equal"] = all(s == scores["serial"]
                              for s in scores.values())
    print(json.dumps(out))
    return 0 if out["scores_equal"] and "failed" not in out else 1


if __name__ == "__main__":
    sys.exit(main())
