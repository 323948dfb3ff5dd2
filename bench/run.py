"""Run one cell of the benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Needs the cards the cell asks for: where
`torch.cuda.is_available()` is false or too few are present it exits
non-zero and prints no result.  With `--trace 0` the result holds the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics and a
breakdown of the traced stretch.  Build and kernel caches stay inside the
checkout (`build/`).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # PyTorch's own kernel cache, at a fixed path inside the checkout
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(
        ROOT / "build" / "bench" / "torch_kernels")
    from bench import spec
    try:
        cell = spec.resolve(args.workload, ROOT)
    except spec.SpecError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from bench import harness
    result = harness.run(cell, seed=args.seed, seconds=args.seconds,
                         traced=bool(args.trace),
                         device=torch.device("cuda", 0), t_start=T_START)
    found = harness.foreign_modules()
    if found:
        print(f"bench: the run loaded {found}", file=sys.stderr)
        return 4
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
