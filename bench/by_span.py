"""One cell's traced stretch by the port's spans, printed as one JSON line.

    python3 bench/by_span.py --workload <cell> --seed <n>

From the root of a checkout, on the cell's card (it exits non-zero
without one).  It runs the cell's set-up and warm-up as `bench/run.py`
does, with `repro_torch.obs` tracing on, then a profiled stretch of the
cell's `trace_forwards` forwards with `obs` metrics counting
(`bench.spans.measure`), and prints: the per-layer readings the spans and
counters give (`readings`: `moe_dispatch_span_ms`, `moe_experts_ms`,
`attention_core_ms`, `moe_slot_fill_pct`), the device's seconds and
launches by span (`by_span`, `(unattributed)` for those launched outside
`prefill`), each span's largest operations (`ops_by_span`), the idle gaps
by span (`idle_by_span`), the MoE counters, the set-up's kernel loads and
the stretch's length, busy and operation seconds.  It is no cell of the
benchmark: it times nothing end to end and checks no output.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(
        ROOT / "build" / "bench" / "torch_kernels")
    from bench import spans, spec
    try:
        cell = spec.resolve(args.workload, ROOT)
    except spec.SpecError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(f"bench: {args.workload} needs a CUDA device", file=sys.stderr)
        return 3
    out = spans.measure(cell, args.seed, torch.device("cuda", 0))
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
