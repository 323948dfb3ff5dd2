"""Trace model-zoo workloads into the DSE on the PyTorch port (the
paper's §4.1 frontend).

Runs the port's own model code (`repro_torch.models`) on meta tensors
under a `TorchDispatchMode` — purely abstractly, so multi-billion-
parameter architectures trace in seconds — lowers the aten calls to the
canonical `ComputationGraph` IR, prints the Table-3-style summary, and
(with --optimize) searches an accelerator configuration for each
workload, its cost model on `--device` (the GPU by default):

  PYTHONPATH=src python examples/torch_trace_model.py
  PYTHONPATH=src python examples/torch_trace_model.py \\
      --app qwen2-0.5b:prefill --app recurrentgemma-9b:decode --optimize
  PYTHONPATH=src python examples/torch_trace_model.py --list

`--list` lists every workload (the port traces all twenty zoo apps).  The
`gather_rows` kernel's launches go to stderr.
"""

import argparse
import sys

from repro_torch.core import apps
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import ENGINES, optimize_for_app
from repro_torch.core.space import default_space
from repro_torch.kernels.gather import gather_rows

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--app", action="append", default=None,
                help="workload to trace (repeatable): '<arch>:prefill' or "
                     "'<arch>:decode'; default: qwen2-0.5b prefill+decode")
ap.add_argument("--list", action="store_true",
                help="list every available workload and exit")
ap.add_argument("--optimize", action="store_true",
                help="run the accelerator DSE on each traced graph")
ap.add_argument("--engine", choices=sorted(ENGINES), default="genetic")
ap.add_argument("--device", default="cuda",
                help="torch device of the cost model (cuda or cpu)")
args = ap.parse_args()

if args.list:
    for name in apps.all_app_names():
        print(name)
    sys.exit(0)

names = args.app or ["qwen2-0.5b:prefill", "qwen2-0.5b:decode"]
space = default_space()
failures = []
for name in names:
    graph = apps.build_app(name)
    s = graph.summary()
    print(f"{name}:")
    print(f"  ops={s['op_counts']}  data_nodes={s['n_data_nodes']}")
    print(f"  total_macs={s['total_macs'] / 1e9:.2f} G  "
          f"weights={s['total_weight_bytes'] / 1e6:.0f} MB  "
          f"peak_act={s['peak_input_memory_bytes'] / 1e6:.2f} MB")
    if args.optimize:
        spec = AppSpec.from_graph(name, graph)
        res = optimize_for_app(spec.stream, space, engine=args.engine,
                               k=1, restarts=1, seed=0, max_rounds=8,
                               peak_weight_bits=spec.peak_weight_bits,
                               peak_input_bits=spec.peak_input_bits,
                               device=args.device)
        print(f"  {args.engine}: best={res.best_perf:.1f} GOPS "
              f"({len(res.evaluated)} configs evaluated, "
              f"area={res.best.area(space.hw):.0f}/{space.area_budget:.0f})")
        if res.best_perf <= 0:
            failures.append(name)

print(f"gather_rows launches: {gather_rows.launches}", file=sys.stderr)
if failures:
    print(f"FAILED: no valid configuration found for {failures}")
    sys.exit(1)
