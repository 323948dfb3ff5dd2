"""Multi-application accelerator DSE on the PyTorch port (paper
§5.1-§5.3, small budget).

Optimizes an accelerator for three DNNs, picks the geometric-mean winner,
and shows the sensitivity of the optimum to the application mix, through
the port's `repro_torch.dse.Study`, every cost-model call on `--device`
(the GPU by default):

  PYTHONPATH=src python examples/torch_dse_accelerator.py          # greedy
  PYTHONPATH=src python examples/torch_dse_accelerator.py --engine genetic
  PYTHONPATH=src python examples/torch_dse_accelerator.py --device cpu

and so is the application mix: any `build_app` name works, including the
traced model-zoo workloads of `repro_torch.frontend` —

  PYTHONPATH=src python examples/torch_dse_accelerator.py \\
      --apps resnet --apps qwen2-0.5b:prefill --apps qwen2-0.5b:decode

The `gather_rows` kernel's launches go to stderr.
"""

import argparse
import sys

from repro_torch.core.search import ENGINES
from repro_torch.core.sensitivity import radar_of_top_configs
from repro_torch.core.space import default_space
from repro_torch.dse import GeomeanAcrossApps, SearchBudget, Study
from repro_torch.kernels.gather import gather_rows

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--engine", choices=sorted(ENGINES), default="greedy",
                help="search engine for the per-app DSE")
ap.add_argument("--apps", action="append", default=None,
                help="applications to co-optimize (repeatable); any "
                     "build_app name incl. '<arch>:prefill'/'<arch>:decode'")
ap.add_argument("--device", default="cuda",
                help="torch device of the cost model (cuda or cpu)")
args = ap.parse_args()

space = default_space()
names = tuple(args.apps or ("resnet", "ptb", "wdl"))

study = Study(apps=names, space=space, objective=GeomeanAcrossApps(),
              engine=args.engine,
              budget=SearchBudget(k=2, restarts=2, max_rounds=12),
              seed=0, name="dse_accelerator", device=args.device)
res = study.run().multiapp
print(res.table4())
print()
print("geomean improvements vs per-app bests (Table 5):")
print(res.table5())
print("\nselected config:",
      {k: v for k, v in res.selected.asdict().items()
       if k in ("pe_group", "mac_per_group", "bank_height", "tif", "tof")})

print("\nsensitivity: per-app optima (compute-bound vs memory-bound pull)")
for spec in study.specs[:2]:
    radar = radar_of_top_configs(spec.name, spec, space, k=2, restarts=2,
                                 max_rounds=10, engine=args.engine,
                                 device=args.device)
    vals = radar.values
    print(f"  {spec.name:8s} macs={vals['mac_per_group']:.2f} "
          f"pe={vals['pe_group']:.2f} tif={vals['tif']:.2f} "
          f"tof={vals['tof']:.2f} (normalized top-10% means)")
print(f"gather_rows launches: {gather_rows.launches}", file=sys.stderr)
