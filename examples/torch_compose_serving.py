"""Heterogeneous composition for LLM serving on the PyTorch port
(CDSE->CDAC walkthrough).

An inference server runs two very differently-shaped phases: *prefill*
(long sequences, compute-bound matmuls) and *decode* (batch-1 token
steps, memory-bound).  One monolithic accelerator must time-share both;
a *composition* spends the same silicon on two specialized engines and
routes each phase to the one that fits.  This example runs the whole
CHARM-style two-level flow through `Study(composition=2)`, every
cost-model call on `--device` (the GPU by default), and explains the
winner engine by engine:

  PYTHONPATH=src python examples/torch_compose_serving.py         # zoo LLM
  PYTHONPATH=src python examples/torch_compose_serving.py --apps ptb \\
      --apps wdl
  PYTHONPATH=src python examples/torch_compose_serving.py --traffic 3 1 \\
      --engine genetic
  PYTHONPATH=src python examples/torch_compose_serving.py --smoke \\
      --device cpu

The traffic mix weighs the score: `--traffic 3 1` says three parts
prefill to one part decode, and the study maximizes the traffic-weighted
geomean of each phase's *effective* (time-shared) service rate under one
shared area budget.  The `gather_rows` kernel's launches go to stderr.
"""

import argparse
import sys

from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import ENGINES
from repro_torch.core.space import default_space
from repro_torch.dse import (Composition, CompositionEvaluator, SearchBudget,
                             Study)
from repro_torch.kernels.gather import gather_rows

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--engine", choices=sorted(ENGINES), default="greedy")
ap.add_argument("--apps", action="append", default=None,
                help="two+ workloads to compose (repeatable)  [default: "
                     "qwen2-0.5b:prefill + qwen2-0.5b:decode]")
ap.add_argument("--traffic", type=float, nargs="+", default=None,
                help="per-app traffic weights, app order  [default: even]")
ap.add_argument("--seed", type=int, default=0)
ap.add_argument("--smoke", action="store_true",
                help="seconds-scale search budget")
ap.add_argument("--device", default="cuda",
                help="torch device of the cost model (cuda or cpu)")
args = ap.parse_args()

apps = list(args.apps or ["qwen2-0.5b:prefill", "qwen2-0.5b:decode"])
traffic = (dict(zip(apps, args.traffic)) if args.traffic else None)
budget = (SearchBudget.smoke() if args.smoke
          else SearchBudget(restarts=2, max_rounds=12,
                            engine_kwargs={"population": 24, "chains": 4,
                                           "batch": 24}))
space = default_space()

print(f"searching a 2-engine composition for {apps} "
      f"(engine={args.engine}, area budget {space.area_budget:g})...")
study = Study(apps=apps, composition=2, traffic=traffic,
              engine=args.engine, budget=budget, seed=args.seed,
              name="compose-serving", device=args.device)
result = study.run()

comp = result.best
assert isinstance(comp, Composition)
print(f"\nbest composition: score {result.best_score:.1f}, "
      f"total area {comp.area(space.hw):.0f} "
      f"(budget {space.area_budget:g})")

# per-engine attribution: which apps each engine serves, their time
# fractions, raw and effective GOPS (repro_torch.obs.attribution)
specs = [AppSpec.from_app(a) for a in apps]
ev = CompositionEvaluator(specs, hw=space.hw, traffic=traffic,
                          area_budget=space.area_budget, device=args.device)
print("\n" + ev.explain(comp).table())

# the monolithic counterfactual: the best single engine of this very
# composition, forced to time-share every workload
shared = [Composition(engines=(e,), assignment=tuple(0 for _ in apps),
                      apps=tuple(apps)) for e in comp.engines]
mono = max(ev.score_one(c) for c in shared)
print(f"\nsame silicon, one engine time-shared: best score {mono:.1f} "
      f"-> composition advantage {result.best_score / mono:.2f}x")

print("\njoint (traffic-score, total-area) front:")
for pt in result.front or []:
    print(f"  score={pt.score:10.1f}  area={pt.area:8.0f}")
print(f"gather_rows launches: {gather_rows.launches}", file=sys.stderr)
