"""`python -m repro_torch.dse` — the command line of the port's DSE loop.

    # per-app optimization (paper §4.3 / Table 3), scored on the GPU
    PYTHONPATH=src python -m repro_torch.dse --apps resnet

    # §5.1 joint geomean selection (Tables 4-5)
    PYTHONPATH=src python -m repro_torch.dse --apps resnet --apps ptb \\
        --apps wdl --objective geomean

    # the same on the CPU
    PYTHONPATH=src python -m repro_torch.dse --apps ptb --apps wdl \\
        --smoke --device cpu

    # traced model-zoo workloads (the port's models, traced on meta
    # tensors), with another engine
    PYTHONPATH=src python -m repro_torch.dse --apps qwen2-0.5b:prefill \\
        --apps qwen2-0.5b:decode --engine genetic

    # perf/area Pareto sweep at three area budgets (Tables 4-5 style),
    # with the §5.3 radar, a trace, the search journal and metrics
    PYTHONPATH=src python -m repro_torch.dse --apps ptb --apps wdl \\
        --objective pareto --budgets 30000 --budgets 60000 \\
        --budgets 90000 --radar --trace t.json --journal j.jsonl --metrics
    PYTHONPATH=src python -m repro_torch.obs.validate --trace t.json \\
        --journal j.jsonl

    # fan per-app searches over 4 workers with crash-safe checkpoints;
    # a killed run continues via --resume (bit-identical result)
    PYTHONPATH=src python -m repro_torch.dse --apps resnet --apps ptb \\
        --apps wdl --workers 4 --checkpoint-every 1
    PYTHONPATH=src python -m repro_torch.dse \\
        --resume experiments/dse_study.json.ckpt

    # a two-engine composition for mixed prefill/decode traffic
    PYTHONPATH=src python -m repro_torch.dse --apps qwen2-0.5b:prefill \\
        --apps qwen2-0.5b:decode --composition 2 --engine genetic \\
        --traffic qwen2-0.5b:prefill=1 --traffic qwen2-0.5b:decode=1

Every run persists a `StudyResult` JSON (default
``experiments/dse_study.json``).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional, Tuple

from repro_torch.core.search.evaluator import BACKENDS
from repro_torch.dse.composition import Composition
from repro_torch.dse.objectives import OBJECTIVES
from repro_torch.dse.study import SearchBudget, Study, StudyResult

DEFAULT_OUT = Path("experiments") / "dse_study.json"


def _parse_engine_kwargs(pairs: List[str]) -> dict:
    out = {}
    for pair in pairs:
        key, sep, val = pair.partition("=")
        if not sep:
            raise SystemExit(f"--engine-kwarg wants key=value, got {pair!r}")
        try:
            out[key] = int(val)
        except ValueError:
            try:
                out[key] = float(val)
            except ValueError:
                out[key] = val
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.dse",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--apps", action="append", default=None,
                    help="applications to optimize for (repeatable): "
                         "inception | deeplab | resnet | fasterRCNN | ptb | "
                         "wdl | nasnet, or a '<arch>:prefill' / "
                         "'<arch>:decode' zoo workload of internvl2-1b, "
                         "recurrentgemma-9b, qwen2-0.5b, qwen2.5-3b, "
                         "qwen2.5-32b or mistral-nemo-12b  [default: "
                         "resnet]")
    ap.add_argument("--engine", default="greedy",
                    help="search engine: greedy | anneal | genetic | "
                         "random | tpe | nsga2")
    ap.add_argument("--composition", type=int, default=1, metavar="K",
                    help="search a K-sub-accelerator composition under one "
                         "shared area budget (CDSE->CDAC; needs >= K apps "
                         "and a pareto objective)  [default: 1 = one "
                         "monolithic accelerator]")
    ap.add_argument("--traffic", action="append", default=None,
                    metavar="APP=WEIGHT",
                    help="traffic weight per app for composition scoring "
                         "(repeatable; normalized to sum 1)  [default: "
                         "uniform]")
    ap.add_argument("--split-grid", type=int, default=4, metavar="G",
                    help="area-split granularity for compositions: each "
                         "engine's budget share is a positive multiple of "
                         "1/G  [default: 4]")
    ap.add_argument("--objective", default=None,
                    choices=sorted(OBJECTIVES),
                    help="optimization objective  [default: maxperf for one "
                         "app, geomean for several]")
    ap.add_argument("--area-budget", type=float, default=None,
                    help="area constraint (cost-model units)  [default: the "
                         "space's budget]")
    ap.add_argument("--budgets", action="append", type=float, default=None,
                    help="area budgets for the pareto sweep (repeatable; "
                         ">= 3 recommended)  [default: 0.75x/1x/1.25x the "
                         "area budget]")
    ap.add_argument("--weight-peak-mode", default="streaming",
                    choices=("strict", "streaming"),
                    help="Eq. 11 weight-peak reading for every app incl. "
                         "traced zoo graphs (strict: weight buffer holds "
                         "the largest layer; streaming: tile bound only)")
    ap.add_argument("--k", type=int, default=None,
                    help="greedy variable-subset size (Algorithm 1) "
                         "[default: 3; explicit values win over --smoke]")
    ap.add_argument("--restarts", type=int, default=None,
                    help="multi-start count per app  [default: 4; explicit "
                         "values win over --smoke]")
    ap.add_argument("--max-rounds", type=int, default=None,
                    help="search rounds per start  [default: 40; explicit "
                         "values win over --smoke]")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="fused", choices=BACKENDS,
                    help="cost-model pass on the device: fused (table "
                         "gathers, gather_rows) or broadcast (the Eqs. "
                         "1-13 broadcast formulas; scores any stream)")
    ap.add_argument("--top-frac", type=float, default=0.10,
                    help="top fraction kept as geomean candidates (§5.1)")
    ap.add_argument("--engine-kwarg", action="append", default=[],
                    metavar="KEY=VAL",
                    help="extra engine knob (repeatable), e.g. batch=4096")
    ap.add_argument("--radar", action="store_true",
                    help="also print the §5.3 sensitivity radar per app")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale budget (k=2, 1 restart, 4 rounds)")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT,
                    help=f"StudyResult JSON path  [default: {DEFAULT_OUT}]")
    ap.add_argument("--device", default="cuda",
                    help="torch device that scores the pools, in every "
                         "worker too  [default: cuda; fails when no GPU is "
                         "available]")
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool width for the per-app searches; "
                         "results are bit-identical at any value  "
                         "[default: 1 = serial]")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="K",
                    help="write a crash-safe checkpoint (<out>.ckpt) after "
                         "every K completed per-app searches; resume a "
                         "killed run with --resume  [default: off]")
    ap.add_argument("--resume", type=Path, default=None, metavar="CKPT",
                    help="continue a killed study from its checkpoint file "
                         "on --device with --backend and --workers "
                         "(produces the same result the uninterrupted run "
                         "would have)")
    grp = ap.add_argument_group(
        "observability (result-inert: the StudyResult JSON is byte-"
        "identical with or without these)")
    grp.add_argument("--trace", type=Path, default=None, metavar="JSON",
                     help="write a Chrome-trace-event JSON (load in "
                          "Perfetto / chrome://tracing) covering study "
                          "phases, ask/tell rounds and evaluator batches")
    grp.add_argument("--journal", type=Path, default=None, metavar="JSONL",
                     help="write the search journal: one record per "
                          "ask/tell round (incumbent, feasible fraction, "
                          "hypervolume)")
    grp.add_argument("--metrics", action="store_true",
                     help="collect counters/histograms (cache hits, "
                          "round latency) and print a summary table")
    grp.add_argument("--log-level", default=None,
                     metavar="LEVEL",
                     help="attach a stderr handler to the 'repro_torch' "
                          "logger at LEVEL (DEBUG/INFO/WARNING/...)")
    return ap


def study_from_cli(argv: Optional[List[str]] = None
                   ) -> Tuple[Study, argparse.Namespace]:
    """Parse flags into a ready-to-run `Study`."""
    args = build_parser().parse_args(argv)
    from repro_torch.core.space import default_space
    from repro_torch.dse.constraints import AreaBudget

    constraints = []
    if args.area_budget is not None:
        constraints.append(AreaBudget(args.area_budget))
    # explicit flags always win; --smoke only fills the unspecified ones
    base = SearchBudget.smoke() if args.smoke else SearchBudget()
    budget = SearchBudget(
        k=args.k if args.k is not None else base.k,
        restarts=(args.restarts if args.restarts is not None
                  else base.restarts),
        max_rounds=(args.max_rounds if args.max_rounds is not None
                    else base.max_rounds),
        engine_kwargs=dict(base.engine_kwargs))
    budget.engine_kwargs.update(_parse_engine_kwargs(args.engine_kwarg))

    traffic = None
    if args.traffic:
        traffic = {}
        for pair in args.traffic:
            key, sep, val = pair.partition("=")
            if not sep:
                raise SystemExit(
                    f"--traffic wants APP=WEIGHT, got {pair!r}")
            traffic[key] = float(val)
    # objective=None defers to Study's own default (maxperf for one app,
    # geomean for several, pareto for compositions); --budgets flows
    # through unconditionally so Study rejects it for non-pareto
    # objectives instead of dropping it
    study = Study(apps=list(args.apps or ["resnet"]), space=default_space(),
                  objective=args.objective, constraints=constraints,
                  engine=args.engine, budget=budget, seed=args.seed,
                  top_frac=args.top_frac, area_budgets=args.budgets,
                  weight_peak_mode=args.weight_peak_mode, name="cli",
                  device=args.device, backend=args.backend,
                  workers=args.workers, composition=args.composition,
                  traffic=traffic, split_grid=args.split_grid)
    return study, args


def _print_result(result: StudyResult) -> None:
    meta = result.meta
    print(f"[dse] objective={meta['objective']['name']} "
          f"engine={meta['engine']} apps={','.join(meta['apps'])} "
          f"seed={meta['seed']} device={meta['device']}")
    for app, rec in result.per_app.items():
        print(f"[dse]   {app:28s} best={rec['best_perf']:10.2f}  "
              f"evaluated={rec['n_evaluated']}")
    if result.multiapp is not None:
        print("\nTable 4 (normalized cross-evaluation):")
        print(result.multiapp.table4())
        print("\nTable 5 (geomean improvements vs per-app bests):")
        print(result.multiapp.table5())
    if result.front is not None:
        print(f"\njoint perf/area Pareto front ({len(result.front)} points):")
        for pt in result.front:
            print(f"  score={pt.score:10.2f}  area={pt.area:9.0f}")
        print("\nselections per area budget:")
        for b, sel in (result.budget_selections or {}).items():
            if sel is None:
                print(f"  area<={b}: no feasible candidate")
            else:
                print(f"  area<={b}: score={sel['score']:.2f} "
                      f"area={sel['area']:.0f}")
    keys = ("pe_group", "mac_per_group", "bank_height", "tif", "tof")
    if isinstance(result.best, Composition):
        comp = result.best
        print(f"\nbest composition (score={result.best_score:.2f}, "
              f"{comp.k} engines):")
        groups = comp.groups()
        for g, eng in enumerate(comp.engines):
            served = ",".join(comp.apps[i] for i in groups[g])
            print(f"  engine {g} <- {served}:",
                  {k: v for k, v in eng.asdict().items() if k in keys})
    elif result.best is not None:
        print(f"\nbest (score={result.best_score:.2f}):",
              {k: v for k, v in result.best.asdict().items() if k in keys})


def _print_metrics(summary: dict) -> None:
    print("\n[obs] metrics summary:")
    if summary["counters"]:
        print("  counters:")
        for k in sorted(summary["counters"]):
            print(f"    {k:44s} {summary['counters'][k]:>12g}")
    if summary["gauges"]:
        print("  gauges:")
        for k in sorted(summary["gauges"]):
            print(f"    {k:44s} {summary['gauges'][k]:>12g}")
    if summary["histograms"]:
        print("  histograms:")
        print(f"    {'name':44s} {'count':>7s} {'mean':>10s} "
              f"{'p50':>10s} {'p95':>10s} {'max':>10s}")
        for k in sorted(summary["histograms"]):
            h = summary["histograms"][k]
            print(f"    {k:44s} {h['count']:7d} {h['mean']:10.4g} "
                  f"{h['p50']:10.4g} {h['p95']:10.4g} {h['max']:10.4g}")


def main(argv: Optional[List[str]] = None) -> int:
    study, args = study_from_cli(argv)

    from repro_torch import obs
    if args.log_level is not None:
        obs.configure_logging(level=args.log_level.upper())
    want_obs = bool(args.trace or args.journal or args.metrics)
    if want_obs:
        obs.enable(trace=args.trace is not None,
                   metrics=args.metrics,
                   journal=args.journal is not None)

    if args.resume is not None:
        if not args.resume.exists():
            raise SystemExit(f"--resume: no checkpoint at {args.resume}")
        result = Study.resume(args.resume, workers=args.workers,
                              device=args.device, backend=args.backend)
    elif args.checkpoint_every is not None:
        ckpt = args.out.with_name(args.out.name + ".ckpt")
        result = study.run(checkpoint_path=ckpt,
                           checkpoint_every=args.checkpoint_every)
    else:
        result = study.run()
    _print_result(result)

    if args.radar:
        from repro_torch.core.sensitivity import radar_of_top_configs
        print("\nsensitivity radar (normalized top-10% means):")
        for spec in study.specs:
            radar = radar_of_top_configs(
                spec.name, spec, study.space, k=study.budget.k,
                restarts=study.budget.restarts, seed=args.seed,
                max_rounds=study.budget.max_rounds, engine=args.engine,
                device=args.device)
            print(" ", radar.fmt())

    path = result.save(args.out)
    print(f"\n[dse] wrote {path}")

    if args.trace is not None:
        tp = obs.tracer().write(args.trace)
        print(f"[obs] wrote trace {tp} ({len(obs.tracer())} events)")
    if args.journal is not None:
        jp = obs.journal().write_jsonl(args.journal)
        print(f"[obs] wrote journal {jp} ({len(obs.journal())} records)")
    if args.metrics:
        _print_metrics(obs.metrics().summary())
    if want_obs:
        obs.disable(reset=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
