"""The readings a cell's correctness limits are set from, on the card.

    python3 bench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] \
        [--out chiprun_out/control.jsonl]

For each seed, in one process: the run's weights and batches from that
seed, the timed step over the cell's own batch (warmed up on the first
seed), for as many forwards as a run compares (`check_forwards`), and
the plain reference over the same tokens.  Against the reference, the
check's numbers of

  program   the timed step (for `--seeds`),
  control   the reference computed with every product's operands in fp8
            e4m3, the precision below the configuration's bf16, in the
            program's place (for `--control-seeds`),
  fault:*   the timed step with each of `bench.faults` planted under it
            (for `--fault-seeds`),

each judged against the cell's limits (`bench/checks/<cell>.json`) as a
run judges it.  The lower reading of a number is the largest the program
gives over the seeds, its upper reading the smallest the control gives
(three times the lower or more); each fault has to come out not correct.
The checks file keeps the readings and the limit set between them.  The
benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("served_gap", "logit_err", "logit_err_median", "logit_maxerr")


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import check, harness, spec
    from bench.faults import FAULTS
    cell = spec.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("bench: control readings need a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    tr, vocab = cell.traffic, cell.config["vocab_size"]
    limits = cell.limits["limits"]
    model, step = harness.build_step(cell)
    lines = []

    def judged(rows):
        numbers = check.cell_numbers(rows)
        verdict = check.judge(numbers, limits)
        return {"numbers": numbers,
                "correct": all(v["ok"] for v in verdict.values()),
                "checks": {k: [v["value"], v["limit"]]
                           for k, v in verdict.items()}}

    def numbers_of(outs, refs):
        return judged([r for f in refs for r in check.prompt_numbers(
            outs[f][:, :vocab].float(), refs[f])])

    seeds = sorted(set(args.seeds) | set(args.control_seeds)
                   | set(args.fault_seeds))
    for n, seed in enumerate(seeds):
        inputs = harness.make_inputs(cell, model, seed, device)
        if n == 0:
            harness.warm_up(step, inputs, device)
        inputs.draw(tr["check_forwards"])
        line = {"workload": cell.name, "seed": seed}
        t = time.perf_counter()
        outs = {f: step(inputs.params, {"tokens": b})
                for f, b in enumerate(inputs.batches)}
        torch.cuda.synchronize()
        line["forward_s"] = (time.perf_counter() - t) / len(outs)
        t = time.perf_counter()
        refs = {f: harness.reference_logits(cell, inputs.params, b)
                for f, b in enumerate(inputs.batches)}
        torch.cuda.synchronize()
        line["reference_s"] = time.perf_counter() - t
        if seed in args.seeds:
            line["program"] = numbers_of(outs, refs)
        if seed in args.control_seeds:
            ctl = {f: harness.reference_logits(cell, inputs.params, b, "fp8")
                   for f, b in enumerate(inputs.batches)}
            line["control"] = numbers_of(ctl, refs)
        if seed in args.fault_seeds:
            for name, fault in FAULTS.items():
                broken = fault(step)
                broken(inputs.params, {"tokens": inputs.warmup[0]})
                bad = {f: broken(inputs.params, {"tokens": b})
                       for f, b in enumerate(inputs.batches)}
                line[f"fault:{name}"] = numbers_of(bad, refs)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del inputs, outs, refs
        torch.cuda.empty_cache()

    def extreme(kind, pick):
        got = [ln[kind]["numbers"] for ln in lines if kind in ln]
        return {k: pick(g[k] for g in got) for k in KEYS} if got else None
    summary = {"workload": cell.name, "device": torch.cuda.get_device_name(0),
               "limits": limits, "lower": extreme("program", max),
               "control": extreme("control", min),
               "faults": {name: extreme(f"fault:{name}", min)
                          for name in FAULTS} if args.fault_seeds else None,
               "correct": {kind: [ln[kind]["correct"] for ln in lines
                                  if kind in ln]
                           for kind in ["program", "control"]
                           + [f"fault:{name}" for name in FAULTS]},
               "seconds": time.perf_counter() - T_START}
    print(json.dumps(summary), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("a") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
