"""Test-width checkouts of the benchmark: the benchmark's harness and data
with cells of small configurations of each model family."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
# the test-width configurations, each of the family of a benchmark config
TINY = {"olmoe-tiny": "olmoe-1b-7b", "deepseek-tiny": "deepseek-v2-lite-16b"}


def cell_limits(cell: str) -> dict:
    """A limits file for the test widths that compares what the benchmark
    cell `cell` compares, at the limits the test widths' own readings set
    (`data/limits_tiny.json`)."""
    keys = json.loads((ROOT / "bench" / "checks" / f"{cell}.json")
                      .read_text())["limits"]
    tiny = json.loads((DATA / "limits_tiny.json").read_text())["limits"]
    return {"limits": {k: tiny[k] for k in keys}}


def tiny_root(tmp: Path, limits: dict) -> Path:
    """A checkout of `bench/` in `tmp` whose BENCHMARK.json holds the
    test-width cells `<config>.tiny` (traffic `prefill_tiny`), each with
    the limits file `limits`."""
    shutil.copytree(ROOT / "bench", tmp / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(DATA / "prefill_tiny.json", tmp / "bench" / "traffic")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    for name in TINY:
        shutil.copy(DATA / f"{name}.json", tmp / "bench" / "configs")
        bench["configs"].append({"name": name,
                                 "file": f"bench/configs/{name}.json"})
        bench["workloads"].append({"name": f"{name}.tiny", "config": name,
                                   "traffic": "prefill_tiny", "chips": 1})
        (tmp / "bench" / "checks" / f"{name}.tiny.json").write_text(
            json.dumps(limits))
    for m in bench["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
