"""Find a cell's files by the names in `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
Its files, each found by name and refused by name when missing:

  configuration   the `file` of its `configs` entry (a JSON object); the
                  key `reference` in it names the plain reference
  traffic mix     `bench/traffic/<traffic>.json`
  reference       `bench/reference/<reference>.py`
  limits          `bench/checks/<cell>.json`: the correctness limits
  metric readers  `bench/metrics/<metric>.py`, for each `per_layer` metric
                  whose `workloads` list the cell (or that has none)

A later change adds a configuration, a mix, a metric or a cell as new
files and entries, and edits none of these.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

__all__ = ["SpecError", "Cell", "load_benchmark", "resolve", "load_module"]

ROOT = Path(__file__).resolve().parents[1]


class SpecError(RuntimeError):
    """A cell, or a file it needs, is missing or malformed."""


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    reference: ModuleType
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    readers: Dict[str, ModuleType]


def _read_json(path: Path, what: str) -> Dict[str, Any]:
    if not path.is_file():
        raise SpecError(f"{what}: {path} is missing")
    try:
        return json.loads(path.read_text())
    except json.JSONDecodeError as e:
        raise SpecError(f"{what}: {path} is not JSON ({e})") from e


def load_module(path: Path, what: str) -> ModuleType:
    """The Python file at `path`, imported under a name of its own."""
    if not path.is_file():
        raise SpecError(f"{what}: {path} is missing")
    name = "bench_file_" + "_".join(path.with_suffix("").parts[-2:]) \
        .replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return _read_json(root / "BENCHMARK.json", "the benchmark")


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with all of its files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"workload {name!r} is not in "
                        f"{root / 'BENCHMARK.json'} (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r}: configuration {w['config']!r} is "
                        f"not among the benchmark's configs")
    config = _read_json(root / configs[w["config"]]["file"],
                        f"configuration {w['config']!r}")
    if "reference" not in config:
        raise SpecError(f"configuration {w['config']!r}: no `reference` key")
    base = root / "bench"
    traffic = _read_json(base / "traffic" / f"{w['traffic']}.json",
                         f"traffic {w['traffic']!r}")
    limits = _read_json(base / "checks" / f"{name}.json",
                        f"limits of {name!r}")
    reference = load_module(base / "reference" / f"{config['reference']}.py",
                            f"reference {config['reference']!r}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    readers = {m["name"]: load_module(base / "metrics" / f"{m['name']}.py",
                                      f"metric {m['name']!r}")
               for m in per_layer}
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, reference=reference,
                end_to_end=e2e, per_layer=per_layer, readers=readers)
