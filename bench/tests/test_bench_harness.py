"""The harness finds a cell's files by name, refuses a missing one by name,
takes an addition made of new files only, refuses to run without a card,
and comes out not correct when the timed path is broken underneath or
replaced by the lower-precision control."""

import hashlib
import json
import subprocess
import sys
import time

import pytest
import torch

from _tiny import ROOT, TINY, cell_limits, tiny_root

from bench import harness, spec
from bench.faults import FAULTS

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
# each benchmark cell beside the test-width configuration of its family
FAMILY_CELLS = [(cfg, cell) for cell in CELLS for cfg, fam in TINY.items()
                if cell.startswith(fam + ".")]


def _run(root, cell, seed=2**31 + 11, traced=False, break_step=None):
    c = spec.resolve(cell, root)
    return harness.run(c, seed=seed, seconds=0.5, traced=traced,
                       device=torch.device("cpu"),
                       t_start=time.perf_counter(), break_step=break_step)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    bench = spec.load_benchmark()
    w = next(w for w in bench["workloads"] if w["name"] == cell)
    c = spec.resolve(cell)
    assert c.config["name"] == w["config"]
    assert c.traffic["name"] == w["traffic"]
    assert callable(c.reference.last_logits)
    assert c.limits["limits"] and set(c.limits["limits"]) <= {
        "served_gap", "logit_err", "logit_err_median", "logit_maxerr"}
    for k, lim in c.limits["limits"].items():       # set between readings
        assert c.limits["readings"]["lower"][k] < lim \
            < c.limits["readings"]["upper"][k]
    want = {m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])}
    assert set(c.readers) == want
    assert all(callable(r.read) for r in c.readers.values())


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "bench").rglob("*") if p.is_file()}


def test_addition_made_of_new_files_runs(tiny):
    """A configuration, a traffic mix, a metric and a cell added as new
    files and BENCHMARK.json entries run; no existing file changes."""
    before = _digests(tiny)
    cfg = json.loads((tiny / "bench/configs/olmoe-tiny.json").read_text())
    cfg["name"] = "olmoe-tiny-wide"
    cfg["num_experts_per_tok"] = cfg["port"]["moe"]["top_k"] = 4
    (tiny / "bench/configs/olmoe-tiny-wide.json").write_text(json.dumps(cfg))
    (tiny / "bench/traffic/prefill_tiny_long.json").write_text(json.dumps(
        {"name": "prefill_tiny_long", "batch": 1, "seq": 128,
         "warmup_forwards": 2, "trace_after": 1,
         "trace_forwards": 1, "check_forwards": 1}))
    (tiny / "bench/metrics/forwards_traced.py").write_text(
        "def read(ctx):\n    return ctx.stretch and ctx.stretch.forwards\n")
    (tiny / "bench/checks/olmoe-tiny-wide.long.json").write_text(
        json.dumps({"limits": {"served_gap": 0.5, "logit_err": 0.05}}))
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "olmoe-tiny-wide",
                             "file": "bench/configs/olmoe-tiny-wide.json"})
    bench["workloads"].append({"name": "olmoe-tiny-wide.long",
                               "config": "olmoe-tiny-wide",
                               "traffic": "prefill_tiny_long", "chips": 1})
    bench["per_layer"].append({"name": "forwards_traced", "unit": "1",
                               "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "prefill_tok_s",
                               "workloads": ["olmoe-tiny-wide.long"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(tiny, "olmoe-tiny-wide.long", traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["forwards_traced"]["value"] == 1
    after = _digests(tiny)
    assert {p: d for p, d in after.items() if p in before} == before


@pytest.mark.parametrize("what", ["config", "traffic", "reference", "checks",
                                  "metric"])
def test_missing_file_refused_by_name(tiny, what):
    path = {"config": "bench/configs/olmoe-tiny.json",
            "traffic": "bench/traffic/prefill_tiny.json",
            "reference": "bench/reference/olmoe.py",
            "checks": "bench/checks/olmoe-tiny.tiny.json",
            "metric": "bench/metrics/moe_dispatch_ms.py"}[what]
    (tiny / path).unlink()
    with pytest.raises(spec.SpecError, match=path.split("/")[-1]):
        spec.resolve("olmoe-tiny.tiny", tiny)


def test_unknown_cell_refused_by_name(tiny):
    with pytest.raises(spec.SpecError, match="no-such-cell"):
        spec.resolve("no-such-cell", tiny)


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert p.returncode != 0
    assert "CUDA device" in p.stderr
    assert not p.stdout.strip()


@pytest.mark.parametrize("config,cell", FAMILY_CELLS)
def test_unbroken_run_is_correct(tmp_path, config, cell):
    root = tiny_root(tmp_path, cell_limits(cell))
    out = _run(root, f"{config}.tiny", traced=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out) >= {"attempted", "metrics", "device", "breakdown"}
    assert list(out)[-1] == "checks"


# ------------------------------------------------------- planted faults

@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("config,cell", FAMILY_CELLS)
def test_planted_fault_is_not_correct(tmp_path, config, cell, fault):
    """Comparing what each benchmark cell compares, at the test widths'
    limits, each fault a prefill cell can have makes `correct` false (one
    chip: no exchange between chips to leave out)."""
    root = tiny_root(tmp_path, cell_limits(cell))
    out = _run(root, f"{config}.tiny", break_step=FAULTS[fault])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("config,cell", FAMILY_CELLS)
def test_control_is_not_correct(tmp_path, config, cell):
    """The plain reference computed in fp8, the precision below the
    configuration's bf16, put in the program's place, fails what each
    benchmark cell compares at the test widths' limits."""
    root = tiny_root(tmp_path, cell_limits(cell))
    c = spec.resolve(f"{config}.tiny", root)

    def control(step):
        return lambda params, batch: c.reference.last_logits(
            c.config, params, batch["tokens"], "fp8")
    out = _run(root, f"{config}.tiny", break_step=control)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
def test_run_on_the_card(card, tmp_path, traced):
    """`bench/run.py` from a checkout of test-width cells on the card:
    correct, on the gpu, with its metrics, the trace's breakdown and each
    check beside its limit."""
    root = tiny_root(tmp_path, {"limits": {"served_gap": 0.5,
                                           "logit_err": 0.05}})
    (root / "src").symlink_to(ROOT / "src")
    (root / "bench" / "run.py").write_bytes(
        (ROOT / "bench" / "run.py").read_bytes())
    for config in TINY:
        p = subprocess.run(
            [sys.executable, "bench/run.py", "--workload", f"{config}.tiny",
             "--seed", str(2**31 + 5), "--seconds", "2", "--trace",
             str(traced)], capture_output=True, text=True, cwd=root,
            timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] and out["device"]["platform"] == "gpu"
        assert list(out)[-1] == "checks"
        assert p.stderr.strip().splitlines()[-1].startswith("check ")
        if traced:
            assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
            assert out["breakdown"]["device_ops"]
            assert {"prefill_mfu", "device_idle_pct",
                    "moe_dispatch_ms"} <= set(out["metrics"])
        else:
            assert {"prefill_tok_s", "ttft_p90_ms", "peak_mem_gb",
                    "setup_s"} == set(out["metrics"])
