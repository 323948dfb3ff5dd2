"""The port's `Study` and CLI on the CPU: the JAX package's study goldens,
bit for bit, a seven-app study against `repro.dse.Study`, persistence, and
the refusal to run on a GPU that is not there."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.dse as ref_dse
from repro_torch.core.apps import APP_NAMES
from repro_torch.dse import (GeomeanAcrossApps, MaxPerf, SearchBudget, Study,
                             StudyResult)

ROOT = Path(__file__).resolve().parents[1]

# goldens of the JAX package's studies (copied here, not imported)
GOLD_MULTI = {"loop_order": 0, "pe_group": 8, "mac_per_group": 512,
              "bank_height": 8192, "bank_width": 128, "weight_banks_pg": 4,
              "act_banks_pg": 4, "tif": 8, "tix": 64, "tiy": 64, "tof": 16,
              "pif": 2, "pof": 16, "pox": 8, "poy": 2, "pkx": 7, "pky": 1,
              "pb": 4}
GOLD_MULTI_PERF = 835.423693109374

GOLD_MA_SELECTED = {"loop_order": 2, "pe_group": 64, "mac_per_group": 32,
                    "bank_height": 8192, "bank_width": 16,
                    "weight_banks_pg": 2, "act_banks_pg": 16, "tif": 32,
                    "tix": 32, "tiy": 16, "tof": 16, "pif": 8, "pof": 16,
                    "pox": 16, "poy": 2, "pkx": 7, "pky": 1, "pb": 4}
GOLD_MA_GEOMEANS = [1.0000000000000004e-06, 0.967758135970744,
                    0.9954428121972676]

BUDGET = SearchBudget(k=2, restarts=2, max_rounds=6)


def test_maxperf_study_golden():
    res = Study(apps=["resnet"], objective=MaxPerf(), engine="greedy",
                budget=BUDGET, seed=0, device="cpu").run()
    assert {k: int(v) for k, v in res.best.asdict().items()} == GOLD_MULTI
    assert res.best_score == GOLD_MULTI_PERF
    assert res.per_app["resnet"]["n_evaluated"] == 454
    assert res.meta["backend"] == "fused"
    assert res.meta["device"] == "cpu"


def test_geomean_study_golden():
    res = Study(apps=["ptb", "wdl"], objective=GeomeanAcrossApps(),
                engine="greedy", budget=BUDGET, seed=0, device="cpu").run()
    assert {k: int(v)
            for k, v in res.best.asdict().items()} == GOLD_MA_SELECTED
    assert res.multiapp_summary["geomeans"] == GOLD_MA_GEOMEANS
    assert {a: len(c) for a, c
            in res.multiapp.candidates_per_app.items()} == {"ptb": 23,
                                                            "wdl": 54}


def test_seven_app_study_selects_what_the_jax_package_selects():
    kw = dict(apps=list(APP_NAMES), engine="greedy", seed=0)
    want = ref_dse.Study(objective=ref_dse.GeomeanAcrossApps(),
                         budget=ref_dse.SearchBudget.smoke(), **kw).run()
    got = Study(objective=GeomeanAcrossApps(), budget=SearchBudget.smoke(),
                device="cpu", **kw).run()
    assert got.best.asdict() == want.best.asdict()
    assert got.best_score == want.best_score
    assert got.per_app == want.per_app
    assert got.multiapp_summary == want.multiapp_summary


def test_study_result_round_trips(tmp_path):
    res = Study(apps=["ptb", "wdl"], budget=SearchBudget.smoke(), seed=1,
                device="cpu").run()
    back = StudyResult.load(res.save(tmp_path / "s.json"))
    assert back == res
    assert back.to_json() == res.to_json()


def test_cli_writes_the_study_json(tmp_path):
    out = tmp_path / "study.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.dse", "--device", "cpu",
         "--smoke", "--apps", "ptb", "--apps", "wdl", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(out.read_text())
    assert rec["meta"]["apps"] == ["ptb", "wdl"]
    assert rec["meta"]["device"] == "cpu"
    assert rec["meta"]["objective"]["name"] == "geomean"
    assert set(rec["per_app"]) == {"ptb", "wdl"}
    assert rec["best"] == rec["multiapp"]["selected"]


def test_cuda_without_a_gpu_raises(monkeypatch):
    """Asking for the GPU where there is none fails; it never carries on
    on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Study(apps=["ptb"], device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Study(apps=["ptb"])                        # the default is cuda


@pytest.mark.parametrize("kwargs", [{"workers": 2}, {"composition": 2},
                                    {"evaluator": object()}])
def test_features_of_a_later_slice_raise(kwargs):
    with pytest.raises(NotImplementedError, match="later slice"):
        Study(apps=["ptb"], device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Study(apps=["ptb"], device="cpu").run(checkpoint_path="ckpt.json")
