"""The port's checkpoint/resume on the CPU: for every engine and crash
point the checkpoint's `completed` fragments are byte-equal to the JAX
package's and `Study.resume` reproduces the uninterrupted JSON; a crashed
pool run resumes serially, a killed worker costs one retry round;
`from_spec` rebuilds the problem with the execution resources as
overrides (device and backend default to the constructor's, never to the
recorded hints); `constraint_from_describe` round-trips the built-ins; the
CLI's `--workers 2 --checkpoint-every 1` and `--resume` give the same
bytes."""

import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro.dse as ref_dse
from repro_torch.core.multiapp import AppSpec
from repro_torch.dse import (AreaBudget, FaultPlan, MaxPerf, ParallelExecutor,
                             ParetoObjective, PeakBuffers, SearchBudget,
                             Study, UserConstraint, constraint_from_describe)

ROOT = Path(__file__).resolve().parents[1]

# `tests/test_parallel_study.py`'s per-engine budgets, as plain kwargs
ENGINE_BUDGETS = {
    "greedy": dict(k=2, restarts=1, max_rounds=3),
    "anneal": dict(restarts=1, max_rounds=4, engine_kwargs={"chains": 3}),
    "genetic": dict(restarts=1, max_rounds=4,
                    engine_kwargs={"population": 12}),
    "random": dict(restarts=1, max_rounds=3, engine_kwargs={"batch": 12}),
    "tpe": dict(restarts=1, max_rounds=4,
                engine_kwargs={"batch": 12, "startup_rounds": 1}),
    "nsga2": dict(restarts=1, max_rounds=4,
                  engine_kwargs={"population": 12}),
}
SMALL = dict(apps=["ptb", "wdl"], engine="greedy",
             budget=SearchBudget(**ENGINE_BUDGETS["greedy"]), seed=0)


class Crash(Exception):
    pass


def crash_at(boundary):
    def boom(n):
        if n == boundary:
            raise Crash
    return boom


def result_bytes(result) -> str:
    return json.dumps(result.to_json(), sort_keys=True)


def without(result, keys=("device", "backend")) -> dict:
    rec = result.to_json()
    rec["meta"] = {k: v for k, v in rec["meta"].items() if k not in keys}
    return rec


@pytest.mark.parametrize("engine", sorted(ENGINE_BUDGETS))
def test_resume_is_bit_identical_and_fragments_equal_the_reference(
        engine, tmp_path):
    """Crash right after each checkpoint write: the `completed` section is
    byte-equal to the reference's at the same boundary, and `Study.resume`
    gives the uninterrupted run's JSON and removes the checkpoint."""
    kw = dict(apps=["ptb", "wdl"], engine=engine, seed=0)
    port_kw = dict(budget=SearchBudget(**ENGINE_BUDGETS[engine]),
                   device="cpu", **kw)
    baseline = result_bytes(Study(**port_kw).run())
    for boundary in (1, 2):
        ckpts = {}
        for tag, make in (
                ("ref", lambda: ref_dse.Study(
                    budget=ref_dse.SearchBudget(**ENGINE_BUDGETS[engine]),
                    **kw)),
                ("port", lambda: Study(**port_kw))):
            ckpts[tag] = tmp_path / f"{engine}.{boundary}.{tag}.ckpt"
            with pytest.raises(Crash):
                make().run(checkpoint_path=ckpts[tag], checkpoint_every=1,
                           on_checkpoint=crash_at(boundary))
        recs = {t: json.loads(p.read_text()) for t, p in ckpts.items()}
        assert recs["port"]["kind"] == "study-checkpoint"
        assert len(recs["port"]["completed"]) == boundary
        assert (json.dumps(recs["port"]["completed"])
                == json.dumps(recs["ref"]["completed"]))
        assert recs["port"]["study"]["device"] == "cpu"
        resumed = Study.resume(ckpts["port"], device="cpu")
        assert result_bytes(resumed) == baseline
        assert not ckpts["port"].exists()


def test_resume_under_parallel_workers(tmp_path):
    """Crash a workers=2 run, resume at workers=1: the same bytes."""
    baseline = result_bytes(Study(device="cpu", **SMALL).run())
    ckpt = tmp_path / "par.ckpt"
    with pytest.raises(Crash):
        Study(workers=2, device="cpu", **SMALL).run(
            checkpoint_path=ckpt, checkpoint_every=1,
            on_checkpoint=crash_at(1))
    assert json.loads(ckpt.read_text())["study"]["workers"] == 2
    assert result_bytes(Study.resume(ckpt, workers=1,
                                     device="cpu")) == baseline


def test_worker_kill_breaks_pool_then_recovers(tmp_path):
    """A SIGKILLed worker poisons the whole pool; exactly one fresh retry
    pool finishes the study with the serial result."""
    baseline = result_bytes(Study(device="cpu", **SMALL).run())
    ex = ParallelExecutor(workers=2,
                          fault=FaultPlan(state_dir=str(tmp_path / "f2"),
                                          mode="kill", times=1,
                                          task_index=0))
    assert result_bytes(Study(executor=ex, device="cpu",
                              **SMALL).run()) == baseline
    assert ex.retry_rounds == 1
    assert not ex.degraded


def test_resume_roundtrips_customized_vector_objective(tmp_path):
    obj = ParetoObjective(method="hypervolume", weights=[2.0, 1.0], rho=0.2)
    kw = dict(apps=["ptb", "wdl"], engine="genetic", objective=obj,
              budget=SearchBudget(restarts=1, max_rounds=4,
                                  engine_kwargs={"population": 12}),
              seed=0, device="cpu")
    baseline = result_bytes(Study(**kw).run())
    spec = obj.describe()
    ckpt = tmp_path / "vec.ckpt"
    with pytest.raises(Crash):
        Study(**kw).run(checkpoint_path=ckpt, checkpoint_every=1,
                        on_checkpoint=crash_at(1))
    assert json.loads(ckpt.read_text())["study"]["objective"] == spec
    resumed = Study.resume(ckpt, device="cpu")
    assert resumed.meta["objective"] == spec
    assert result_bytes(resumed) == baseline


def test_checkpoint_requires_rebuildable_spec(tmp_path):
    study = Study(apps=[AppSpec.from_app("ptb")], objective=MaxPerf(),
                  budget=SearchBudget(restarts=1, max_rounds=2),
                  device="cpu")
    with pytest.raises(ValueError, match="AppSpec"):
        study.run(checkpoint_path=tmp_path / "x.ckpt")
    assert not (tmp_path / "x.ckpt").exists()
    p = tmp_path / "junk.json"
    p.write_text("{}")
    with pytest.raises(ValueError, match="not a study checkpoint"):
        Study.resume(p, device="cpu")


def test_from_spec_takes_device_and_backend_as_overrides(tmp_path,
                                                          monkeypatch):
    """A checkpoint written on the CPU names the CPU only as a hint: with
    no override the rebuilt study asks for the GPU (and so fails here);
    with overrides the result equals the uninterrupted run outside
    meta's device and backend."""
    kw = dict(device="cpu", **SMALL)
    base = Study(**kw)
    baseline = base.run()
    spec = base._spec_record()
    assert (spec["device"], spec["backend"], spec["workers"]) == ("cpu",
                                                                  "fused", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        Study.from_spec(spec)
    rebuilt = Study.from_spec(spec, device="cpu", backend="broadcast",
                              workers=3)
    assert (str(rebuilt.device), rebuilt.backend, rebuilt.workers) == (
        "cpu", "broadcast", 3)
    ckpt = tmp_path / "cpu.ckpt"
    with pytest.raises(Crash):
        Study(**kw).run(checkpoint_path=ckpt, checkpoint_every=1,
                        on_checkpoint=crash_at(1))
    with pytest.raises(RuntimeError, match="is_available"):
        Study.resume(ckpt)
    assert ckpt.exists()
    resumed = Study.resume(ckpt, device="cpu", backend="broadcast")
    assert resumed.meta["backend"] == "broadcast"
    assert without(resumed) == without(baseline)


def test_constraint_from_describe_round_trips_the_built_ins():
    for c in (AreaBudget(45000.0), PeakBuffers(weight_bits=1 << 20,
                                               input_bits=1 << 18)):
        back = constraint_from_describe(c.describe())
        assert type(back) is type(c)
        assert back.describe() == c.describe()
    user = UserConstraint(lambda batch, metrics: metrics["area"] > 0,
                          name="positive-area")
    with pytest.raises(ValueError, match="not reconstructible"):
        constraint_from_describe(user.describe())
    with pytest.raises(ValueError, match="not reconstructible"):
        Study(apps=["ptb"], constraints=[user],
              device="cpu")._require_resumable()


def test_cli_workers_checkpoint_and_resume_give_the_same_bytes(tmp_path):
    """`--workers 2 --checkpoint-every 1` writes the study JSON (and
    removes its checkpoint); a checkpoint crashed at boundary 1 resumed
    through `--resume` writes the same bytes."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    flags = ["--device", "cpu", "--smoke", "--apps", "ptb", "--apps", "wdl"]

    def cli(*args):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.dse", *flags, *args],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=180)
        assert proc.returncode == 0, proc.stderr

    cli("--workers", "2", "--checkpoint-every", "1", "--out", "pool.json")
    assert not (tmp_path / "pool.json.ckpt").exists()
    # the CLI's study, crashed after its first app
    from repro_torch.dse.cli import study_from_cli
    study, _ = study_from_cli(flags + ["--out", str(tmp_path / "x.json")])
    ckpt = tmp_path / "crashed.ckpt"
    with pytest.raises(Crash):
        study.run(checkpoint_path=ckpt, checkpoint_every=1,
                  on_checkpoint=crash_at(1))
    cli("--resume", str(ckpt), "--out", "resumed.json")
    assert filecmp.cmp(tmp_path / "pool.json", tmp_path / "resumed.json",
                       shallow=False)
    assert not ckpt.exists()
