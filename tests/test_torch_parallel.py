"""The port's parallel Study (`repro_torch.dse.parallel`) on the CPU: the
`StudyResult` JSON of every engine equals the JAX package's at workers=1
and is byte-identical at workers=2, the sharded cross-evaluation equals the
serial one, worker faults retry or degrade as the reference's do, every
pool task reports its process and kernel launches, and the Pareto-front
reductions are order-invariant.

Each pool worker is a spawned interpreter that imports torch (seconds), so
this file starts few pools: one per engine, two for the fault tests, one
for the sharded cross-evaluation."""

import json
import os
import random

import numpy as np
import pytest

import repro.dse as ref_dse
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.space import default_space
from repro_torch.dse import (FaultPlan, ParallelExecutionWarning,
                             ParallelExecutor, SearchBudget, Study,
                             canonical_front_indices, merge_pareto_fronts)
from repro_torch.dse.parallel import (EvalParams, _score_shard_task,
                                      score_population_sharded, shard_rows)

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
             budget=SearchBudget(**ENGINE_BUDGETS["greedy"]), seed=0,
             device="cpu")


def result_bytes(result) -> str:
    return json.dumps(result.to_json(), sort_keys=True)


def problem_bytes(result) -> str:
    """The JSON outside the execution resources (device, backend)."""
    rec = result.to_json()
    rec["meta"] = {k: v for k, v in rec["meta"].items()
                   if k not in ("device", "backend")}
    return json.dumps(rec, sort_keys=True)


@pytest.mark.parametrize("engine", sorted(ENGINE_BUDGETS))
def test_every_engine_equals_the_reference_and_is_worker_invariant(engine):
    """workers=1 equals the JAX package's study outside device/backend;
    workers=2 (a spawn pool, one task per app) is byte-identical to
    workers=1.  The greedy case also shards its cross-evaluation over the
    pool."""
    kw = dict(apps=["ptb", "wdl"], engine=engine, seed=0)
    ref = ref_dse.Study(budget=ref_dse.SearchBudget(**ENGINE_BUDGETS[engine]),
                        **kw).run()
    serial = Study(budget=SearchBudget(**ENGINE_BUDGETS[engine]),
                   device="cpu", **kw).run()
    assert problem_bytes(serial) == problem_bytes(ref)
    pooled = Study(budget=SearchBudget(**ENGINE_BUDGETS[engine]),
                   device="cpu", workers=2, **kw)
    if engine == "greedy":
        pooled.cross_eval_shard_min = 1        # force the sharded path
    assert result_bytes(pooled.run()) == result_bytes(serial)
    tasks = pooled.launch_stats["tasks"]
    fns = {t["fn"] for t in tasks}
    assert "_search_app_task" in fns
    if engine == "greedy":
        assert "_cross_eval_task" in fns
    # every task ran in a worker, not in this process, and on the CPU the
    # scorer launches no kernel anywhere
    assert all(t["pool"] and t["pid"] != os.getpid() for t in tasks)
    assert pooled.launch_stats["workers"] == 0
    assert pooled.launch_stats["parent"] == 0


def test_serial_run_goes_through_the_executor_in_process():
    study = Study(**SMALL)
    study.run()
    tasks = study.launch_stats["tasks"]
    assert [t["fn"] for t in tasks] == ["_search_app_task"] * 2
    assert all(not t["pool"] and t["pid"] == os.getpid() for t in tasks)
    assert [t["task"] for t in tasks] == [0, 1]


def test_worker_raise_retries_then_succeeds(tmp_path):
    """One injected worker raise: a retry round recovers, no degradation,
    the serial result."""
    baseline = result_bytes(Study(**SMALL).run())
    ex = ParallelExecutor(workers=2,
                          fault=FaultPlan(state_dir=str(tmp_path / "f1"),
                                          mode="raise", times=1))
    assert result_bytes(Study(executor=ex, **SMALL).run()) == baseline
    assert ex.retry_rounds == 1
    assert not ex.degraded
    assert len(ex.pool_start_seconds) == 2


def test_persistent_faults_degrade_to_serial_with_warning(tmp_path):
    """When every pool round fails, the study falls back to in-process
    serial execution, warns, and still returns the serial result."""
    baseline = result_bytes(Study(**SMALL).run())
    ex = ParallelExecutor(workers=2, max_retries=0,
                          fault=FaultPlan(state_dir=str(tmp_path / "f3"),
                                          mode="raise", times=999))
    with pytest.warns(ParallelExecutionWarning, match="serial"):
        got = result_bytes(Study(executor=ex, **SMALL).run())
    assert got == baseline
    assert ex.degraded
    assert ex.retry_rounds == 0
    # the degraded tasks ran here
    assert all(not t["pool"] for t in ex.tasks)


def test_sharded_cross_eval_and_population_match_serial():
    """The sharded [n_apps, n_cands] cross-evaluation and the sharded
    population score concatenate back to exactly the serial arrays."""
    space = default_space()
    specs = [AppSpec.from_app(n) for n in ("ptb", "wdl")]
    rng = np.random.default_rng(0)
    cands = [space.sample(rng) for _ in range(37)]
    serial = Study(apps=specs, space=space, device="cpu")._cross_eval(cands)
    ex = ParallelExecutor(workers=3)
    par = Study(apps=specs, space=space, device="cpu", executor=ex)
    par.cross_eval_shard_min = 1
    np.testing.assert_array_equal(par._cross_eval(cands), serial)
    assert len(ex.tasks) == 3 and all(t["pool"] for t in ex.tasks)
    # the population scorer, with the serial executor (no second pool)
    params = EvalParams(stream=specs[0].stream, hw=space.hw,
                        peak_weight_bits=specs[0].peak_weight_bits,
                        peak_input_bits=specs[0].peak_input_bits,
                        area_budget=space.area_budget, device="cpu")
    from repro_torch.core.costmodel import ConfigBatch
    batch = ConfigBatch.from_configs(cands)
    one = _score_shard_task({"params": params, "batch": batch})
    sharded = score_population_sharded(params, batch,
                                        ParallelExecutor(workers=1))
    np.testing.assert_array_equal(sharded, one)
    assert [len(r) for r in shard_rows(37, 3)] == [13, 12, 12]
    assert shard_rows(0, 3) == []


def _double(x):
    return 2 * x


def test_executor_map_orders_and_streams():
    ex = ParallelExecutor(workers=1)
    seen = []
    out = ex.map(_double, [3, 1, 2], on_result=lambda i, r: seen.append(i))
    assert out == [6, 2, 4]
    assert seen == [0, 1, 2]
    assert [t["task"] for t in ex.tasks] == [0, 1, 2]
    assert all(t["launches"] == 0 and t["fn"] == "_double"
               for t in ex.tasks)


def test_eval_params_carry_device_and_backend():
    spec = AppSpec.from_app("ptb")
    study = Study(apps=["ptb"], device="cpu", backend="broadcast")
    params = study._eval_params(spec)
    assert params.device == "cpu" and params.backend == "broadcast"
    ev = params.build()
    assert str(ev.device) == "cpu" and ev.backend == "broadcast"
    assert ev.scorer is None


def test_merge_pareto_fronts_is_order_invariant():
    """Shard fronts merged in any arrival order / shard split produce one
    identical global front."""
    space = default_space()
    rng = np.random.default_rng(7)
    pool = [space.sample(rng) for _ in range(60)]
    perf = rng.uniform(10.0, 1000.0, len(pool))
    area = np.asarray([c.area(space.hw) for c in pool])
    entries = list(zip(pool, perf, area))

    def split(n_shards, seed):
        shuffled = entries[:]
        random.Random(seed).shuffle(shuffled)
        return [shuffled[i::n_shards] for i in range(n_shards)]

    ref = merge_pareto_fronts([entries])
    assert ref, "test front must be non-empty"
    for n_shards, seed in ((2, 0), (3, 1), (5, 2)):
        got = merge_pareto_fronts(split(n_shards, seed))
        assert [(e[1], e[2]) for e in got] == [(e[1], e[2]) for e in ref]
        assert [e[0].asdict() for e in got] == [e[0].asdict() for e in ref]
    assert merge_pareto_fronts([entries, entries]) == ref
    bad = [(pool[0], float(perf[0]) + 1.0, float(area[0]))]
    with pytest.raises(ValueError, match="conflicting"):
        merge_pareto_fronts([entries, bad])


def test_canonical_front_ties_break_by_content():
    perf = np.asarray([5.0, 5.0, 3.0, 0.0])
    area = np.asarray([10.0, 10.0, 4.0, 1.0])
    keys = ["b", "a", "c", "d"]
    assert canonical_front_indices(perf, area, keys) == [2, 1]
    rev = canonical_front_indices(perf[::-1].copy(), area[::-1].copy(),
                                  keys[::-1])
    assert rev == [1, 2]
