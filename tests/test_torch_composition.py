"""The port's heterogeneous compositions on the CPU, against the JAX
package: the partition enumerations, the traffic mix and
`composition_score` equal the reference's; `CompositionEvaluator`'s
`app_matrix` and scores are bit-equal to the reference's; `Study(
composition=2)` equals the reference's JSON (outside device and backend)
for every engine at workers=1 and is byte-identical at workers=2; it
resumes bit for bit; the composition sweep's configuration (qwen2-0.5b
prefill + decode, genetic, 90,000 area) picks the reference's composition,
score and monolithic score; `explain_composition` equals the
reference's."""

import json

import numpy as np
import pytest

import repro.core.search.partition as ref_partition
import repro.dse as ref_dse
import repro_torch.dse as port_dse
from repro.core.multiapp import AppSpec as RefAppSpec
from repro.core.costmodel import AccelConfig as RefAccelConfig
from repro.obs.attribution import explain_composition as ref_explain
from repro_torch import obs
from repro_torch.core.costmodel import AccelConfig, HardwareConstants
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import Evaluator, partition
from repro_torch.core.space import default_space
from repro_torch.dse import (Composition, CompositionEvaluator, SearchBudget,
                             Study, TrafficMix, composition_score,
                             merge_pareto_fronts)
from repro_torch.dse.composition import cross_gops, total_area
from repro_torch.obs.attribution import explain_composition

HW = HardwareConstants()
SWEEP_APPS = ["qwen2-0.5b:prefill", "qwen2-0.5b:decode"]

# `tests/test_composition.py`'s per-engine budgets, as plain kwargs
ENGINE_BUDGETS = {
    "greedy": dict(k=2, restarts=1, max_rounds=3),
    "anneal": dict(restarts=1, max_rounds=3, engine_kwargs={"chains": 3}),
    "genetic": dict(restarts=1, max_rounds=3,
                    engine_kwargs={"population": 12}),
    "random": dict(restarts=1, max_rounds=2, engine_kwargs={"batch": 12}),
    "tpe": dict(restarts=1, max_rounds=3,
                engine_kwargs={"batch": 12, "startup_rounds": 1}),
    "nsga2": dict(restarts=1, max_rounds=3,
                  engine_kwargs={"population": 12}),
}
COMP_KW = dict(apps=["ptb", "wdl"], composition=2, seed=0)


def result_bytes(result) -> str:
    return json.dumps(result.to_json(), sort_keys=True)


def problem_bytes(result) -> str:
    rec = result.to_json()
    rec["meta"] = {k: v for k, v in rec["meta"].items()
                   if k not in ("device", "backend")}
    return json.dumps(rec, sort_keys=True)


def _cfgs():
    return [dict(), dict(tof=16), dict(mac_per_group=128),
            dict(pe_group=16, tof=32)]


# ---------------------------------------------------------- combinatorics

@pytest.mark.parametrize("n,k,grid", [(2, 1, 4), (2, 2, 4), (3, 2, 4),
                                      (4, 2, 3), (4, 3, 5), (5, 3, 6)])
def test_partition_enumerations_equal_the_reference(n, k, grid):
    assert (partition.enumerate_assignments(n, k)
            == ref_partition.enumerate_assignments(n, k))
    assert (partition.enumerate_assignments(n, k, limit=2)
            == ref_partition.enumerate_assignments(n, k, limit=2))
    assert (partition.enumerate_splits(k, grid)
            == ref_partition.enumerate_splits(k, grid))
    assert partition.tier_shares(k, grid) == ref_partition.tier_shares(k,
                                                                        grid)
    got = [p.to_json() for p in partition.enumerate_partitions(n, k, grid)]
    want = [p.to_json()
            for p in ref_partition.enumerate_partitions(n, k, grid)]
    assert got == want
    for a in partition.enumerate_assignments(n, k):
        assert (partition.group_members(a, k)
                == ref_partition.group_members(a, k))


def test_partition_rejections_and_round_trip():
    with pytest.raises(ValueError, match="surjectively"):
        partition.enumerate_assignments(1, 2)
    with pytest.raises(ValueError, match="too coarse"):
        partition.enumerate_splits(3, 2)
    p = partition.Partition(assignment=(0, 1, 0), split=(0.75, 0.25))
    assert p.groups() == [[0, 2], [1]]
    assert partition.Partition.from_json(p.to_json()) == p
    with pytest.raises(ValueError, match="sum to 1"):
        partition.Partition(assignment=(0, 1), split=(0.5, 0.4))


# ------------------------------------------------------------ traffic mix

def test_traffic_mix_and_score_equal_the_reference():
    for spec, apps in (({"a": 3, "b": 1}, ["a", "b"]), (None, ["a", "b", "c"]),
                       ({"x": 0.2, "y": 0.7, "z": 1.1}, ["x", "y", "z"])):
        got = TrafficMix.of(spec, apps)
        want = ref_dse.TrafficMix.of(spec, apps)
        assert got.weights == want.weights
        assert got.to_json() == want.to_json()
    with pytest.raises(ValueError, match="unknown"):
        TrafficMix.of({"a": 1, "z": 1}, ["a", "b"])
    with pytest.raises(ValueError, match="missing"):
        TrafficMix.of({"a": 1}, ["a", "b"])
    rng = np.random.default_rng(3)
    for assignment in ((0, 0), (0, 1), (0, 1, 0), (0, 1, 2)):
        n = len(assignment)
        for _ in range(5):
            w = rng.dirichlet(np.ones(n))
            g = rng.uniform(0.0, 500.0, n)
            assert (composition_score(w, assignment, g)
                    == ref_dse.composition_score(w, assignment, g))
    assert composition_score([0.5, 0.5], (0, 1), [100.0, 0.0]) == 0.0


def test_composition_identity_and_json():
    e0, e1 = AccelConfig(tof=8), AccelConfig(tof=16)
    a = Composition(engines=(e0, e1), assignment=(0, 1), apps=("x", "y"),
                    split=(0.25, 0.75))
    b = Composition(engines=(e0, e1), assignment=(0, 1), apps=("x", "y"),
                    split=(0.5, 0.5))
    assert a.key() == b.key()
    assert Composition.from_json(a.to_json()) == a
    ref = ref_dse.Composition(
        engines=(RefAccelConfig(tof=8), RefAccelConfig(tof=16)),
        assignment=(0, 1), apps=("x", "y"), split=(0.25, 0.75))
    assert a.to_json() == ref.to_json()
    assert a.asdict() == ref.asdict()
    with pytest.raises(ValueError, match="every one"):
        Composition(engines=(e0, e1), assignment=(0, 0), apps=("x", "y"))


# ------------------------------------------------- CompositionEvaluator

def test_app_matrix_is_bit_equal_to_the_reference():
    names = ["ptb", "wdl", "resnet"]
    specs = [AppSpec.from_app(n) for n in names]
    ref_specs = [RefAppSpec.from_app(n) for n in names]
    space = default_space()
    rng = np.random.default_rng(0)
    cands = [AccelConfig(**d) for d in _cfgs()]
    cands += [space.sample(rng) for _ in range(40)]
    ref_cands = [RefAccelConfig(**c.asdict()) for c in cands]
    ev = CompositionEvaluator(specs, hw=HW, device="cpu",
                              domains=space.domains)
    gops, area = ev.app_matrix(cands)
    rgops, rarea = ref_dse.CompositionEvaluator(ref_specs).app_matrix(
        ref_cands)
    assert gops.tobytes() == rgops.tobytes()
    assert area.tobytes() == rarea.tobytes()
    np.testing.assert_array_equal(gops, cross_gops(specs, cands, HW,
                                                   device="cpu"))
    np.testing.assert_array_equal(area, total_area(cands, HW))
    gops2, _ = ev.app_matrix(cands)
    np.testing.assert_array_equal(gops, gops2)
    assert ev.stats()["cache_hits"] > 0
    # the broadcast backend gives the same bits
    bc = CompositionEvaluator(specs, hw=HW, device="cpu",
                              backend="broadcast")
    assert bc.app_matrix(cands)[0].tobytes() == gops.tobytes()


def test_scores_rates_budget_and_warm_from_equal_the_reference():
    specs = [AppSpec.from_app("ptb"), AppSpec.from_app("wdl")]
    ref_specs = [RefAppSpec.from_app("ptb"), RefAppSpec.from_app("wdl")]
    e0, e1 = AccelConfig(), AccelConfig(tof=16)
    comp = Composition(engines=(e0, e1), assignment=(0, 1),
                       apps=("ptb", "wdl"))
    ref_comp = ref_dse.Composition.from_json(comp.to_json())
    traffic = {"ptb": 3, "wdl": 1}
    ev = CompositionEvaluator(specs, hw=HW, traffic=traffic, device="cpu")
    ref_ev = ref_dse.CompositionEvaluator(ref_specs, traffic=traffic)
    s, a = ev.score_with_area([comp])
    rs, ra = ref_ev.score_with_area([ref_comp])
    assert s.tobytes() == rs.tobytes() and a.tobytes() == ra.tobytes()
    assert ev.per_app_rates(comp) == ref_ev.per_app_rates(ref_comp)
    tight = CompositionEvaluator(specs, hw=HW, area_budget=a[0] - 1,
                                 device="cpu")
    s2, a2 = tight.score_with_area([comp])
    assert s2[0] == 0.0 and a2[0] == a[0]
    # explain on this evaluator's device equals the reference's, and the
    # scorer's number
    got = ev.explain(comp)
    assert got.to_json() == ref_ev.explain(ref_comp).to_json()
    assert got.table() == ref_ev.explain(ref_comp).table()
    assert got.score == float(s[0])
    # a search evaluator's cache merges straight in
    search_ev = Evaluator(specs[0].stream, hw=HW,
                          peak_weight_bits=specs[0].peak_weight_bits,
                          peak_input_bits=specs[0].peak_input_bits,
                          device="cpu")
    search_ev.score_with_area([e0, e1])
    fresh = CompositionEvaluator([specs[0]], hw=HW, device="cpu")
    assert fresh.warm_from("ptb", search_ev.cache_export()) == 2
    fresh.app_matrix([e0, e1])
    assert fresh.stats()["cache_hits"] >= 2
    assert fresh.stats()["scored"] == 0


def test_merge_pareto_fronts_tolerates_empty_shards():
    assert merge_pareto_fronts([]) == []
    assert merge_pareto_fronts([None, []]) == []
    real = [(AccelConfig(), 10.0, 100.0), (AccelConfig(tof=16), 20.0, 200.0)]
    merged = merge_pareto_fronts([None, [], real, ()])
    assert [(p, a) for _, p, a in merged] == [(10.0, 100.0), (20.0, 200.0)]


# ------------------------------------------- Study(composition=K) e2e

@pytest.mark.parametrize("engine", sorted(ENGINE_BUDGETS))
def test_composition_study_equals_the_reference_at_both_worker_counts(
        engine):
    kw = dict(engine=engine, **COMP_KW)
    ref = ref_dse.Study(budget=ref_dse.SearchBudget(**ENGINE_BUDGETS[engine]),
                        **kw).run()
    serial = Study(budget=SearchBudget(**ENGINE_BUDGETS[engine]),
                   device="cpu", **kw).run()
    assert problem_bytes(serial) == problem_bytes(ref)
    assert isinstance(serial.best, Composition)
    pooled = Study(budget=SearchBudget(**ENGINE_BUDGETS[engine]),
                   device="cpu", workers=2, **kw)
    assert result_bytes(pooled.run()) == result_bytes(serial)
    assert len(pooled.launch_stats["tasks"]) == 6      # 2 apps x 3 tiers


def test_composition_study_with_traffic_resumes_and_is_telemetry_inert(
        tmp_path):
    kw = dict(engine="random",
              budget=SearchBudget(**ENGINE_BUDGETS["random"]),
              traffic={"ptb": 2, "wdl": 1}, device="cpu", **COMP_KW)
    res = Study(**kw).run()
    baseline = result_bytes(res)
    assert res.meta["composition"]["traffic"] == {"ptb": 2 / 3,
                                                  "wdl": 1 - 2 / 3}
    assert sorted(res.per_app) == ["ptb@0.25", "ptb@0.5", "ptb@0.75",
                                   "wdl@0.25", "wdl@0.5", "wdl@0.75"]
    loaded = json.loads(baseline)
    assert loaded["best"]["kind"] == "composition"

    class Crash(Exception):
        pass

    for boundary in (1, 3, 5):
        ckpt = tmp_path / f"comp.{boundary}.ckpt"

        def boom(n, stop=boundary):
            if n == stop:
                raise Crash

        with pytest.raises(Crash):
            Study(**kw).run(checkpoint_path=ckpt, checkpoint_every=1,
                            on_checkpoint=boom)
        frag = json.loads(ckpt.read_text())
        assert frag["study"]["composition"]["k"] == 2
        assert result_bytes(Study.resume(ckpt, device="cpu")) == baseline
        assert not ckpt.exists()
    obs.enable(trace=True, metrics=True, journal=True)
    try:
        traced = Study(**kw).run()
    finally:
        obs.disable(reset=True)
    assert "telemetry" in traced.meta
    assert result_bytes(traced) == baseline


def _sweep(mod, **dev):
    """`benchmarks/composition_sweep.py`'s full configuration: the K=2
    study and the monolithic Pareto study, and the monolithic pick scored
    as the K=1 composition."""
    budget = mod.SearchBudget(restarts=2, max_rounds=16,
                              engine_kwargs={"population": 32, "chains": 4,
                                             "batch": 32})
    area_budget = float(default_space().area_budget)
    comp = mod.Study(apps=SWEEP_APPS, composition=2, engine="genetic",
                     budget=budget, seed=0, area_budgets=[area_budget],
                     name="composition-sweep", **dev)
    res = comp.run()
    mono = mod.Study(apps=SWEEP_APPS, objective="pareto", engine="genetic",
                     budget=budget, seed=0, area_budgets=[area_budget],
                     name="composition-sweep-mono", **dev).run()
    ev = mod.CompositionEvaluator(comp.specs, area_budget=area_budget,
                                  **dev)
    mono_comp = mod.Composition(engines=(mono.best,), assignment=(0, 0),
                                apps=tuple(SWEEP_APPS))
    return res, ev.score_one(mono_comp), comp.specs, area_budget


def test_composition_sweep_configuration_equals_the_reference():
    got, got_mono, specs, area_budget = _sweep(port_dse, device="cpu")
    want, want_mono, ref_specs, _ = _sweep(ref_dse)
    assert area_budget == 90000.0
    assert problem_bytes(got) == problem_bytes(want)
    assert got.best.to_json() == want.best.to_json()
    assert got.best_score == want.best_score
    assert got_mono == want_mono
    # the composition beats the monolithic design at the same area
    assert got.best_score > got_mono
    assert got.best.area(HW) <= area_budget
    explained = explain_composition(got.best, specs, hw=HW,
                                    area_budget=area_budget, device="cpu")
    want_exp = ref_explain(want.best, ref_specs, area_budget=area_budget)
    assert explained.to_json() == want_exp.to_json()
    assert explained.score == got.best_score


@pytest.mark.parametrize("kwargs,match", [
    (dict(apps=["ptb"], composition=2), "at least"),
    (dict(apps=["ptb", "wdl"], composition=2, split_grid=1), "too coarse"),
    (dict(apps=["ptb", "wdl"], composition=2, objective="geomean"),
     "ParetoObjective"),
    (dict(apps=["ptb", "wdl"], traffic={"ptb": 1, "wdl": 1}),
     "composition > 1"),
])
def test_study_rejects_what_the_reference_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        ref_dse.Study(**kwargs)
    with pytest.raises(ValueError, match=match):
        Study(device="cpu", **kwargs)
