"""The port's Pareto studies on the CPU against the JAX package's.

`ParetoObjective` (values, both scalarizers and their running bounds),
the front reduction helpers, and the `pareto_result` study of
`tests/test_dse_study.py` (ptb + wdl, three area budgets) must equal the
reference's exactly: the front's configs, scores, areas and per-app GOPS,
and the budget selections.  Then rerun reproducibility, the save/load
round trip and the CLI's new flags.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.dse as ref_dse
import repro_torch.dse as port_dse
from repro.core import apps as ref_apps
from repro.dse import parallel as ref_parallel
from repro_torch import obs
from repro_torch.convert import ops_from_records
from repro_torch.core.costmodel import AccelConfig
from repro_torch.core.search import Evaluator, make_engine
from repro_torch.core.space import default_space
from repro_torch.dse import (GeomeanAcrossApps, ParetoObjective,
                             SearchBudget, Study, StudyResult,
                             canonical_front_indices, make_objective,
                             merge_pareto_fronts, study_from_cli)
from repro_torch.dse.cli import main
from repro_torch.dse.study import DEFAULT_BUDGET_FACTORS

BUDGETS = (30000.0, 60000.0, 90000.0)


def pareto_study(mod, engine="genetic", **kw):
    return mod.Study(apps=["ptb", "wdl"],
                     objective=mod.ParetoObjective(["perf", "-area"]),
                     engine=engine,
                     budget=mod.SearchBudget(
                         restarts=1, max_rounds=6,
                         engine_kwargs={"population": 20}),
                     area_budgets=BUDGETS, seed=0, **kw)


@pytest.fixture(scope="module")
def results():
    """{engine: (reference result, port result)}."""
    return {e: (pareto_study(ref_dse, e).run(),
                pareto_study(port_dse, e, device="cpu").run())
            for e in ("genetic", "nsga2")}


@pytest.fixture(autouse=True)
def obs_off():
    obs.disable(reset=True)
    yield
    obs.disable(reset=True)


# ----------------------------------------------------------- objective

@pytest.mark.parametrize("method", ["chebyshev", "hypervolume"])
def test_pareto_objective_equals_reference(method):
    """Values and the scalarizer over a sequence of batches: the running
    normalization bounds are state, so the sequence matters."""
    rng = np.random.default_rng(0)
    ref = ref_dse.ParetoObjective(["perf", "-area"], method=method,
                                  weights=[2.0, 1.0])
    port = ParetoObjective(["perf", "-area"], method=method,
                           weights=[2.0, 1.0])
    for step in range(6):
        n = int(rng.integers(1, 40))
        perf = rng.uniform(0, 3000, n) * (rng.random(n) > 0.3)
        metrics = {"perf": perf, "area": rng.uniform(1e4, 1e5, n)}
        v_ref, v_port = ref.values(metrics), port.values(metrics)
        np.testing.assert_array_equal(v_port, v_ref)
        np.testing.assert_array_equal(port.scalarize(v_port),
                                      ref.scalarize(v_ref),
                                      err_msg=f"step {step}")
        np.testing.assert_array_equal(port.score(metrics),
                                      ref.score(metrics))
    assert port.describe() == ref.describe()


def test_pareto_objective_validation_and_registry():
    with pytest.raises(ValueError):
        ParetoObjective(["perf"])
    with pytest.raises(ValueError, match="scalarization"):
        ParetoObjective(method="sideways")
    with pytest.raises(ValueError, match="maximize"):
        ParetoObjective(["-perf", "-area"])
    obj = make_objective("pareto")
    assert isinstance(obj, ParetoObjective)
    rebuilt = make_objective(ParetoObjective(
        ["perf", "-area"], method="hypervolume").describe())
    assert rebuilt.describe()["method"] == "hypervolume"


def test_front_helpers_equal_reference():
    rng = np.random.default_rng(1)
    perf = np.round(rng.uniform(-10, 100, 60))
    area = np.round(rng.uniform(1, 50, 60))
    keys = [(int(i) % 7, int(i)) for i in range(60)]
    assert (canonical_front_indices(perf, area, keys)
            == ref_parallel.canonical_front_indices(perf, area, keys))
    assert (canonical_front_indices(perf, area)
            == ref_parallel.canonical_front_indices(perf, area))
    space = default_space()
    cfgs = [space.sample(rng) for _ in range(30)]
    shards = [[(c, float(p), float(a)) for c, p, a in
               zip(cfgs[i::3], perf[i::3], area[i::3])] for i in range(3)]
    want = ref_parallel.merge_pareto_fronts(shards + [None, []])
    got = merge_pareto_fronts(
        [[(AccelConfig(**c.asdict()), p, a) for c, p, a in s]
         for s in shards] + [None, []])
    assert [(c.asdict(), p, a) for c, p, a in got] == \
        [(c.asdict(), p, a) for c, p, a in want]


def test_make_engine_installs_the_scalarizer():
    stream = ops_from_records(
        [{**dataclasses.asdict(op), "kind": op.kind.name}
         for op in ref_apps.build_app("wdl").op_stream().ops])
    ev = Evaluator(stream, area_budget=60000.0, device="cpu",
                   objective=ParetoObjective())
    eng = make_engine("genetic", default_space(), ev, seed=0, population=8)
    assert eng.scalarizer == ev.scalarize
    pool = eng.propose()
    rows = ev(pool)
    assert rows.shape == (len(pool), 2)
    np.testing.assert_array_equal(eng._scalar(rows), ev.scalarize(rows))
    plain = Evaluator(stream, device="cpu")
    assert make_engine("genetic", default_space(), plain,
                       seed=0).scalarizer is None


# ---------------------------------------------------------------- study

@pytest.mark.parametrize("engine", ["genetic", "nsga2"])
def test_pareto_study_equals_reference(engine, results):
    ref, port = (r.to_json() for r in results[engine])
    assert port["front"] == ref["front"]
    assert port["budget_selections"] == ref["budget_selections"]
    assert port["per_app"] == ref["per_app"]
    assert port["best"] == ref["best"]
    assert port["best_score"] == ref["best_score"]
    assert port["meta"]["area_budgets"] == list(BUDGETS)
    assert port["front"] and any(s is not None for s in
                                 port["budget_selections"].values())


def test_pareto_study_front_and_selections(results):
    res = results["genetic"][1]
    front = res.front
    for i, a in enumerate(front):
        for j, b in enumerate(front):
            if i != j:
                assert not (b.score >= a.score and b.area <= a.area
                            and (b.score > a.score or b.area < a.area))
    assert all(set(p.per_app) == {"ptb", "wdl"} for p in front)
    for b, sel in res.budget_selections.items():
        if sel is not None:
            assert sel["area"] <= float(b)
            assert sel["score"] == max(p.score for p in front
                                       if p.area <= float(b))
    for rec in res.per_app.values():
        assert rec["best_perf"] > 10.0              # GOPS, not scalarized
        assert 0.0 < rec["best_scalarized"] <= 1.2


def test_pareto_study_rerun_is_reproducible():
    study = Study(apps=["ptb", "wdl"], objective=ParetoObjective(),
                  engine="genetic",
                  budget=SearchBudget(restarts=1, max_rounds=4,
                                      engine_kwargs={"population": 12}),
                  seed=3, device="cpu")
    a, b = study.run(), study.run()
    assert a.to_json() == b.to_json()
    # the default sweep: 0.75x / 1x / 1.25x the space's budget
    assert study.area_budgets == tuple(
        f * default_space().area_budget for f in DEFAULT_BUDGET_FACTORS)


def test_study_result_save_load_roundtrip(results, tmp_path):
    res = results["genetic"][1]
    loaded = StudyResult.load(res.save(tmp_path / "study.json"))
    assert loaded.to_json() == res.to_json()
    assert loaded.best.asdict() == res.best.asdict()
    assert loaded.meta["objective"]["name"] == "pareto"
    assert [p.config.asdict() for p in loaded.front] == \
        [p.config.asdict() for p in res.front]


def test_pareto_study_rejections():
    with pytest.raises(ValueError, match="perf"):
        Study(apps=["ptb"], objective=ParetoObjective(["perf", "-energy"]),
              device="cpu")
    with pytest.raises(ValueError, match="area_budgets"):
        Study(apps=["ptb"], objective=GeomeanAcrossApps(),
              area_budgets=BUDGETS, device="cpu")


def test_broadcast_backend_study_equals_fused(results):
    """The same Pareto study scored by the broadcast pass."""
    res = pareto_study(port_dse, device="cpu", backend="broadcast").run()
    want = results["genetic"][1].to_json()
    got = res.to_json()
    assert got["meta"]["backend"] == "broadcast"
    for key in ("front", "budget_selections", "per_app", "best"):
        assert got[key] == want[key]


# ------------------------------------------------------------------ CLI

def test_cli_parses_the_new_flags():
    study, args = study_from_cli([
        "--apps", "ptb", "--apps", "wdl", "--objective", "pareto",
        "--budgets", "30000", "--budgets", "60000", "--budgets", "90000",
        "--backend", "broadcast", "--top-frac", "0.2", "--device", "cpu",
        "--radar", "--metrics", "--log-level", "info"])
    assert study.objective.name == "pareto"
    assert study.area_budgets == BUDGETS
    assert study.backend == "broadcast" and study.top_frac == 0.2
    assert args.radar and args.metrics and args.log_level == "info"
    with pytest.raises(ValueError, match="area_budgets"):
        study_from_cli(["--apps", "resnet", "--budgets", "30000",
                        "--device", "cpu"])
    with pytest.raises(SystemExit):
        study_from_cli(["--backend", "jax"])


def test_cli_pareto_run_with_telemetry_and_radar(tmp_path, capsys):
    base = ["--apps", "ptb", "--apps", "wdl", "--objective", "pareto",
            "--budgets", "30000", "--budgets", "60000", "--budgets",
            "90000", "--smoke", "--device", "cpu"]
    assert main(base + ["--out", str(tmp_path / "plain.json")]) == 0
    capsys.readouterr()
    trace, journal = tmp_path / "t.json", tmp_path / "j.jsonl"
    assert main(base + ["--out", str(tmp_path / "obs.json"), "--radar",
                        "--trace", str(trace), "--journal", str(journal),
                        "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "joint perf/area Pareto front" in out
    assert "selections per area budget" in out
    assert "sensitivity radar" in out and "[ptb |" in out
    assert "[obs] metrics summary" in out
    # result-inert: the same JSON with and without telemetry
    assert ((tmp_path / "plain.json").read_bytes()
            == (tmp_path / "obs.json").read_bytes())
    from repro_torch.obs.validate import main as validate
    assert validate(["--trace", str(trace), "--journal", str(journal)]) == 0
    rec = json.loads((tmp_path / "obs.json").read_text())
    assert rec["front"] and len(rec["budget_selections"]) == 3
    assert not obs.active()
