"""`repro_torch.obs` on the CPU against the JAX package's `repro.obs`.

Telemetry is result-inert for all six engines (serial studies); the
search journal is byte-equal to the reference's JSONL at equal seeds; the
trace carries the reference's span names; `Evaluator.explain` equals the
reference's `explain_config`; the logger is quiet by default; the
validators reject malformed files.
"""

import json
import logging
import warnings

import numpy as np
import pytest

import repro.dse as ref_dse
import repro_torch.dse as port_dse
from repro import obs as ref_obs
from repro.core.multiapp import AppSpec as RefAppSpec
from repro.core.search import Evaluator as RefEvaluator
from repro.core.space import default_space as ref_default_space
from repro_torch import obs
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import Evaluator
from repro_torch.core.space import default_space
from repro_torch.obs.attribution import explain_composition
from repro_torch.obs.journal import validate_record
from repro_torch.obs.validate import (main as validate_main,
                                      validate_chrome_trace, validate_journal)

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


@pytest.fixture(autouse=True)
def obs_reset():
    """Both packages' obs start and end off and empty."""
    obs.disable(reset=True)
    ref_obs.disable(reset=True)
    yield
    obs.disable(reset=True)
    ref_obs.disable(reset=True)


def result_bytes(result) -> str:
    return json.dumps(result.to_json(), sort_keys=True)


def study(mod, engine="greedy", **kw):
    extra = {"device": "cpu"} if mod is port_dse else {}
    return mod.Study(apps=["ptb", "wdl"], engine=engine,
                     budget=mod.SearchBudget(**ENGINE_BUDGETS[engine]),
                     seed=0, **extra, **kw)


@pytest.mark.parametrize("engine", sorted(ENGINE_BUDGETS))
def test_telemetry_is_result_inert(engine):
    plain = result_bytes(study(port_dse, engine).run())
    obs.enable(trace=True, metrics=True, journal=True)
    traced = study(port_dse, engine).run()
    obs.disable(reset=True)
    assert result_bytes(traced) == plain
    assert "telemetry" in traced.meta
    assert "telemetry" not in traced.to_json()["meta"]


@pytest.mark.parametrize("engine", sorted(ENGINE_BUDGETS))
def test_journal_equals_reference(engine, tmp_path):
    """One record per round, and the JSONL byte-equal to the reference's
    (same seeds, same scores, same hypervolumes)."""
    files = {}
    for tag, mod, o in (("ref", ref_dse, ref_obs), ("port", port_dse, obs)):
        o.enable(trace=False, metrics=False, journal=True)
        res = study(mod, engine).run()
        files[tag] = o.journal().write_jsonl(tmp_path / f"{tag}.jsonl")
        o.disable(reset=True)
        if tag == "port":
            records = validate_journal(files[tag])
            for app in ("ptb", "wdl"):
                n = sum(1 for r in records if r["app"] == app)
                assert n >= res.per_app[app]["rounds"] >= 1
    assert files["port"].read_bytes() == files["ref"].read_bytes()


def test_trace_span_names_equal_reference(tmp_path):
    names = {}
    for tag, mod, o in (("ref", ref_dse, ref_obs), ("port", port_dse, obs)):
        o.enable(trace=True, metrics=False, journal=False)
        study(mod, "genetic",
              objective=mod.ParetoObjective(["perf", "-area"])).run()
        names[tag] = {e["name"] for e in o.tracer().export()
                      if e.get("ph") == "X"}
        if tag == "port":
            path = obs.tracer().write(tmp_path / "trace.json")
            events = validate_chrome_trace(path, expect_processes=1)
            study_ev = [e for e in events if e.get("name") == "study"]
            assert len(study_ev) == 1
        o.disable(reset=True)
    assert names["port"] == names["ref"]
    assert {"study", "phase.search", "search_app", "ask_tell_round",
            "evaluate_batch", "phase.synthesize",
            "cross_eval"} <= names["port"]


def test_telemetry_snapshot_contents():
    obs.enable(trace=True, metrics=True, journal=True)
    tel = study(port_dse).run().meta["telemetry"]
    assert tel["configs_scored"] > 0 and tel["wall_seconds"] > 0
    assert set(tel["per_app"]) == {"ptb", "wdl"}
    assert tel["executor"] == {"workers": 1, "retry_rounds": 0,
                               "degraded": False}
    assert tel["journal_records"] > 0 and tel["trace_events"] > 0
    counters = tel["metrics"]["counters"]
    assert counters["evaluator.scored"] == tel["configs_scored"]
    assert counters["evaluator.cache_misses"] > 0
    assert tel["metrics"]["histograms"]["round_seconds.greedy"]["count"] > 0


def test_disabled_obs_records_nothing():
    res = study(port_dse).run()
    assert "telemetry" not in res.meta
    assert len(obs.tracer()) == 0 and len(obs.journal()) == 0
    exp = obs.metrics().export()
    assert exp["counters"] == {} and exp["histograms"] == {}


def test_journal_hypervolume_and_best_monotone():
    obs.enable(trace=False, metrics=False, journal=True)
    port_dse.Study(apps=["ptb"], engine="genetic",
                   budget=port_dse.SearchBudget(
                       restarts=1, max_rounds=4,
                       engine_kwargs={"population": 12}),
                   seed=0, device="cpu").run()
    recs = obs.journal().records
    for rec in recs:
        validate_record(rec)
    hvs = [r["hypervolume"] for r in recs]
    bests = [r["best"] for r in recs if r["best"] is not None]
    assert all(hv is not None and hv >= 0 for hv in hvs)
    assert hvs == sorted(hvs) and bests == sorted(bests)


@pytest.mark.parametrize("app", ["resnet", "ptb"])
def test_explain_equals_reference(app):
    ref_spec, spec = RefAppSpec.from_app(app), AppSpec.from_app(app)
    rspace, space = ref_default_space(), default_space()
    rev = RefEvaluator.for_space(ref_spec.stream, rspace,
                                 peak_weight_bits=ref_spec.peak_weight_bits,
                                 peak_input_bits=ref_spec.peak_input_bits)
    ev = Evaluator.for_space(spec.stream, space,
                             peak_weight_bits=spec.peak_weight_bits,
                             peak_input_bits=spec.peak_input_bits,
                             device="cpu")
    rng = np.random.default_rng(0)
    idx = space.sample_indices(rng, 200)
    # raw draws (mostly invalid) and the first draw the evaluator scores
    repaired = space.repair_for_peaks_many(space.decode_batch(idx),
                                           spec.peak_weight_bits,
                                           ev.peak_input_bits_scaled)
    good = int(np.flatnonzero(ev.score_with_area(repaired)[0] > 0)[0])
    cfgs = space.decode(idx[:5]) + [repaired[good]]
    ref_cfgs = rspace.decode(idx[:5]) + [rspace.repair_for_peaks_many(
        rspace.decode_batch(idx), ref_spec.peak_weight_bits,
        rev.peak_input_bits_scaled)[good]]
    for cfg, rcfg in zip(cfgs, ref_cfgs):
        got, want = ev.explain(cfg), rev.explain(rcfg)
        assert got.to_json() == want.to_json()
        assert got.table(max_rows=5) == want.table(max_rows=5)
    assert got.feasible
    assert got.gops == ev.score_with_area([cfgs[-1]])[0][0]
    # a two-engine composition of the same configs on ptb and wdl
    from repro.dse import Composition as RefComposition
    from repro.obs.attribution import explain_composition as ref_explain
    from repro_torch.dse import Composition
    comp = Composition(engines=(repaired[good], cfgs[0]), assignment=(0, 1),
                       apps=("ptb", "wdl"), split=(0.75, 0.25))
    ref_comp = RefComposition.from_json(comp.to_json())
    specs = [AppSpec.from_app(a) for a in comp.apps]
    ref_specs = [RefAppSpec.from_app(a) for a in comp.apps]
    for traffic, budget in ((None, 0.0), ({"ptb": 3, "wdl": 1}, 1e9),
                            ({"ptb": 1, "wdl": 1}, 1.0)):
        mine = explain_composition(comp, specs, traffic=traffic,
                                   area_budget=budget, device="cpu")
        want = ref_explain(ref_comp, ref_specs, traffic=traffic,
                           area_budget=budget)
        assert mine.to_json() == want.to_json()
        assert mine.table() == want.table()


def test_logger_is_quiet_by_default():
    logger = obs.get_logger("dse.study")
    assert logger.name == "repro_torch.dse.study"
    assert obs.get_logger("repro_torch.x").name == "repro_torch.x"
    root = logging.getLogger("repro_torch")
    assert any(isinstance(h, logging.NullHandler) for h in root.handlers)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        obs.log_event(logger, "debug", "noop", x=1)


def test_validate_chrome_trace_rejects_malformed(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0}]}))
    with pytest.raises(ValueError, match="dur"):
        validate_chrome_trace(p)
    p.write_text(json.dumps([1, 2, 3]))
    with pytest.raises(ValueError, match="not a Chrome trace"):
        validate_chrome_trace(p)
    p.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(ValueError, match="empty"):
        validate_chrome_trace(p)
    p.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "Q", "pid": 1, "tid": 1, "ts": 0}]}))
    with pytest.raises(ValueError, match="phase"):
        validate_chrome_trace(p)
    p.write_text(json.dumps({"traceEvents": [
        {"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 5}]}))
    with pytest.raises(ValueError, match="process"):
        validate_chrome_trace(p, expect_processes=2)


def test_validate_journal_rejects_malformed(tmp_path):
    p = tmp_path / "j.jsonl"
    good = {"seq": 0, "kind": "round", "engine": "tpe", "round": 0,
            "pool": 8, "n_scored": 8, "best": 1.0, "feasible_frac": 1.0,
            "hypervolume": None}
    p.write_text(json.dumps(good) + "\n")
    assert validate_journal(p) == [good]
    for bad, match in ((dict(good, kind="sandwich"), "kind"),
                       (dict(good, seq=-1), "seq"),
                       ({k: v for k, v in good.items() if k != "pool"},
                        "missing"),
                       (dict(good, best="x"), "best")):
        p.write_text(json.dumps(bad) + "\n")
        with pytest.raises(ValueError, match=match):
            validate_journal(p)
    p.write_text("not json\n")
    with pytest.raises(ValueError, match="not JSON"):
        validate_journal(p)


def test_validate_cli_gates(tmp_path):
    obs.enable(trace=True, metrics=False, journal=True)
    with obs.span("study"):
        obs.journal_record(kind="round", engine="tpe", round=0, pool=8,
                           n_scored=8, best=1.0, feasible_frac=1.0,
                           hypervolume=None)
    trace, journal = tmp_path / "t.json", tmp_path / "j.jsonl"
    obs.tracer().write(trace)
    obs.journal().write_jsonl(journal)
    assert validate_main(["--trace", str(trace),
                          "--journal", str(journal)]) == 0
    assert validate_main(["--trace", str(trace),
                          "--expect-processes", "5"]) == 2
    with pytest.raises(SystemExit):
        validate_main([])


def test_metrics_export_merge_and_summary():
    from repro.obs.metrics import Metrics as RefMetrics
    from repro_torch.obs.metrics import Metrics
    a, ra = Metrics(), RefMetrics()
    for m in (a, ra):
        m.enabled = True
        m.inc("x", 2)
        m.gauge("g", 1.5)
        for v in (3.0, 1.0, 2.0):
            m.observe("h", v)
    b, rb = Metrics(), RefMetrics()
    b.merge(a.export())
    rb.merge(ra.export())
    b.merge(a.export())
    rb.merge(ra.export())
    assert b.summary() == rb.summary()
