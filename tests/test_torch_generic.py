"""The port's evaluator-mode `Study` and `FunctionEvaluator` on the CPU,
against the JAX package: the memo's pool scores, cache export/merge and
stats equal the reference's; an evaluator-mode study over a
`DiscreteSpace` gives the reference's result for every engine; the study
refuses what the reference refuses; and `autotune_search` with anneal,
genetic and random over `tests/test_torch_roofline.py`'s synthetic cell
returns the reference's point and score with the same call log."""

import dataclasses
import json

import pytest

import repro.dse as ref_dse
from repro.core import autotune as ref_at
from repro.core.search import DiscreteSpace as RefDiscreteSpace
from repro.core.search import FunctionEvaluator as RefFunctionEvaluator
from repro_torch.core import autotune as at
from repro_torch.core.search import DiscreteSpace, FunctionEvaluator
from repro_torch.dse import (AreaBudget, ParetoObjective, SearchBudget,
                             Study)
from test_torch_roofline import _Synthetic

DOMAINS = {"x": (1, 2, 3, 4, 5, 6), "y": (0, 1, 2, 3), "z": (10, 20, 30)}


@dataclasses.dataclass(frozen=True)
class Pt:
    x: int = 1
    y: int = 0
    z: int = 10


def score(pt) -> float:
    """A bumpy score with a 0 region (the "constraint violation")."""
    if pt.x == 6 and pt.y == 3:
        return 0.0
    return float(pt.x * (1 + pt.y) + (pt.z % 7) / (1 + abs(pt.x - 4)))


def spaces():
    return (DiscreteSpace(domains=DOMAINS, make_config=lambda **kw: Pt(**kw)),
            RefDiscreteSpace(domains=DOMAINS,
                             make_config=lambda **kw: Pt(**kw)))


def test_function_evaluator_equals_the_reference():
    pools = [[Pt(1, 0, 10), Pt(2, 1, 20), Pt(1, 0, 10)],
             [Pt(2, 1, 20), Pt(6, 3, 30), Pt(4, 2, 10)],
             [Pt(x, y, 20) for x in (1, 2) for y in (0, 1)]]
    batches = []
    mine = FunctionEvaluator(score, cache_size=4,
                             batch_score_fn=lambda cs: (
                                 batches.append(len(cs))
                                 or [score(c) for c in cs]))
    ref = RefFunctionEvaluator(score, cache_size=4,
                               batch_score_fn=lambda cs: [score(c)
                                                          for c in cs])
    for pool in pools:
        assert mine(pool).tobytes() == ref(pool).tobytes()
        assert mine.stats() == ref.stats()
    assert mine.cache_export() == ref.cache_export()
    assert len(mine.cache_export()) == 4                  # LRU-trimmed
    assert mine.n_batches == ref.n_batches == len(batches) == 3
    # merging a shard's export: first writer wins, trimmed to size
    shard = FunctionEvaluator(score)
    shard([Pt(5, 1, 10), Pt(3, 3, 30), Pt(1, 0, 10)])
    ref_shard = RefFunctionEvaluator(score)
    ref_shard([Pt(5, 1, 10), Pt(3, 3, 30), Pt(1, 0, 10)])
    assert (mine.cache_merge(shard.cache_export())
            == ref.cache_merge(ref_shard.cache_export()))
    assert mine.cache_export() == ref.cache_export()
    assert mine.score_one(Pt(6, 3, 30)) == 0.0
    bad = FunctionEvaluator(score, batch_score_fn=lambda cs: [1.0])
    with pytest.raises(ValueError, match="returned 1 scores"):
        bad([Pt(1, 0, 10), Pt(2, 0, 10)])


ENGINES = {
    "greedy": dict(k=2, restarts=2, max_rounds=4),
    "anneal": dict(restarts=1, max_rounds=4, engine_kwargs={"chains": 3}),
    "genetic": dict(restarts=1, max_rounds=4,
                    engine_kwargs={"population": 8}),
    "random": dict(restarts=2, max_rounds=3, engine_kwargs={"batch": 6}),
    "tpe": dict(restarts=1, max_rounds=4,
                engine_kwargs={"batch": 6, "startup_rounds": 1}),
    "nsga2": dict(restarts=1, max_rounds=3,
                  engine_kwargs={"population": 8}),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_evaluator_mode_study_equals_the_reference(engine):
    space, ref_space = spaces()
    got_ev, ref_ev = FunctionEvaluator(score), RefFunctionEvaluator(score)
    got = Study(space=space, evaluator=got_ev, engine=engine,
                budget=SearchBudget(**ENGINES[engine]), seed=3,
                name="generic").run()
    want = ref_dse.Study(space=ref_space, evaluator=ref_ev, engine=engine,
                         budget=ref_dse.SearchBudget(**ENGINES[engine]),
                         seed=3, name="generic").run()
    mine, ref = got.to_json(), want.to_json()
    # the evaluator owns the scoring: no device, and the backend is moot
    assert mine["meta"].pop("device") is None
    mine["meta"].pop("backend"), ref["meta"].pop("backend")
    assert mine == ref
    assert mine["meta"]["objective"] == {"name": "evaluator-native"}
    res = got.per_app_results["space"]
    ref_res = want.per_app_results["space"]
    assert res.evaluated == ref_res.evaluated
    assert res.evaluated_perf.tobytes() == ref_res.evaluated_perf.tobytes()
    assert got_ev.stats() == ref_ev.stats()


def test_evaluator_mode_refuses_what_the_reference_refuses(tmp_path):
    space, ref_space = spaces()
    for mod, sp, fev in ((ref_dse, ref_space, RefFunctionEvaluator(score)),
                         (None, space, FunctionEvaluator(score))):
        make = mod.Study if mod is not None else Study
        objective = (mod.ParetoObjective(["perf", "-area"])
                     if mod is not None
                     else ParetoObjective(["perf", "-area"]))
        budget = (mod.AreaBudget(1.0) if mod is not None
                  else AreaBudget(1.0))
        with pytest.raises(ValueError, match="evaluator"):
            make(space=sp, evaluator=fev, objective=objective)
        with pytest.raises(ValueError, match="evaluator"):
            make(space=sp, evaluator=fev, constraints=[budget])
        with pytest.raises(ValueError, match="evaluator mode"):
            make(apps=["ptb", "wdl"], space=sp, evaluator=fev,
                 composition=2)
        study = make(space=sp, evaluator=fev,
                     budget={"restarts": 1, "max_rounds": 2})
        with pytest.raises(ValueError, match="checkpoint"):
            study.run(checkpoint_path=tmp_path / "x.ckpt")
    with pytest.raises(ValueError, match="apps=... or evaluator=..."):
        Study(device="cpu")


@pytest.mark.parametrize("engine", ["anneal", "genetic", "random"])
@pytest.mark.parametrize("seed,mode,moe", [(0, "train", True),
                                           (1, "train", False),
                                           (7, "prefill", False)])
def test_autotune_other_engines_equal_the_reference(engine, seed, mode, moe):
    """Point, score, the search log and every call the cell saw."""
    mine_ev, ref_ev = _Synthetic(), _Synthetic()
    mine_log, ref_log = [], []
    best, s = at.autotune_search(mine_ev, engine=engine, shape_mode=mode,
                                 has_moe=moe, seed=seed, max_rounds=4,
                                 log=mine_log)
    ref_best, ref_s = ref_at.autotune_search(ref_ev, engine=engine,
                                             shape_mode=mode, has_moe=moe,
                                             seed=seed, max_rounds=4,
                                             log=ref_log)
    assert dataclasses.asdict(best) == dataclasses.asdict(ref_best)
    assert s == ref_s > 0
    assert json.dumps(mine_log) == json.dumps(ref_log)
    assert mine_ev.calls == ref_ev.calls
    # the memo: every point reaches the cell once
    assert len(mine_ev.calls) == len(set(mine_ev.calls))


def test_autotune_scores_the_init_point_and_refuses_no_rounds():
    init = at.ExecPoint(sharding_mode="tp", remat="dots", microbatches=4,
                        attn_kv_block=2048)
    ref_init = ref_at.ExecPoint(**dataclasses.asdict(init))
    for engine in ("genetic", "random"):
        mine_ev, ref_ev = _Synthetic(), _Synthetic()
        got = at.autotune_search(mine_ev, engine=engine, seed=2,
                                 max_rounds=1, init=init, population=2,
                                 batch=2)
        want = ref_at.autotune_search(ref_ev, engine=engine, seed=2,
                                      max_rounds=1, init=ref_init,
                                      population=2, batch=2)
        assert dataclasses.asdict(got[0]) == dataclasses.asdict(want[0])
        assert got[1] == want[1]
        assert mine_ev.calls == ref_ev.calls
        assert json.dumps(dataclasses.asdict(init),
                          sort_keys=True) in mine_ev.calls
    with pytest.raises(ValueError, match="evaluated no candidates"):
        at.autotune_search(_Synthetic(), engine="random", max_rounds=0)
