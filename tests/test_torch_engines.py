"""The port's anneal, genetic, tpe and nsga2 engines on the CPU: config
for config against the JAX package's at equal seeds, the shared engine
contract (tests/engine_contract.py), the closed-form problems' optima, the
search-state round trip, and every engine of the reference's zoo
acceptance test on traced apps."""

import json

import numpy as np
import pytest

from engine_contract import CONTRACT_CHECKS, CONTRACT_KW
from repro.core import apps as ref_apps
from repro.core.multiapp import AppSpec as RefAppSpec
from repro.core.search import optimize_for_app as ref_optimize_for_app
from repro.core.search import synthetic as ref_synthetic
from repro.core.space import default_space as ref_default_space
from repro_torch.core import apps
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import (ENGINES, Evaluator, NSGA2Optimizer,
                                     TPEOptimizer, make_engine,
                                     optimize_for_app, run_search, synthetic)
from repro_torch.core.space import default_space

NEW_ENGINES = ("anneal", "genetic", "tpe", "nsga2")
ENGINE_KW = {"population": 16, "chains": 4, "batch": 16,
             "startup_rounds": 1}


def _peaks(spec):
    return dict(peak_weight_bits=spec.peak_weight_bits,
                peak_input_bits=spec.peak_input_bits)


@pytest.fixture(scope="module")
def resnet():
    return AppSpec.from_graph("resnet", apps.build_app("resnet"))


@pytest.mark.parametrize("app", ["resnet", "qwen2-0.5b:decode"])
@pytest.mark.parametrize("engine", NEW_ENGINES)
def test_engine_matches_the_jax_package(engine, app):
    """Same seed, same app: the same configs evaluated in the same order,
    the same scores and the same best."""
    kw = dict(engine=engine, k=1, restarts=2, seed=3, max_rounds=4,
              engine_kwargs=ENGINE_KW)
    ref_spec = RefAppSpec.from_graph(app, ref_apps.build_app(app))
    want = ref_optimize_for_app(ref_spec.stream, ref_default_space(), **kw,
                                **_peaks(ref_spec))
    spec = AppSpec.from_graph(app, apps.build_app(app))
    got = optimize_for_app(spec.stream, default_space(), device="cpu", **kw,
                           **_peaks(spec))
    assert [c.asdict() for c in got.evaluated] == \
        [c.asdict() for c in want.evaluated]
    np.testing.assert_array_equal(got.evaluated_perf, want.evaluated_perf)
    assert got.best.asdict() == want.best.asdict()
    assert got.best_perf == want.best_perf > 0
    assert got.rounds == want.rounds


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("check", sorted(CONTRACT_CHECKS))
def test_engine_contract(check, engine, resnet):
    """The shared harness's checks (budget, valid pool, NaN observe,
    termination, reproducibility) against the port's engines."""
    space = default_space()

    def fresh(seed):
        ev = Evaluator.for_space(resnet.stream, space, device="cpu",
                                 **_peaks(resnet))
        return make_engine(engine, space, ev, seed=seed,
                           **CONTRACT_KW), ev, space

    CONTRACT_CHECKS[check](engine, fresh)


@pytest.mark.parametrize("problem", tuple(synthetic.PROBLEMS))
def test_synthetic_optima_match_the_jax_package(problem):
    """The closed-form problems' exhaustive truth: best value, the
    Pareto front and its hypervolume, equal to the reference's."""
    got = synthetic.problem_truth(problem)
    want = ref_synthetic.problem_truth(problem)
    assert got.keys() == want.keys()
    for key, val in want.items():
        np.testing.assert_array_equal(got[key], val, err_msg=key)


@pytest.mark.parametrize("engine_cls,kw", [
    (TPEOptimizer, {"batch": 8, "startup_rounds": 1}),
    (NSGA2Optimizer, {"population": 8}),
])
def test_state_roundtrip_continues_bit_identically(engine_cls, kw):
    """A snapshot at round 3, through JSON, restored into a fresh engine,
    continues exactly as the uninterrupted run does."""
    p = synthetic.make_problem("roofline")
    space = p.space()

    def fresh():
        return engine_cls(space, synthetic.SyntheticEvaluator(p), seed=5,
                          max_rounds=6, **kw)

    ref, ev_ref, ref_pools = fresh(), synthetic.SyntheticEvaluator(p), []
    while not ref.done:
        pool = ref.propose()
        ref_pools.append([c.asdict() for c in pool])
        ref.observe(pool, ev_ref(pool))

    half, ev_half = fresh(), synthetic.SyntheticEvaluator(p)
    for _ in range(3):
        pool = half.propose()
        half.observe(pool, ev_half(pool))
    resumed = fresh()
    resumed.load_state(json.loads(json.dumps(half.state_dict())))
    assert resumed.rounds == half.rounds
    assert resumed.best_perf == half.best_perf
    cont_pools, ev_cont = [], synthetic.SyntheticEvaluator(p)
    while not resumed.done:
        pool = resumed.propose()
        cont_pools.append([c.asdict() for c in pool])
        resumed.observe(pool, ev_cont(pool))
    assert cont_pools == ref_pools[3:]
    assert resumed.best_perf == ref.best_perf
    assert resumed.best.asdict() == ref.best.asdict()
    with pytest.raises(NotImplementedError):
        make_engine("anneal", space, ev_ref, seed=0).state_dict()


def test_run_search_routes_vector_rows_to_nsga2():
    """With [N, M] scores the driver hands NSGA-II the rows and logs the
    first column as the scalar score."""

    class VectorEval:
        objective = None

        def __call__(self, pool):
            v = np.asarray([c.pe * c.mac for c in pool], dtype=np.float64)
            a = np.asarray([c.pe + c.mac for c in pool], dtype=np.float64)
            return np.stack([v, -a], axis=1)

    p = synthetic.make_problem("roofline")
    ev = VectorEval()
    eng = make_engine("nsga2", p.space(), ev, seed=0, population=8,
                      max_rounds=3)
    res = run_search(eng, ev)
    assert eng.observes_vector and res.evaluated_values.shape[1] == 2
    np.testing.assert_array_equal(res.evaluated_perf,
                                  res.evaluated_values[:, 0])


@pytest.mark.parametrize("engine", ["greedy", "anneal", "genetic", "random"])
def test_zoo_optimize_every_engine_nonzero_gops(engine):
    """The twin of the reference's zoo acceptance test: every engine finds
    a valid nonzero-GOPS config on traced apps at the default budget."""
    space = default_space()
    for name in ("qwen2-0.5b:prefill", "internvl2-1b:prefill",
                 "qwen2-0.5b:decode"):
        spec = AppSpec.from_graph(name, apps.build_app(name))
        res = optimize_for_app(
            spec.stream, space, engine=engine, k=1, restarts=1, seed=0,
            max_rounds=4, device="cpu", **_peaks(spec),
            engine_kwargs={"population": 24, "chains": 6, "batch": 32})
        assert res.best_perf > 0, (name, engine)
        assert res.best.area(space.hw) <= space.area_budget
