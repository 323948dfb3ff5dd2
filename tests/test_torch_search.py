"""The port's search engines on the CPU: the greedy goldens of the JAX
package, bit for bit, and the random engine against the JAX package's."""

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core.multiapp import AppSpec as RefAppSpec
from repro.core.search import optimize_for_app as ref_optimize_for_app
from repro.core.space import default_space as ref_default_space
from repro_torch.core import apps
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import (ENGINES, make_engine,
                                     multi_step_greedy, optimize_for_app)
from repro_torch.core.space import default_space

# goldens of the JAX package's greedy engine on resnet, captured at its
# seed commit (copied here, not imported)
GOLD_SINGLE = {"loop_order": 3, "pe_group": 32, "mac_per_group": 32,
               "bank_height": 4096, "bank_width": 128, "weight_banks_pg": 2,
               "act_banks_pg": 2, "tif": 8, "tix": 8, "tiy": 32, "tof": 4,
               "pif": 16, "pof": 4, "pox": 8, "poy": 2, "pkx": 1, "pky": 1,
               "pb": 4}
GOLD_SINGLE_PERF = 369.6940437641056

GOLD_MULTI = {"loop_order": 0, "pe_group": 8, "mac_per_group": 512,
              "bank_height": 8192, "bank_width": 128, "weight_banks_pg": 4,
              "act_banks_pg": 4, "tif": 8, "tix": 64, "tiy": 64, "tof": 16,
              "pif": 2, "pof": 16, "pox": 8, "poy": 2, "pkx": 7, "pky": 1,
              "pb": 4}
GOLD_MULTI_PERF = 835.423693109374


@pytest.fixture(scope="module")
def resnet():
    return AppSpec.from_graph("resnet", apps.build_app("resnet"))


def _peaks(spec):
    return dict(peak_weight_bits=spec.peak_weight_bits,
                peak_input_bits=spec.peak_input_bits)


def test_multi_step_greedy_golden(resnet):
    res = multi_step_greedy(resnet.stream, default_space(), k=2, seed=123,
                            max_rounds=8, device="cpu", **_peaks(resnet))
    assert {k: int(v) for k, v in res.best.asdict().items()} == GOLD_SINGLE
    assert res.best_perf == GOLD_SINGLE_PERF
    assert res.rounds == 2
    assert len(res.evaluated) == 84
    assert len(res.evaluated_perf) == 84


def test_optimize_for_app_golden(resnet):
    res = optimize_for_app(resnet.stream, default_space(), engine="greedy",
                           k=2, restarts=2, seed=0, max_rounds=6,
                           device="cpu", **_peaks(resnet))
    assert {k: int(v) for k, v in res.best.asdict().items()} == GOLD_MULTI
    assert res.best_perf == GOLD_MULTI_PERF
    assert len(res.evaluated) == 454
    stats = res.evaluator.stats()
    assert stats["cache_hits"] > 0
    assert stats["scored"] < len(res.evaluated)
    assert res.evaluator.scorer.device.type == "cpu"


@pytest.mark.parametrize("app", ["resnet", "nasnet"])
def test_random_engine_matches_jax_package(app, resnet):
    kw = dict(engine="random", restarts=2, seed=5, max_rounds=3,
              engine_kwargs={"batch": 256})
    ref_spec = RefAppSpec.from_graph(app, ref_apps.build_app(app))
    want = ref_optimize_for_app(ref_spec.stream, ref_default_space(),
                                **kw, **_peaks(ref_spec))
    spec = AppSpec.from_graph(app, apps.build_app(app))
    got = optimize_for_app(spec.stream, default_space(), device="cpu", **kw,
                           **_peaks(spec))
    assert got.best.asdict() == want.best.asdict()
    assert got.best_perf == want.best_perf > 0
    np.testing.assert_array_equal(got.evaluated_perf, want.evaluated_perf)


@pytest.mark.parametrize("engine", ["anneal", "genetic", "tpe", "nsga2"])
def test_engines_of_a_later_slice_raise(engine, resnet):
    """The engines of the slice after the first one build now (held
    against the JAX package's in tests/test_torch_engines.py); a
    misspelt name still raises."""
    assert isinstance(make_engine(engine, default_space(), evaluator=None),
                      ENGINES[engine])
    with pytest.raises(ValueError, match="unknown engine"):
        make_engine(engine + "x", default_space(), evaluator=None)
