"""The port's §5.3 sensitivity radar and `run_multiapp_study` on the CPU
against the JAX package's: radar values, `n_configs` and the extras for
resnet and for the four Faster R-CNN build steps at smoke budgets, and the
multi-app selection of the historical signature."""

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core import multiapp as ref_multiapp
from repro.core import sensitivity as ref_sens
from repro.core.space import default_space as ref_default_space
from repro_torch.core import apps
from repro_torch.core import multiapp
from repro_torch.core.sensitivity import (RadarSummary, radar_of_top_configs,
                                          sensitivity_study)
from repro_torch.core.space import default_space

STEPS = (1, 2, 3, 4)


def assert_radar_equal(got: RadarSummary, want) -> None:
    assert got.app == want.app
    assert got.values == want.values
    assert got.n_configs == want.n_configs
    assert got.extras == want.extras
    assert got.fmt() == want.fmt()


@pytest.mark.parametrize("engine", ["greedy", "random"])
def test_radar_of_top_configs_equals_reference(engine):
    kw = dict(k=2, restarts=1, max_rounds=4, engine=engine, seed=1)
    want = ref_sens.radar_of_top_configs(
        "resnet", ref_multiapp.AppSpec.from_app("resnet"),
        ref_default_space(), **kw)
    got = radar_of_top_configs("resnet",
                               multiapp.AppSpec.from_app("resnet"),
                               default_space(), device="cpu", **kw)
    assert_radar_equal(got, want)
    assert set(got.values) == set(default_space().variables)
    assert all(0.0 <= v <= 1.0 for v in got.values.values())


def test_sensitivity_study_over_faster_rcnn_steps_equals_reference():
    names = [f"fasterRCNN-step{s}" for s in STEPS]
    kw = dict(k=2, restarts=1, max_rounds=3, seed=0)
    want = ref_sens.sensitivity_study(
        [lambda s=s: ref_apps.faster_rcnn_step(s) for s in STEPS], names,
        ref_default_space(), **kw)
    got = sensitivity_study(
        [lambda s=s: apps.faster_rcnn_step(s) for s in STEPS], names,
        default_space(), device="cpu", **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_radar_equal(g, w)
    assert all(r.n_configs > 0 for r in got)


def test_run_multiapp_study_equals_reference():
    kw = dict(k=2, restarts=2, seed=0, max_rounds=6)
    want = ref_multiapp.run_multiapp_study(
        [ref_multiapp.AppSpec.from_app(a) for a in ("ptb", "wdl")],
        ref_default_space(), **kw)
    got = multiapp.run_multiapp_study(
        [multiapp.AppSpec.from_app(a) for a in ("ptb", "wdl")],
        default_space(), device="cpu", **kw)
    assert got.selected.asdict() == want.selected.asdict()
    np.testing.assert_array_equal(got.perf_matrix, want.perf_matrix)
    np.testing.assert_array_equal(got.geomeans, want.geomeans)
    np.testing.assert_array_equal(got.improvements_valid,
                                  want.improvements_valid)
    assert got.table4() == want.table4() and got.table5() == want.table5()
