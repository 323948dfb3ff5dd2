"""The port's own paper graphs against the JAX package's, carried across as
plain data by `repro_torch.convert`: op for op, with equal operation counts
and equal memory-profile peaks (the Eq. 11/13 floors)."""

import dataclasses

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core.costmodel import ConfigBatch as RefConfigBatch
from repro.core.space import default_space as ref_default_space
from repro_torch.convert import (config_batch_from_matrix, ops_from_records,
                                 space_from_domains)
from repro_torch.core import apps
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.space import default_space

NAMES = tuple(ref_apps.APP_BUILDERS)


def converted(graph):
    return ops_from_records([{**dataclasses.asdict(op), "kind": op.kind.name}
                             for op in graph.op_stream().ops])


def check_same_graph(got, want):
    want_ops = converted(want)
    got_ops = got.op_stream()
    assert got_ops.ops == want_ops.ops
    np.testing.assert_array_equal(got_ops.field_matrix, want_ops.field_matrix)
    assert got_ops.total_ops == want.op_stream().total_ops
    gp, wp = got.memory_profile(), want.memory_profile()
    assert gp.peak_activation_bits == wp.peak_activation_bits
    assert gp.peak_weight_bits == wp.peak_weight_bits


@pytest.mark.parametrize("name", NAMES)
def test_paper_app_equals_reference(name):
    check_same_graph(apps.build_app(name), ref_apps.build_app(name))


def test_multi_context_equals_reference():
    check_same_graph(
        apps.multi_context([apps.build_app(n) for n in NAMES]),
        ref_apps.multi_context([ref_apps.build_app(n) for n in NAMES]))
    check_same_graph(apps.multi_context(), ref_apps.multi_context())


def test_space_and_batch_round_trip():
    ref = ref_default_space()
    space = space_from_domains(ref.domains, dataclasses.asdict(ref.hw),
                               ref.area_budget)
    assert space == default_space()
    matrix = ref.decode_batch(
        ref.sample_indices(np.random.default_rng(0), 64)).matrix
    batch = config_batch_from_matrix(matrix)
    np.testing.assert_array_equal(batch.matrix, matrix)
    assert ([c.asdict() for c in batch.to_configs()]
            == [c.asdict() for c in RefConfigBatch(matrix).to_configs()])


def test_whisper_zoo_apps_build_and_unknown_apps_raise():
    """The encoder-decoder's zoo apps build (every arch's do); an unknown
    app raises `KeyError`."""
    for name in ("whisper-medium:prefill", "whisper-medium:decode"):
        spec = AppSpec.from_app(name)
        assert len(spec.stream.ops) > 0 and spec.peak_input_bits > 0
    with pytest.raises(KeyError):
        AppSpec.from_app("no-such-app")
