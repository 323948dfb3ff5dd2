"""`FusedTorchScorer` on the CPU against the JAX package's numpy scorer.

Both sides get the same op streams (carried across as plain records by
`repro_torch.convert`), the same spaces and the same pools, made from a
numpy seed.  GOPS and area must be bit-equal: the port keeps numpy's
operand order and its pairwise summation order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import apps as ref_apps
from repro.core.costmodel import (ConfigBatch, FusedStreamScorer,
                                  area_many, performance_gops)
from repro.core.multiapp import AppSpec
from repro.core.space import DesignSpace, default_space
from repro_torch.convert import (config_batch_from_matrix, ops_from_records,
                                 space_from_domains)
from repro_torch.core.costmodel import area_many as port_area_many
from repro_torch.kernels.costmodel import FusedTorchScorer, numpy_order_sum

APPS = tuple(ref_apps.APP_BUILDERS)


def port_stream(stream):
    return ops_from_records([{**dataclasses.asdict(op), "kind": op.kind.name}
                             for op in stream.ops])


def port_space(space):
    return space_from_domains(space.domains, dataclasses.asdict(space.hw),
                              space.area_budget)


def random_space(rng):
    """A sub-space of `default_space()` (as `tests/test_fused_eval.py`
    builds them): each domain cut to a random subset."""
    base = default_space()
    domains = {}
    for k, dom in base.domains.items():
        size = int(rng.integers(1, len(dom) + 1))
        domains[k] = tuple(sorted(int(v) for v in
                                  rng.choice(dom, size=size, replace=False)))
    return DesignSpace(domains=domains, hw=base.hw,
                       area_budget=base.area_budget)


def pool(space, spec, rng, n):
    """Raw draws (mostly invalid) and peak-repaired draws (mostly valid)."""
    raw = space.decode_batch(space.sample_indices(rng, n))
    fixed = space.repair_for_peaks_many(
        space.decode_batch(space.sample_indices(rng, n)),
        spec.peak_weight_bits,
        spec.peak_input_bits * int(spec.stream.batch.max()))
    return np.concatenate([raw.matrix, fixed.matrix])


@pytest.fixture(scope="module")
def specs():
    return {n: AppSpec.from_graph(n, ref_apps.build_app(n)) for n in APPS}


def scorers(spec, space, peaks):
    pw, pi = (spec.peak_weight_bits, spec.peak_input_bits) if peaks else (0, 0)
    ref = FusedStreamScorer(spec.stream, space.hw, pw, pi,
                            domains=space.domains)
    ps = port_space(space)
    port = FusedTorchScorer(port_stream(spec.stream), ps.hw, pw, pi,
                            domains=ps.domains, device="cpu")
    return ref, port


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("space_kind", ["default", "random"])
@pytest.mark.parametrize("peaks", [True, False])
def test_scorer_bit_equal_to_numpy(app, space_kind, peaks, specs):
    spec = specs[app]
    rng = np.random.default_rng(APPS.index(app) * 4 + peaks * 2
                                + (space_kind == "random"))
    space = default_space() if space_kind == "default" else random_space(rng)
    ref, port = scorers(spec, space, peaks)
    matrix = pool(space, spec, rng, 400)
    g_ref, a_ref = ref.metrics(matrix)
    g, a = port.metrics(matrix)
    assert g.dtype == a.dtype == np.float64
    np.testing.assert_array_equal(g > 0, g_ref > 0)      # same validity
    np.testing.assert_array_equal(g, g_ref)
    np.testing.assert_array_equal(a, a_ref)
    if space_kind == "default" and peaks:
        assert (g > 0).any(), "pool exercised no latency tail"


def test_scorer_matches_reference_formulas_on_resnet(specs):
    """Against the verbatim Eq. (1)-(13) broadcast formulas and the
    unit-area model of the JAX package."""
    spec = specs["resnet"]
    space = default_space()
    matrix = pool(space, spec, np.random.default_rng(7), 300)
    _, port = scorers(spec, space, peaks=True)
    g, a = port.metrics(matrix)
    ref_batch = ConfigBatch(matrix)
    want_g = performance_gops(ref_batch, spec.stream, space.hw,
                              spec.peak_weight_bits, spec.peak_input_bits,
                              backend="numpy-ref")
    np.testing.assert_array_equal(g, want_g)
    want_a = area_many(ref_batch, space.hw)
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_array_equal(
        port_area_many(config_batch_from_matrix(matrix),
                       port_space(space).hw), want_a)


def test_uploads_follow_table_rebuilds(specs):
    """Tables go to the device once per build: ragged pools from the known
    domains upload nothing new, a pool with unseen values uploads once."""
    spec = specs["resnet"]
    rng = np.random.default_rng(3)
    small = random_space(rng)
    while all(len(d) == len(default_space().domains[k])
              for k, d in small.domains.items()):
        small = random_space(rng)
    _, port = scorers(spec, small, peaks=True)
    port.metrics(pool(small, spec, rng, 150))
    assert port.n_uploads == 1
    for n in (300, 301, 299, 260):
        matrix = small.decode_batch(small.sample_indices(rng, n)).matrix
        assert port.metrics(matrix)[0].shape == (n,)
    assert port.n_uploads == 1
    full = default_space()
    port.metrics(full.decode_batch(full.sample_indices(rng, 500)).matrix)
    assert port.n_uploads == 2
    assert port.n_calls == 6


def test_numpy_order_sum_is_numpys_row_sum():
    """The pairwise order of `np.add.reduce`, at lengths around each of
    its branch points, up to nasnet's 494 op columns."""
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 15, 16, 17, 128, 129, 255, 256, 257, 494):
        x = rng.random((64, n)) * 10.0 ** rng.integers(-3, 9, size=(64, n))
        got = numpy_order_sum(torch.from_numpy(x.T.copy()))
        np.testing.assert_array_equal(got.numpy(), x.sum(axis=1))
