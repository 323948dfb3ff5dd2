"""The port's default analysis pass (`evaluate_stream_many(backend=
"tables")`) on the CPU against the JAX package's default (``"numpy"``, its
table-driven fast path) and against the port's ``"numpy-ref"``.

Cycles, validity and all five [C, O] parts must be bit-equal, dtypes
included, on the seven paper apps and two traced zoo apps at pools of 64,
513 and 4097 from the Table-2 space (peaks on and off), at every loop
order, with and without parts, and on a stream with a zero `nif` and a
zero `nox`.  The dispatch is read from `PASSES`: pools under 64 and
streams with a zero-size kernel or stride take the broadcast pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import apps as ref_apps
from repro.core import costmodel as ref_cm
from repro.core.multiapp import AppSpec
from repro.core.space import default_space
from repro_torch import obs
from repro_torch.convert import config_batch_from_matrix, ops_from_records
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import LoopOrder, evaluate_stream_many
from repro_torch.core.search import Evaluator

APPS = tuple(ref_apps.APP_BUILDERS)
ZOO = ("qwen2-0.5b:prefill", "recurrentgemma-9b:decode")
POOLS = (64, 513, 4097)
PARTS = ("compute", "weight", "input", "total", "valid_ops")


def port_stream(stream):
    return ops_from_records([{**dataclasses.asdict(op), "kind": op.kind.name}
                             for op in stream.ops])


@pytest.fixture(scope="module")
def space():
    return default_space()


@pytest.fixture(scope="module")
def hw(space):
    return cm.HardwareConstants(**dataclasses.asdict(space.hw))


@pytest.fixture(scope="module")
def specs():
    return {n: AppSpec.from_graph(n, ref_apps.build_app(n))
            for n in APPS + ZOO}


@pytest.fixture(scope="module")
def pools(space):
    rng = np.random.default_rng(21)
    return {n: space.decode_batch(space.sample_indices(rng, n))
            for n in POOLS}


def assert_same(got, want, context):
    for i, name in enumerate(("cycles", "valid")):
        assert got[i].dtype == want[i].dtype, f"{name} dtype {context}"
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"{name} {context}")
    if want[2] is None:
        assert got[2] is None, context
        return
    assert set(got[2]) == set(want[2]) == set(PARTS)
    for k in PARTS:
        assert got[2][k].dtype == want[2][k].dtype, f"{k} dtype {context}"
        np.testing.assert_array_equal(got[2][k], want[2][k],
                                      err_msg=f"parts[{k}] {context}")


def three(batch, stream, hw, port_hw, pw=0, pi=0, with_parts=True):
    """(reference "numpy", port "tables" on the CPU, port "numpy-ref"),
    with the passes the port ran."""
    with np.errstate(divide="ignore"):
        ref = ref_cm.evaluate_stream_many(batch, stream, hw, pw, pi,
                                          backend="numpy",
                                          with_parts=with_parts)
    pb, ps = config_batch_from_matrix(batch.matrix), port_stream(stream)
    cm.PASSES.clear()
    got = evaluate_stream_many(pb, ps, port_hw, pw, pi, device="cpu",
                               with_parts=with_parts)
    passes = dict(cm.PASSES)
    host = evaluate_stream_many(pb, ps, port_hw, pw, pi, backend="numpy-ref",
                                with_parts=with_parts)
    return ref, got, host, passes


@pytest.mark.parametrize("peaks", [True, False], ids=["peaks", "no-peaks"])
@pytest.mark.parametrize("n", POOLS)
@pytest.mark.parametrize("app", APPS + ZOO)
def test_tables_equal_the_reference_fast_path(app, n, peaks, specs, pools,
                                              space, hw):
    spec = specs[app]
    pw, pi = ((spec.peak_weight_bits, spec.peak_input_bits) if peaks
              else (0, 0))
    ref, got, host, passes = three(pools[n], spec.stream, space.hw, hw,
                                   pw, pi)
    assert passes == {"tables": 1}
    ctx = f"{app} C={n} peaks={peaks}"
    assert_same(got, ref, ctx)
    assert_same(got, host, ctx)


@pytest.mark.parametrize("lo", list(LoopOrder), ids=lambda v: v.name)
def test_every_loop_order(lo, specs, pools, space, hw):
    m = pools[513].matrix.copy()
    m[:, ref_cm.ConfigBatch._INDEX["loop_order"]] = int(lo)
    batch = ref_cm.ConfigBatch(m)
    for app in ("resnet", "ptb", "qwen2-0.5b:prefill"):
        spec = specs[app]
        ref, got, host, passes = three(batch, spec.stream, space.hw, hw,
                                       spec.peak_weight_bits,
                                       spec.peak_input_bits)
        assert passes == {"tables": 1}
        assert_same(got, ref, f"{app} {lo.name}")
        assert_same(got, host, f"{app} {lo.name}")


@pytest.mark.parametrize("app", ("inception", "nasnet", "wdl",
                                 "recurrentgemma-9b:decode"))
def test_without_parts(app, specs, pools, space, hw):
    spec = specs[app]
    ref, got, host, passes = three(pools[513], spec.stream, space.hw, hw,
                                   spec.peak_weight_bits,
                                   spec.peak_input_bits, with_parts=False)
    assert passes == {"tables": 1}
    assert_same(got, ref, app)
    assert_same(got, host, app)


def zero_dims_stream():
    """A zero `nif`, a zero `nox` (and `noy`), a zero `nof`: the
    reference's dispatch checks only `nkx`, `nky` and `s`, so these reach
    its fast path."""
    return ref_cm.OpStream([
        ref_cm.Op(ref_cm.OpKind.CONV2D, 0, 12, 12, 3, 3, 32, 10, 10),
        ref_cm.Op(ref_cm.OpKind.CONV2D, 8, 9, 9, 3, 3, 8, 0, 0),
        ref_cm.Op(ref_cm.OpKind.CONV2D, 8, 9, 9, 3, 3, 0, 0, 7),
        ref_cm.Op.matmul(64, 32, 48),
    ])


@pytest.mark.parametrize("peaks", [True, False], ids=["peaks", "no-peaks"])
@pytest.mark.parametrize("n", (64, 513))
def test_zero_nif_and_nox_stream(n, peaks, pools, space, hw):
    pw = pi = (1 << 10) if peaks else 0
    ref, got, host, passes = three(pools[n], zero_dims_stream(), space.hw,
                                   hw, pw, pi)
    assert passes == {"tables": 1}
    assert_same(got, ref, "zero nif/nox")
    assert_same(got, host, "zero nif/nox")


def zero_size_stream():
    return ref_cm.OpStream([
        ref_cm.Op(ref_cm.OpKind.CONV2D, 16, 12, 12, 0, 0, 32, 12, 12),
        ref_cm.Op(ref_cm.OpKind.CONV2D, 8, 9, 9, 3, 3, 8, 4, 4, s=0),
        ref_cm.Op.matmul(64, 32, 48),
    ])


@pytest.mark.parametrize("case,want", [
    ("pool of 63", "broadcast"),
    ("pool of 64", "tables"),
    ("zero-size kernel and stride, pool of 513", "broadcast"),
    ("one config", "broadcast"),
])
def test_dispatch(case, want, specs, pools, space, hw):
    stream = (zero_size_stream() if case.startswith("zero")
              else specs["resnet"].stream)
    m = pools[513].matrix
    m = {"pool of 63": m[:63], "pool of 64": m[:64],
         "one config": m[:1]}.get(case, m)
    batch = ref_cm.ConfigBatch(m)
    ref, got, host, passes = three(batch, stream, space.hw, hw,
                                   1 << 10, 1 << 10)
    assert passes == {want: 1}
    assert_same(got, ref, case)
    assert_same(got, host, case)


def test_the_span_names_the_route(specs, pools, hw):
    ps = port_stream(specs["ptb"].stream)
    obs.enable(trace=True, metrics=False, journal=False)
    try:
        for n in (63, 64):
            evaluate_stream_many(
                config_batch_from_matrix(pools[513].matrix[:n]), ps, hw,
                device="cpu")
        events = [e for e in obs.tracer().export()
                  if e.get("name") == "evaluate_stream_many"]
    finally:
        obs.disable(reset=True)
    assert [(e["args"]["backend"], e["args"]["route"]) for e in events] \
        == [("tables", "broadcast"), ("tables", "tables")]


@pytest.mark.parametrize("chunk", [1, 5, None])
def test_chunk_size_changes_no_bit(chunk, specs, pools, space, hw,
                                   monkeypatch):
    """`_tables_chunk` scales with `_BROADCAST_CHUNK`."""
    spec = specs["inception"]
    monkeypatch.setattr(cm, "_BROADCAST_CHUNK", chunk or 1 << 20)
    step = cm._tables_chunk(len(port_stream(spec.stream).dedup_columns()[0]),
                            len(spec.stream))
    assert step < 513 if chunk else step >= 513
    ref, got, host, _ = three(pools[513], spec.stream, space.hw, hw,
                              spec.peak_weight_bits, spec.peak_input_bits)
    assert_same(got, ref, f"chunk={chunk}")
    assert_same(got, host, f"chunk={chunk}")


def test_unseen_values_grow_the_tables(specs, space, hw):
    """A pool outside the Table-2 domains rebuilds the tables (and their
    device copies) and still equals the reference."""
    spec = specs["resnet"]
    rng = np.random.default_rng(22)
    m = space.decode_batch(space.sample_indices(rng, 200)).matrix.copy()
    ps = port_stream(spec.stream)
    evaluate_stream_many(config_batch_from_matrix(m), ps, hw, device="cpu")
    t = cm._fused_tables_for(ps, hw, None)
    before = t.n_rebuilds
    m2 = m.copy()
    for f in ("tix", "pof"):
        m2[:, ref_cm.ConfigBatch._INDEX[f]] += 3
    ref = ref_cm.evaluate_stream_many(ref_cm.ConfigBatch(m2), spec.stream,
                                      space.hw, backend="numpy")
    got = evaluate_stream_many(config_batch_from_matrix(m2), ps, hw,
                               device="cpu")
    assert t.n_rebuilds == before + 1
    assert_same(got, ref, "grown")
    uploads = cm._TABLE_PASS_UPLOADS[t]["cpu"]
    assert uploads.n_uploads == 2
    ref0 = ref_cm.evaluate_stream_many(ref_cm.ConfigBatch(m), spec.stream,
                                       space.hw, backend="numpy")
    assert_same(evaluate_stream_many(config_batch_from_matrix(m), ps, hw,
                                     device="cpu"), ref0, "after growth")
    assert uploads.n_uploads == 2


def test_the_analysis_api_takes_the_new_default(specs, pools, space, hw):
    """`performance_gops` takes the table pass from 64 configs up and
    `evaluate_stream` (one config) the broadcast pass; both equal the
    reference's."""
    spec = specs["deeplab"]
    ps = port_stream(spec.stream)
    batch = pools[513]
    cm.PASSES.clear()
    got = cm.performance_gops(config_batch_from_matrix(batch.matrix), ps, hw,
                              spec.peak_weight_bits, spec.peak_input_bits,
                              device="cpu")
    assert dict(cm.PASSES) == {"tables": 1}
    np.testing.assert_array_equal(
        got, ref_cm.performance_gops(batch, spec.stream, space.hw,
                                     spec.peak_weight_bits,
                                     spec.peak_input_bits))
    cfg = batch[3]
    cm.PASSES.clear()
    bd = cm.evaluate_stream(cm.AccelConfig(**cfg.asdict()), ps, hw,
                            device="cpu")
    assert dict(cm.PASSES) == {"broadcast": 1}
    np.testing.assert_array_equal(
        bd.total_cycles,
        ref_cm.evaluate_stream(cfg, spec.stream, space.hw).total_cycles)


@pytest.mark.parametrize("backend,want", [("broadcast", {"broadcast": 1}),
                                          ("fused", {})])
def test_evaluator_backends_keep_their_pass(backend, want, specs, pools,
                                            space, hw):
    """`Evaluator(backend="broadcast")` still scores through the broadcast
    pass (a pool of 513 would take the table pass by default), and the
    fused evaluator through none of them."""
    spec = specs["ptb"]
    ev = Evaluator(port_stream(spec.stream), hw=hw,
                   peak_weight_bits=spec.peak_weight_bits,
                   peak_input_bits=spec.peak_input_bits, device="cpu",
                   backend=backend)
    cm.PASSES.clear()
    got = ev(config_batch_from_matrix(pools[513].matrix))
    assert dict(cm.PASSES) == want
    np.testing.assert_array_equal(
        got, ref_cm.performance_gops(pools[513], spec.stream, space.hw,
                                     spec.peak_weight_bits,
                                     spec.peak_input_bits))


def test_gather_operands_meet_the_kernels_contract(specs, pools, hw,
                                                   monkeypatch):
    """On the card `gather_rows` takes a contiguous [U, O] int64 table and
    contiguous int64 indices on its device, or raises; on the CPU it runs
    the plain version whatever the layout.  So the CPU run checks what
    the kernel would be handed: eleven gathers a chunk, each within the
    contract, the results unchanged."""
    from repro_torch.kernels.gather import gather_rows_plain

    seen = []

    def strict(table, idx):
        assert table.dtype == idx.dtype == torch.int64
        assert table.dim() == 2 and idx.dim() == 1
        assert table.is_contiguous() and idx.is_contiguous()
        seen.append(idx.shape[0])
        return gather_rows_plain(table, idx)

    monkeypatch.setattr(cm, "gather_rows", strict)
    monkeypatch.setattr(cm, "_BROADCAST_CHUNK", 64)
    spec = specs["resnet"]
    ps = port_stream(spec.stream)
    batch = pools[513]
    got = evaluate_stream_many(config_batch_from_matrix(batch.matrix), ps,
                               hw, spec.peak_weight_bits,
                               spec.peak_input_bits, device="cpu")
    step = cm._tables_chunk(len(ps.dedup_columns()[0]), len(ps))
    chunks = -(-513 // step)
    assert chunks > 1 and len(seen) == 11 * chunks
    assert sum(seen) == 11 * 513
    assert_same(got, ref_cm.evaluate_stream_many(
        batch, spec.stream, ref_cm.HardwareConstants(
            **dataclasses.asdict(hw)), spec.peak_weight_bits,
        spec.peak_input_bits, backend="numpy"), "contract")
