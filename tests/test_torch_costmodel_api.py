"""The port's analysis API on the CPU against the JAX package's.

`evaluate_stream_many` (the device broadcast pass with ``device="cpu"``,
and the host ``numpy-ref``), `evaluate_stream`, `performance_gops`,
`LatencyBreakdown` and `BufferSimulator` must equal the reference's
``numpy-ref`` results bit for bit: cycles, validity and all five [C, O]
parts, with their dtypes.  Both packages get the same streams (carried as
plain records by `repro_torch.convert`), spaces and pools, made from numpy
seeds.  Then the port's versions of `tests/test_costmodel.py`'s Eq. 9-13
cases.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import apps as ref_apps
from repro.core import costmodel as ref_cm
from repro.core.multiapp import AppSpec
from repro.core.space import default_space
from repro_torch.convert import config_batch_from_matrix, ops_from_records
from repro_torch.core import costmodel as cm
from repro_torch.core.costmodel import (AccelConfig, BufferSimulator,
                                        ConfigBatch, LoopOrder, Op, OpKind,
                                        OpStream, evaluate_stream,
                                        evaluate_stream_many,
                                        performance_gops)
from repro_torch.core.search import Evaluator
from repro_torch.kernels.costmodel import FusedTorchScorer
from test_config_batch import random_space, random_stream

APPS = tuple(ref_apps.APP_BUILDERS)
PARTS = ("compute", "weight", "input", "total", "valid_ops")


def port_stream(stream):
    return ops_from_records([{**dataclasses.asdict(op), "kind": op.kind.name}
                             for op in stream.ops])


def port_hw(hw):
    return cm.HardwareConstants(**dataclasses.asdict(hw))


def assert_same(got, want, context=""):
    """Bit-equal cycles, validity and parts, dtypes included."""
    for i, name in enumerate(("cycles", "valid")):
        assert got[i].dtype == want[i].dtype, f"{name} dtype {context}"
        np.testing.assert_array_equal(got[i], want[i],
                                      err_msg=f"{name} {context}")
    if want[2] is None:
        assert got[2] is None
        return
    assert set(got[2]) == set(want[2]) == set(PARTS)
    for k in PARTS:
        assert got[2][k].dtype == want[2][k].dtype, f"{k} dtype {context}"
        np.testing.assert_array_equal(got[2][k], want[2][k],
                                      err_msg=f"parts[{k}] {context}")


def both(batch, stream, hw, pw=0, pi=0, with_parts=True):
    """(reference numpy-ref, port broadcast on the CPU, port numpy-ref)."""
    ref = ref_cm.evaluate_stream_many(batch.to_configs(), stream, hw, pw, pi,
                                      backend="numpy-ref")
    pb = config_batch_from_matrix(batch.matrix)
    ps, ph = port_stream(stream), port_hw(hw)
    got = evaluate_stream_many(pb, ps, ph, pw, pi, backend="broadcast",
                               device="cpu", with_parts=with_parts)
    host = evaluate_stream_many(pb, ps, ph, pw, pi, backend="numpy-ref",
                                with_parts=with_parts)
    return ref, got, host


@pytest.fixture(scope="module")
def specs():
    return {n: AppSpec.from_graph(n, ref_apps.build_app(n)) for n in APPS}


@pytest.fixture(scope="module")
def space():
    return default_space()


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("trial", range(8))
def test_broadcast_equals_reference_over_random_spaces(trial):
    """The reference's randomized spaces, streams, pools and peaks
    (`tests/test_config_batch.py`'s generators)."""
    rng = np.random.default_rng(100 + trial)
    sp = random_space(rng)
    stream = random_stream(rng)
    n = int(rng.choice([1, 7, 63, 64, 65, 200]))
    batch = sp.decode_batch(sp.sample_indices(rng, n))
    pw = int(rng.integers(0, 2)) * int(rng.integers(0, 1 << 24))
    pi = int(rng.integers(0, 2)) * int(rng.integers(0, 1 << 24))
    ref, got, host = both(batch, stream, sp.hw, pw, pi)
    ctx = f"trial={trial} n={n} pw={pw} pi={pi}"
    assert_same(got, ref, ctx)
    assert_same(host, ref, ctx)
    np.testing.assert_array_equal(
        performance_gops(config_batch_from_matrix(batch.matrix),
                         port_stream(stream), port_hw(sp.hw), pw, pi,
                         device="cpu"),
        ref_cm.performance_gops(batch.to_configs(), stream, sp.hw, pw, pi,
                                backend="numpy-ref"), err_msg=ctx)


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("peaks", [True, False])
def test_broadcast_equals_reference_on_paper_apps(app, peaks, specs, space):
    spec = specs[app]
    rng = np.random.default_rng(4)
    raw = space.decode_batch(space.sample_indices(rng, 96))
    fixed = space.repair_for_peaks_many(
        space.decode_batch(space.sample_indices(rng, 96)),
        spec.peak_weight_bits,
        spec.peak_input_bits * int(spec.stream.batch.max()))
    batch = ref_cm.ConfigBatch.concat([raw, fixed])
    pw, pi = ((spec.peak_weight_bits, spec.peak_input_bits) if peaks
              else (0, 0))
    ref, got, host = both(batch, spec.stream, space.hw, pw, pi)
    assert_same(got, ref, app)
    assert_same(host, ref, app)
    assert ref[1].any(), "the pool should hold valid configs"


def test_broadcast_equals_reference_on_a_traced_zoo_app(space):
    spec = AppSpec.from_graph("qwen2-0.5b:decode",
                              ref_apps.build_app("qwen2-0.5b:decode"))
    rng = np.random.default_rng(5)
    batch = space.decode_batch(space.sample_indices(rng, 128))
    ref, got, host = both(batch, spec.stream, space.hw,
                          spec.peak_weight_bits, spec.peak_input_bits)
    assert_same(got, ref, "zoo")
    assert_same(host, ref, "zoo")


@pytest.mark.parametrize("lo", list(LoopOrder))
def test_every_loop_order(lo, specs, space):
    rng = np.random.default_rng(6)
    m = space.decode_batch(space.sample_indices(rng, 64)).matrix.copy()
    m[:, ConfigBatch._INDEX["loop_order"]] = int(lo)
    batch = ref_cm.ConfigBatch(m)
    for app in ("resnet", "ptb"):
        ref, got, _ = both(batch, specs[app].stream, space.hw)
        assert_same(got, ref, f"{app} {lo.name}")


def zero_size_stream():
    """A zero-size kernel, a zero stride and a plain op: the fused scorer
    refuses such a stream; the broadcast pass scores it."""
    return ref_cm.OpStream([
        ref_cm.Op(ref_cm.OpKind.CONV2D, 16, 12, 12, 0, 0, 32, 12, 12),
        ref_cm.Op(ref_cm.OpKind.CONV2D, 8, 9, 9, 3, 3, 8, 4, 4, s=0),
        ref_cm.Op.matmul(64, 32, 48),
    ])


def test_zero_size_kernel_and_stride_stream(space):
    stream = zero_size_stream()
    rng = np.random.default_rng(7)
    batch = space.decode_batch(space.sample_indices(rng, 80))
    with np.errstate(divide="ignore"):
        ref, got, host = both(batch, stream, space.hw, 1 << 10, 1 << 10)
    assert_same(got, ref, "zero-size")
    assert_same(host, ref, "zero-size")
    ps = port_stream(stream)
    assert not FusedTorchScorer.supports(ps)
    with pytest.raises(ValueError, match="not supported"):
        Evaluator(ps, device="cpu")
    ev = Evaluator(ps, device="cpu", backend="broadcast")
    with np.errstate(divide="ignore"):
        want = ref_cm.performance_gops(batch.to_configs(), stream, space.hw,
                                       backend="numpy-ref")
    np.testing.assert_array_equal(
        ev(config_batch_from_matrix(batch.matrix)), want)


@pytest.mark.parametrize("chunk", [1, 7, None])
def test_chunk_size_changes_no_bit(chunk, specs, space, monkeypatch):
    spec = specs["inception"]
    rng = np.random.default_rng(8)
    batch = space.decode_batch(space.sample_indices(rng, 50))
    monkeypatch.setattr(cm, "_BROADCAST_CHUNK", chunk or len(batch))
    ref, got, _ = both(batch, spec.stream, space.hw, spec.peak_weight_bits,
                       spec.peak_input_bits)
    assert_same(got, ref, f"chunk={chunk}")
    _, lean, _ = both(batch, spec.stream, space.hw, spec.peak_weight_bits,
                      spec.peak_input_bits, with_parts=False)
    assert lean[2] is None
    np.testing.assert_array_equal(lean[0], ref[0])
    np.testing.assert_array_equal(lean[1], ref[1])


def test_evaluate_stream_and_breakdown(specs, space):
    rng = np.random.default_rng(9)
    for app in ("resnet", "wdl", "nasnet"):
        spec = specs[app]
        ps = port_stream(spec.stream)
        for cfg in [space.sample(rng) for _ in range(4)]:
            want = ref_cm.evaluate_stream(cfg, spec.stream, space.hw,
                                          spec.peak_weight_bits,
                                          spec.peak_input_bits)
            got = evaluate_stream(AccelConfig(**cfg.asdict()), ps,
                                  port_hw(space.hw), spec.peak_weight_bits,
                                  spec.peak_input_bits, device="cpu")
            for f in ("compute_cycles", "weight_cycles", "input_cycles",
                      "total_cycles", "valid"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
            assert got.stream_cycles == want.stream_cycles
            assert got.stream_valid == want.stream_valid
            assert got.bottlenecks() == want.bottlenecks()
            np.testing.assert_array_equal(got.latency_shares(),
                                          want.latency_shares())


def test_evaluator_backends_agree(specs, space):
    """The broadcast evaluator scores what the fused one does, bit for
    bit, with the area budget and the peaks."""
    spec = specs["ptb"]
    ps = port_stream(spec.stream)
    rng = np.random.default_rng(10)
    pool = config_batch_from_matrix(
        space.decode_batch(space.sample_indices(rng, 300)).matrix)
    kw = dict(peak_weight_bits=spec.peak_weight_bits,
              peak_input_bits=spec.peak_input_bits, area_budget=60000.0,
              device="cpu")
    fused = Evaluator(ps, backend="fused", **kw)
    broad = Evaluator(ps, backend="broadcast", **kw)
    np.testing.assert_array_equal(broad(pool), fused(pool))
    for a, b in zip(broad.score_with_area(pool), fused.score_with_area(pool)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(cm.area_many(pool, device="cpu"),
                                  cm.area_many(pool))
    with pytest.raises(ValueError, match="unknown backend"):
        Evaluator(ps, backend="numpy", device="cpu")


def test_unknown_backend_raises():
    s = OpStream([Op.matmul(8, 8, 8)])
    with pytest.raises(ValueError, match="unknown backend"):
        evaluate_stream_many([AccelConfig()], s, backend="jax", device="cpu")


def test_buffer_simulator_equals_reference(specs, space):
    rng = np.random.default_rng(11)
    for app in ("resnet", "deeplab", "ptb"):
        spec = specs[app]
        ps = port_stream(spec.stream)
        for cfg in [space.sample(rng) for _ in range(2)]:
            for n_blocks in (16, 64):
                want = ref_cm.BufferSimulator(cfg, space.hw,
                                              n_blocks).simulate(spec.stream)
                got = BufferSimulator(AccelConfig(**cfg.asdict()),
                                      port_hw(space.hw),
                                      n_blocks).simulate(ps)
                assert got == want


# ----------------------------- `tests/test_costmodel.py`, on the port

def test_compute_cycles_ideal_at_full_unroll():
    op = Op.conv2d(nif=8, nix=10, niy=10, nkx=3, nky=3, nof=8)
    cfg = AccelConfig(pe_group=64, mac_per_group=512,
                      tif=8, tix=10, tiy=10, tof=8,
                      pif=8, pof=8, pox=4, poy=4, pkx=3, pky=3,
                      bank_height=8192, bank_width=128,
                      weight_banks_pg=16, act_banks_pg=16)
    bd = evaluate_stream(cfg, OpStream([op]), device="cpu")
    assert bd.valid.all()
    assert int(bd.compute_cycles[0]) == 4


def test_eq9_mac_constraint_violation():
    op = Op.conv2d(nif=64, nix=28, niy=28, nkx=3, nky=3, nof=64)
    cfg = AccelConfig(pe_group=1, mac_per_group=16,
                      pif=64, pof=64, pox=4, poy=4, pkx=3, pky=3,
                      tif=64, tix=28, tiy=28, tof=64)
    _, valid, _ = evaluate_stream_many([cfg], OpStream([op]), device="cpu")
    assert not valid[0]
    assert performance_gops([cfg], OpStream([op]), device="cpu")[0] == 0.0


def test_buffer_constraints_eq10_12():
    op = Op.conv2d(nif=256, nix=56, niy=56, nkx=3, nky=3, nof=256)
    small = AccelConfig(bank_height=256, bank_width=16, weight_banks_pg=1,
                        act_banks_pg=1, pe_group=1, tif=256, tix=56,
                        tiy=56, tof=256)
    _, valid, _ = evaluate_stream_many([small], OpStream([op]),
                                       device="cpu")
    assert not valid[0]


@pytest.mark.parametrize("peak", ["weight", "input"])
def test_eq11_13_peak_floors(peak):
    op = Op.conv2d(nif=32, nix=28, niy=28, nkx=3, nky=3, nof=32, batch=4)
    cfg = AccelConfig()
    s = OpStream([op])
    assert evaluate_stream_many([cfg], s, device="cpu")[1][0]
    buf = (cfg.weight_buffer_bits() if peak == "weight"
           else cfg.act_buffer_bits())
    kw = ({"peak_weight_bits": buf + 1} if peak == "weight"
          else {"peak_input_bits": buf // 4 + 1})     # Eq. 13 x max batch
    assert not evaluate_stream_many([cfg], s, device="cpu", **kw)[1][0]


def test_memory_latency_scales_with_bandwidth():
    op = Op.conv2d(nif=64, nix=56, niy=56, nkx=3, nky=3, nof=64)
    base = AccelConfig(weight_banks_pg=1, act_banks_pg=1, bank_width=16,
                       pe_group=4, mac_per_group=64, bank_height=8192)
    wide = AccelConfig(weight_banks_pg=8, act_banks_pg=8, bank_width=128,
                       pe_group=4, mac_per_group=64, bank_height=8192)
    s = OpStream([op])
    b1 = evaluate_stream(base, s, device="cpu")
    b2 = evaluate_stream(wide, s, device="cpu")
    assert b2.weight_cycles[0] < b1.weight_cycles[0]
    assert b2.input_cycles[0] < b1.input_cycles[0]


def test_total_latency_is_max_of_terms():
    op = Op.conv2d(nif=32, nix=28, niy=28, nkx=3, nky=3, nof=32)
    bd = evaluate_stream(AccelConfig(), OpStream([op]), device="cpu")
    assert bd.total_cycles[0] == max(bd.compute_cycles[0],
                                     max(bd.weight_cycles[0],
                                         bd.input_cycles[0]))


def test_loop_orders_change_memory_cost():
    op = Op.conv2d(nif=128, nix=28, niy=28, nkx=3, nky=3, nof=512)
    cfgs = [AccelConfig(loop_order=lo, tif=32, tix=14, tiy=14, tof=32)
            for lo in LoopOrder]
    _, _, parts = evaluate_stream_many(cfgs, OpStream([op]), device="cpu")
    assert len(set(parts["weight"][:, 0].tolist())) > 1


def test_batch_extension():
    op1 = Op.conv2d(nif=32, nix=28, niy=28, nkx=3, nky=3, nof=32, batch=8)
    s = OpStream([op1])
    c1 = evaluate_stream(AccelConfig(pb=1, pe_group=64, mac_per_group=512),
                         s, device="cpu")
    c8 = evaluate_stream(AccelConfig(pb=8, pe_group=64, mac_per_group=512),
                         s, device="cpu")
    assert c8.compute_cycles[0] * 8 == c1.compute_cycles[0]
    assert c8.weight_cycles[0] <= c1.weight_cycles[0]


def test_buffer_simulator_upper_bounds_ideal():
    op = Op.conv2d(nif=64, nix=28, niy=28, nkx=3, nky=3, nof=64)
    cfg = AccelConfig()
    bd = evaluate_stream(cfg, OpStream([op]), device="cpu")
    sim = BufferSimulator(cfg, n_blocks=16).simulate_op(op)
    assert sim >= 0.5 * float(bd.total_cycles[0])


def test_empty_pool_and_depthwise_kind():
    s = OpStream([Op.depthwise(nif=32, nix=28, niy=28, nkx=3, nky=3)])
    assert s.ops[0].kind is OpKind.DEPTHWISE_CONV
    cyc, valid, parts = evaluate_stream_many([], s, device="cpu")
    assert cyc.shape == (0,) and valid.shape == (0,)
    assert parts["total"].shape == (0, 1)
