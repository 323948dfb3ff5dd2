"""The port's frontend (`repro_torch.frontend`) on the CPU: twins of the
reference's frontend tests, the aten rules where aten is not a jaxpr
(in-place writes, constants, two-activation einsums) against the
reference's trace of the same function, and the twenty zoo apps of the
ten archs against the reference's graphs, vertex for vertex, with the
twenty-app greedy study selecting the reference's config."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax
from torch.utils.checkpoint import checkpoint

from repro.core import apps as ref_apps
from repro.core.multiapp import AppSpec as RefAppSpec
from repro.dse import GeomeanAcrossApps as RefGeomean
from repro.dse import SearchBudget as RefBudget
from repro.dse import Study as RefStudy
from repro.frontend import trace_to_graph as ref_trace
from repro_torch.core import apps
from repro_torch.core.apps import _B
from repro_torch.core.costmodel import OpKind
from repro_torch.core.multiapp import AppSpec
from repro_torch.dse import GeomeanAcrossApps, SearchBudget, Study
from repro_torch.frontend import trace_to_graph
from repro_torch.frontend import zoo

ZOO20 = tuple(f"{arch}:{v}" for arch in zoo.PORTED_ARCHS
              for v in zoo.ZOO_VARIANTS)

def _op_sig(op):
    return (op.kind.value, op.nif, op.nix, op.niy, op.nkx, op.nky, op.nof,
            op.nox, op.noy, op.s, op.batch, op.repeat)


def _stream_nodes(graph):
    return [graph.nodes[n] for n in graph.operation_stream()
            if graph.nodes[n].op is not None]


def _structure(graph):
    """The graph as the analysis sees it, names dropped: per stream
    position the op signature (or None), output and weight bits, and the
    stream positions of the parents."""
    stream = graph.operation_stream()
    pos = {n: i for i, n in enumerate(stream)}
    return [(_op_sig(graph.nodes[n].op) if graph.nodes[n].op else None,
             graph.nodes[n].output_bits, graph.nodes[n].weight_bits,
             tuple(pos[p] for p in graph.nodes[n].parents)) for n in stream]


# ------------------------------------------------------ reference twins

def test_traced_cnn_matches_hand_built_graph():
    """A torch CNN (conv, depthwise, 1x1, conv, a reshape and an FC)
    lowers to exactly the graph the `_B` DSL hand-builds."""
    H = W = 16
    params = {"w1": torch.empty(8, 3, 3, 3), "wd": torch.empty(8, 1, 3, 3),
              "w2": torch.empty(16, 8, 1, 1), "w3": torch.empty(16, 16, 3, 3),
              "wfc": torch.empty(16 * 10 * 10, 10)}

    def fn(p, x):
        y = F.relu(F.conv2d(x, p["w1"]))
        y = F.conv2d(y, p["wd"], groups=8)
        y = F.relu(F.conv2d(y, p["w2"]))
        y = F.conv2d(y, p["w3"])
        return y.reshape(1, -1) @ p["wfc"]

    traced = trace_to_graph(fn, params, torch.empty(1, 3, H, W), name="cnn")
    b = _B("cnn", H, W, 3)
    b.conv(8, 3, 1, "valid")
    b.dwconv(3, 1, "valid")
    b.conv(16, 1, 1, "valid")
    b.conv(16, 3, 1, "valid")
    b.fc(10)
    hand = b.g

    t_nodes, h_nodes = _stream_nodes(traced), _stream_nodes(hand)
    assert len(t_nodes) == len(h_nodes) == 5
    for tn, hn in zip(t_nodes, h_nodes):
        assert _op_sig(tn.op) == _op_sig(hn.op), (tn.name, hn.name)
        assert tn.output_bits == hn.output_bits, (tn.name, hn.name)
        assert tn.weight_bits == hn.weight_bits, (tn.name, hn.name)
    assert [n.op.kind for n in t_nodes] == [
        OpKind.CONV2D, OpKind.DEPTHWISE_CONV, OpKind.CHANNEL_MIXING,
        OpKind.CONV2D, OpKind.MATVEC]
    t_prof, h_prof = traced.memory_profile(), hand.memory_profile()
    assert t_prof.peak_activation_bits == h_prof.peak_activation_bits
    assert t_prof.peak_weight_bits == h_prof.peak_weight_bits
    assert traced.op_stream().total_macs == hand.op_stream().total_macs


def test_matmul_vs_matvec_prefill_decode_dispatch():
    w = torch.empty(64, 32)
    prefill = trace_to_graph(lambda p, x: x @ p, w, torch.empty(8, 64))
    decode = trace_to_graph(lambda p, x: x @ p, w, torch.empty(1, 64))
    (p_node,), (d_node,) = _stream_nodes(prefill), _stream_nodes(decode)
    assert p_node.op.kind == OpKind.MATMUL and p_node.op.nix == 8
    assert d_node.op.kind == OpKind.MATVEC
    assert p_node.weight_bits == d_node.weight_bits == 64 * 32 * 8


def test_dot_batch_dims_become_repeat_instances():
    g = trace_to_graph(lambda p, q, k: torch.einsum("hqd,hkd->hqk", q, k),
                       {}, torch.empty(4, 16, 32), torch.empty(4, 16, 32))
    (node,) = _stream_nodes(g)
    assert node.op.kind == OpKind.MATMUL and node.op.repeat == 4
    assert (node.op.nif, node.op.nix, node.op.nof) == (32, 16, 16)
    assert node.weight_bits == 0


def test_nested_calls_checkpoint_and_layer_loops_are_traversed():
    """The twin of the reference's nested-jit test, with its expected
    values (3 MATMULs, d x d x 8 weight bits each; the reference itself
    misses nested `jit` on jax 0.9.0): a nested call under
    `torch.utils.checkpoint` in a Python loop over a stacked weight, each
    layer claiming its own slice."""
    n_layers, d = 3, 16

    def layer(x, w):
        return torch.tanh(x @ w)

    def fn(ws, x):
        for w in ws:
            x = checkpoint(layer, x, w, use_reentrant=False)
        return x

    g = trace_to_graph(fn, torch.empty(n_layers, d, d), torch.empty(4, d),
                       name="scanned")
    nodes = _stream_nodes(g)
    assert len(nodes) == n_layers
    assert all(n.op.kind == OpKind.MATMUL for n in nodes)
    assert all(n.weight_bits == d * d * 8 for n in nodes)


def test_weights_never_become_activation_nodes():
    small = {"w": torch.empty(8, 8)}
    big = {"w": torch.empty(8, 8), "unused": torch.empty(4096, 4096)}
    x = torch.empty(2, 8)
    peak_small = trace_to_graph(lambda p, x: x @ p["w"], small, x)
    peak_big = trace_to_graph(lambda p, x: x @ p["w"], big, x)
    assert peak_small.memory_profile().peak_activation_bits == \
        peak_big.memory_profile().peak_activation_bits


# ------------------------------------- aten rules against the reference

@pytest.mark.parametrize("eq,rows", [("bqd,bkd->bqk", 8),
                                     ("bqd,bkd->bkq", 24)])
def test_two_activation_einsum_has_the_reference_rows(eq, rows):
    """`jnp.einsum` hands `dot_general` the operand order that spares a
    transpose of its output, and the rows come from its lhs: the port
    traces the same op, and its einsum computes what `torch.einsum`
    does."""
    from repro_torch.frontend.trace import _dot_general_einsum

    want = ref_trace(lambda p, q, k: jnp.einsum(eq, q, k), {},
                     jax.ShapeDtypeStruct((2, 8, 32), jnp.float32),
                     jax.ShapeDtypeStruct((2, 24, 32), jnp.float32))
    got = trace_to_graph(lambda p, q, k: torch.einsum(eq, q, k), {},
                         torch.empty(2, 8, 32), torch.empty(2, 24, 32))
    assert _structure(got) == _structure(want)
    assert _stream_nodes(got)[0].op.nix == rows
    g = torch.Generator().manual_seed(0)
    q, k = torch.randn(2, 8, 32, generator=g), torch.randn(2, 24, 32,
                                                            generator=g)
    torch.testing.assert_close(_dot_general_einsum(eq, q, k),
                               torch.einsum(eq, q, k))


@pytest.mark.parametrize("tensor_pos", [True, False])
def test_cache_write_is_a_new_version_of_the_cache(tensor_pos):
    """An in-place write into the cache is one vertex of the cache's size
    over the old cache, the value (and the position), as the reference's
    `dynamic_update_slice`: `kv_cache_write` at a traced position, and an
    assignment through a slice at a fixed one, whose slice leaves no
    vertex."""
    from repro_torch.models.layers import kv_cache_write

    def write_through_a_slice(p, c, n):
        c[:, 5:6] = n
        return c

    want = ref_trace(
        lambda p, c, n, i: lax.dynamic_update_slice_in_dim(c, n, i, axis=1),
        {}, jax.ShapeDtypeStruct((1, 16, 2, 8), jnp.float32),
        jax.ShapeDtypeStruct((1, 1, 2, 8), jnp.float32),
        jax.ShapeDtypeStruct((), jnp.int32))
    args = [{}, torch.empty(1, 16, 2, 8), torch.empty(1, 1, 2, 8)]
    if tensor_pos:
        got = trace_to_graph(lambda p, c, n, i: kv_cache_write(c, n, i),
                             *args, torch.empty((), dtype=torch.int64))
        assert _structure(got) == _structure(want)
    else:
        got = trace_to_graph(write_through_a_slice, *args)
        (write,) = [n for n in got.nodes.values() if n.parents]
        assert write.output_bits == 16 * 2 * 8 * 8
        assert len(got.nodes) == 3 and len(write.parents) == 2


def test_constants_count_as_weights_and_iotas_as_data():
    """`arange` with a step is a captured constant (as `jnp.arange` with a
    step is), a plain `arange` a parentless data vertex (an iota), a 0-d
    scalar a literal."""
    want = ref_trace(
        lambda p, x: x * (1e4 ** (-jnp.arange(0, 8, 2, dtype=jnp.float32)
                                  / 8)) + jnp.arange(4) * 2.0,
        {}, jax.ShapeDtypeStruct((3, 4), jnp.float32))
    def fn(p, x):
        freqs = torch.arange(0, 8, 2, dtype=torch.float32, device=x.device)
        return x * (1e4 ** (-freqs / 8)) + torch.arange(4, device=x.device) \
            * 2.0

    got = trace_to_graph(fn, {}, torch.empty(3, 4))
    assert got.total_weight_bits == want.total_weight_bits == 4 * 8
    assert _structure(got) == _structure(want)


def test_softmax_is_the_references_four_vertices():
    """`torch.softmax` traces as `jax.nn.softmax`'s jaxpr: the row max,
    `x - max` (its exp aliased), the row sum and the quotient."""
    want = ref_trace(lambda p, x: jax.nn.softmax(x * 2.0, axis=-1), {},
                     jax.ShapeDtypeStruct((3, 5, 8), jnp.float32))
    got = trace_to_graph(lambda p, x: torch.softmax(x * 2.0, dim=-1), {},
                         torch.empty(3, 5, 8))
    assert _structure(got) == _structure(want)
    assert got.summary()["n_data_nodes"] == 5


def test_dispatch_calls_are_the_references_vertices():
    """`F.one_hot` and `torch.take_along_dim` are one vertex each, as the
    nested `jit` of `jax.nn.one_hot` and `jnp.take_along_axis` is; an
    `index_put_` with two index tensors is the reference's
    ``x.at[i, j].set(v)``: the smaller index broadcast, the two
    concatenated, then the scatter."""
    def ref(p, e, x, src):
        oh = jax.nn.one_hot(e, 8, dtype=jnp.int32)
        pos = oh.sum(-1)
        g = jnp.arange(2)[:, None]
        buf = jnp.full((2, 9), 5, jnp.int32).at[g, e + pos].set(
            src, mode="drop")
        return jnp.take_along_axis(x, buf[:, :-1][..., None], axis=1)

    def port(p, e, x, src):
        oh = F.one_hot(e, 8).to(torch.int32)
        pos = oh.sum(-1)
        g = torch.arange(2, device=e.device)[:, None]
        buf = torch.full((2, 9), 5, dtype=torch.int64, device=e.device)
        buf[g, e + pos] = src
        return torch.take_along_dim(x, buf[:, :-1][..., None], dim=1)

    want = ref_trace(ref, {}, jax.ShapeDtypeStruct((2, 6), jnp.int32),
                     jax.ShapeDtypeStruct((2, 7, 4), jnp.float32),
                     jax.ShapeDtypeStruct((2, 6), jnp.int32))
    got = trace_to_graph(port, {}, torch.empty(2, 6, dtype=torch.int64),
                         torch.empty(2, 7, 4),
                         torch.empty(2, 6, dtype=torch.int64))
    assert _structure(got) == _structure(want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("skv,kv_block", [(40, 16), (32, 16), (12, 64)])
def test_blocked_attention_in_the_references_ops(causal, skv, kv_block):
    """`blocked_attention` traces as the reference's (its scan over KV
    blocks, the block counter, the mask) vertex for vertex, padded tail
    and several blocks included, and computes its values."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, skv, 4, 8, generator=g)
    k, v = (torch.randn(2, skv, 2, 8, generator=g) for _ in range(2))
    kw = dict(causal=causal, kv_block=kv_block)
    np.testing.assert_allclose(
        TL.blocked_attention(q, k, v, **kw).numpy(),
        np.asarray(JL.blocked_attention(*(jnp.asarray(t.numpy())
                                          for t in (q, k, v)), **kw)),
        rtol=1e-5, atol=1e-5)
    sds = [jax.ShapeDtypeStruct(tuple(t.shape), jnp.float32)
           for t in (q, k, v)]
    want = ref_trace(lambda p, q, k, v: JL.blocked_attention(q, k, v, **kw),
                     {}, *sds)
    got = trace_to_graph(
        lambda p, q, k, v: TL.blocked_attention(q, k, v, **kw), {}, q, k, v)
    assert _structure(got) == _structure(want)


@pytest.mark.parametrize("steps", [1, 3])
def test_scan_and_index_from_end_are_the_references_vertices(steps):
    """`layers.scan` traces as `jax.lax.scan` (a slice vertex per step and
    operand, the ys stacked into one vertex, even over one step), and
    `index_from_end` as jnp's ``x[:, -1]`` (the index normalised on
    literals, then a dynamic slice); `cumsum` is aliased, as the
    reference's nested `jit` of it is."""
    from repro_torch.frontend.trace import index_from_end
    from repro_torch.models.layers import scan

    def ref(p, x):
        t = jnp.cumsum(x, axis=1)[:, -1]

        def step(carry, xs):
            y = carry * xs
            return y, y + carry
        _, ys = lax.scan(step, t, x.swapaxes(0, 1)[:steps])
        return ys

    def port(p, x):
        t = index_from_end(torch.cumsum(x, 1), 1, -1)

        def step(carry, xs):
            y = carry * xs[0]
            return y, y + carry
        _, ys = scan(step, t, (x.transpose(0, 1)[:steps],))
        return ys

    want = ref_trace(ref, {}, jax.ShapeDtypeStruct((2, 5, 3), jnp.float32))
    got = trace_to_graph(port, {}, torch.empty(2, 5, 3))
    assert _structure(got) == _structure(want)
    assert got.summary()["n_data_nodes"] == \
        want.summary()["n_data_nodes"] == 7 + 3 * steps
    x = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(port({}, x).numpy(),
                               np.asarray(ref({}, jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)


def test_scan_slices_outside_a_trace_is_zip():
    from repro_torch.frontend.trace import scan_slices

    a, b = torch.arange(6).reshape(3, 2), torch.arange(3)
    assert [(x.tolist(), y.item()) for x, y in scan_slices(a, b)] == \
        [([0, 1], 0), ([2, 3], 1), ([4, 5], 2)]


# ------------------------------------------------------------------ zoo

def test_zoo_apps_listed_and_unknown_rejected():
    names = apps.all_app_names()
    assert set(apps.APP_NAMES) <= set(names)
    assert apps.zoo_app_names() == tuple(ref_apps.zoo_app_names())
    assert len(ZOO20) == 20 and set(ZOO20) == set(zoo.ZOO_APP_NAMES)
    with pytest.raises(KeyError):
        apps.build_app("definitely-not-an-app")
    with pytest.raises(KeyError):
        apps.build_app("qwen2-0.5b:bogus-variant")
    with pytest.raises(KeyError):
        apps.build_app("no-such-arch:prefill")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-9b"])
def test_zoo_prefill_is_the_serving_forward(arch):
    """What the zoo traces in the reference's form computes the serving
    forward: `prefill_fn` (the layers a group at a time) gives
    `forward(last_only=True)`'s logits bit for bit, and with the RG-LRU
    block's scan as the reference's `associative_scan` within fp32
    rounding of the doubling's."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.layers import Runtime
    from repro_torch.models.lm import DecoderLM

    model = DecoderLM(get_smoke(arch))
    rt = Runtime(compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0), rt)
    toks = torch.randint(0, model.cfg.vocab_size, (2, 37),
                         generator=torch.Generator().manual_seed(1))
    want = model.forward(params, {"tokens": toks}, rt, last_only=True)
    assert torch.equal(zoo.prefill_fn(model, rt)(params, toks), want)
    with zoo._scan_as_the_reference():
        got = model.forward(params, {"tokens": toks}, rt, last_only=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _reference(name):
    return ref_apps.build_app(name)


@pytest.mark.parametrize("name", ZOO20)
def test_zoo_graph_matches_the_reference(name):
    """Vertex for vertex: the compute stream in order (kind, every Table-1
    field and `repeat`), each compute node's weight bits, the totals and
    both peaks, the `AppSpec`'s stream arrays, the count of data vertices,
    and every vertex of the stream (op or data) with its output and
    weight bits and its parents' stream positions."""
    want, got = _reference(name), apps.build_app(name)
    w_nodes, g_nodes = _stream_nodes(want), _stream_nodes(got)
    assert [_op_sig(n.op) for n in g_nodes] == \
        [_op_sig(n.op) for n in w_nodes]
    assert [n.weight_bits for n in g_nodes] == \
        [n.weight_bits for n in w_nodes]
    assert got.total_weight_bits == want.total_weight_bits
    w_prof, g_prof = want.memory_profile(), got.memory_profile()
    assert g_prof.peak_weight_bits == w_prof.peak_weight_bits
    assert g_prof.peak_activation_bits == w_prof.peak_activation_bits
    assert got.summary()["n_data_nodes"] == want.summary()["n_data_nodes"]
    assert _structure(got) == _structure(want)
    spec = AppSpec.from_graph(name, got, weight_peak_mode="strict")
    ref = RefAppSpec.from_graph(name, want, weight_peak_mode="strict")
    for field in spec.stream.FIELDS:
        np.testing.assert_array_equal(getattr(spec.stream, field),
                                      getattr(ref.stream, field))
    assert [op.kind.value for op in spec.stream.ops] == \
        [op.kind.value for op in ref.stream.ops]
    assert spec.peak_weight_bits == ref.peak_weight_bits


def test_zoo_study_selects_the_reference_config():
    """The greedy geomean study over the twenty apps on the CPU selects the
    reference numpy `Study`'s config, with the same per-app bests."""
    kw = dict(engine="greedy", seed=0)
    want = RefStudy(apps=list(ZOO20), objective=RefGeomean(),
                    budget=RefBudget(k=2, restarts=2, max_rounds=6),
                    **kw).run()
    got = Study(apps=list(ZOO20), objective=GeomeanAcrossApps(),
                budget=SearchBudget(k=2, restarts=2, max_rounds=6),
                device="cpu", **kw).run()
    assert got.best.asdict() == want.best.asdict()
    assert got.best_score == want.best_score > 0
    assert {a: r["best_perf"] for a, r in got.per_app.items()} == \
        {a: r["best_perf"] for a, r in want.per_app.items()}
