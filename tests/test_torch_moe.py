"""The port's token-choice MoE block and the two MoE decoders (olmoe-1b-7b,
deepseek-v2-lite-16b) against the JAX package, on the CPU in fp32.

Inputs come from numpy with a seed; parameters are the reference's own
initialised trees, carried across by `decoder_params_from_numpy` (the
block's by the same leaf rule).  Tolerances are the reference's own:
`moe_block` and the smoke models' logits 2e-4 (`tests/test_moe.py`),
prefill against decode rtol 2e-2, atol 5e-3 (`tests/test_decode_parity.py`,
drop-free as it is there); dropped pairs and served tokens exactly."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import layers as JL
from repro_torch import configs as tconfigs
from repro_torch.convert import decoder_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as TL

JRT = JL.Runtime(compute_dtype=jnp.float32, moe_group_size=64)
TRT = TL.Runtime(compute_dtype=torch.float32, moe_group_size=64)
TOL = dict(rtol=2e-4, atol=2e-4)
PARITY_TOL = dict(rtol=2e-2, atol=5e-3)
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")


def _block_params(d, e, f, shared, seed=3):
    jp = JL.init_params(JL.moe_specs(d, e, f, shared),
                        jax.random.PRNGKey(seed), jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(shape, seed=5, scale=0.5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32) * scale
    return jnp.asarray(x), torch.from_numpy(x)


def _both_blocks(jp, tp, jx, tx, **kw):
    want = JL.moe_block(jp, jx, rt=JRT, **kw)
    got = TL.moe_block(tp, tx, rt=TRT, **kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("normalize", [True, False])
def test_moe_block_matches_the_reference(normalize, shared):
    """Two groups of 64 tokens, drop-free and at the default capacity."""
    D, E, F, k = 16, 8, 24, 2
    jp, tp = _block_params(D, E, F, shared)
    jx, tx = _x((2, 64, D))
    for factor in (8.0, 1.25):
        want, got = _both_blocks(jp, tp, jx, tx, n_experts=E, top_k=k,
                                 capacity_factor=factor,
                                 normalize_gates=normalize)
        np.testing.assert_allclose(got, want, **TOL)


def _reference_dropped(jp, jx, *, n_experts, top_k, cap, group):
    """The (group, token, choice) pairs the reference's routing drops,
    with the reference's own steps (`repro.models.layers.moe_block`:
    fp32 logits, softmax, top-k, the cumsum of the one-hot over the
    token-major order): positions >= `cap`."""
    xg = jx.reshape(-1, group, jx.shape[-1])
    logits = jnp.einsum("gtd,de->gte", xg, jp["router"],
                        preferred_element_type=jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    e_flat = eidx.reshape(xg.shape[0], group * top_k)
    onehot = jax.nn.one_hot(e_flat, n_experts, dtype=jnp.int32)
    pos = (jnp.cumsum(onehot, axis=1) * onehot).sum(-1) - 1
    return set(zip(*np.nonzero(np.asarray(pos) >= cap)))


def test_tight_capacity_drops_the_references_pairs():
    """At capacity factor 0.25 the port drops exactly the reference's
    (token, choice) pairs, and the block's output is the reference's."""
    D, E, F, k, group = 8, 4, 8, 2, 64
    jp, tp = _block_params(D, E, F, 0)
    jx, tx = _x((1, 128, D), seed=9, scale=1.0)
    cap = TL.moe_capacity(group, k, E, 0.25)
    assert cap == JL_capacity(group, k, E, 0.25) == 8
    _, _, slot = TL.moe_route(tp, tx.reshape(-1, group, D), n_experts=E,
                              top_k=k, cap=cap, normalize_gates=True, rt=TRT)
    got = set(zip(*np.nonzero(slot.numpy() == E * cap)))
    want = _reference_dropped(jp, jx, n_experts=E, top_k=k, cap=cap,
                              group=group)
    assert got == want and len(want) > 64
    want_y, got_y = _both_blocks(jp, tp, jx, tx, n_experts=E, top_k=k,
                                 capacity_factor=0.25, normalize_gates=True)
    np.testing.assert_allclose(got_y, want_y, **TOL)


def JL_capacity(group, top_k, n_experts, factor):
    """The reference's capacity rule (`moe_block`'s `cap`)."""
    cap = int(math.ceil(group * top_k / n_experts * factor))
    return max(8, -(-cap // 8) * 8)


def test_in_range_slots_are_unique():
    """Every expert slot takes at most one pair, so the index scatter has
    no racing writes on the card; only the padding slot repeats."""
    D, E, k, group = 8, 4, 2, 64
    _, tp = _block_params(D, E, 8, 0)
    _, tx = _x((1, 128, D), seed=9, scale=1.0)
    _, _, slot = TL.moe_route(tp, tx.reshape(-1, group, D), n_experts=E,
                              top_k=k, cap=8, normalize_gates=True, rt=TRT)
    for row in slot.numpy():
        kept = row[row < E * 8]
        assert len(set(kept.tolist())) == len(kept)
        assert (row == E * 8).sum() == len(row) - len(kept) > 0


def test_the_unique_slot_check_the_card_runs():
    """`assert_unique_slots`, which `moe_block` runs on CUDA tensors: the
    routing's slots pass, a duplicated in-range slot raises."""
    D, E, k, group = 8, 4, 2, 64
    _, tp = _block_params(D, E, 8, 0)
    _, tx = _x((1, 128, D), seed=9, scale=1.0)
    _, _, slot = TL.moe_route(tp, tx.reshape(-1, group, D), n_experts=E,
                              top_k=k, cap=8, normalize_gates=True, rt=TRT)
    TL.assert_unique_slots(slot, E * 8)
    bad = slot.clone()
    kept = (bad[0] < E * 8).nonzero().flatten()
    bad[0, kept[1]] = bad[0, kept[0]]
    with pytest.raises(RuntimeError):
        TL.assert_unique_slots(bad, E * 8)


def test_group_size_must_divide_the_tokens():
    _, tp = _block_params(8, 4, 8, 0)
    with pytest.raises(AssertionError):
        TL.moe_block(tp, torch.zeros(1, 96, 8), n_experts=4, top_k=2,
                     capacity_factor=1.0, normalize_gates=True, rt=TRT)


# ------------------------------------------------------- the two models

def _pair(name, drop_free=False, seed=7):
    jcfg, tcfg = jconfigs.get_smoke(name), tconfigs.get_smoke(name)
    if drop_free:
        jcfg, tcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, capacity_factor=16.0))
            for c in (jcfg, tcfg))
    jm = jsteps.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed),
                 JL.Runtime(compute_dtype=jnp.float32))
    tp = decoder_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tcfg, tsteps.build_model(tcfg), tp


def _tokens(cfg, b, s, seed=11):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_converted_params_carry_the_moe_leaves(name):
    jcfg, _, jp, _, tm, tp = _pair(name)
    assert tm.kinds[:jcfg.moe.first_dense] == \
        ["attn_dense"] * jcfg.moe.first_dense
    for kind, layer in zip(tm.kinds, tp["layers"]):
        want = {"ln1", "attn", "ln2",
                "mlp" if kind == "attn_dense" else "moe"}
        assert set(layer) == want
    moe = tp["layers"][-1]["moe"]
    assert set(moe) == {"router", "we1", "we3", "we2"} | (
        {"shared"} if jcfg.moe.num_shared else set())
    last = jax.tree.map(lambda a: np.asarray(a)[-1], jp["groups"][-1][0])
    np.testing.assert_array_equal(moe["we2"].numpy(), last["moe"]["we2"])
    if jcfg.mla is not None:
        assert set(tp["layers"][0]["attn"]) == {"wq", "wdkv", "wukv", "wo",
                                                "kv_norm"}
        np.testing.assert_array_equal(tp["layers"][-1]["attn"]["wukv"],
                                      last["attn"]["wukv"])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_forward_logits_match_the_reference(name):
    jcfg, jm, jp, _, tm, tp = _pair(name)
    tok = _tokens(jcfg, 2, 9)
    jrt = JL.Runtime(compute_dtype=jnp.float32)
    trt = TL.Runtime(compute_dtype=torch.float32)
    want = jm.forward(jp, {"tokens": jnp.asarray(tok)}, jrt)
    got = tm.forward(tp, {"tokens": torch.from_numpy(tok)}, trt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_prefill_vs_decode_drop_free(name):
    """Teacher forcing, as `tests/test_decode_parity.py` holds the
    reference, on its inputs (its key 7 draws the weights and the
    tokens): drop-free, since the forward routes a group of B x S tokens
    and a decode step routes B.  The decode path keeps K and V in bf16,
    which can flip a near-tied top-k choice: with olmoe's smoke weights
    and tokens drawn by numpy's seed 7, the reference itself exceeds this
    tolerance on 155 of the 12,288 logits, and the port on the same 155
    (`test_decode_steps_match_the_reference` holds the two decode paths
    together)."""
    _, _, _, tcfg, tm, tp = _pair(name, drop_free=True)
    trt = TL.Runtime(compute_dtype=torch.float32)
    tok = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(7), (2, 12), 0, tcfg.vocab_size)).astype(
            np.int64))
    full = tm.forward(tp, {"tokens": tok}, trt)
    cache = tm.init_cache(2, 32, trt)
    rows = []
    for t in range(tok.shape[1]):
        lg, cache = tm.decode_step(tp, cache, tok[:, t:t + 1],
                                   torch.tensor(t), trt)
        rows.append(lg[:, 0])
    v = tcfg.vocab_size
    np.testing.assert_allclose(torch.stack(rows, 1)[..., :v].numpy(),
                               full[..., :v].numpy(), **PARITY_TOL)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_decode_steps_match_the_reference(name):
    jcfg, jm, jp, _, tm, tp = _pair(name)
    jrt = JL.Runtime(compute_dtype=jnp.float32)
    trt = TL.Runtime(compute_dtype=torch.float32)
    tok = _tokens(jcfg, 2, 6, seed=2)
    jc, tc = jm.init_cache(2, 16, jrt), tm.init_cache(2, 16, trt)
    step = tsteps.make_serve_step(tm, trt)
    for t in range(tok.shape[1]):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                  jnp.int32(t), jrt)
        got, tc = step(tp, tc, torch.from_numpy(tok[:, t:t + 1]),
                       torch.tensor(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_serve_requests_generate_the_references_tokens():
    """The reference's server draws its weights from key 0."""
    jcfg, _, _, tcfg, _, tp = _pair("olmoe-1b-7b", seed=0)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    want = jserve.serve_requests(jcfg, prompts, batch=2, max_new=5,
                                 max_len=32)
    got = tserve.serve_requests(tcfg, prompts, batch=2, max_new=5,
                                max_len=32, device="cpu", params=tp)
    assert [r.generated for r in got] == [r.generated for r in want]
    assert all(len(r.generated) == 5 for r in got)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_forward_reading_the_decodes_caches_holds_the_served_decode(name):
    """The check the card runs on the served decode, with its own hook
    (`chip_smoke.reads_the_cache`), at smoke size: the teacher-forced
    decode over 12 tokens with bf16 caches, as served, against the fp32
    forward through the kernels' wrappers (their plain versions here)
    whose every attention layer reads what the decode wrote into its
    caches (GQA: k and v; MLA: the latent and the RoPE key), taking the
    decode's expert choices (`chip_smoke.routes`), drop-free.  The logits
    within `chip_smoke.SERVE_RG_TOL`; each cache entry within one bf16
    rounding of the forward's own value (`CACHE_RTOL`, `CACHE_ATOL`), the
    unwritten slots zero; each attention layer read once, in order."""
    smoke = _chip_smoke()
    _, _, _, tcfg, tm, tp = _pair(name, drop_free=True)
    trt = TL.Runtime(compute_dtype=torch.float32)
    seq = [int(t) for t in _tokens(tcfg, 1, 12, seed=3)[0]]
    cache = tm.init_cache(1, 16, trt)
    rows, step_routes = [], []
    for pos, t in enumerate(seq):
        with smoke.routes() as rts:
            lg, cache = tm.decode_step(tp, cache, torch.tensor([[t]]),
                                       torch.tensor(pos), trt)
        rows.append(lg[0, 0, :tcfg.vocab_size])
        step_routes.append(rts)
    decoded = [{key: torch.cat([x[layer][key] for x in step_routes])
                for key in ("experts", "logits")}
               for layer in range(len(step_routes[0]))]
    assert all(c["k" if tcfg.mla is None else "ckv"].dtype == torch.bfloat16
               for c in cache)
    with smoke.routes(force=decoded), \
            smoke.reads_the_cache(tm, tp, cache) as rd:
        fwd = tm.forward(tp, {"tokens": torch.tensor([seq])},
                         dataclasses.replace(trt, use_kernels=True))
    layers = list(range(tcfg.num_layers))
    want = ({"attention": [], "latent": layers, "rope_key": layers}
            if tcfg.mla is not None
            else {"attention": layers, "latent": [], "rope_key": []})
    assert rd["hits"] == want
    atol, rtol = smoke.SERVE_RG_TOL
    np.testing.assert_allclose(torch.stack(rows).numpy(),
                               fwd[0, :, :tcfg.vocab_size].numpy(),
                               rtol=rtol, atol=atol)
    res = smoke.cache_against_forward(cache, rd, len(seq))
    assert res["worst_ratio"] <= 1.0 and res["unwritten_nonzero"] == 0
    per_layer = (2 * tcfg.num_kv_heads * tcfg.resolved_head_dim
                 if tcfg.mla is None else
                 tcfg.mla.kv_lora_rank + tcfg.mla.qk_rope_head_dim)
    assert res["entries"] == tcfg.num_layers * len(seq) * per_layer
