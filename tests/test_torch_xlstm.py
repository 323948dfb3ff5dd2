"""The port's xLSTM (mLSTM and sLSTM blocks, xlstm-1.3b) against the JAX
package on the CPU, with numpy-seeded inputs and the reference's own
weights (`decoder_params_from_numpy`), fp32 compute.

Tolerances: a function against the reference's function 2e-5 (`TOL` of
tests/test_torch_models.py: the same fp32 arithmetic, in another
summation order); a block's chunkwise or scan form against its step form
2e-4 (tests/test_recurrent_blocks.py); the smoke model's logits, prefill
and decode 2e-4 (tests/test_torch_recurrent.py: eight layers of it);
prefill against decode (2e-2, 5e-3) (tests/test_decode_parity.py); served
tokens exactly."""

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

NAME = "xlstm-1.3b"
JRT = JL.Runtime(compute_dtype=jnp.float32)
TRT = TL.Runtime(compute_dtype=torch.float32)
TOL = dict(rtol=2e-5, atol=2e-5)
FORM_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
PARITY_TOL = dict(rtol=2e-2, atol=5e-3)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
D, H = 32, 2


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _gates(B, S, seed):
    """log_i ~ N(0, 0.25) and log_f = log_sigmoid(N(2, 1)), as
    tests/test_recurrent_blocks.py draws them."""
    li = _rand(B, S, H, seed=seed, scale=0.5)
    lf = np.asarray(jax.nn.log_sigmoid(jnp.asarray(
        _rand(B, S, H, seed=seed + 1) + 2.0)))
    return li, lf


@pytest.mark.parametrize("S,chunk", [(33, 8), (128, 256)])
def test_mlstm_chunkwise_matches_the_reference(S, chunk):
    """S 33 in chunks of 8 (five chunks, the last padded) and S 128 in one
    chunk of 256 (the zoo's prefill and every serve forward under 256
    tokens run through this pad): y and the final (C, n, m)."""
    B, hd = 2, 16
    q, k, v = (_rand(B, S, H, hd, seed=i) for i in range(3))
    li, lf = _gates(B, S, 3)
    args = [_both(a) for a in (q, k, v, li, lf)]
    want_y, want_st = JL._mlstm_chunkwise(*(a[0] for a in args), chunk)
    got_y, got_st = TL._mlstm_chunkwise(*(a[1] for a in args), chunk)
    assert got_y.shape == (B, S, H, hd) and got_y.dtype == torch.float32
    _close(got_y, want_y, TOL)
    for g, w in zip(got_st, want_st):
        _close(g, w, TOL)


def test_mlstm_chunkwise_pads_the_input_gate_with_minus_1e9():
    """A padded step must add nothing to the state: with input gates far
    below 0 (the stabiliser m stays negative), the final (C, n, m) over S
    33 in chunks of 8 (padded to 40) equals the reference's and the one
    over the same 33 steps in chunks of 11 (no pad).  A pad of log_i with
    0 would lift the last chunk's m to 0."""
    B, hd, S = 1, 8, 33
    q, k, v = (_rand(B, S, H, hd, seed=i) for i in range(3))
    li, lf = _gates(B, S, 5)
    li = li - 6.0
    args = [_both(a) for a in (q, k, v, li, lf)]
    _, want = JL._mlstm_chunkwise(*(a[0] for a in args), 8)
    _, padded = TL._mlstm_chunkwise(*(a[1] for a in args), 8)
    _, whole = TL._mlstm_chunkwise(*(a[1] for a in args), 11)
    assert float(whole[2].max()) < -1.0
    for a, b, w in zip(padded, whole, want):
        _close(a, w, TOL)
        np.testing.assert_allclose(a.numpy(), b.numpy(), **FORM_TOL)


def _block_params(kind, seed=0):
    specs = JL.mlstm_specs(D, H) if kind == "mlstm" else JL.slstm_specs(D, H)
    jp = JL.init_params(specs, jax.random.PRNGKey(seed), jnp.float32)
    if kind == "slstm":     # a recurrence large enough to matter
        jp["r"] = jp["r"] * 30.0
    else:                   # q, k and v of unit size, as at full width
        for w in ("wq", "wk", "wv"):
            jp[w] = jp[w] * 30.0
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


_TRAIN = {"mlstm": (JL.mlstm_block_train, TL.mlstm_block_train),
          "slstm": (JL.slstm_block_train, TL.slstm_block_train)}
_DECODE = {"mlstm": (JL.mlstm_block_decode, TL.mlstm_block_decode),
           "slstm": (JL.slstm_block_decode, TL.slstm_block_decode)}


def _zero_state(kind, B, m=0.0):
    u = 2 * D
    shapes = ({"C": (B, H, u // H, u // H), "n": (B, H, u // H), "m": (B, H)}
              if kind == "mlstm"
              else {key: (B, D) for key in ("h", "c", "n", "m")})
    st = {key: np.zeros(s, np.float32) for key, s in shapes.items()}
    st["m"][:] = m
    return ({key: jnp.asarray(a) for key, a in st.items()},
            {key: torch.from_numpy(a) for key, a in st.items()})


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_train_form_matches_the_reference(kind):
    """S 21 through the whole block: the mLSTM's projections, gates,
    chunkwise form (one chunk of 256, padded), inner norm and SiLU gate;
    the sLSTM's input pre-activations and its scan over time."""
    jp, tp = _block_params(kind)
    jx, tx = _both(_rand(2, 21, D, seed=7))
    jf, tf = _TRAIN[kind]
    _close(tf(tp, tx, n_heads=H, eps=1e-6, rt=TRT),
           jf(jp, jx, n_heads=H, eps=1e-6, rt=JRT), TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_form_matches_the_reference(kind):
    """Nine steps from the decode cache's zero state (m = 0, not the
    chunkwise form's -1e30): each output and the state after it."""
    jp, tp = _block_params(kind, seed=1)
    jx, tx = _both(_rand(2, 9, D, seed=8))
    jst, tst = _zero_state(kind, 2)
    jf, tf = _DECODE[kind]
    for t in range(9):
        want, jst = jf(jp, jx[:, t:t + 1], jst, n_heads=H, eps=1e-6, rt=JRT)
        got, tst = tf(tp, tx[:, t:t + 1], tst, n_heads=H, eps=1e-6, rt=TRT)
        _close(got, want, TOL)
        assert set(tst) == set(jst)
        for key in jst:
            assert tst[key].dtype == torch.float32
            _close(tst[key], jst[key], TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_train_form_equals_its_step_form(kind):
    """The port's chunkwise (scan) form against its step form started at
    the chunkwise form's stabiliser, m = -1e30, as
    tests/test_recurrent_blocks.py holds the reference: S 300 crosses the
    chunk of 256 and pads the second."""
    jp, tp = _block_params(kind, seed=2)
    x = torch.from_numpy(_rand(1, 300, D, seed=9))
    y = _TRAIN[kind][1](tp, x, n_heads=H, eps=1e-6, rt=TRT)
    _, st = _zero_state(kind, 1, m=-1e30)
    rows = []
    for t in range(x.shape[1]):
        yt, st = _DECODE[kind][1](tp, x[:, t:t + 1], st, n_heads=H,
                                  eps=1e-6, rt=TRT)
        rows.append(yt[:, 0])
    np.testing.assert_allclose(y.numpy(), torch.stack(rows, 1).numpy(),
                               **FORM_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_the_stabiliser_start_is_the_only_difference(kind, monkeypatch):
    """The full-sequence form starts m at -1e30, the decode cache at 0, as
    the reference's do.  With the input gates below the forget gates
    (their biases set so) the sLSTM's two forms differ at the first
    positions: its h = o c / max(n, 1) clamps n at 1 whatever m is.  The
    mLSTM's do not: its num, |q n| and exp(-m) all scale with exp(-m).
    Started at 0 (`STABILISER_START`, as the card's serve check runs its
    forward), either full-sequence form is the decode's function."""
    _, tp = _block_params(kind, seed=4)
    if kind == "mlstm":
        tp["b_if"] = tp["b_if"] - torch.tensor([4.0] * H + [0.0] * H)
    else:                                       # the input gate's quarter
        tp["b_in"] = tp["b_in"] - torch.cat([torch.zeros(D),
                                             torch.full((D,), 4.0),
                                             torch.zeros(2 * D)])
    x = torch.from_numpy(_rand(1, 12, D, seed=11))
    _, st = _zero_state(kind, 1)
    rows = []
    for t in range(x.shape[1]):
        yt, st = _DECODE[kind][1](tp, x[:, t:t + 1], st, n_heads=H,
                                  eps=1e-6, rt=TRT)
        rows.append(yt[:, 0])
    dec = torch.stack(rows, 1).numpy()
    # the form tolerance relative to the block's output scale (the mLSTM
    # block's output is some 1e-3 here)
    scale = float(np.abs(dec).max())
    tol = dict(rtol=FORM_TOL["rtol"], atol=FORM_TOL["atol"] * scale)
    ref_start = _TRAIN[kind][1](tp, x, n_heads=H, eps=1e-6, rt=TRT).numpy()
    if kind == "slstm":
        assert np.abs(ref_start - dec)[:, 0].max() > 10 * tol["atol"]
    else:
        np.testing.assert_allclose(ref_start, dec, **tol)
    monkeypatch.setattr(TL, "STABILISER_START", 0.0)
    zero_start = _TRAIN[kind][1](tp, x, n_heads=H, eps=1e-6, rt=TRT).numpy()
    np.testing.assert_allclose(zero_start, dec, **tol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_step_form_runs_in_float64(kind):
    """At a float64 compute dtype the step form keeps float64 throughout
    (the card's block check evaluates its yardstick so); its output equals
    the fp32 step form's within the fp32 tolerance."""
    _, tp = _block_params(kind, seed=3)
    x = torch.from_numpy(_rand(1, 5, D, seed=10))
    p64 = {k: v.double() for k, v in tp.items()}
    rt64 = TL.Runtime(compute_dtype=torch.float64)
    _, s32 = _zero_state(kind, 1)
    s64 = {k: v.double() for k, v in s32.items()}
    for t in range(5):
        y32, s32 = _DECODE[kind][1](tp, x[:, t:t + 1], s32, n_heads=H,
                                    eps=1e-6, rt=TRT)
        y64, s64 = _DECODE[kind][1](p64, x[:, t:t + 1].double(), s64,
                                    n_heads=H, eps=1e-6, rt=rt64)
        assert y64.dtype == torch.float64
        assert all(v.dtype == torch.float64 for v in s64.values())
        np.testing.assert_allclose(y32.numpy(), y64.numpy(), **TOL)


def test_slstm_cell_matches_the_reference_gate_major():
    """`_slstm_cell` on random pre-activations, state and recurrence; and
    its layout: a recurrence nonzero only in gate g's block of head 1
    moves only that gate's quarter of the pre-activations, at head 1's
    columns (`rec` is [B, 4, H, hd] reshaped to [B, 4D])."""
    B, hd = 3, D // H
    wx, hp, c, n = (_rand(B, 4 * D if i == 0 else D, seed=i)
                    for i in range(4))
    m = _rand(B, D, seed=4)
    r = _rand(4, H, hd, hd, seed=5, scale=0.3)
    want = JL._slstm_cell(jnp.asarray(wx), jnp.asarray(hp),
                          tuple(map(jnp.asarray, (c, n, m))),
                          jnp.asarray(r), H)
    got = TL._slstm_cell(torch.from_numpy(wx), torch.from_numpy(hp),
                         tuple(map(torch.from_numpy, (c, n, m))),
                         torch.from_numpy(r), H)
    _close(got[0], want[0], TOL)
    for g, w in zip(got[1], want[1]):
        _close(g, w, TOL)

    seen = []

    def spy(eq, *ops):
        out = torch_einsum(eq, *ops)
        seen.append(out.reshape(B, 4 * D))
        return out
    torch_einsum = torch.einsum
    for gate in range(4):
        rg = np.zeros_like(r)
        rg[gate, 1] = r[gate, 1]
        seen.clear()
        torch.einsum = spy
        try:
            TL._slstm_cell(torch.from_numpy(wx), torch.from_numpy(hp),
                           tuple(map(torch.from_numpy, (c, n, m))),
                           torch.from_numpy(rg), H)
        finally:
            torch.einsum = torch_einsum
        nz = seen[0].abs().sum(0).nonzero()[:, 0]
        lo = gate * D + hd
        assert nz.min() >= lo and nz.max() < lo + hd


def test_log_sigmoid_is_the_references():
    """-logaddexp(-x, 0), the reference's, at ordinary and extreme x."""
    x = np.array([-200.0, -30.0, -1.0, 0.0, 1e-4, 3.0, 40.0, 300.0],
                 np.float32)
    _close(TL._log_sigmoid(torch.from_numpy(x)),
           jax.nn.log_sigmoid(jnp.asarray(x)), dict(rtol=1e-6, atol=0))


def test_specs_and_runtime_equal_the_references():
    for kind, jfn, tfn in (("mlstm", JL.mlstm_specs, TL.mlstm_specs),
                           ("slstm", JL.slstm_specs, TL.slstm_specs)):
        want, got = jfn(2048, 4), tfn(2048, 4)
        assert {k: (v.shape, v.axes, v.init) for k, v in got.items()} == \
            {k: (v.shape, v.axes, v.init) for k, v in want.items()}, kind
    assert TL.mlstm_specs(2048, 4)["wq"].shape == (4, 1024, 1024)
    assert TL.Runtime().mlstm_chunk == JL.Runtime().mlstm_chunk == 256


# ------------------------------------------------------------ the model

def _pair(seed=0):
    jcfg, tcfg = jconfigs.get_smoke(NAME), tconfigs.get_smoke(NAME)
    jm = jsteps.build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed), JRT)
    tp = decoder_params_from_numpy(tcfg, jax.tree.map(np.asarray, jp))
    return jcfg, jm, jp, tcfg, tsteps.build_model(tcfg), tp


@pytest.fixture(scope="module")
def models():
    return _pair()


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


def test_converted_params_have_the_ports_layout(models):
    """The smoke model's unit (three mLSTM, one sLSTM) repeats twice, so
    the reference stacks its leaves and the converter slices them; an
    mLSTM layer has no ln2 or MLP, an sLSTM layer a SwiGLU of
    `_slstm_ff_dim(d)`."""
    from repro.models.lm import _slstm_ff_dim as ref_ff
    from repro_torch.models.lm import _slstm_ff_dim
    _, jm, jp, tcfg, tm, tp = models
    assert tm.kinds == ["mlstm"] * 3 + ["slstm"] + ["mlstm"] * 3 + ["slstm"]
    assert [g.repeats for g in jm.groups] == [2]
    assert set(tp["layers"][0]) == {"ln1", "mlstm"}
    assert set(tp["layers"][3]) == {"ln1", "slstm", "ln2", "mlp"}
    assert tp["layers"][3]["mlp"]["w1"].shape == (64, _slstm_ff_dim(64))
    assert _slstm_ff_dim(2048) == ref_ff(2048) == 2816
    fresh = tm.init(torch.Generator().manual_seed(0), TRT)
    layout = lambda tree: [(k, v.shape, v.dtype) for k, v in  # noqa: E731
                           jax.tree_util.tree_leaves_with_path(tree)]
    assert layout(tp) == layout(fresh)
    np.testing.assert_array_equal(   # layer 7 is repeat 1 of unit slot 3
        tp["layers"][7]["slstm"]["r"].numpy(),
        np.asarray(jp["groups"][0][3]["slstm"]["r"][1]))


@pytest.mark.parametrize("seq", [37, 300])
def test_forward_logits_match_the_reference(models, seq):
    """S 37 (one padded chunk) and S 300 (two chunks, the second padded)."""
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 2, seq)
    want = jm.forward(jp, {"tokens": jnp.asarray(tok)}, JRT)
    got = tm.forward(tp, {"tokens": torch.from_numpy(tok)}, TRT)
    assert got.shape == want.shape == (2, seq, tm.v_pad)
    _close(got, want, MODEL_TOL)


def test_prefill_step_last_logits_match_the_reference(models):
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 3, 20, seed=1)
    want = jsteps.make_prefill_step(jm, JRT)(jp, {"tokens": jnp.asarray(tok)})
    got = tsteps.make_prefill_step(tm, TRT)(tp,
                                           {"tokens": torch.from_numpy(tok)})
    assert got.shape == (3, tm.v_pad)
    _close(got, want, MODEL_TOL)


def test_cache_is_all_fp32_state(models):
    """No bf16 leaf: the mLSTM's C [B, H, u/H, u/H], n, m and the sLSTM's
    h, c, n, m, all fp32 and zero (m too) — at full width C is
    4 x 1024 x 1024 a layer, 0.70 GB of state a sequence."""
    _, _, _, tcfg, tm, _ = models
    cache = tm.init_cache(2, 40, TRT)
    assert [sorted(c) for c in cache[:4]] == [["C", "m", "n"]] * 3 + \
        [["c", "h", "m", "n"]]
    assert cache[0]["C"].shape == (2, 2, 64, 64)
    assert all(t.dtype == torch.float32 and not t.any()
               for c in cache for t in c.values())
    full = tsteps.build_model(tconfigs.get_arch(NAME))
    specs = full.cache_specs(1, 1)
    assert specs[0]["C"].shape == (1, 4, 1024, 1024)
    state = sum(math.prod(s.shape) * 4 for c in specs for s in c.values())
    assert 0.70e9 < state < 0.71e9
    assert not any(s.dtype == "bf16" for c in specs for s in c.values())


def test_decode_steps_match_the_reference(models):
    jcfg, jm, jp, _, tm, tp = models
    tok = _tokens(jcfg, 2, 12, seed=2)
    jc = jm.init_cache(2, 32, JRT)
    tc = tm.init_cache(2, 32, TRT)
    step = tsteps.make_serve_step(tm, TRT)
    for t in range(tok.shape[1]):
        want, jc = jm.decode_step(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                                  jnp.int32(t), JRT)
        got, tc = step(tp, tc, torch.from_numpy(tok[:, t:t + 1]),
                       torch.tensor(t))
        _close(got, want, MODEL_TOL)


def test_forward_vs_decode_parity(models):
    """The chunkwise forward (m from -1e30) against the decode steps (m
    from 0), as tests/test_decode_parity.py holds the reference."""
    _, _, _, tcfg, tm, tp = models
    tok = torch.from_numpy(_tokens(tcfg, 1, 24, seed=7))
    full = tm.forward(tp, {"tokens": tok}, TRT)
    cache = tm.init_cache(1, 24, TRT)
    steps = []
    for t in range(tok.shape[1]):
        lg, cache = tm.decode_step(tp, cache, tok[:, t:t + 1],
                                   torch.tensor(t), TRT)
        steps.append(lg[:, 0])
    v = tcfg.vocab_size
    np.testing.assert_allclose(torch.stack(steps, 1)[..., :v].numpy(),
                               full[..., :v].numpy(), **PARITY_TOL)


def test_serve_requests_generate_the_references_tokens(models):
    jcfg, _, _, tcfg, _, tp = models
    want = jserve.serve_requests(jcfg, PROMPTS, batch=2, max_new=5,
                                 max_len=64)
    got = tserve.serve_requests(tcfg, PROMPTS, batch=2, max_new=5,
                                max_len=64, device="cpu", params=tp)
    assert [r.prompt for r in got] == PROMPTS
    assert [r.generated for r in got] == [r.generated for r in want]


def test_serve_cli_on_the_cpu(capsys):
    tserve.main(["--arch", NAME, "--smoke", "--device", "cpu",
                 "--requests", "3", "--batch", "2", "--max-new", "4"])
    assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out


def test_input_specs_and_runtime_of_the_serving_cells():
    cfg = tconfigs.get_arch(NAME)
    pre = tconfigs.shape_by_name("prefill_32k")
    assert tsteps.input_specs(cfg, pre) == {
        "tokens": ((32, 32768), torch.int64)}
    long = tconfigs.shape_by_name("long_500k")
    assert tconfigs.cell_applicable(NAME, long)[0]
    assert tsteps.input_specs(cfg, long) == {
        "token": ((1, 1), torch.int64), "pos": ((), torch.int64)}
    model = tsteps.build_model(cfg)
    assert model.kinds.count("mlstm") == 42
    assert model.kinds.count("slstm") == 6
    assert tsteps.make_runtime(cfg, pre).mlstm_chunk == 256
