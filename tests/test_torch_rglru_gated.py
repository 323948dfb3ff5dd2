"""`repro_torch.kernels.rg_lru.rglru_gated_scan` (the RG-LRU block from its
gate logits to its gated output, the scan inside) on the CPU, and the
layouts the slab kernels read in place.

On the CPU the wrapper runs `rglru_gated_scan_plain`, which must be the
port's own block arithmetic (`models.layers`) bit for bit, and the JAX
package's block (`rglru_block_train`) within a stated tolerance.  The
kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`).  Inputs come from numpy with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import layers as JL
from repro_torch.kernels import rg_lru as R
from repro_torch.models import layers as TL

D, W, H = 16, 64, 2            # smoke width: two gate heads of 32
# the JAX block against the port's, both fp32, at the reference's init:
# the scans compose the recurrence in different orders (associative_scan
# against doubling), as tests/test_torch_rglru.py's BLOCK_TOL
BLOCK_TOL = dict(rtol=1e-4, atol=1e-4)
# long memory (a up to about 0.9987): a composed scan's rounding gap
# relative to |h| grows as a few fp32 ulps times 1 / (1 - a), about
# 770 x 4 x 6e-8 = 2e-4
LONG_TOL = dict(rtol=5e-4, atol=5e-4)


def _params(seed=0, long_memory=False):
    """The JAX package's RG-LRU parameters with non-zero biases (so the
    bias paths are checked), as numpy, and their torch twins."""
    specs = JL.rglru_specs(D, W, H, 4)
    p = JL.init_params(specs, jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    p = {k: (jnp.asarray(r.standard_normal(v.shape).astype(np.float32))
             * 0.1 if k in ("conv_b", "ba", "bi") else v)
         for k, v in p.items()}
    if long_memory:       # softplus(-8) = 3.4e-4: a = exp(-2.7e-3 r)
        p["a_param"] = jnp.asarray(
            -8.0 + 0.5 * r.standard_normal(W).astype(np.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(b=2, s=37, seed=1):
    return (np.random.default_rng(seed).standard_normal((b, s, D))
            .astype(np.float32) * 0.5)


def _rt(cd):
    return TL.Runtime(compute_dtype=cd, use_kernels=False)


def _gated(tp, x, rt, out_dtype):
    xc, ra, ri, gate = TL.rglru_gated_inputs(tp, x, n_heads=H, rt=rt)
    return R.rglru_gated_scan(xc, ra, ri, gate, tp["ba"], tp["bi"],
                              tp["a_param"], out_dtype)


@pytest.mark.parametrize("cd,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_plain_equals_the_layers_composition(cd, out_dtype):
    """`rglru_scan_inputs` -> `rglru_scan_plain` -> h * gelu(gate) rounded
    into the output dtype (what `rglru_output` hands `wout`), bit for
    bit, from `rglru_gated_inputs`' operands (the gate as the bf16 product
    where the compute dtype is bf16)."""
    _, tp = _params()
    x = torch.from_numpy(_x())
    rt = _rt(cd)
    a, b, gate = TL.rglru_scan_inputs(tp, x, n_heads=H, rt=rt)
    want = (R.rglru_scan_plain(a, b)
            * F.gelu(gate, approximate="tanh")).to(out_dtype)
    got = _gated(tp, x, rt, out_dtype)
    assert got.dtype == out_dtype and got.shape == (2, 37, W)
    assert torch.equal(got, want)
    if cd == torch.bfloat16:
        assert TL.rglru_gated_inputs(tp, x, n_heads=H, rt=rt)[3].dtype == cd


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_scan_inputs_are_the_block_spelled_out(cd):
    """`rglru_scan_inputs`, built on `rglru_gated_inputs`, equals bit for
    bit the block spelled out op by op: both products widened to fp32,
    the conv, the gates, the decay and b = beta (i xc)."""
    _, tp = _params(seed=9)
    x = torch.from_numpy(_x(seed=9))
    a, b, gate = TL.rglru_scan_inputs(tp, x, n_heads=H, rt=_rt(cd))
    xb = TL._causal_conv1d(TL.cd_matmul(x, tp["wx"], cd), tp["conv_w"],
                           tp["conv_b"])
    r, i = TL._rglru_gates(tp, xb, H)
    a0, beta = TL._rglru_decay(tp, r)
    assert torch.equal(a, a0) and torch.equal(b, beta * (i * xb))
    assert torch.equal(gate, TL.cd_matmul(x, tp["wy"], cd))
    assert gate.dtype == a.dtype == b.dtype == torch.float32


@pytest.mark.parametrize("use_kernels", [False, True])
def test_block_train_is_the_same_function_on_both_branches(use_kernels):
    """On the CPU the kernel branch of `rglru_block_train` (the gated
    wrapper, then `wout`) is the plain branch bit for bit."""
    _, tp = _params(seed=2)
    x = torch.from_numpy(_x(seed=2))
    rt = TL.Runtime(compute_dtype=torch.float32, use_kernels=use_kernels)
    got = TL.rglru_block_train(tp, x, n_heads=H, rt=rt)
    a, b, gate = TL.rglru_scan_inputs(tp, x, n_heads=H, rt=rt)
    want = TL.rglru_output(tp, R.rglru_scan_plain(a, b), gate, rt)
    assert torch.equal(got, want)


def _jax_gated_y(jp, x):
    """The JAX package's `rglru_block_train` up to its output projection
    (src/repro/models/layers.py), fp32, from its own functions."""
    xb = jnp.einsum("bsd,dw->bsw", x, jp["wx"],
                    preferred_element_type=jnp.float32)
    gate = jnp.einsum("bsd,dw->bsw", x, jp["wy"],
                      preferred_element_type=jnp.float32)
    xb = JL._causal_conv1d(xb, jp["conv_w"], jp["conv_b"])
    r, i = JL._rglru_gates(jp, xb, H)
    log_a = -JL._RGLRU_C * jax.nn.softplus(jp["a_param"])[None, None] * r
    a = jnp.exp(log_a)
    beta = jnp.sqrt(jnp.maximum(1.0 - jnp.exp(2.0 * log_a), 1e-6))

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    _, h = jax.lax.associative_scan(combine, (a, beta * (i * xb)), axis=1)
    return h * jax.nn.gelu(gate)


@pytest.mark.parametrize("long_memory,tol", [(False, BLOCK_TOL),
                                             (True, LONG_TOL)])
def test_plain_matches_the_jax_block(long_memory, tol):
    """Against the reference's block arithmetic, at its init and at the
    long-memory end of the decay (ROADMAP.md C: the init is nearly
    memoryless), every position of a 200-step sequence."""
    jp, tp = _params(seed=3, long_memory=long_memory)
    x = _x(b=2, s=200, seed=3)
    want = np.asarray(_jax_gated_y(jp, jnp.asarray(x)))
    got = _gated(tp, torch.from_numpy(x), _rt(torch.float32), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    jy = JL.rglru_block_train(jp, jnp.asarray(x), n_heads=H,
                              rt=JL.Runtime(compute_dtype=jnp.float32))
    ty = TL.rglru_block_train(tp, torch.from_numpy(x), n_heads=H,
                              rt=TL.Runtime(compute_dtype=torch.float32,
                                            use_kernels=True))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)


def test_takes_head_major_views_and_a_bf16_gate():
    """ra and ri as the einsum leaves them (head-major views), as
    contiguous copies and as [B, S, W]; the gate in bf16 or widened: the
    same output, bit for bit."""
    _, tp = _params(seed=4)
    x = torch.from_numpy(_x(seed=4))
    xc, ra, ri, gate = TL.rglru_gated_inputs(tp, x, n_heads=H,
                                             rt=_rt(torch.bfloat16))
    assert ra.dim() == 4 and not ra.is_contiguous()
    vecs = (tp["ba"], tp["bi"], tp["a_param"])
    want = R.rglru_gated_scan(xc, ra, ri, gate, *vecs, torch.bfloat16)
    for ra2, ri2, gate2 in ((ra.contiguous(), ri.contiguous(), gate),
                            (ra.reshape(2, 37, W), ri.reshape(2, 37, W),
                             gate.float())):
        got = R.rglru_gated_scan(xc, ra2, ri2, gate2, *vecs, torch.bfloat16)
        assert torch.equal(got, want)


def test_gate_logits_are_read_in_place_where_tma_can():
    """The einsum's head-major [B, S, heads, 32] view is handed to the
    kernel as it lies (no copy: its head and batch strides are whole
    16-byte rows); a [B, S, W] with W * 4 bytes off 16 and heads narrower
    than a slab are copied, zero-padded, into [B, S, 1, Wp]."""
    _, tp = _params(seed=5)
    xc = torch.randn(2, 37, W)
    ra, _ = TL._rglru_gate_logits(tp, xc, H)
    assert ra.stride() == (37 * 32, 32, 2 * 37 * 32, 1)   # head-major
    t, g = R._tma_geometry(ra)
    assert t is ra and g == (32, 2, 32, 2 * 37 * 32, 37 * 32, 0)
    odd = torch.randn(3, 5, 130)
    t, g = R._tma_geometry(odd.unsqueeze(2))
    assert t.shape == (3, 5, 1, 132) and g == (130, 1, 132, 132, 5 * 132, 0)
    assert torch.equal(t[..., :130, ], odd.unsqueeze(2))
    assert not t[..., 130:].any()
    narrow = torch.randn(2, 5, 4, 16)
    t, g = R._tma_geometry(narrow)
    assert t.shape == (2, 5, 1, 64) and g[:2] == (64, 1)
    assert torch.equal(t.reshape(2, 5, 4, 16), narrow)


def test_cpu_path_launches_nothing():
    _, tp = _params(seed=6)
    x = torch.from_numpy(_x(seed=6))
    counters = (R.rglru_gated_scan, R.rglru_scan)
    before = [c.launches for c in counters]
    got = _gated(tp, x, _rt(torch.float32), torch.float32)
    assert [c.launches for c in counters] == before
    xc, ra, ri, gate = TL.rglru_gated_inputs(tp, x, n_heads=H,
                                             rt=_rt(torch.float32))
    assert torch.equal(got, R.rglru_gated_scan_plain(
        xc, ra, ri, gate, tp["ba"], tp["bi"], tp["a_param"], torch.float32))


def _inputs(b=1, s=8, w=64, heads=2):
    r = np.random.default_rng(7)
    t = lambda *shape: torch.from_numpy(
        r.standard_normal(shape).astype(np.float32))
    return (t(b, s, w), t(b, s, heads, w // heads), t(b, s, heads,
            w // heads), t(b, s, w), t(w), t(w), t(w))


@pytest.mark.parametrize("case,error", [
    ("ra on meta", ValueError), ("all on meta", ValueError),
    ("ra float16", TypeError), ("xc float16", TypeError),
    ("gate float64", TypeError), ("out float16", TypeError),
    ("ba of W + 1", ValueError), ("ri of 3 heads", ValueError),
    ("gate of S + 1", ValueError)])
def test_refuses_mixed_devices_and_what_it_does_not_take(case, error):
    xc, ra, ri, gate, ba, bi, ap = _inputs()
    out = torch.float32
    if case == "ra on meta":
        ra = ra.to("meta")
    elif case == "all on meta":
        xc, ra, ri, gate, ba, bi, ap = (t.to("meta") for t in
                                        (xc, ra, ri, gate, ba, bi, ap))
    elif case == "ra float16":
        ra = ra.half()
    elif case == "xc float16":
        xc = xc.half()
    elif case == "gate float64":
        gate = gate.double()
    elif case == "out float16":
        out = torch.float16
    elif case == "ba of W + 1":
        ba = torch.zeros(65)
    elif case == "ri of 3 heads":
        ri = torch.zeros(1, 8, 3, 21)
    else:
        gate = torch.zeros(1, 9, 64)
    with pytest.raises(error):
        R.rglru_gated_scan(xc, ra, ri, gate, ba, bi, ap, out)


# (shape, how the tensor is made from a contiguous one, read in place?)
@pytest.mark.parametrize("case,read", [
    ("head-major [2, 37, 16, 256] fp32", True),     # the gate einsum's view
    ("[2, 37, 4096] fp32", True),                   # xc at full width
    ("[2, 37, 4096] bf16", True),                   # the gate product
    ("a [2, 37, 512] slice of [2, 37, 1024]", True),  # by its strides
    ("[2, 37, 130] fp32", False),                   # rows off 16 bytes
    ("head-major [2, 37, 8, 16] fp32", False),      # heads under a slab
    ("a [2, 37, 128] slice from channel 1", False)])  # start off 16 bytes
def test_what_the_slab_kernels_read_in_place(case, read):
    """`read_in_place` on each layout: the kernels' operands lie where TMA
    reads them (16-byte start and strides, a 32-channel slab inside one
    group) or are copied first."""
    if case.startswith("head-major"):
        heads, hd = (16, 256) if "16, 256" in case else (8, 16)
        t = torch.zeros(heads, 2, 37, hd).permute(1, 2, 0, 3)
    elif "slice of" in case:
        t = torch.zeros(2, 37, 1024)[..., 512:]
    elif "from channel 1" in case:
        t = torch.zeros(2, 37, 129)[..., 1:]
    else:
        dtype = torch.bfloat16 if "bf16" in case else torch.float32
        t = torch.zeros(2, 37, 130 if "130" in case else 4096, dtype=dtype)
    assert R.read_in_place(t) is read
    t4, g = R._tma_geometry(t)
    assert t4.shape[:2] == (2, 37) and g[0] * g[1] >= t.shape[-1] * (
        t.shape[-2] if t.dim() == 4 else 1)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_the_block_hands_the_kernel_operands_it_reads_in_place(cd):
    """`rglru_gated_inputs` at gate heads of 32 channels: xc, ra, ri and
    the gate all go to the kernel uncopied (what `chip_smoke.py` checks on
    the model's own layers)."""
    _, tp = _params(seed=8)
    x = torch.from_numpy(_x(seed=8))
    ops = TL.rglru_gated_inputs(tp, x, n_heads=H, rt=_rt(cd))
    assert [R.read_in_place(t) for t in ops] == [True] * 4
    assert ops[3].dtype == cd and ops[0].dtype == torch.float32


@pytest.mark.parametrize("w,dtype,stride", [
    (4096, torch.float32, 4096), (130, torch.float32, 132),
    (130, torch.bfloat16, 136)])
def test_slab_output_rows_are_whole_16_byte_rows(w, dtype, stride):
    """The slab kernels' output [B, S, W]: TMA stores whole 16-byte rows,
    so a width off them is a view of a padded buffer."""
    out = R._slab_out(2, 5, w, dtype, torch.device("cpu"))
    assert out.shape == (2, 5, w) and out.dtype == dtype
    assert out.stride() == (5 * stride, stride, 1)
    assert out.is_contiguous() is (stride == w)
