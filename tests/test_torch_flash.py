"""`repro_torch.kernels.flash_attention` on the CPU: its plain version
against the JAX package's Pallas kernel (interpret mode) and dense oracle,
the arithmetic of the tensor-core kernel (emulated) against the plain
version, the wrapper's contract (dispatch table, TMA check), and the
CUDA-core kernel's shared memory at each head dim.

Inputs come from numpy with a seed.  Tolerances are those of
`tests/test_kernels.py`: fp32 3e-4 (two fp32 summation orders over at
most 128 keys), bf16 2e-2 (both sides round the output to bf16, so one
bf16 ulp of an O(1) value); the emulated kernel is held to
`chip_smoke.FLASH_TOL`, the card's element-by-element bound."""

import importlib.util
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels.flash_attention import (CUDA_CORE, DISPATCH,
                                                 HEAD_DIMS, TENSOR_CORE,
                                                 flash_attention,
                                                 flash_attention_plain,
                                                 kernel_for, tma_readable)

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)

TOL = {"float32": dict(rtol=3e-4, atol=3e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# each shape of the sweep of tests/test_kernels.py, both masks and both
# dtypes, plus causal shapes with Sq != Skv in each dtype (both kernels
# mask top-left, so they need not be skipped here).  Each case compiles
# the Pallas kernel anew, so the grid is not a full product.
CASES = [
    (64, 64, 4, 4, 32, True, "float32"),        # MHA
    (96, 96, 4, 2, 32, False, "bfloat16"),      # GQA 2:1
    (128, 128, 8, 1, 16, True, "bfloat16"),     # MQA
    (80, 48, 4, 4, 32, False, "float32"),       # uneven, padded
    (80, 48, 4, 4, 32, True, "float32"),        # causal, Sq > Skv
    (80, 48, 4, 4, 32, True, "bfloat16"),
    (48, 80, 4, 2, 16, True, "bfloat16"),       # causal, Sq < Skv
    (100, 36, 7, 1, 64, True, "float32"),       # qwen2's 7:1 grouping, hd 64
]


def _inputs(b, sq, skv, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kv, hd)).astype(np.float32))


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TORCH[dtype]) for a in arrs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("sq,skv,h,kv,hd,causal,dtype", CASES)
def test_plain_matches_the_pallas_kernel(sq, skv, h, kv, hd, causal, dtype):
    arrs = _inputs(2, sq, skv, h, kv, hd)
    want = ops.flash_attention(*[jnp.asarray(a, JNP[dtype]) for a in arrs],
                               causal=causal, bq=32, bkv=32, interpret=True)
    got = flash_attention_plain(*_torch(arrs, dtype), causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == (2, sq, h, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("sq,h,kv,hd", [(64, 4, 4, 32), (96, 4, 2, 32),
                                        (128, 8, 1, 16)])
def test_plain_matches_the_dense_oracle_where_sq_equals_skv(sq, h, kv, hd):
    """Causal: where Sq == Skv the oracle's bottom-right mask is the
    kernel's top-left one."""
    arrs = _inputs(2, sq, sq, h, kv, hd, seed=1)
    want = ref.flash_attention_ref(*map(jnp.asarray, arrs), causal=True)
    got = flash_attention_plain(*_torch(arrs, "float32"), causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("sq,skv", [(96, 96), (96, 40)])
def test_plain_in_query_chunks_equals_the_whole(sq, skv):
    """`q_offset` places a chunk of query rows where it sits in the whole,
    so a long sequence can be checked chunk by chunk."""
    q, k, v = _torch(_inputs(2, sq, skv, 4, 2, 16, seed=2), "float32")
    whole = flash_attention_plain(q, k, v, causal=True)
    chunks = torch.cat([flash_attention_plain(q[:, i:i + 32], k, v,
                                              causal=True, q_offset=i)
                        for i in range(0, sq, 32)], dim=1)
    torch.testing.assert_close(chunks, whole, rtol=1e-6, atol=1e-6)


def test_causal_mask_is_top_left():
    """Row i sees keys 0..i, whatever Skv is: with v = key index, the
    first row attends to key 0 alone."""
    q = torch.zeros(1, 3, 1, 16)
    k = torch.zeros(1, 5, 1, 16)
    v = torch.arange(5.0)[None, :, None, None].expand(1, 5, 1, 16)
    out = flash_attention_plain(q, k, v, causal=True)[0, :, 0, 0]
    torch.testing.assert_close(out, torch.tensor([0.0, 0.5, 1.0]))


def test_cpu_tensors_take_the_plain_path_without_a_launch():
    q, k, v = _torch(_inputs(1, 20, 20, 4, 2, 16), "float32")
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_plain(q, k, v, causal=True))


def test_mixed_devices_raise():
    q, k, v = _torch(_inputs(1, 8, 8, 2, 2, 16), "float32")
    with pytest.raises(ValueError):
        flash_attention(q, k.to("meta"), v, causal=True)
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_plain_with_no_keys_gives_zeros():
    q = torch.ones(1, 5, 4, 16)
    k = torch.zeros(1, 0, 2, 16)
    for causal in (True, False):
        assert torch.equal(flash_attention_plain(q, k, k, causal=causal),
                           torch.zeros(1, 5, 4, 16))


# --- the tensor-core kernel's arithmetic, emulated on the CPU -------------

_HI = -65536                    # 0xFFFF0000: an fp32 word's high half


def _split3(p: torch.Tensor):
    """`split3` of csrc/flash_attention.cu: p = hi + mid + lo, each term a
    bf16 value held as an fp32, by truncating to the word's high half."""
    hi = (p.view(torch.int32) & _HI).view(torch.float32)
    r = p - hi
    mid = (r.view(torch.int32) & _HI).view(torch.float32)
    lo = ((r - mid).view(torch.int32) & _HI).view(torch.float32)
    return hi, mid, lo


def test_three_bf16_terms_carry_every_fp32_p_in_0_1():
    """Every fp32 p in [0, 1], subnormals included: hi + mid + lo is p
    exactly wherever p is a multiple of
    2^-133 (bf16's finest step; every p >= 2^-110, every bf16 subnormal).
    Below that no sum of bf16 values can be p; the split drops less than
    2^-133, which no output can show (its atol is 2e-6)."""
    top = int(torch.tensor(1.0).view(torch.int32))
    tiny_end = int(torch.tensor(2.0 ** -110).view(torch.int32))
    for start in range(0, top + 1, 1 << 24):
        p = torch.arange(start, min(start + (1 << 24), top + 1),
                         dtype=torch.int32).view(torch.float32)
        hi, mid, lo = _split3(p)         # bf16 values: low halves zero
        total = (hi + mid) + lo
        if start >= tiny_end:
            assert torch.equal(total, p)
            continue
        tiny = p < 2.0 ** -110
        assert torch.equal(total[~tiny], p[~tiny])
        steps = p[tiny].double() * 2.0 ** 133           # exact scaling
        drop = (p[tiny] - total[tiny]).double() * 2.0 ** 133
        assert bool(((drop >= 0) & (drop < 1)).all())
        assert bool((drop[steps == steps.floor()] == 0).all())


def test_plain_version_keeps_float64():
    """Float64 inputs are computed in float64 (the card's checks hold the
    kernel against that evaluation); other dtypes in fp32, as before."""
    q, k, v = _torch(_inputs(1, 40, 40, 4, 2, 16, seed=5), "float32")
    got = flash_attention_plain(q.double(), k.double(), v.double())
    assert got.dtype == torch.float64
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v),
                               rtol=1e-6, atol=1e-6)
    assert not torch.equal(got, flash_attention_plain(q, k, v).double())


# keys per KV tile of `flash_attention_kernel_wgmma` (`Tile<HD>::kBKV`)
_KV_TILE = {64: 128, 128: 64, 256: 64}


def _tensor_core_model(q, k, v, causal, terms=3):
    """The tensor-core kernel's arithmetic on bf16 q, k, v: raw scores
    from exact bf16 products summed in fp32, the Pallas kernel's online
    softmax over KV tiles of the kernel's size (-1e30 masks, the alive
    rule, fp32 m, l and accumulator) with exp(scale (s - m)) taken as
    2^(s c - mc), c = scale log2(e) in fp32, mc = m c rounded, and the
    correction 2^(mc_old - mc), each tile's p @ v as the first `terms` of
    p's bf16 split (summed smallest first, each product exact, the sums
    fp32) added to acc * corr, the output rounded to bf16 once.

    The model is exact where the card is not: it takes `torch.exp2` where
    the kernel takes `ex2.approx`, and it sums in fp32 where the tensor
    cores align each product to the running sum and truncate.  So it
    cannot show the card's failure modes (accumulating every tile in the
    tensor cores passes here and failed `FLASH_TOL` on the card at S
    32768); `chip_smoke.py`'s checks on the card hold the kernel
    itself."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G, bkv, neg = H // KV, _KV_TILE[hd], -1e30
    c = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
         * torch.tensor(math.log2(math.e), dtype=torch.float32))
    qf = q.float().transpose(1, 2)                           # [B, H, Sq, hd]
    kf = k.float().transpose(1, 2).repeat_interleave(G, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(G, dim=1)
    m = mc = torch.full((B, H, Sq, 1), neg)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, hd))
    q_pos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, bkv):
        s = qf @ kf[:, :, k0:k0 + bkv].transpose(-1, -2)
        k_pos = k0 + torch.arange(s.shape[-1])[None, :]
        if causal:
            s = s.masked_fill(q_pos < k_pos, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alive = m_new > 0.5 * neg
        mc_new = m_new * c
        p = torch.where(alive, torch.exp2(s * c - mc_new), 0.0)
        corr = torch.where(alive, torch.exp2(mc - mc_new), 1.0)
        l = l * corr + p.sum(-1, keepdim=True)
        m, mc = m_new, mc_new
        tile = torch.zeros_like(acc)
        for t in reversed(_split3(p.contiguous())[:terms]):
            tile = tile + t @ vf[:, :, k0:k0 + bkv]
        acc = acc * corr + tile
    out = acc / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


def _tol_ratio(got, want):
    atol, rtol = chip_smoke.FLASH_TOL[torch.bfloat16]
    diff = (got.float() - want.float()).abs()
    return float((diff / (atol + rtol * want.float().abs())).max())


@pytest.mark.parametrize("hd,h,kv", [(64, 14, 2), (128, 8, 2), (256, 4, 1)])
@pytest.mark.parametrize("sq,skv", [(200, 200), (230, 100), (100, 230)])
def test_tensor_core_arithmetic_holds_the_chip_tolerance(hd, h, kv, sq,
                                                         skv):
    """Emulated kernel against the plain version, causal, every element
    within `chip_smoke.FLASH_TOL` (about one bf16 ulp), at the tensor-core
    head dims, Sq = Skv and Sq != Skv.  This holds the design's arithmetic
    (three exact terms of p, per-tile sums), not the card's rounding: see
    `_tensor_core_model`."""
    q, k, v = _torch(_inputs(1, sq, skv, h, kv, hd, seed=hd + sq),
                     "bfloat16")
    got = _tensor_core_model(q, k, v, causal=True)
    assert _tol_ratio(got, flash_attention_plain(q, k, v)) <= 1.0


def test_one_bf16_term_of_p_breaks_the_tolerance():
    """Why three terms: p rounded to one bf16 term (what a bf16 flash
    kernel feeds its second product) is another function."""
    q, k, v = _torch(_inputs(1, 200, 200, 14, 2, 64, seed=3), "bfloat16")
    want = flash_attention_plain(q, k, v)
    assert _tol_ratio(_tensor_core_model(q, k, v, True, terms=1), want) > 1
    assert _tol_ratio(_tensor_core_model(q, k, v, True), want) <= 1


# --- the wrapper's dispatch and its TMA check ------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_dispatch_picks_the_kernel_for_dtype_and_head_dim(dtype, hd):
    """bf16 at the models' head dims on the tensor cores; fp32 (no TF32)
    and the tests' small bf16 head dims on the CUDA cores."""
    want = (TENSOR_CORE if dtype == torch.bfloat16 and hd >= 64
            else CUDA_CORE)
    assert kernel_for(dtype, hd) is want is DISPATCH[(dtype, hd)]


def test_dispatch_raises_outside_its_table():
    assert set(DISPATCH) == {(d, hd) for d in (torch.float32, torch.bfloat16)
                             for hd in HEAD_DIMS}
    with pytest.raises(ValueError):
        kernel_for(torch.bfloat16, 48)
    with pytest.raises(ValueError):
        kernel_for(torch.float16, 64)


CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc" / "flash_attention.cu")


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_cuda_core_tiles_fit_a_blocks_shared_memory(hd):
    """`flash_attention_kernel`'s shared memory at each head dim (its
    `FLASH_TILE` line): q * scale for the block's query rows, the ring's
    slots of K or V tiles and each warp's p, within the 232,448 bytes a
    block may use; at least two slots, each tile copied in whole 16-byte
    chunks by the block's threads, and two blocks an SM up to hd 64."""
    text = CSRC.read_text()
    bq = int(re.search(r"constexpr int kBQ = (\d+);", text).group(1))
    warps = int(re.search(r"constexpr int kWarps = (\d+);", text).group(1))
    tiles = {int(h): (int(b), int(s)) for h, b, s in re.findall(
        r"^FLASH_TILE\((\d+), (\d+), (\d+)\)", text, re.MULTILINE)}
    assert set(tiles) == set(HEAD_DIMS)
    bkv, slots = tiles[hd]
    smem = 4 * (bq * hd + slots * bkv * hd + warps * bkv * (bq // warps))
    assert slots >= 2 and smem <= 232448
    assert bkv * hd // 4 % (32 * warps) == 0 and bkv % 8 == 0
    if hd <= 64:
        assert 2 * (smem + 1024) <= 233472


def test_tma_check_takes_fused_qkv_slices_and_refuses_odd_offsets():
    qkv = torch.zeros((2, 50, 14 + 2 + 2, 64), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, :14], qkv[:, :, 14:16], qkv[:, :, 16:]
    assert all(tma_readable(t) for t in (q, k, v))
    assert tma_readable(torch.zeros((1, 7, 1, 256), dtype=torch.bfloat16))
    flat = torch.zeros(2 * 50 * 4 * 64 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 50 * 4 * 64].view(2, 50, 4, 64)
    assert shifted.storage_offset() == 1 and not tma_readable(shifted)
    assert tma_readable(flat[8:8 + 2 * 50 * 4 * 64].view(2, 50, 4, 64))
    # a seq stride of 66 elements (132 bytes) is no multiple of 16 bytes
    odd = torch.zeros((1, 9, 66), dtype=torch.bfloat16)[..., :64]
    assert not tma_readable(odd.unsqueeze(2))
    assert not tma_readable(qkv.transpose(2, 3))      # hd not contiguous
