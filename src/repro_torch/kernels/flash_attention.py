"""`flash_attention`: causal or non-causal GQA softmax attention.

`flash_attention(q, k, v, causal=...)` takes q `[B, Sq, H, hd]` and k, v
`[B, Skv, KV, hd]` (H a multiple of KV; query head h reads KV head
h // (H // KV)) and returns `[B, Sq, H, hd]` in q's dtype, computed in
fp32 with scale `1/sqrt(hd)` — the function of the Pallas kernel
`flash_attention` in the JAX package.  The causal mask is top-left,
`q_pos >= k_pos` with both positions counted from 0: the Pallas kernel's
convention (the JAX package's dense oracle masks bottom-right; the two
agree when Sq == Skv).  A row with no visible key gives zeros.

On CUDA tensors it launches one of the two hand-written kernels in
`csrc/flash_attention.cu` (built by `kernels.build`), the one that
`DISPATCH` names for the inputs' dtype and head dim: bf16 at the models'
head dims (64, 128, 256) on the tensor cores (`TENSOR_CORE`), fp32 (kept
free of TF32) and bf16 at head dims 16 and 32 on the CUDA cores
(`CUDA_CORE`).  A CUDA call outside the table raises; nothing is re-routed.
Each kernel counts its launches in its `launches`, and
`flash_attention.launches` counts both.  On CPU tensors it runs the plain
PyTorch version `flash_attention_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS",
           "FlashKernel", "CUDA_CORE", "TENSOR_CORE", "DISPATCH",
           "kernel_for", "tma_readable"]

#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(eq=False)
class FlashKernel:
    """One kernel of `csrc/flash_attention.cu` and its launch count."""
    name: str
    code: int        # its number at the C entry point
    launches: int = 0


#: `flash_attention_kernel`: fp32 FMAs on the CUDA cores, from fp32 tiles
#: in shared memory
CUDA_CORE = FlashKernel("flash_attention_cuda_core", 0)
#: `flash_attention_kernel_wgmma`: wgmma on TMA-fed bf16 tiles, p @ v as
#: three exact bf16 terms of the fp32 p
TENSOR_CORE = FlashKernel("flash_attention_tensor_core", 1)
#: (dtype, head dim) -> the kernel that takes it
DISPATCH = {**{(torch.float32, hd): CUDA_CORE for hd in HEAD_DIMS},
            (torch.bfloat16, 16): CUDA_CORE,
            (torch.bfloat16, 32): CUDA_CORE,
            (torch.bfloat16, 64): TENSOR_CORE,
            (torch.bfloat16, 128): TENSOR_CORE,
            (torch.bfloat16, 256): TENSOR_CORE}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version (any device): dense masked softmax attention
    with fp32 internals (float64 ones for float64 inputs) and the kernel's
    top-left causal mask.

    Row i of `q` sits at position `q_offset + i` (0 for the kernel's
    function): with it the kernel's output on a long sequence can be
    checked one chunk of query rows at a time, in O(chunk x Skv) memory."""
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if Skv == 0:                        # no visible key: zeros
        return q.new_zeros(q.shape)
    G = H // KV
    ct = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(ct).reshape(B, Sq, KV, G, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(ct))
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(Skv, device=q.device)
        s = s.masked_fill(q_pos[:, None] < k_pos[None, :], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isneginf(m), 0.0, m))
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgqs,bskd->bqkgd", p / l, v.to(ct))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


@functools.cache
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                   + [ctypes.c_int64] * 6 + [ctypes.c_int]
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}; all must be on the "
                         "CPU or on one CUDA device")
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; expected one of float32, bfloat16 for "
                        "all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be "
                         f"[B, Sq, H, hd], k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} the same [B, Skv, KV, hd]")
    B, _, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head dim, or "
                         "H is not a multiple of KV")
    if any(t.stride(-1) != 1 and t.numel() for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim of q, k and v must "
                         "be contiguous (stride 1)")


def kernel_for(dtype: torch.dtype, hd: int) -> FlashKernel:
    """The kernel that `DISPATCH` names for (dtype, head dim); ValueError
    for a pair outside the table (a head dim not in `HEAD_DIMS`)."""
    kernel = DISPATCH.get((dtype, hd))
    if kernel is None:
        raise ValueError(f"flash_attention: no kernel takes {dtype} at head "
                         f"dim {hd}; the kernels take float32 and bfloat16 "
                         f"at {HEAD_DIMS}")
    return kernel


def tma_readable(t: torch.Tensor) -> bool:
    """Whether TMA can read `t` ([B, S, heads, hd], head dim contiguous):
    its start 16-byte aligned and its batch, seq and head strides
    multiples of 16 bytes.  A slice of a fused qkv tensor at a head
    boundary is; a view at an odd storage offset is not."""
    item = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * item % 16 == 0 for st in t.stride()[:3]))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, hd]; k, v [B, Skv, KV, hd] -> [B, Sq, H, hd].

    CUDA tensors: float32 or bfloat16, all of one dtype, head dim in
    `HEAD_DIMS` and contiguous; the other dims are read by stride.  The
    tensor-core kernel reads through TMA: q, k and v must be
    `tma_readable`, or it raises `ValueError`."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    kernel = kernel_for(q.dtype, hd)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if Skv == 0:                # no visible key (and no tensor map of 0 rows)
        return out.zero_()
    if kernel is TENSOR_CORE:
        unread = [n for n, t in (("q", q), ("k", k), ("v", v))
                  if not tma_readable(t)]
        if unread:
            raise ValueError(
                f"flash_attention: TMA cannot read {', '.join(unread)} "
                "(start not 16-byte aligned, or a stride not a multiple of "
                "16 bytes)")
    with torch.cuda.device(q.device):
        err = _launcher()(
            kernel.code, out.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _DTYPE_CODES[q.dtype], B, Sq, Skv, H, KV, hd,
            int(causal), *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: {kernel.name} launch failed "
                           f"with CUDA error {err}")
    kernel.launches += 1
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
