"""`rglru_scan`: the RG-LRU linear recurrence over the sequence.

`rglru_scan(a, b)` takes a, b `[B, S, W]` and returns h `[B, S, W]` with
`h[:, t] = a[:, t] * h[:, t-1] + b[:, t]` and `h[:, -1] = 0`, computed in
fp32 and returned in a's dtype — the function of the Pallas kernel
`rglru_scan` in the JAX package, and of the `associative_scan` in its
`rglru_block_train`.

On CUDA tensors it launches the hand-written kernel in
`csrc/rglru_scan.cu` (built by `kernels.build`) and counts the launch in
`rglru_scan.launches`; on CPU tensors it runs the plain PyTorch version
`rglru_scan_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["rglru_scan", "rglru_scan_plain", "chunk_len"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads the kernel wants in flight (about 2048 on each of 132 SMs)
_TARGET_THREADS = 1 << 18


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (any device): an inclusive scan of the affine
    maps h -> a_t h + b_t by log-step doubling over the whole sequence.
    After the step of shift s, (a, b)[t] is the composition of the maps of
    positions (t - 2s, t]; with h[-1] = 0 the final b is h.  fp32 math,
    log2(S) whole-tensor steps: no loop over S, so it runs at S = 32768 on
    the card in milliseconds."""
    out_dtype = a.dtype
    a, b = a.float(), b.float()
    s = 1
    while s < a.shape[1]:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:],
                                               b[:, :-s])], dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b.to(out_dtype)


def chunk_len(batch: int, seq: int, width: int) -> int:
    """Steps per chunk: the longest power of two in [32, 256] that still
    gives the kernel's first and last passes `_TARGET_THREADS` threads
    (one per batch row, chunk and channel)."""
    n = 256
    while n > 32 and batch * width * -(-seq // n) < _TARGET_THREADS:
        n //= 2
    return n


@functools.cache
def _launcher():
    fn = build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                   + [ctypes.c_int64] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.device.type == "cuda" and b.device == a.device):
        raise ValueError(f"rglru_scan: a on {a.device} and b on {b.device}; "
                         "both must be on the CPU or on one CUDA device")
    if a.dtype not in _DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}, {b.dtype}; expected "
                        "float32 or bfloat16 for both")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must both be [B, S, W]")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan: the channel dim of a and b must be "
                         "contiguous (stride 1)")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] -> h [B, S, W] in a's dtype.

    CUDA tensors: float32 or bfloat16, both alike, the channel dim
    contiguous; batch and sequence are read by stride."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_plain(a, b)
    _check(a, b)
    B, S, W = a.shape
    out = torch.empty((B, S, W), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    chunk = chunk_len(B, S, W)
    scratch = torch.empty((2, B, -(-S // chunk), W), dtype=torch.float32,
                          device=a.device)
    with torch.cuda.device(a.device):
        err = _launcher()(
            out.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
            a.data_ptr(), b.data_ptr(), _DTYPE_CODES[a.dtype], B, S, W,
            chunk, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA "
                           f"error {err}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
