"""`matmul`: a tiled matrix product with an fp32 accumulator.

`matmul(x, y, bm=, bk=, bn=)` takes x `[M, K]` and y `[K, N]` and returns
`x @ y` `[M, N]`, accumulated in fp32 over `(bm, bk, bn)` tiles with K
innermost and cast to `out_dtype` (x's dtype by default) — the function of
the Pallas kernel `matmul` in the JAX package, whose tiles the execution-
space DSE tunes (`core.kernel_tune`).

On CUDA tensors it launches one of the two hand-written kernels in
`csrc/matmul.cu` (built by `kernels.build`), the one that `DISPATCH` names
for the inputs' dtype: bf16 on the tensor cores (`TENSOR_CORE`: wgmma on
TMA-fed tiles), fp32 on the CUDA cores (`CUDA_CORE`: fp32 FMAs, free of
TF32).  Each kernel is built for its own tiles (`MatmulKernel.tiles`) and
counts its launches in its `launches`; `matmul.launches` counts both.  On
CPU tensors it runs the plain PyTorch version `matmul_plain`.  A tile that
the dtype's kernel is not built for raises `ValueError` on every device, so
the CPU shows which tiles the card can run.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["MatmulKernel", "CUDA_CORE", "TENSOR_CORE", "DISPATCH",
           "kernel_for", "tma_operands", "matmul", "matmul_plain"]

Tile = Tuple[int, int, int]


@dataclasses.dataclass(eq=False)
class MatmulKernel:
    """One kernel of `csrc/matmul.cu`, the tiles it is instantiated for
    (in the order the tile tuner breaks ties in) and its launch count."""
    name: str
    code: int        # its number at the C entry point
    tiles: Tuple[Tile, ...]
    launches: int = 0


#: `matmul_kernel`: fp32 FMAs on the CUDA cores; its `MATMUL_TILE(...)`
#: lines, the larger output tile first (it refetches the inputs fewer
#: times), then the deeper K tile
CUDA_CORE = MatmulKernel("matmul_cuda_core", 0, (
    (128, 64, 128), (128, 32, 128), (128, 16, 128),
    (128, 128, 64), (64, 128, 128),
    (128, 64, 64), (64, 64, 128),
    (128, 32, 64), (64, 32, 128),
    (128, 16, 64), (64, 16, 128),
    (64, 128, 64), (64, 64, 64), (64, 32, 64), (64, 16, 64),
))
#: `tc::matmul_kernel_wgmma`: wgmma on TMA-fed bf16 tiles; its
#: `MATMUL_TC_TILE(...)` lines, every (bm, bn) in {64, 128, 256}^2 but
#: 256 x 256 at bk 64 and 128, the larger output tile first
TENSOR_CORE = MatmulKernel("matmul_tensor_core", 1, (
    (128, 64, 256), (256, 64, 128), (128, 128, 256), (256, 128, 128),
    (128, 64, 128), (128, 128, 128),
    (64, 64, 256), (256, 64, 64), (64, 128, 256), (256, 128, 64),
    (64, 64, 128), (128, 64, 64), (64, 128, 128), (128, 128, 64),
    (64, 64, 64), (64, 128, 64),
))
#: input dtype -> the kernel that takes it
DISPATCH = {torch.float32: CUDA_CORE, torch.bfloat16: TENSOR_CORE}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535                      # CUDA-core blocks along M
_TMA_ALIGN = 8                           # bf16 elements in 16 bytes


def kernel_for(dtype: torch.dtype) -> MatmulKernel:
    """The kernel that `DISPATCH` names for inputs of `dtype`; TypeError
    for a dtype outside the table."""
    kernel = DISPATCH.get(dtype)
    if kernel is None:
        raise TypeError(f"matmul: no kernel takes {dtype} inputs; the "
                        "kernels take float32 and bfloat16")
    return kernel


def _check_tile(kernel: MatmulKernel, bm: int, bk: int, bn: int) -> None:
    if (bm, bk, bn) not in kernel.tiles:
        raise ValueError(f"matmul: no kernel for tile ({bm}, {bk}, {bn}); "
                         f"{kernel.name} is built for {kernel.tiles}")


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *, bk: int,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version (any device): fp32 partial products of the K
    tiles, added in the kernel's K order, then the cast.  On the card it
    must run under `layers.full_precision_products` (no TF32)."""
    out_dtype = out_dtype or x.dtype
    K = x.shape[1]
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, K, bk):
        acc += x[:, k0:k0 + bk].float() @ y[k0:k0 + bk].float()
    return acc.to(out_dtype)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _zero_padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = t.new_zeros((rows, cols))
    out[:t.shape[0], :t.shape[1]] = t
    return out


def tma_operands(x: torch.Tensor, y: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] and y [K, N] (contiguous bf16) as the tensor-core kernel
    reads them through TMA, which needs 16-byte-aligned starts and row
    strides: where K is not a multiple of 8, or a start is not aligned,
    x and y are copied with K zero-padded to a multiple of 8, and y also
    with N zero-padded so.  That is the Pallas wrapper's own zero padding:
    the extra terms are exact zeros and add nothing to any sum.  Returns
    x [M, K'] and y [K', N'] (N' >= N is y's row stride)."""
    K, N = y.shape
    kp, np_ = _round_up(K, _TMA_ALIGN), _round_up(N, _TMA_ALIGN)
    item = x.element_size()
    if kp != K or x.data_ptr() % (_TMA_ALIGN * item):
        x = _zero_padded(x, x.shape[0], kp)
    if (kp, np_) != (K, N) or y.data_ptr() % (_TMA_ALIGN * item):
        y = _zero_padded(y, kp, np_)
    return x, y


@functools.cache
def _launcher():
    fn = build.load("matmul").matmul_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_int64] * 4
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, y: torch.Tensor, out_dtype: torch.dtype,
           kernel: MatmulKernel, bm: int) -> None:
    if not (x.device.type == "cuda" and y.device == x.device):
        raise ValueError(f"matmul: x on {x.device} and y on {y.device}; "
                         "both must be on the CPU or on one CUDA device")
    if y.dtype != x.dtype or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul: dtypes {x.dtype}, {y.dtype} -> "
                        f"{out_dtype}; expected float32 or bfloat16 inputs "
                        "alike and a float32 or bfloat16 output")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be [M, K] and [K, N]")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul: x and y must be contiguous")
    if kernel is CUDA_CORE and -(-x.shape[0] // bm) > _MAX_GRID_Y:
        raise ValueError(f"matmul: M = {x.shape[0]} needs more than "
                         f"{_MAX_GRID_Y} blocks of {bm} rows")
    if kernel is TENSOR_CORE and max(x.shape[0], _round_up(
            y.shape[1], _TMA_ALIGN)) >= 2 ** 31:
        raise ValueError(f"matmul: M = {x.shape[0]} or N = {y.shape[1]} "
                         "reaches 2^31, past TMA's coordinates")


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int, bk: int, bn: int,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ y [K, N] -> [M, N] in `out_dtype` (default x's).

    float32 or bfloat16 inputs, both alike; on CUDA tensors contiguous,
    the output float32 or bfloat16.  `(bm, bk, bn)` must be one of
    `kernel_for(x.dtype).tiles`."""
    kernel = kernel_for(x.dtype)
    _check_tile(kernel, bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and y.device.type == "cpu":
        return matmul_plain(x, y, bk=bk, out_dtype=out_dtype)
    _check(x, y, out_dtype, kernel, bm)
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if kernel is TENSOR_CORE:
        if K == 0:                    # no terms (and no tensor map of 0)
            return out.zero_()
        x, y = tma_operands(x, y)
    with torch.cuda.device(x.device):
        err = _launcher()(
            kernel.code, out.data_ptr(), x.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x.dtype], int(out_dtype == torch.bfloat16),
            M, x.shape[1], N, y.shape[1], bm, bk, bn,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul: {kernel.name} launch failed with CUDA "
                           f"error {err}")
    kernel.launches += 1
    matmul.launches += 1
    return out


matmul.launches = 0
