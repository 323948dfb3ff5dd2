"""`matmul`: a tiled matrix product with an fp32 accumulator.

`matmul(x, y, bm=, bk=, bn=)` takes x `[M, K]` and y `[K, N]` and returns
`x @ y` `[M, N]`, accumulated in fp32 over `(bm, bk, bn)` tiles with K
innermost and cast to `out_dtype` (x's dtype by default) — the function of
the Pallas kernel `matmul` in the JAX package, whose tiles the execution-
space DSE tunes (`core.kernel_tune`).

On CUDA tensors it launches the hand-written kernel in `csrc/matmul.cu`
(built by `kernels.build`) and counts the launch in `matmul.launches`; on
CPU tensors it runs the plain PyTorch version `matmul_plain`.  A tile the
kernel is not built for raises `ValueError` on every device, so the CPU
shows which tiles the card can run.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

__all__ = ["MATMUL_TILES", "matmul", "matmul_plain"]

#: every (bm, bk, bn) that `csrc/matmul.cu` is instantiated for, in the
#: order the tile tuner breaks ties in: the larger output tile first (it
#: refetches the inputs fewer times), then the deeper K tile.  Where the
#: Hopper model ties every tile (`core.kernel_tune`), this order alone is
#: the pick; the K order has no basis in the model
MATMUL_TILES: Tuple[Tuple[int, int, int], ...] = (
    (128, 64, 128), (128, 32, 128), (128, 16, 128),
    (128, 128, 64), (64, 128, 128),
    (128, 64, 64), (64, 64, 128),
    (128, 32, 64), (64, 32, 128),
    (128, 16, 64), (64, 16, 128),
    (64, 128, 64), (64, 64, 64), (64, 32, 64), (64, 16, 64),
)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535                      # blocks along M


def _check_tile(bm: int, bk: int, bn: int) -> None:
    if (bm, bk, bn) not in MATMUL_TILES:
        raise ValueError(f"matmul: no kernel for tile ({bm}, {bk}, {bn}); "
                         f"it is built for {MATMUL_TILES}")


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


@functools.cache
def _launcher():
    fn = build.load("matmul").matmul_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                   + [ctypes.c_int64] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, y: torch.Tensor, out_dtype: torch.dtype,
           bm: int) -> None:
    if not (x.device.type == "cuda" and y.device == x.device):
        raise ValueError(f"matmul: x on {x.device} and y on {y.device}; "
                         "both must be on the CPU or on one CUDA device")
    if x.dtype not in _DTYPE_CODES or y.dtype != x.dtype \
            or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"matmul: dtypes {x.dtype}, {y.dtype} -> "
                        f"{out_dtype}; expected float32 or bfloat16 inputs "
                        "alike and a float32 or bfloat16 output")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be [M, K] and [K, N]")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul: x and y must be contiguous")
    if -(-x.shape[0] // bm) > _MAX_GRID_Y:
        raise ValueError(f"matmul: M = {x.shape[0]} needs more than "
                         f"{_MAX_GRID_Y} blocks of {bm} rows")


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: int, bk: int, bn: int,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [M, K] @ y [K, N] -> [M, N] in `out_dtype` (default x's).

    CUDA tensors: float32 or bfloat16, both alike and contiguous; the
    output float32 or bfloat16.  `(bm, bk, bn)` must be in
    `MATMUL_TILES`."""
    _check_tile(bm, bk, bn)
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu" and y.device.type == "cpu":
        return matmul_plain(x, y, bk=bk, out_dtype=out_dtype)
    _check(x, y, out_dtype, bm)
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _launcher()(
            out.data_ptr(), x.data_ptr(), y.data_ptr(),
            _DTYPE_CODES[x.dtype], int(out_dtype == torch.bfloat16),
            M, K, N, bm, bk, bn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul: kernel launch failed with CUDA error "
                           f"{err}")
    matmul.launches += 1
    return out


matmul.launches = 0
