"""`gather_rows`: the table gather of the fused scorer's validity screen.

`gather_rows(table, idx)` returns `out[c, :] = table[idx[c], :]`, with a
zero row wherever `idx[c]` lies outside `[0, U)` — the function of the
Pallas kernel `gather_rows` in the JAX package.  On CUDA tensors it
launches the hand-written kernel in `csrc/gather_rows.cu` (built by
`kernels.build`) and counts the launch in `gather_rows.launches`; on CPU
tensors it runs the plain PyTorch version `gather_rows_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

__all__ = ["gather_rows", "gather_rows_plain"]


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of `gather_rows` (any device)."""
    u = table.shape[0]
    in_range = (idx >= 0) & (idx < u)
    rows = table[idx.clamp(0, u - 1)]
    return torch.where(in_range[:, None], rows,
                       torch.zeros((), dtype=table.dtype,
                                   device=table.device))


@functools.cache
def _launcher():
    fn = build.load("gather_rows").gather_rows_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`out[c, :] = table[idx[c], :]`; zero rows for out-of-range indices.

    `table` is a contiguous `[U, O]` int64 or float64 tensor, `idx` a
    contiguous `[C]` int64 tensor on the same device."""
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"gather_rows: table on {table.device} and idx on "
                         f"{idx.device}; both must be on one CUDA device")
    if table.dtype not in (torch.int64, torch.float64):
        raise TypeError(f"gather_rows: table dtype {table.dtype}, expected "
                        "int64 or float64")
    if idx.dtype != torch.int64:
        raise TypeError(f"gather_rows: idx dtype {idx.dtype}, expected int64")
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows: table {tuple(table.shape)} must be "
                         f"[U, O] and idx {tuple(idx.shape)} must be [C]")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows: table and idx must be contiguous")
    (u, o), n = table.shape, idx.shape[0]
    out = torch.empty((n, o), dtype=table.dtype, device=table.device)
    if n * o == 0:
        return out
    with torch.cuda.device(table.device):
        err = _launcher()(out.data_ptr(), table.data_ptr(), idx.data_ptr(),
                          n, u, o,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_rows: kernel launch failed with CUDA "
                           f"error {err}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
