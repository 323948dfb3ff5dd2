"""`rglru_scan`: the RG-LRU linear recurrence over the sequence, and
`rglru_gated_scan`: the RG-LRU block from its gate logits to its gated
output, with the recurrence inside.

`rglru_scan(a, b)` takes a, b `[B, S, W]` and returns h `[B, S, W]` with
`h[:, t] = a[:, t] * h[:, t-1] + b[:, t]` and `h[:, -1] = 0`, computed in
fp32 and returned in a's dtype — the function of the Pallas kernel
`rglru_scan` in the JAX package, and of the `associative_scan` in its
`rglru_block_train`.  On CUDA tensors it launches the hand-written
`rglru_slab_kernel` in `csrc/rglru_scan.cu` (built by `kernels.build`):
one warp walks each slab of 32 channels through the sequence, a and b
read once, and the launch is counted in `rglru_scan.launches`.

`rglru_gated_scan(xc, ra, ri, gate, ba, bi, a_param, out_dtype)` returns
`y = h * gelu_tanh(gate)` in `out_dtype`, where h is the recurrence of
`a = exp(log_a)` and `b = beta * (i * xc)` made from the gate logits as
`models.layers` makes them (`rglru_gated_scan_plain` spells it out).  On
CUDA tensors it launches `rglru_gated_kernel`, the slab walk with that
arithmetic in its loads and stores, and counts the launch in
`rglru_gated_scan.launches`.

On CPU tensors both run their plain PyTorch versions; a CUDA call a kernel
does not take raises, nothing is re-routed.  An operand TMA cannot read
where it lies (a start or a stride off 16 bytes, or a head narrower than
a slab) is copied, zero-padded, into a layout it can: the kernel runs.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["rglru_scan", "rglru_scan_plain", "rglru_gated_scan",
           "rglru_gated_scan_plain", "SLAB_CHANNELS", "read_in_place"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: channels of one slab: one warp's lanes, one 128-byte TMA row of fp32
SLAB_CHANNELS = 32
#: the RG-LRU decay's constant c in log a = -c softplus(a_param) r
_C = 8.0


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


def rglru_gated_scan_plain(xc: torch.Tensor, ra: torch.Tensor,
                           ri: torch.Tensor, gate: torch.Tensor,
                           ba: torch.Tensor, bi: torch.Tensor,
                           a_param: torch.Tensor,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version (any device), op for op the arithmetic of
    `models.layers`' `_rglru_gates`, `_rglru_decay`, `rglru_scan_inputs`
    and `rglru_output` up to the output projection: the gates' sigmoids,
    the decay a and its input scale beta (softplus as logaddexp(x, 0)),
    b = beta (i xc), the scan (`rglru_scan_plain`), and h times the tanh
    GeLU of the gate, rounded once into `out_dtype`."""
    B, S, W = xc.shape
    r = torch.sigmoid(ra.reshape(B, S, W) + ba.float())
    i = torch.sigmoid(ri.reshape(B, S, W) + bi.float())
    a_param = a_param.float()
    log_a = -_C * torch.logaddexp(a_param, torch.zeros_like(a_param)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6))
    h = rglru_scan_plain(a, beta * (i * xc.float()))
    return (h * F.gelu(gate.float(), approximate="tanh")).to(out_dtype)


@functools.cache
def _launcher():
    fn = build.load("rglru_scan").rglru_scan_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] + [ctypes.c_int64] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _gated_launcher():
    fn = build.load("rglru_scan").rglru_gated_scan_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
                   + [ctypes.c_void_p])
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


def _tma_geometry(t: torch.Tensor):
    """(t4, geometry) for the slab kernels: t [B, S, W] (one group) or
    [B, S, G, I] (G groups of I channels, W = G I; I contiguous) as t4
    [B, S, G, I], and its six numbers (I, G, step, group and batch strides
    in elements, 0).  TMA reads t in place where its start and strides are
    multiples of 16 bytes and a 32-channel slab stays in one group (I a
    multiple of 32, or G = 1); else t4 is a contiguous copy [B, S, 1, Wp],
    zero-padded to whole 16-byte rows.  A dim of size 1 gets a stride TMA
    takes (it is never stepped)."""
    if t.dim() == 3:
        t = t.unsqueeze(2)
    B, S, G, I = t.shape
    item = t.element_size()
    row = -(-I * item // 16) * 16 // item          # I rounded up to 16 B

    def stride(d):
        return t.stride(d) if t.shape[d] > 1 else row

    if (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and (G == 1 or I % SLAB_CHANNELS == 0)
            and all(stride(d) * item % 16 == 0 for d in (0, 1, 2))):
        return t, (I, G, stride(1), stride(2), stride(0), 0)
    W = G * I
    wp = -(-W * item // 16) * 16 // item
    c = t.new_zeros((B, S, 1, wp))
    c[..., :W] = t.reshape(B, S, 1, W)
    return c, (W, 1, wp, wp, S * wp, 0)


def read_in_place(t: torch.Tensor) -> bool:
    """Whether the slab kernels read the operand t where it lies (no
    copy before the launch)."""
    return _tma_geometry(t)[0].data_ptr() == t.data_ptr()


def _slab_out(B: int, S: int, W: int, dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """The slab kernels' output [B, S, W]: TMA stores whole 16-byte rows,
    so W is padded up to them in storage (a view of the first W channels
    where it is)."""
    item = torch.empty((), dtype=dtype).element_size()
    wp = -(-W * item // 16) * 16 // item
    out = torch.empty((B, S, wp), dtype=dtype, device=device)
    return out if wp == W else out[..., :W]


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, W] -> h [B, S, W] in a's dtype.

    CUDA tensors: float32 or bfloat16, both alike, the channel dim
    contiguous; batch and sequence are read by stride."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_plain(a, b)
    _check(a, b)
    B, S, W = a.shape
    out = _slab_out(B, S, W, a.dtype, a.device)
    if out.numel() == 0:
        return out
    (a, ga), (b, gb) = (_tma_geometry(t) for t in (a, b))
    with torch.cuda.device(a.device):
        err = _launcher()(
            out.data_ptr(), out.stride(1), a.data_ptr(), b.data_ptr(),
            _DTYPE_CODES[a.dtype], B, S, W, ga[4], ga[2], gb[4], gb[2],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA "
                           f"error {err}")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0


def _check_gated(xc, ra, ri, gate, ba, bi, a_param, out_dtype) -> None:
    """Shapes and dtypes, on every device."""
    if xc.dim() != 3 or gate.shape != xc.shape:
        raise ValueError(f"rglru_gated_scan: xc {tuple(xc.shape)} and gate "
                         f"{tuple(gate.shape)} must both be [B, S, W]")
    B, S, W = xc.shape
    for name, t in (("ra", ra), ("ri", ri)):
        if not (t.shape == xc.shape or (t.dim() == 4 and t.shape[:2] == (B, S)
                                        and t.shape[2] * t.shape[3] == W)):
            raise ValueError(f"rglru_gated_scan: {name} {tuple(t.shape)} "
                             f"must be [B, S, W] or [B, S, heads, W / heads] "
                             f"with xc {tuple(xc.shape)}")
    for name, t in (("ba", ba), ("bi", bi), ("a_param", a_param)):
        if t.shape != (W,) or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"rglru_gated_scan: {name} {tuple(t.shape)} "
                             f"{t.dtype} must be [{W}], float32 or bfloat16")
    if ra.dtype != torch.float32 or ri.dtype != torch.float32:
        raise TypeError(f"rglru_gated_scan: ra and ri are {ra.dtype}, "
                        f"{ri.dtype}; expected float32")
    for name, dt in (("xc", xc.dtype), ("gate", gate.dtype),
                     ("out_dtype", out_dtype)):
        if dt not in _DTYPE_CODES:
            raise TypeError(f"rglru_gated_scan: {name} is {dt}; expected "
                            "float32 or bfloat16")


def rglru_gated_scan(xc: torch.Tensor, ra: torch.Tensor, ri: torch.Tensor,
                     gate: torch.Tensor, ba: torch.Tensor, bi: torch.Tensor,
                     a_param: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """xc, gate [B, S, W]; ra, ri [B, S, W] or [B, S, heads, W / heads]
    (the gate einsums' head-major views, read in place); ba, bi, a_param
    [W] -> y [B, S, W] in `out_dtype`.

    ra and ri float32; xc, gate and `out_dtype` float32 or bfloat16; the
    [W] vectors float32 or bfloat16."""
    _check_gated(xc, ra, ri, gate, ba, bi, a_param, out_dtype)
    tensors = (xc, ra, ri, gate, ba, bi, a_param)
    if all(t.device.type == "cpu" for t in tensors):
        return rglru_gated_scan_plain(*tensors, out_dtype)
    dev = xc.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("rglru_gated_scan: the inputs lie on "
                         f"{sorted({str(t.device) for t in tensors})}; all "
                         "must be on the CPU or on one CUDA device")
    B, S, W = xc.shape
    out = _slab_out(B, S, W, out_dtype, dev)
    if out.numel() == 0:
        return out
    ops, geom = [], []
    for t in (xc, ra, ri, gate):
        t4, g = _tma_geometry(t)
        ops.append(t4)
        geom.extend(g)
    vecs = [v.float().contiguous() for v in (ba, bi, a_param)]
    with torch.cuda.device(dev):
        err = _gated_launcher()(
            out.data_ptr(), out.stride(1), _DTYPE_CODES[out_dtype],
            ops[0].data_ptr(),
            _DTYPE_CODES[xc.dtype], ops[1].data_ptr(), ops[2].data_ptr(),
            ops[3].data_ptr(), _DTYPE_CODES[gate.dtype],
            (ctypes.c_int64 * 24)(*geom), *(v.data_ptr() for v in vecs),
            B, S, W, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_gated_scan: kernel launch failed with "
                           f"CUDA error {err}")
    rglru_gated_scan.launches += 1
    return out


rglru_gated_scan.launches = 0
