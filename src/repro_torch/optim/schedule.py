"""Learning-rate schedules (pure functions of the step counter), the twins
of `repro.optim.schedule`: every value a float32 tensor computed in
float32, as jnp computes it, bit for bit.

The one function that is not a single rounding is the cosine: XLA's f32
`cos` on the CPU is glibc's `cosf` (a double-precision reduction and
polynomial, rounded to float), where `torch.cos` is SLEEF's on the CPU
and CUDA's `cosf` on the card; they differ from it in the last bit on
about 1 % of inputs.  `_cosf` evaluates glibc's algorithm in float64
tensor ops on any device.
"""

from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "linear_warmup_cosine"]

# glibc's `__sincosf_table` (sysdeps/ieee754/flt-32/sincosf_data.c): the
# reduction by pi/2 (2/pi scaled by 2^24, pi/2) and the cosine and sine
# polynomials; the second table negates the cosine's, for quadrants 2-3
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_C = (1.0, -float.fromhex("0x1.ffffffd0c621cp-2"),
      float.fromhex("0x1.55553e1068f19p-5"),
      -float.fromhex("0x1.6c087e89a359dp-10"),
      float.fromhex("0x1.99343027bf8c3p-16"))
_S = (-float.fromhex("0x1.555545995a603p-3"),
      float.fromhex("0x1.1107605230bc4p-7"),
      -float.fromhex("0x1.994eb3774cf24p-13"))


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's `cosf` of float32 `y` for 0 <= y < 120 (the schedule's
    range, [0, pi]), as float32: below pi/4 (by the top 12 bits of y) the
    cosine polynomial of y; above, y reduced by the nearest multiple n of
    pi/2 in double, the sine or cosine polynomial by n's parity, signed
    by its quadrant."""
    top12 = (y.view(torch.int32) >> 20) & 0x7FF
    x = y.double()
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    n = torch.where(top12 < 0x3F4, torch.zeros_like(n), n)  # |y| < ~pi/4
    xr = x - n.double() * _HPI
    x2 = xr * xr
    flip = torch.where((n & 2) != 0, -1.0, 1.0).double()   # table [1]
    x4 = x2 * x2
    c = (_C[0] + x2 * _C[1]) + x4 * _C[2]
    c = flip * (c + (x4 * x2) * (_C[3] + x2 * _C[4]))
    xs = xr * torch.where((n & 3) == 1, -1.0, 1.0).double() \
        * torch.where((n & 3) == 2, -1.0, 1.0).double()
    x3 = xs * x2
    s = (xs + x3 * _S[0]) + (x3 * x2) * (_S[1] + x2 * _S[2])
    out = torch.where((n & 1) == 1, s, c)
    return torch.where(top12 < 0x398, 1.0, out).float()     # y < 2^-12


def cosine_schedule(step: torch.Tensor, *, base_lr: float, total_steps: int,
                    min_frac: float = 0.1) -> torch.Tensor:
    t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + _cosf(math.pi * t))
    return base_lr * (min_frac + (1.0 - min_frac) * cos)


def linear_warmup_cosine(step: torch.Tensor, *, base_lr: float,
                         warmup_steps: int, total_steps: int,
                         min_frac: float = 0.1) -> torch.Tensor:
    """`step` an integer tensor (0-d or not) on any device."""
    warm = base_lr * torch.clamp_max(step.float() / max(warmup_steps, 1),
                                     1.0)
    decay = cosine_schedule(step - warmup_steps, base_lr=base_lr,
                            total_steps=max(total_steps - warmup_steps, 1),
                            min_frac=min_frac)
    return torch.where(step < warmup_steps, warm, decay)
