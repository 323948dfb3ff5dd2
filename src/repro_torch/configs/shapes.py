"""Assigned input shapes (identical set for every LM-family architecture).

  train_4k     seq 4096,   global_batch 256  — training  (train_step)
  prefill_32k  seq 32768,  global_batch 32   — inference prefill (full fwd)
  decode_32k   seq 32768,  global_batch 128  — one new token, 32k KV cache
  long_500k    seq 524288, global_batch 1    — one new token, 500k context;
               requires sub-quadratic attention (SSM/hybrid only)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ShapeSpec", "SHAPES", "shape_by_name"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                  # "train" | "prefill" | "decode"
    needs_sub_quadratic: bool = False


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode", needs_sub_quadratic=True),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
