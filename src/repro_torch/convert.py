"""Carry the JAX package's state into the port, as plain data.

The DSE system has no weights: its state is op streams, design spaces and
configurations.  These functions build the port's objects from plain
Python/numpy data that the JAX package's objects export, so a test can
hand both packages the same inputs without the port importing the other
package.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core.costmodel import (ConfigBatch, HardwareConstants, Op,
                                        OpKind, OpStream)
from repro_torch.core.space import DesignSpace

__all__ = ["ops_from_records", "space_from_domains",
           "config_batch_from_matrix"]


def ops_from_records(records: Iterable[Mapping]) -> OpStream:
    """`OpStream` from op records: each is `dataclasses.asdict(op)` of an
    `Op`, with `kind` given as its enum name (e.g. ``"CONV2D"``)."""
    ops = []
    for rec in records:
        fields = dict(rec)
        ops.append(Op(kind=OpKind[fields.pop("kind")], **fields))
    return OpStream(ops)


def space_from_domains(domains: Mapping[str, Sequence[int]],
                       hw_fields: Mapping[str, object],
                       area_budget: float) -> DesignSpace:
    """`DesignSpace` from per-variable domains, the fields of a
    `HardwareConstants` (`dataclasses.asdict`) and an area budget."""
    return DesignSpace(
        domains={k: tuple(int(v) for v in dom) for k, dom in domains.items()},
        hw=HardwareConstants(**dict(hw_fields)),
        area_budget=float(area_budget))


def config_batch_from_matrix(matrix: np.ndarray) -> ConfigBatch:
    """`ConfigBatch` from an `[N, 18]` integer matrix in the canonical
    `ConfigBatch.FIELDS` column order."""
    return ConfigBatch(np.asarray(matrix, dtype=np.int64))
