"""Logical-axis sharding rules (MaxText-style) for the model zoo, as
DTensor placements on a `DeviceMesh`: the twin of
`repro.distributed.sharding`.

Model code annotates tensors with *logical* axis names ("batch", "heads",
"ff", "vocab", "experts", "embed", "kv_seq", ...).  An `AxisRules` instance
maps logical names onto the mesh's named dimensions ("pod", "data",
"model").  The mapping is a design variable of the execution space: the
autotune (`core/autotune.py`) flips entries of it (`extra_rules`).

Two standard rule-sets, the reference's:

  tp_rules    — Megatron-style tensor parallelism on the "model" axis,
                batch on ("pod", "data"); parameters replicated on "data".
  fsdp_rules  — tp_rules + parameter "embed" dimension sharded over "data"
                (ZeRO-3/FSDP).

`AxisRules.spec` gives, per tensor dimension, the mesh axis, the tuple of
mesh axes or `None`: the content of the reference's `PartitionSpec`.
`placements_of` turns it into DTensor placements, one per mesh dimension:
`Shard(d)` on every mesh dimension that tensor dimension `d` maps to,
`Replicate()` elsewhere.  A tuple such as `batch -> ("pod", "data")`
becomes `Shard(0)` on both mesh dimensions, which DTensor splits major to
minor in the mesh's order, as JAX splits the tuple's axes; a tuple in
another order than the mesh's has no plain DTensor placement and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

__all__ = ["AxisRules", "Layout", "tp_rules", "fsdp_rules",
           "placements_of", "logical_placements", "tree_placements",
           "shard_shape", "shard_constraint"]

MeshAxes = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name -> mesh axis (or tuple, or None)."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def get(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def spec(self, logical_axes: Sequence[Optional[str]]
             ) -> Tuple[MeshAxes, ...]:
        """Mesh axes per dimension, normalised as JAX's `PartitionSpec`
        normalises its entries: a tuple of one axis is the axis, an empty
        tuple `None`."""
        return tuple(_entry(self.get(a)) for a in logical_axes)

    def replace(self, **kv: MeshAxes) -> "AxisRules":
        d = dict(self.rules)
        d.update(kv)
        return AxisRules(tuple(d.items()))

    def asdict(self) -> Dict[str, MeshAxes]:
        return dict(self.rules)


def _entry(axes: MeshAxes) -> MeshAxes:
    if isinstance(axes, tuple) and len(axes) <= 1:
        return axes[0] if axes else None
    return axes


def tp_rules(batch_axes: Tuple[str, ...] = ("data",)) -> AxisRules:
    return AxisRules((
        ("batch", batch_axes),
        ("seq", None),
        ("attn_seq", "model"),        # context parallelism inside attention
        ("kv_seq", "model"),          # decode KV caches: flash-decode style
        ("kv_heads", None),           # alt decode layout (autotune flips)
        ("heads", "model"),
        ("qkv_fused", "model"),
        ("ff", "model"),
        ("vocab", "model"),
        ("experts", "model"),
        ("embed", None),
        ("lru", "model"),
        ("layers", None),
    ))


def fsdp_rules(batch_axes: Tuple[str, ...] = ("data",)) -> AxisRules:
    return tp_rules(batch_axes).replace(embed="data")


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one tensor lies on a mesh: its global shape, its mesh axes
    per dimension (`AxisRules.spec`) and the DTensor placements of
    those."""

    shape: Tuple[int, ...]
    spec: Tuple[MeshAxes, ...]
    placements: tuple


def placements_of(mesh, spec: Sequence[MeshAxes]) -> tuple:
    """DTensor placements on `mesh` of a tensor whose dimension `d` lies on
    the mesh axes `spec[d]`.  Raises `ValueError` on an axis the mesh does
    not have, on a mesh axis given to two tensor dimensions (JAX's
    `DuplicateSpecError`) and on a tuple whose axes are not in the mesh's
    order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)}: mesh {names} has no "
                                 f"axis {a!r}")
            if a in owner:
                raise ValueError(
                    f"spec {tuple(spec)} gives mesh axis {a!r} to tensor "
                    f"dimensions {owner[a]} and {d}")
            owner[a] = d
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {tuple(spec)}: the axes {axes} of dimension {d} are "
                f"not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_placements(mesh, rules: AxisRules,
                       logical_axes: Sequence[Optional[str]]) -> tuple:
    """The counterpart of the reference's `logical_sharding`."""
    return placements_of(mesh, rules.spec(logical_axes))


def tree_placements(mesh, rules: AxisRules, spec_tree):
    """A tree of `Spec`s (`models.layers`) as the same tree of DTensor
    placements (the counterpart of the reference's `tree_shardings`)."""
    from repro_torch.models.layers import map_specs

    return map_specs(lambda s: logical_placements(mesh, rules, s.axes),
                     spec_tree)


def shard_shape(global_shape: Sequence[int], mesh,
                placements: Sequence) -> Tuple[int, ...]:
    """Rank 0's local shape of a tensor of `global_shape` placed on `mesh`.
    Raises `ValueError` when a dimension is not divisible by the sizes of
    the mesh axes it lies on, as the reference's
    `NamedSharding.shard_shape` does (DTensor itself would chunk the
    dimension unevenly)."""
    parts = [1] * len(global_shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            parts[p.dim] *= mesh.size(i)
    for d, (n, k) in enumerate(zip(global_shape, parts)):
        if n % k:
            raise ValueError(
                f"dimension {d} of {tuple(global_shape)} is split {k} ways "
                f"by {tuple(placements)}, which does not divide {n}")
    return tuple(n // k for n, k in zip(global_shape, parts))


def shard_constraint(x: torch.Tensor, rules: Optional[AxisRules],
                     *logical_axes: Optional[str], mesh=None
                     ) -> torch.Tensor:
    """`x` redistributed to the rules' placements of `logical_axes` on
    `mesh`; `x` unchanged when no rules or no mesh are given (the
    reference's constraint without an active mesh) or `x` is a plain
    tensor, not a DTensor."""
    from torch.distributed.tensor import DTensor

    if rules is None or mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, logical_placements(mesh, rules,
                                                   logical_axes))
