"""Carry the JAX package's state into the port, as plain data.

The DSE loop's state is op streams, design spaces and configurations;
the model zoo's is a parameter tree.  These functions build the port's
objects from plain Python/numpy data that the JAX package's objects
export, so a test can hand both packages the same inputs without the port
importing the other package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.costmodel import (ConfigBatch, HardwareConstants, Op,
                                        OpKind, OpStream)
from repro_torch.core.space import DesignSpace
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import plan_groups

__all__ = ["ops_from_records", "space_from_domains",
           "config_batch_from_matrix", "decoder_params_from_numpy",
           "encdec_params_from_numpy", "tree_from_numpy", "to_port_layout",
           "params_from_numpy", "adamw_state_from_numpy"]


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


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":     # the same bits, reinterpreted
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint8)).view(
            torch.float8_e4m3fn).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map_leaves(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


def to_port_layout(cfg: ArchConfig, tree: Mapping[str, Any],
                   take: Callable[[Any, int], Any]) -> Dict[str, Any]:
    """A tree in the reference's parameter layout for `cfg`'s model, with
    leaves of any kind, in the port's layout.  The encoder-decoder's
    layout is the reference's.  A `DecoderLM` tree, ``{"embed",
    "final_norm", ("lm_head",) "groups": [[unit dicts]]}``, becomes
    ``{"embed", "final_norm", ("lm_head",) "layers": [layer dicts]}``:
    `take(leaf, r)` gives repeat `r` of a leaf stacked on its group's
    repeats (a group of one repeat stacks nothing), every other leaf is
    kept as it is."""
    if cfg.is_encdec:
        return dict(tree)
    out: Dict[str, Any] = {
        k: tree[k] for k in ("embed", "final_norm", "lm_head") if k in tree}
    layers = []
    for g, gparams in zip(plan_groups(cfg), tree["groups"]):
        for r in range(g.repeats):
            for unit in gparams:
                layers.append(unit if g.repeats == 1 else _map_leaves(
                    lambda a, r=r: take(a, r), unit))
    out["layers"] = layers
    return out


def decoder_params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                              device="cpu") -> Dict[str, Any]:
    """The port's `DecoderLM` parameters from a reference `DecoderLM`
    parameter tree with numpy leaves (`to_port_layout`): stacked leaves
    are sliced into one dict per layer; every leaf keeps its layout (`wq`
    is `[d, H*hd]`) and dtype."""
    return _map_leaves(lambda a: _tensor(a, device), to_port_layout(
        cfg, tree, lambda a, r: np.asarray(a)[r]))


def tree_from_numpy(tree: Mapping[str, Any], device="cpu") -> Dict[str, Any]:
    """A nested dict of numpy leaves (bf16 and f8 e4m3 included) as the
    same dict of tensors, every leaf in its layout and dtype: a reference
    `EncDecLM` cache (`k`, `v`, `xk`, `xv` stacked on the layers), or a
    layer's cache of any model."""
    return _map_leaves(lambda a: _tensor(a, device), tree)


def encdec_params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                             device="cpu") -> Dict[str, Any]:
    """The port's `EncDecLM` parameters from a reference `EncDecLM`
    parameter tree with numpy leaves: the same layout (``embed``,
    ``enc_pos``, ``dec_pos``, the ``encoder`` and ``decoder`` stacks with
    their leaves stacked on the layers, the four norm leaves), every leaf
    in its dtype."""
    for stack, n in (("encoder", cfg.encoder_layers),
                     ("decoder", cfg.num_layers)):
        depth = np.shape(tree[stack]["ln1_s"])[0]
        if depth != n:
            raise ValueError(f"{stack}: {depth} stacked layers, the "
                             f"config has {n}")
    return tree_from_numpy(tree, device)


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device="cpu") -> Dict[str, Any]:
    """A reference parameter tree (or any tree of its layout: gradients,
    AdamW moments) with numpy leaves in the port's layout for `cfg`'s
    model: `encdec_params_from_numpy` for the encoder-decoder, else
    `decoder_params_from_numpy`."""
    if cfg.is_encdec:
        return encdec_params_from_numpy(cfg, tree, device)
    return decoder_params_from_numpy(cfg, tree, device)


def adamw_state_from_numpy(cfg: ArchConfig, state: Any, device="cpu"):
    """The port's `AdamWState` from the reference's (its `step`, `mu` and
    `nu` with numpy leaves): the step a 0-d int32 tensor, each moment in
    the port's layout (`params_from_numpy`)."""
    from repro_torch.optim import AdamWState
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        mu=params_from_numpy(cfg, state.mu, device),
        nu=params_from_numpy(cfg, state.nu, device))
