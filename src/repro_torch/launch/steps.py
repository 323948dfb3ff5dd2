"""Step builders of the port: `build_model`, `make_runtime`,
`input_specs`, and the serving steps `make_prefill_step` /
`make_serve_step`.

The reference builds jit-able steps over a device mesh; on one GPU a step
is a plain function that runs eagerly under `torch.inference_mode` and
`layers.full_precision_products`.  The
training step, the mesh and the sharding rules are ported in a later
slice (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (Runtime, full_precision_products,
                                       not_ported)
from repro_torch.models.lm import DecoderLM

__all__ = ["build_model", "make_runtime", "input_specs",
           "make_prefill_step", "make_serve_step"]


def build_model(arch: ArchConfig) -> DecoderLM:
    if arch.is_encdec:
        raise not_ported("EncDecLM")
    return DecoderLM(arch)


def make_runtime(arch: ArchConfig, shape: ShapeSpec, *,
                 use_kernels: bool = False,
                 overrides: Optional[Dict[str, Any]] = None) -> Runtime:
    """Execution point for one (arch, shape) cell.  Serving shapes run
    bf16 weights, as in the reference (half the memory and the bytes of
    every weight read)."""
    kw: Dict[str, Any] = {"use_kernels": use_kernels}
    if shape.mode != "train":
        kw["param_dtype"] = torch.bfloat16
    if overrides:
        kw.update(overrides)
    return Runtime(**kw)


def input_specs(arch: ArchConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input of this cell."""
    B, S = shape.global_batch, shape.seq_len
    if arch.is_encdec:
        raise not_ported("EncDecLM")
    if shape.mode in ("train", "prefill"):
        batch: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
        s_text = S
        if arch.frontend == "vit_stub":
            s_text = S - arch.num_patches
            batch["patch_embeds"] = ((B, arch.num_patches, arch.d_model),
                                     torch.bfloat16)
        batch["tokens"] = ((B, s_text), torch.int64)
        return batch
    # decode: one new token against a seq_len-deep cache
    return {"token": ((B, 1), torch.int64), "pos": ((), torch.int64)}


def make_prefill_step(model: DecoderLM, rt: Runtime) -> Callable:
    def prefill_step(params, batch):
        # the sampler needs only the last position's logits
        with torch.inference_mode(), full_precision_products():
            logits = model.forward(params, batch, rt, last_only=True)
        return logits[:, -1, :]
    return prefill_step


def make_serve_step(model: DecoderLM, rt: Runtime) -> Callable:
    def serve_step(params, cache, token, pos):
        with torch.inference_mode(), full_precision_products():
            return model.decode_step(params, cache, token, pos, rt)
    return serve_step
