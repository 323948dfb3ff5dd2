"""Dry-run of one training or serving step, counted on fake tensors: on
one GPU, or per rank over the reference's production meshes.

For every (architecture x shape) cell, run the cell's step once on fake
tensors (`launch.steps.trace_step`) and record:

  * the FLOPs of the matmul family (`FlopCounterMode`'s formulas) and the
    operand and result bytes of every aten op (an upper bound on traffic);
  * the peak bytes of live storage (proves the step fits the card, or not);
  * over a mesh, the collectives rank 0 takes part in, by kind and result
    bytes;
  * the roofline per card (`core.roofline`), with the analytic traffic
    model as its memory term and the collective bytes over NVLink as its
    collective term, as in the reference.

Nothing is allocated and no kernel runs, so a full-batch 32k prefill is
counted in seconds.  The reference (`repro.launch.dryrun`) compiles each
cell with XLA for a 256- or 512-chip mesh and reads the per-partition
program.  Here `multi_pod=None` counts one card (mesh "1gpu"); `False` /
`True` count rank 0 of the 16x16 (256 ranks) / 2x16x16 (512 ranks) mesh:
`run_cell` makes this process rank 0 of a fake process group of that size
(the "fake" backend: its collectives move nothing), places every argument
of the step as the reference's `in_shardings` (`launch.steps.
step_placements`, under `sharding_mode` and `rule_updates`) and runs the
port's own model code on the DTensors, which lays out its activations at
the reference's `rt.shard` sites.  Each rank's counts are those of its
local shards; per-rank `fits_hbm` is checked against the H100's 80 GB.

A train cell (`train_4k`) counts forward, backward and the AdamW update
under `remat` (the reference's default "full") over `microbatches` (the
reference's `DEFAULT_MICROBATCHES`, cut so that each microbatch still
tiles the batch's shards, as the reference cuts it) at the full batch.
Every cell of every arch is counted, on one card and on both meshes:
the encoder-decoder's (whisper-medium: the encoder at its 1500 frames and
the decoder at the cell's tokens), qwen2.5-32b's decode_32k over the
reference's f8 KV cache (`DEFAULT_SERVE_KV_DTYPE`: the cache at one byte
an element in the peak and in the analytic traffic) and xlstm-1.3b's
train_4k included; failures are recorded as FAILED.  A sub-quadratic
arch's `long_500k` (xlstm-1.3b: one token against a 524,288-token
context) is counted as any decode cell.  A scan over time, chunks or
layers (the xLSTM blocks, the encoder-decoder's layers) runs a few of its
steps and counts one of them for the others (`steps.count_step`), its
backward too in a train step.  Records are written to
`<out>/<cell>.json`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape prefill_32k [--mesh 1gpu|single|multi|both] \\
      [--sharding-mode fsdp|tp] [--device cuda|cpu] [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

`--device` names the fake tensors' device (and the mesh's): `cuda` (the
default) needs a CUDA build of PyTorch and a GPU, as every entry point of
the port does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, shape_by_name
from repro_torch.core.roofline import (HW, analytic_hbm_bytes,
                                       model_flops, roofline_from_totals)
from repro_torch.launch.steps import trace_step

__all__ = ["MESH", "OUT_DIR", "DEFAULT_MICROBATCHES", "mesh_name", "fake_mesh", "cut_microbatches", "run_cell", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH = "1gpu"                          # one card, no mesh
# the reference's fp8 KV cache for archs whose bf16 cache and weights
# exceed its chips' memory at decode_32k
DEFAULT_SERVE_KV_DTYPE = {"qwen2.5-32b": "f8"}
# the reference's gradient-accumulation factors of its train_4k cells
DEFAULT_MICROBATCHES = {
    "qwen2.5-32b": 16, "mistral-nemo-12b": 8, "recurrentgemma-9b": 8,
    "qwen2.5-3b": 4, "deepseek-v2-lite-16b": 2, "olmoe-1b-7b": 2,
    "xlstm-1.3b": 4, "qwen2-0.5b": 2, "internvl2-1b": 2,
    "whisper-medium": 2,
}


def mesh_name(multi_pod: Optional[bool]) -> str:
    """"1gpu", or the reference's "16x16" / "2x16x16"."""
    if multi_pod is None:
        return MESH
    return "2x16x16" if multi_pod else "16x16"


def _register_fake_backend() -> None:
    """Register torch's `FakeProcessGroup` as the "fake" backend, where
    nothing registered it yet (PyTorch ships the class, and registers it
    only from its test helpers)."""
    import torch.distributed as dist
    from torch._C._distributed_c10d import FakeProcessGroup

    if "FAKE" in dist.Backend._plugins:
        return

    def make(common_opts, backend_opts):
        create = getattr(FakeProcessGroup, "_create_internal", None)
        if create is not None:
            return create(common_opts.group_rank, common_opts.group_size,
                          backend_opts)
        return FakeProcessGroup(common_opts.group_rank,
                                common_opts.group_size)

    dist.Backend.register_backend("fake", make, extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_mesh(multi_pod: bool, device: str = "cuda"):
    """The reference's production mesh (`launch.mesh.
    make_production_mesh`) over a fake process group of 256 or 512 ranks
    made in this process, which is rank 0 (the "fake" backend: no
    collective moves a byte).  Refuses if a process group is initialised
    already, and destroys its own on exit."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    if dist.is_initialized():
        raise RuntimeError(
            "a process group is initialised already: the mesh dry-run makes "
            "its own fake group of 256 / 512 ranks and cannot share one")
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type=device)
    finally:
        dist.destroy_process_group()


def cut_microbatches(mesh, shape, microbatches: int) -> int:
    """A train cell's microbatches, cut as the reference cuts them: each
    microbatch still tiles the batch's shards (`microbatches` at most the
    global batch over the product of the batch axes' sizes), one row a
    microbatch at least on one card."""
    n_shards = 1
    if mesh is not None:
        from repro_torch.launch.mesh import batch_axes_for

        names = tuple(mesh.mesh_dim_names)
        for a in batch_axes_for(mesh, shape.global_batch):
            n_shards *= mesh.size(names.index(a))
    return max(1, min(microbatches, shape.global_batch // n_shards))


def run_cell(arch_name: str, shape_name: str, out_dir: Path, *,
             multi_pod: Optional[bool] = None, device: str = "cuda",
             sharding_mode: str = "fsdp", remat: str = "full",
             microbatches: int = 0,
             overrides: Optional[Dict[str, Any]] = None,
             rule_updates: Optional[Dict[str, Any]] = None,
             tag: str = "") -> dict:
    """Count one cell's step and write its record to `out_dir`.

    `multi_pod=None` counts one card (mesh "1gpu"); `False` / `True` count
    rank 0 of 16x16 / 2x16x16 inside `fake_mesh`, with `sharding_mode` and
    `rule_updates` choosing the rules (on one card they change nothing and
    are only recorded).  `overrides` may set `attn_kv_block` (the plain
    attention's KV tile) and `moe_group_size` (the tokens the MoE block
    routes together: its dispatch buffers' size, so the step's peak, and
    with it the capacity a group gives each expert).  A train cell runs
    under `remat` over `microbatches` (0: the reference's
    `DEFAULT_MICROBATCHES`, cut by `cut_microbatches`); neither changes a
    serving cell."""
    mesh_id = mesh_name(multi_pod)
    cell_id = f"{arch_name}_{shape_name}_{mesh_id}{tag}"
    out_path = Path(out_dir) / f"{cell_id}.json"

    shape = shape_by_name(shape_name)
    ok, why = configs.cell_applicable(arch_name, shape)
    if not ok:
        rec = {"cell": cell_id, "status": "SKIPPED", "reason": why}
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[dryrun] {cell_id}: SKIPPED ({why.split(':')[0]})")
        return rec

    arch = configs.get_arch(arch_name)
    if microbatches <= 0:
        microbatches = DEFAULT_MICROBATCHES.get(arch_name, 1) \
            if shape.mode == "train" else 1
    rt_overrides = dict(overrides or {})
    if shape.mode == "decode" and arch_name in DEFAULT_SERVE_KV_DTYPE:
        rt_overrides.setdefault("kv_dtype", DEFAULT_SERVE_KV_DTYPE[arch_name])
    kv_bytes = 1 if rt_overrides.get("kv_dtype") == "f8" else 2
    with (fake_mesh(multi_pod, device) if multi_pod is not None
          else contextlib.nullcontext()) as mesh:
        chips = 1 if mesh is None else mesh.size()
        if shape.mode == "train":
            microbatches = cut_microbatches(mesh, shape, microbatches)
        t0 = time.time()
        try:
            counts, rt = trace_step(arch, shape, device=device,
                                    overrides=rt_overrides, remat=remat,
                                    microbatches=microbatches, mesh=mesh,
                                    sharding_mode=sharding_mode,
                                    rule_updates=rule_updates)
            t_trace = time.time() - t0
            hw = HW()
            # the reference's tensor-parallel width on its meshes (its
            # default `tp`), none on one card
            analytic = analytic_hbm_bytes(
                arch, shape, chips, microbatches=microbatches,
                kv_bytes=kv_bytes, **({"tp": 1} if mesh is None else {}))
            rep = roofline_from_totals(
                arch=arch_name, shape=shape_name, mesh_name=mesh_id,
                chips=chips, flops=counts.flops,
                hbm_bytes=counts.bytes_accessed, coll=counts.collectives,
                peak_bytes=counts.peak_bytes, analytic_bytes=analytic,
                model_flops_total=model_flops(arch, shape), hw=hw)
            where = "rank 0's local shards" if mesh is not None else \
                "one card"
            rec = {
                "cell": cell_id, "status": "OK",
                # nothing is lowered or compiled: the trace is the whole
                # cost
                "lower_s": 0.0, "compile_s": round(t_trace, 2),
                "total_s": round(time.time() - t0, 2),
                "memory_analysis": (
                    f"peak live storage {counts.peak_bytes} bytes (params, "
                    f"inputs and caches included) on {where}, fake "
                    f"{device} tensors"),
                "fits_hbm": bool(counts.peak_bytes <= hw.hbm_bytes),
                "roofline": rep.to_json(), "analytic_bytes": analytic,
                "probes": [],
                "config": {"sharding_mode": sharding_mode, "remat": remat,
                           "microbatches": microbatches,
                           "overrides": overrides or {},
                           "rule_updates": {k: str(v) for k, v in
                                            (rule_updates or {}).items()}},
                "device": device,
                "runtime": {"param_dtype": str(rt.param_dtype),
                            "compute_dtype": str(rt.compute_dtype),
                            "attn_kv_block": rt.attn_kv_block,
                            "moe_group_size": rt.moe_group_size,
                            "kv_dtype": rt.kv_dtype, "kv_bytes": kv_bytes,
                            "remat": rt.remat,
                            "use_kernels": rt.use_kernels},
                "flops_by_op": counts.flops_by_op,
                "matmul_flops": counts.matmul_flops,
                "elementwise_flops": counts.elementwise_flops,
                "transcendentals": counts.transcendentals,
            }
            if mesh is not None:
                rec.update({
                    "mesh": mesh_id, "chips": chips,
                    "arg_bytes_per_chip": counts.arg_bytes,
                    "collectives": {
                        "by_kind": dict(counts.collectives.by_kind),
                        "count": counts.collectives.count}})
            print(f"[dryrun] {cell_id}: OK "
                  f"peak={counts.peak_bytes/1e9:.2f}GB "
                  f"trace={t_trace:.1f}s  {rep.row()}")
        except Exception as e:   # noqa: BLE001 — record it, keep going
            rec = {"cell": cell_id, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"[dryrun] {cell_id}: FAILED {type(e).__name__}: {e}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


MESH_CHOICES = {"1gpu": [None], "single": [False], "multi": [True],
                "both": [False, True]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=list(configs.ARCH_NAMES))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) cell")
    ap.add_argument("--mesh", choices=list(MESH_CHOICES), default="1gpu",
                    help="1gpu (default): one card; single / multi / both: "
                         "rank 0 of 16x16, of 2x16x16, or of each")
    ap.add_argument("--sharding-mode", default="fsdp",
                    choices=["fsdp", "tp"])
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default; fails "
                         "without a GPU) or cpu")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU "
                           "(torch.cuda.is_available() is False); pass "
                           "--device cpu to count on fake CPU tensors")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s.name) for a in configs.ARCH_NAMES for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    n_fail = 0
    for arch_name, shape_name in cells:
        for multi_pod in MESH_CHOICES[args.mesh]:
            rec = run_cell(arch_name, shape_name, out_dir,
                           multi_pod=multi_pod, device=args.device,
                           sharding_mode=args.sharding_mode,
                           remat=args.remat)
            n_fail += rec["status"] == "FAILED"
    print(f"[dryrun] done; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
