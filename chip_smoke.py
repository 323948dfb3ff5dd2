#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc` (one
nvcc per source, all started together), then runs these phases in order,
printing one JSON line each:

  1. device      the card, its power limit, the nvcc build time, each
                 kernel's registers, spills and ptxas warnings, and the
                 HGMMA instructions of each flash and matmul kernel
                 (`cuobjdump`);
  2. kernel gather_rows
                 `gather_rows` against its plain PyTorch version on the
                 card (the five screen tables of all seven paper apps and a
                 random float64 table; pools of 4097, 65536 and 262144;
                 out-of-range indices), bit-equal, with CUDA-event times of
                 the kernel, the plain version and `torch.index_select`;
  3. scorer      `FusedTorchScorer` on the card against the same scorer on
                 the CPU, all seven apps, 65536-config pools;
  4. study       the main path: a seven-app `GeomeanAcrossApps` greedy
                 `Study` on the card and on the CPU must select the same
                 config, with the kernel launched and jax never imported;
  5. study zoo   the model-zoo frontend on the main path: the twelve zoo
                 apps of the six ported archs traced on meta tensors (each
                 app's seconds and compute ops), a twelve-app
                 `GeomeanAcrossApps` greedy `Study` on the card and on the
                 CPU selecting the same config and per-app bests (the
                 kernel launched on the card only, neither jax nor the JAX
                 package imported), then the genetic and anneal engines on
                 qwen2-0.5b:prefill on both, each with the same best;
  6. study pareto
                 the analysis API on the main path: `evaluate_stream_many`'s
                 broadcast pass on the card against the numpy oracle
                 (`backend="numpy-ref"`, in worker processes) bit for bit
                 (total cycles, validity and the five [C, O] parts) on the
                 seven paper apps and two traced zoo apps at pools of 4097
                 and 65536 from the Table-2 space (peaks on and off, every
                 loop order), at 262144 (cycles and validity) on inception
                 and qwen2-0.5b:prefill, and on a stream with a zero-size
                 kernel; its time against `FusedTorchScorer.metrics` on the
                 same pools and its peak memory; then a
                 `ParetoObjective(["perf", "-area"])` study over ptb and wdl
                 with genetic and with nsga2 at three area budgets, on the
                 card (telemetry on and off: the same JSON; trace and
                 journal validated) and on the CPU, the same front and
                 selections, the kernel launched on the card only;
                 `Evaluator.explain` of the selection and the §5.3 radar
                 (resnet, the four Faster R-CNN steps) equal on both;
  7. study parallel
                 the parallel, resumable and composed `Study` on the card:
                 phase 4's seven-app greedy study at workers=4 (a spawn
                 pool; every worker scores on the card and reports its own
                 gather_rows launches) byte-equal to workers=1 and
                 selecting what the CPU selects; a random study over ptb +
                 wdl crashed at its first checkpoint and resumed at
                 workers=2, and a checkpoint written on the CPU resumed on
                 the card, each equal to the uninterrupted run; a killed
                 pool worker (one retry round, no degradation); and
                 `benchmarks/composition_sweep.py`'s configuration (K=2
                 over qwen2-0.5b prefill + decode, genetic, 90,000 area)
                 byte-identical at workers 1 and 2, equal to the CPU's,
                 beating the monolithic design, with `explain_composition`
                 equal on both devices.  A `ParallelExecutionWarning` is an
                 error; each run's wall, the pool start-up times and the
                 launches are printed;
  8. throughput  the random engine at 262144-config pools on inception and
                 nasnet, on the card, with where the time goes: the scorer's
                 device time by kind (`torch.profiler`) and the search's
                 host time by function (`cProfile`, one round);
  9. kernel flash_attention
                 `flash_attention` against its plain PyTorch version, every
                 output element within a tolerance of about one bf16 ulp, on
                 the sweep of `tests/test_kernels.py`, on qwen2-0.5b's heads
                 at S = 512 to 32768, on recurrentgemma-9b's (head dim 256)
                 and on mistral-nemo-12b's (32 heads on 8 KV heads of 128)
                 (causal Sq != Skv included, the prefills' shapes on random
                 inputs): bf16 at head dims 64-256 runs the tensor-core
                 kernel, fp32 and bf16 at 16-32 the CUDA-core one.  Then
                 CUDA-event times of the kernel, of
                 `scaled_dot_product_attention` and of the plain version,
                 each row with the kernel that ran, its TFLOP/s and its
                 share of the bound;
 10. kernel rglru_scan
                 the bare scan (the channel-slab walk) against its plain
                 PyTorch version, every element, on the sweep of
                 `tests/test_kernels.py` (the 1024-step decay case and
                 bf16 included) and on the recurrentgemma prefill's two
                 shapes, with CUDA-event times of it and the plain
                 version;
                 `rglru_gated_scan` against its plain version on the same
                 shapes (head-major and contiguous gate logits, bf16 and
                 fp32 gates and outputs, the long-memory end of the decay)
                 and timed at the two prefill shapes in the model's
                 dtypes; then one full-width RG-LRU block by the route
                 before the gated kernel (the bare scan's path) and by the
                 gated kernel, each call's launches counted from 0, each
                 route timed and split by `torch.profiler`;
 11. prefill qwen2-0.5b
                 the second main path: `make_prefill_step` at full width
                 (24 layers, bf16 weights, `use_kernels=True`) at seq 32768
                 x batch 1 (prefill_32k with its batch cut from 32) and seq
                 2048 x batch 4, held against the same step through the
                 plain paths (logits and next token), with 24 kernel
                 launches a forward, every one on the tensor cores (and
                 none of `matmul`, counted); then the kernel against its
                 plain version on the q, k, v that the first and the last
                 layer hand it at both shapes, every row;
 12. serve qwen2-0.5b
                 `serve_requests` at full width (fp32 compute): 8 requests
                 of 4-12 prompt tokens, batch 4, 16 new tokens each, held
                 against the port's own CPU run on the same weights;
 13. prefill recurrentgemma-9b
                 the third main path, as phase 11 at the same two shapes (38
                 layers: 26 RG-LRU, 12 local attention): 26
                 `rglru_gated_scan` launches a forward at both shapes (and
                 no bare scan), 12 `flash_attention` (on
                 the tensor cores) at seq 2048 (S <= the 2048 window) and
                 none at 32768 (local-block attention); then each kernel
                 against its plain version on what the first and last
                 layer of its kind hand it;
 14. serve recurrentgemma-9b
                 `serve_requests` at full width, fp32 compute: 8 requests of
                 4-12 prompt tokens, batch 4, 16 new tokens, caches of 256,
                 held against a teacher-forced full-sequence forward on the
                 card (fp32, `use_kernels=True`: its attention on the
                 CUDA-core flash kernel only) over each request's prompt
                 and generated tokens;
 15. kernel matmul
                 `matmul` against its plain PyTorch version on every element,
                 within the fp32 summation bound (`matmul_against_plain`),
                 on the sweep of `tests/test_kernels.py` at its two tiles
                 (fp32 on the CUDA-core kernel, bf16 on the tensor-core
                 one: each case must move only its kernel's counter) and on
                 an all-positive bf16 product at K = 12288, both output
                 dtypes (phase 16 holds the tile DSE's shapes, at every
                 tile);
 16. tile_dse    the fourth main path: for each of `TILE_SHAPES` (bf16),
                 `tune_matmul_tiles` picks a tile under the tensor-core
                 model and `matmul` runs at it and at every other tile the
                 tensor-core kernel is built for, each output held against
                 the plain version; predicted and measured time per tile,
                 their rank correlation, the tuned tile's regret against
                 the fastest, its share of the bound, and CUDA-event times
                 of the plain version and `torch.matmul`; the LM-head shape
                 (M N > 2^31) runs once, at its tuned tile.  Then the fp32
                 `FP32_SHAPE` on the CUDA-core kernel at the CUDA-core
                 model's pick, beside its 67 TFLOP/s bound;
 17. dryrun      `run_cell` for qwen2-0.5b and recurrentgemma-9b at
                 prefill_32k and decode_32k on fake CUDA tensors (full batch),
                 each cell's matmul and elementwise FLOPs and
                 transcendentals, one greedy `autotune_search` over
                 qwen2-0.5b's decode_32k (a cell whose points fit 80 GB;
                 every record it writes must be OK with a finite peak and
                 roofline, and its best score above 0; whether its pick
                 moved from `MATMUL_ONLY_PICK`), one random-engine
                 `autotune_search` (the evaluator-mode `Study`) over the
                 same cell, and qwen2-0.5b's plain
                 prefill at seq 2048 x batch 4 counted on fake tensors and
                 run for real on the card: the three counts equal, and the
                 fake peak within `DRYRUN_PEAK_BAND` of
                 `max_memory_allocated`.

Then the card's name and power limit as `nvidia-smi` gives them, a
`{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`.  Any
failure exits non-zero before the last line.  Without a GPU, or without
the repository's `src/` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import multiprocessing
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet: 3.35 TB/s of HBM3, 989 TFLOP/s dense bf16
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# fp32 outside the tensor cores (the fp32 paths stay free of TF32)
FP32_FLOP_PER_S = 67e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/gather_rows.cu"
TPU_KERNEL = "src/repro/kernels/costmodel.py:57"
POOLS = (4097, 65536, 262144)
TIMED_POOLS = (65536, 262144)
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py:78"
# |kernel - plain| <= atol + rtol * |plain|, element by element, as
# (atol, rtol).  Both compute in fp32 (scores, p, accumulator) and differ
# in summation order only, then round the output to the inputs' dtype:
# bf16 may land one bf16 ulp apart, at most 2^-7 of the value; atol is
# the fp32 floor for outputs near zero, where the relative term vanishes.
FLASH_TOL = {torch.float32: (2e-6, 2e-5), torch.bfloat16: (2e-6, 2 ** -7)}
# query rows of the plain version per call on long sequences, so that its
# [B, KV, G, rows, Skv] fp32 scores stay a few GB
PLAIN_ROWS = 1024
RGLRU_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
RGLRU_TPU = "src/repro/kernels/rg_lru.py:54"
# |kernel - plain| <= atol + rtol * |plain|, element by element.  Both
# compute in fp32 and differ only in how the recurrence is composed: the
# kernel steps it in order, the plain version composes it by doubling.  fp32 rounding gaps grow as 1 / (1 - a) on
# slow decays (the a = 0.999 case reads about 5e-6 relative); bf16 output
# may land one bf16 ulp apart, at most 2^-7 of the value.
RGLRU_TOL = {torch.float32: (2e-6, 2e-5), torch.bfloat16: (2e-6, 2 ** -7)}
# rglru_gated_scan against rglru_gated_scan_plain, element by element,
# |kernel - plain| <= atol + rtol |plain|: the scan's RGLRU_TOL[float32]
# (the kernel steps the recurrence, the plain version composes it by
# doubling), its rtol widened by 8 fp32 ulps (2^-20) for the card's expf,
# log1pf and tanhf and nvcc's FMA contractions against PyTorch's compiled
# kernels of the same functions (the odd last bit of a, b or gelu(gate));
# a bf16 y may land one bf16 ulp further, as it rounds once
GATED_TOL = (RGLRU_TOL[torch.float32][0],
             RGLRU_TOL[torch.float32][1] + 2 ** -20)
# fp32 operations of rglru_gated_scan an element, each transcendental one:
# two sigmoids (add, exp, add, divide: 8), log_a 1, exp 1, 2 log_a 1,
# exp 1, 1 - e 1, max 1, sqrt 1, i xc 1, beta (.) 1, the scan's FMA 2,
# gelu_tanh 9, h g 1
GATED_OPS = 29
RGLRU_LIBRARY = ("none: no single PyTorch call computes h_t = a_t h_{t-1} "
                 "+ b_t; a cumprod/cumsum rewrite divides by products of a "
                 "that vanish, so it is not the same function")
ARCH = "qwen2-0.5b"
RG_ARCH = "recurrentgemma-9b"
# prefill logits, kernel path against the plain path, both bf16:
# |a - b| <= PREFILL_TOL * (1 + |b|), about 4x the largest gap measured
# (0.0054 on the H100 for qwen2-0.5b); the blocked path also rounds p to
# bf16.  A next token may differ only where the plain path's top-1 margin
# is within that tolerance: then either token is the model's.
PREFILL_TOL = 0.02
# served logits, card against CPU, fp32 with TF32 off: the only gap is the
# summation order, plus the odd K/V entry that rounds to the other bf16
# neighbour in the cache; |a - b| <= SERVE_TOL * (1 + |b|)
SERVE_TOL = 2e-3
# recurrentgemma's decode logits against its full-sequence forward, both
# fp32 on the card: the decode path keeps K and V in a bf16 cache, the
# forward does not; (atol, rtol) of tests/test_decode_parity.py
SERVE_RG_TOL = (5e-3, 2e-2)
MATMUL_SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
MATMUL_TPU = "src/repro/kernels/matmul.py:42"
# the tile DSE's shapes (M, K, N), bf16: the reference quickstart's
# product, qwen2-0.5b's MLP up-projection over a 32k prefill,
# recurrentgemma-9b's up and down projections, a decode-like product, and
# qwen2-0.5b's tied LM head over all 32k positions (M N > 2^31), run once
TILE_SHAPES = {"quickstart 8192^3": (8192, 8192, 8192),
               "qwen2-0.5b mlp up, 32k": (32768, 896, 4864),
               "recurrentgemma-9b up, 32k": (32768, 4096, 12288),
               "recurrentgemma-9b down, 32k": (32768, 12288, 4096),
               "decode-like": (128, 4096, 12288),
               "qwen2-0.5b lm head, 32k": (32768, 896, 151936)}
ONCE = "qwen2-0.5b lm head, 32k"
# the all-positive bf16 product of the matmul phase (K of the longest
# tuned shape)
POSITIVE_SHAPE = (1024, 12288, 1024)
# the fp32 product the tile DSE tunes for the CUDA-core kernel
FP32_SHAPE = (8192, 8192, 8192)
# the greedy autotune's pick of qwen2-0.5b's decode_32k when the dry-run
# counted the matmul family's FLOPs only: the dry-run phase records whether
# counting the elementwise FLOPs moved it
MATMUL_ONLY_PICK = {"sharding_mode": "fsdp", "remat": "full",
                    "microbatches": 1, "attn_kv_block": 1024,
                    "moe_group_size": 4096, "extra_rules": []}
# output elements of the plain version per chunk on the largest shapes
MATMUL_CHUNK = 1 << 28
# the dry-run's peak of qwen2-0.5b's plain prefill at 2048 x 4 against the
# card's max_memory_allocated of the same step: real / fake must lie in
# this band (the card adds allocator rounding and cuBLAS workspaces)
DRYRUN_PEAK_BAND = (0.9, 1.25)
# phase study pareto: the analysis API's broadcast pass against the numpy
# oracle, at the paper apps and two traced zoo apps
BROADCAST_POOLS = (4097, 65536)
BROADCAST_BIG = 262144
BROADCAST_BIG_APPS = ("inception", "qwen2-0.5b:prefill")
BROADCAST_ZOO = ("qwen2-0.5b:prefill", "recurrentgemma-9b:decode")
BROADCAST_TIMED = "inception"
# the numpy oracle is host-bound: it runs in worker processes, each in row
# chunks (rows are independent, so chunks change no bit)
ORACLE_WORKERS = 7
ORACLE_CHUNK = 16384
PARETO_BUDGETS = (30000.0, 60000.0, 90000.0)
# phase study parallel: benchmarks/composition_sweep.py's apps and budget
COMP_APPS = ("qwen2-0.5b:prefill", "qwen2-0.5b:decode")
COMP_AREA = 90000.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def check_isolated() -> None:
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    check(not leaked, f"the port imported {leaked[:5]}")


def device_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over `reps` of the mean device time of `inner` back-to-back
    calls, from CUDA events.  A sleep kernel queued first keeps the device
    busy while the host enqueues, so host launch overhead is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def screen_tables(t) -> dict:
    return {"u1_tbl": t.u1_tbl, "u2_tbl": t.u2_tbl, "u3_tbl": t.u3_tbl,
            "wt_tile": np.ascontiguousarray(t.wt_tbl[1]),
            "atile_tbl": t.atile_tbl}


def phase_kernel(specs, space, rng) -> dict:
    """Kernel against its plain version at the main path's shapes."""
    from repro_torch.core.costmodel import _fused_tables_for
    from repro_torch.kernels.gather import gather_rows, gather_rows_plain

    cases = []
    for spec in specs:
        t = _fused_tables_for(spec.stream, space.hw, space.domains)
        for name, tbl in screen_tables(t).items():
            cases.append((f"{spec.name}.{name}", tbl))
    cases.append(("random_float64", rng.standard_normal((2304, 44))))

    checked, max_err = 0, 0.0
    for label, tbl in cases:
        table = torch.from_numpy(np.ascontiguousarray(tbl)).cuda()
        u = table.shape[0]
        for c in POOLS:
            idx = torch.from_numpy(rng.integers(-3, u + 3, size=c)).cuda()
            got = gather_rows(table, idx)
            want = gather_rows_plain(table, idx)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"gather_rows != plain on {label} at C={c}")
            max_err = max(max_err, float((got.double() - want.double())
                                         .abs().max()))
            checked += 1

    # times on the largest screen table (inception's Eq. 12 tile table)
    # and on a float64 table of the same shape
    table = torch.from_numpy(np.ascontiguousarray(
        dict(cases)["inception.atile_tbl"])).cuda()
    ftable = torch.from_numpy(rng.standard_normal(tuple(table.shape))).cuda()
    u, o = table.shape
    timings = {}
    for c in TIMED_POOLS:
        idx = torch.from_numpy(rng.integers(0, u, size=c)).cuda()
        row = {"C": c, "U": int(u), "O": int(o)}
        for tag, tbl in (("int64", table), ("float64", ftable)):
            row[f"{tag}_kernel_ms"] = device_ms(lambda: gather_rows(tbl, idx))
            row[f"{tag}_plain_ms"] = device_ms(
                lambda: gather_rows_plain(tbl, idx))
            row[f"{tag}_library_ms"] = device_ms(
                lambda: torch.index_select(tbl, 0, idx))
        # each input read once (table, indices), the output written once
        nbytes = (c * o + c + u * o) * 8
        row["bytes"] = nbytes
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        timings[str(c)] = row
    emit("kernel gather_rows", cases=checked, tables=len(cases),
         bit_equal=True, max_abs_err=max_err, timings=timings,
         timing_launches=gather_rows.launches)
    return {"max_abs_err": max_err, "timings": timings}


def phase_scorer(specs, space, rng) -> None:
    """The scorer on the card against the same scorer on the CPU."""
    from repro_torch.core.costmodel import ConfigBatch
    from repro_torch.kernels.costmodel import FusedTorchScorer

    per_app = {}
    for spec in specs:
        raw = space.decode_batch(space.sample_indices(rng, 32768))
        scaled = spec.peak_input_bits * int(spec.stream.batch.max())
        fixed = space.repair_for_peaks_many(
            space.decode_batch(space.sample_indices(rng, 32768)),
            spec.peak_weight_bits, scaled)
        pool = ConfigBatch.concat([raw, fixed]).matrix
        out, secs = {}, {}
        for dev in ("cpu", "cuda"):
            sc = FusedTorchScorer(spec.stream, space.hw,
                                  spec.peak_weight_bits, spec.peak_input_bits,
                                  domains=space.domains, device=dev)
            sc.metrics(pool[:4096])                       # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[dev] = sc.metrics(pool)
            secs[dev] = time.perf_counter() - t0
        (g_cpu, a_cpu), (g_gpu, a_gpu) = out["cpu"], out["cuda"]
        check(np.array_equal(g_cpu > 0, g_gpu > 0),
              f"scorer validity differs between cuda and cpu on {spec.name}")

        def rel(a, b):
            return float(np.max(np.abs(a - b)
                                / np.maximum(np.abs(a), 1e-300)))

        gops_rel, area_rel = rel(g_cpu, g_gpu), rel(a_cpu, a_gpu)
        check(gops_rel <= 1e-12 and area_rel <= 1e-12,
              f"scorer differs on {spec.name}: gops {gops_rel}, "
              f"area {area_rel}")
        per_app[spec.name] = {
            "pool": int(pool.shape[0]), "valid": int((g_gpu > 0).sum()),
            "gops_max_rel": gops_rel, "area_max_rel": area_rel,
            "bit_equal": bool(np.array_equal(g_cpu, g_gpu)
                              and np.array_equal(a_cpu, a_gpu)),
            "cuda_s": secs["cuda"], "cpu_s": secs["cpu"]}
    emit("scorer", apps=per_app)


def phase_study(names) -> int:
    """The main path on the card and on the CPU; returns the kernel's
    launches during the card run."""
    from repro_torch.dse import GeomeanAcrossApps, SearchBudget, Study
    from repro_torch.kernels.gather import gather_rows

    runs = {}
    for dev in ("cuda", "cpu"):
        study = Study(apps=list(names), objective=GeomeanAcrossApps(),
                      engine="greedy",
                      budget=SearchBudget(k=2, restarts=2, max_rounds=6),
                      seed=0, device=dev)
        gather_rows.launches = 0
        t0 = time.perf_counter()
        result = study.run()
        torch.cuda.synchronize()
        # the searches' scorer calls (their evaluators' batches) and the
        # synthesis's, on the study's own evaluators
        runs[dev] = {
            "result": result, "seconds": time.perf_counter() - t0,
            "launches": gather_rows.launches,
            "scorer_calls": sum(s["batches"]
                                for s in study._run_stats.values())
            + sum(ev.scorer.n_calls for ev in study._evaluators)}
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(gpu["result"].best == cpu["result"].best,
          "the cuda and cpu studies selected different configs")
    check(gpu["result"].per_app == cpu["result"].per_app,
          "the cuda and cpu studies found different per-app bests")
    check(gpu["launches"] > 0, "the cuda study never launched gather_rows")
    check(cpu["launches"] == 0, "gather_rows launched on the cpu study")
    check(gpu["scorer_calls"] > 0, "the cuda study never called the scorer")
    check_isolated()
    emit("study", apps=list(names), selected=gpu["result"].best.asdict(),
         same_selection=True, best_score=gpu["result"].best_score,
         cuda_s=gpu["seconds"], cpu_s=cpu["seconds"],
         gather_rows_launches=gpu["launches"],
         scorer_calls=gpu["scorer_calls"])
    return gpu["launches"]


def phase_study_zoo() -> dict:
    """The main path over the traced zoo apps: the twelve apps of the six
    ported archs, the greedy geomean study on the card and on the CPU, then
    the genetic and anneal engines on one app on both.  Returns the
    kernel's launches on each card run."""
    from repro_torch.core.apps import build_app
    from repro_torch.core.multiapp import AppSpec
    from repro_torch.core.search import optimize_for_app
    from repro_torch.core.space import default_space
    from repro_torch.dse import GeomeanAcrossApps, SearchBudget, Study
    from repro_torch.frontend.zoo import PORTED_ARCHS, ZOO_VARIANTS
    from repro_torch.kernels.gather import gather_rows

    names = [f"{a}:{v}" for a in PORTED_ARCHS for v in ZOO_VARIANTS]
    traced = {}
    for name in names:
        t0 = time.perf_counter()
        ops = len(build_app(name).op_stream())
        traced[name] = {"seconds": time.perf_counter() - t0,
                        "compute_ops": ops}
        check(ops > 0, f"the zoo app {name} traced no compute op")
    runs = {}
    for dev in ("cuda", "cpu"):
        study = Study(apps=names, objective=GeomeanAcrossApps(),
                      engine="greedy",
                      budget=SearchBudget(k=2, restarts=2, max_rounds=6),
                      seed=0, device=dev)
        gather_rows.launches = 0
        t0 = time.perf_counter()
        result = study.run()
        torch.cuda.synchronize()
        runs[dev] = {"result": result, "seconds": time.perf_counter() - t0,
                     "launches": gather_rows.launches}
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(gpu["result"].best == cpu["result"].best,
          "the cuda and cpu zoo studies selected different configs")
    check(gpu["result"].per_app == cpu["result"].per_app,
          "the cuda and cpu zoo studies found different per-app bests")
    check(gpu["launches"] > 0, "the cuda zoo study never launched "
          "gather_rows")
    check(cpu["launches"] == 0, "gather_rows launched on the cpu zoo study")
    app = "qwen2-0.5b:prefill"
    spec = AppSpec.from_app(app)
    engines = {}
    for engine in ("genetic", "anneal"):
        res = {}
        for dev in ("cuda", "cpu"):
            gather_rows.launches = 0
            t0 = time.perf_counter()
            r = optimize_for_app(
                spec.stream, default_space(), engine=engine, k=2,
                restarts=2, seed=0, max_rounds=6, device=dev,
                peak_weight_bits=spec.peak_weight_bits,
                peak_input_bits=spec.peak_input_bits,
                engine_kwargs={"population": 64, "chains": 8})
            torch.cuda.synchronize()
            res[dev] = {"r": r, "seconds": time.perf_counter() - t0,
                        "launches": gather_rows.launches}
        check(res["cuda"]["r"].best.asdict() == res["cpu"]["r"].best.asdict()
              and res["cuda"]["r"].best_perf == res["cpu"]["r"].best_perf,
              f"{engine} found different bests on the cuda and the cpu")
        check(np.array_equal(res["cuda"]["r"].evaluated_perf,
                             res["cpu"]["r"].evaluated_perf),
              f"{engine} scored differently on the cuda and the cpu")
        check(res["cuda"]["launches"] > 0 and res["cpu"]["launches"] == 0,
              f"{engine} launched gather_rows "
              f"{res['cuda']['launches']} / {res['cpu']['launches']} times "
              "on the cuda / the cpu")
        engines[engine] = {
            "best_perf": res["cuda"]["r"].best_perf,
            "evaluated": len(res["cuda"]["r"].evaluated),
            "cuda_s": res["cuda"]["seconds"], "cpu_s": res["cpu"]["seconds"],
            "gather_rows_launches": res["cuda"]["launches"]}
    check_isolated()
    emit("study zoo", apps=traced,
         trace_s=sum(t["seconds"] for t in traced.values()),
         selected=gpu["result"].best.asdict(), same_selection=True,
         best_score=gpu["result"].best_score,
         per_app_best={a: r["best_perf"]
                       for a, r in gpu["result"].per_app.items()},
         cuda_s=gpu["seconds"], cpu_s=cpu["seconds"],
         gather_rows_launches=gpu["launches"], engines={app: engines})
    return {"study": gpu["launches"],
            **{e: r["gather_rows_launches"] for e, r in engines.items()}}


class Digest:
    """sha256 of the bytes of each array `evaluate_stream_many` returns
    (total cycles, validity and the five parts), fed row chunk by row
    chunk: the chunks of a C-order [C, O] array concatenate to its bytes,
    so a whole array and its chunks digest alike."""

    KEYS = ("cycles", "valid", "compute", "weight", "input", "total",
            "valid_ops")

    def __init__(self):
        self.h = {k: hashlib.sha256() for k in self.KEYS}

    def update(self, out) -> None:
        arrays = {"cycles": out[0], "valid": out[1], **(out[2] or {})}
        for k, a in arrays.items():
            self.h[k].update(np.ascontiguousarray(a).data)

    def hexdigest(self) -> dict:
        return {k: h.hexdigest() for k, h in self.h.items()}


def oracle_digest(task) -> tuple:
    """The numpy oracle (`backend="numpy-ref"`) in a worker process: its
    `Digest` and its host seconds."""
    from repro_torch.core.costmodel import ConfigBatch, evaluate_stream_many
    matrix, stream, hw, pw, pi, with_parts = task
    digest = Digest()
    t0 = time.perf_counter()
    for lo in range(0, matrix.shape[0], ORACLE_CHUNK):
        digest.update(evaluate_stream_many(
            ConfigBatch(matrix[lo:lo + ORACLE_CHUNK]), stream, hw, pw, pi,
            backend="numpy-ref", with_parts=with_parts))
    return digest.hexdigest(), time.perf_counter() - t0


def call_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call that ends in a copy to the host
    (so each call synchronises), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def broadcast_cases(space, rng) -> tuple:
    """The pools by size, and (label, matrix, stream, pw, pi, with_parts)
    of every check of the broadcast pass against the oracle."""
    from repro_torch.core.costmodel import Op, OpKind, OpStream
    from repro_torch.core.apps import APP_NAMES
    from repro_torch.core.multiapp import AppSpec

    specs = [AppSpec.from_app(n) for n in APP_NAMES + BROADCAST_ZOO]
    pools = {n: space.decode_batch(space.sample_indices(rng, n)).matrix
             for n in BROADCAST_POOLS + (BROADCAST_BIG,)}
    cases = []
    for spec in specs:
        peaks = (spec.peak_weight_bits, spec.peak_input_bits)
        for n in BROADCAST_POOLS:
            cases.append((f"{spec.name} C={n} peaks", pools[n], spec.stream,
                          *peaks, True))
        cases.append((f"{spec.name} C={BROADCAST_POOLS[0]} no peaks",
                      pools[BROADCAST_POOLS[0]], spec.stream, 0, 0, True))
        if spec.name in BROADCAST_BIG_APPS:
            cases.append((f"{spec.name} C={BROADCAST_BIG} peaks",
                          pools[BROADCAST_BIG], spec.stream, *peaks, False))
    # a zero-size kernel and a zero stride: the fused scorer refuses it
    zero = OpStream([Op(OpKind.CONV2D, 16, 12, 12, 0, 0, 32, 12, 12),
                     Op(OpKind.CONV2D, 8, 9, 9, 3, 3, 8, 4, 4, s=0),
                     Op.matmul(64, 32, 48)])
    cases.append((f"zero-size kernel and stride C={BROADCAST_POOLS[0]}",
                  pools[BROADCAST_POOLS[0]], zero, 1 << 10, 1 << 10, True))
    return pools, cases


def phase_study_pareto() -> int:
    """The analysis API on the card: `evaluate_stream_many`'s broadcast
    pass bit for bit against the numpy oracle, its time against the fused
    scorer's, then Pareto studies, `explain` and the radar on the card and
    on the CPU.  Returns the kernel's launches in the card's studies."""
    from repro_torch import obs
    from repro_torch.core import apps
    from repro_torch.core.costmodel import (ConfigBatch, evaluate_stream_many,
                                            performance_gops)
    from repro_torch.core.multiapp import AppSpec
    from repro_torch.core.sensitivity import (radar_of_top_configs,
                                              sensitivity_study)
    from repro_torch.core.space import default_space
    from repro_torch.dse import ParetoObjective, SearchBudget, Study
    from repro_torch.kernels.costmodel import FusedTorchScorer
    from repro_torch.kernels.gather import gather_rows
    from repro_torch.obs.validate import validate_chrome_trace, \
        validate_journal

    t_phase = time.perf_counter()
    space = default_space()
    pools, cases = broadcast_cases(space, np.random.default_rng(5))
    check(set(np.unique(pools[BROADCAST_POOLS[0]][:, 0]).tolist())
          == {0, 1, 2, 3}, "the pool misses a loop order")
    check(not FusedTorchScorer.supports(cases[-1][2]),
          "the fused scorer takes the zero-size stream")
    ctx = multiprocessing.get_context("spawn")
    broadcast, timed = {}, {}
    # the longest oracle runs (configs x ops) start first
    order = sorted(range(len(cases)),
                   key=lambda i: -cases[i][1].shape[0] * len(cases[i][2]))
    with ctx.Pool(ORACLE_WORKERS) as pool:
        pending = pool.map_async(
            oracle_digest, [(m, st, space.hw, pw, pi, parts) for
                            _, m, st, pw, pi, parts in (cases[i]
                                                        for i in order)],
            chunksize=1)
        # the broadcast pass on the card while the oracle runs on the host
        for label, m, stream, pw, pi, parts in cases:
            digest = Digest()
            digest.update(evaluate_stream_many(
                ConfigBatch(m), stream, space.hw, pw, pi,
                with_parts=parts, device="cuda"))
            broadcast[label] = digest.hexdigest()
            # dtypes and values on a slice, in this process
            head = ConfigBatch(m[:64])
            want = evaluate_stream_many(head, stream, space.hw, pw, pi,
                                        backend="numpy-ref")
            got = evaluate_stream_many(head, stream, space.hw, pw, pi,
                                       device="cuda")
            for k in want[2]:
                check(got[2][k].dtype == want[2][k].dtype
                      and np.array_equal(got[2][k], want[2][k]),
                      f"broadcast part {k} differs on {label}")
        oracle = dict(zip(order, pending.get()))
    oracle_s = time.perf_counter() - t_phase
    checked = {}
    for i, (label, m, stream, *_) in enumerate(cases):
        digest, secs = oracle[i]
        differ = [k for k in Digest.KEYS
                  if broadcast[label][k] != digest[k]]
        check(not differ, f"broadcast != numpy-ref on {label}: {differ}")
        checked[label] = {"ops": len(stream), "oracle_s": secs}

    # times: the broadcast pass (cycles and validity only), the fused
    # scorer on the same pool, and the oracle's host seconds
    for name in (BROADCAST_TIMED, BROADCAST_BIG_APPS[-1]):
        spec = AppSpec.from_app(name)
        scorer = FusedTorchScorer(spec.stream, space.hw,
                                  spec.peak_weight_bits,
                                  spec.peak_input_bits,
                                  domains=space.domains, device="cuda")
        sizes = (BROADCAST_POOLS + (BROADCAST_BIG,)
                 if name == BROADCAST_TIMED else (BROADCAST_BIG,))
        for n in sizes:
            m = pools[n]
            batch = ConfigBatch(m)

            def twin():
                return evaluate_stream_many(
                    batch, spec.stream, space.hw, spec.peak_weight_bits,
                    spec.peak_input_bits, with_parts=False, device="cuda")

            twin_ms = call_ms(twin)
            torch.cuda.reset_peak_memory_stats()
            twin()
            peak = torch.cuda.max_memory_allocated()
            fused_ms = call_ms(lambda: scorer.metrics(m))
            gops = performance_gops(batch, spec.stream, space.hw,
                                    spec.peak_weight_bits,
                                    spec.peak_input_bits, device="cuda")
            check(np.array_equal(gops, scorer.metrics(m)[0]),
                  f"performance_gops != the fused scorer on {name} C={n}")
            label = f"{name} C={n} peaks"
            timed[f"{name} C={n}"] = {
                "ops": len(spec.stream), "broadcast_ms": twin_ms,
                "fused_ms": fused_ms,
                "broadcast_over_fused": twin_ms / fused_ms,
                "oracle_s": checked[label]["oracle_s"],
                "broadcast_max_memory_allocated": peak}

    # the Pareto studies: the card's telemetry-on runs are the main path
    studies = {}
    tmp = tempfile.TemporaryDirectory()
    with_obs = Path(tmp.name)

    def pareto(engine, device):
        return Study(apps=["ptb", "wdl"],
                     objective=ParetoObjective(["perf", "-area"]),
                     engine=engine,
                     budget=SearchBudget(restarts=1, max_rounds=6,
                                         engine_kwargs={"population": 20}),
                     area_budgets=PARETO_BUDGETS, seed=0, device=device)

    gather_rows.launches = 0
    for engine in ("genetic", "nsga2"):
        obs.enable(trace=True, metrics=True, journal=True)
        t0 = time.perf_counter()
        study = pareto(engine, "cuda")
        res = study.run()
        torch.cuda.synchronize()
        studies[engine] = {"cuda": res, "cuda_s": time.perf_counter() - t0,
                           "study": study}
        obs.tracer().write(with_obs / f"{engine}_trace.json")
        obs.journal().write_jsonl(with_obs / f"{engine}_journal.jsonl")
        obs.disable(reset=True)
    launches = gather_rows.launches
    check(launches > 0, "the cuda pareto studies never launched gather_rows")
    out = {}
    for engine, rec in studies.items():
        events = validate_chrome_trace(with_obs / f"{engine}_trace.json")
        journal = validate_journal(with_obs / f"{engine}_journal.jsonl")
        quiet = pareto(engine, "cuda").run()
        gather_rows.launches = 0
        t0 = time.perf_counter()
        cpu_study = pareto(engine, "cpu")
        cpu = cpu_study.run()
        cpu_s = time.perf_counter() - t0
        check(gather_rows.launches == 0, "gather_rows launched on the cpu")
        gpu = rec["cuda"]
        gj, qj, cj = gpu.to_json(), quiet.to_json(), cpu.to_json()
        check(json.dumps(gj) == json.dumps(qj),
              f"{engine}: telemetry changed the StudyResult JSON")
        for key in ("front", "budget_selections", "per_app", "best",
                    "best_score"):
            check(gj[key] == cj[key],
                  f"{engine}: the cuda and cpu studies differ in {key}")
        check(gpu.front and any(v is not None for v in
                                gpu.budget_selections.values()),
              f"{engine}: empty front or no budget selection")
        explain = {}
        for i, app in enumerate(("ptb", "wdl")):
            e_gpu = rec["study"]._evaluators[i].explain(gpu.best)
            e_cpu = cpu_study._evaluators[i].explain(gpu.best)
            check(e_gpu.to_json() == e_cpu.to_json(),
                  f"{engine}: explain differs on {app}")
            explain[app] = {"ops": len(e_gpu.ops), "gops": e_gpu.gops,
                            "feasible": e_gpu.feasible,
                            "bottlenecks": e_gpu.bottleneck_counts}
        out[engine] = {
            "front": len(gpu.front),
            "selections": {b: (None if v is None else
                               {"score": v["score"], "area": v["area"]})
                           for b, v in gpu.budget_selections.items()},
            "best_score": gpu.best_score, "cuda_s": rec["cuda_s"],
            "cpu_s": cpu_s, "trace_events": len(events),
            "journal_records": len(journal),
            "telemetry": {k: gpu.meta["telemetry"][k] for k in
                          ("wall_seconds", "configs_scored",
                           "configs_per_second", "cache_hits")},
            "explain": explain}
    tmp.cleanup()

    # the §5.3 radar on both devices
    radar = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = [radar_of_top_configs("resnet", AppSpec.from_app("resnet"),
                                  space, k=2, restarts=1, max_rounds=4,
                                  device=dev)]
        r += sensitivity_study(
            [lambda s=s: apps.faster_rcnn_step(s) for s in (1, 2, 3, 4)],
            [f"fasterRCNN-step{s}" for s in (1, 2, 3, 4)], space, k=2,
            restarts=1, max_rounds=3, device=dev)
        radar[dev] = (r, time.perf_counter() - t0)
    for a, b in zip(radar["cuda"][0], radar["cpu"][0]):
        check((a.values, a.n_configs, a.extras)
              == (b.values, b.n_configs, b.extras),
              f"the radar of {a.app} differs on the cuda and the cpu")
    check_isolated()
    emit("study pareto", broadcast_cases=len(checked),
         broadcast_bit_equal=True, broadcast=checked,
         oracle_workers=ORACLE_WORKERS, oracle_wall_s=oracle_s,
         timings=timed, studies=out, gather_rows_launches=launches,
         radar={r.app: {"n_configs": r.n_configs, "extras": r.extras}
                for r in radar["cuda"][0]},
         radar_cuda_s=radar["cuda"][1], radar_cpu_s=radar["cpu"][1],
         phase_s=time.perf_counter() - t_phase)
    return launches


def pool_record(study_or_ex, fault: bool = False) -> dict:
    """Checks one pooled run on the card and returns its pool numbers: no
    serial degradation, no retry round (one, under a `FaultPlan`), and
    every task a pool worker ran reports its own `gather_rows` launches."""
    ex = getattr(study_or_ex, "_run_executor", study_or_ex)
    check(not ex.degraded, "a pooled run degraded to serial")
    check(ex.retry_rounds == (1 if fault else 0),
          f"{ex.retry_rounds} retry rounds, expected {int(fault)}")
    tasks = [t for t in ex.tasks if t["pool"]]
    check(tasks, "no task ran in a pool worker")
    for t in tasks:
        check(t["launches"] > 0, f"pool task {t['fn']}[{t['task']}] on "
              f"pid {t['pid']} launched gather_rows 0 times")
    return {"workers": ex.workers, "retry_rounds": ex.retry_rounds,
            "pool_start_s": list(ex.pool_start_seconds),
            "worker_launches": sum(t["launches"] for t in tasks),
            "tasks": [{k: t[k] for k in ("fn", "task", "pid", "launches",
                                         "seconds")} for t in tasks]}


def problem_json(result) -> str:
    """A StudyResult's JSON outside the execution resources."""
    rec = result.to_json()
    rec["meta"] = {k: v for k, v in rec["meta"].items() if k != "device"}
    return json.dumps(rec, sort_keys=True)


def phase_study_parallel() -> dict:
    """The parallel, resumable and composed Study on the card: the
    seven-app greedy study at workers=4 against workers=1 and the CPU; a
    random study over ptb + wdl crashed at its first checkpoint and resumed
    at workers=2 (and a checkpoint written on the CPU resumed on the card);
    a killed pool worker; the composition sweep's configuration at workers
    1 and 2 against the CPU and the monolithic design.  Every pool worker
    scores on the card (its own CUDA context and scorer tables) and must
    report gather_rows launches; a `ParallelExecutionWarning` is an error.
    Returns the parent's and the workers' launches."""
    import warnings

    from repro_torch.core.apps import APP_NAMES
    from repro_torch.dse import (Composition, CompositionEvaluator,
                                 FaultPlan, GeomeanAcrossApps,
                                 ParallelExecutionWarning, ParallelExecutor,
                                 SearchBudget, Study)
    from repro_torch.kernels.gather import gather_rows
    from repro_torch.obs.attribution import explain_composition

    t_phase = time.perf_counter()
    parent = {}

    def run(label, fn):
        """fn() with gather_rows counted from 0, timed."""
        gather_rows.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        parent[label] = gather_rows.launches
        return res, time.perf_counter() - t0

    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("error", ParallelExecutionWarning)
        # 1. workers: the seven-app greedy study of phase `study`
        def seven(workers, device):
            return Study(apps=list(APP_NAMES), objective=GeomeanAcrossApps(),
                         engine="greedy",
                         budget=SearchBudget(k=2, restarts=2, max_rounds=6),
                         seed=0, device=device, workers=workers)

        s4 = seven(4, "cuda")
        r4, w4 = run("workers=4", s4.run)
        r1, w1 = run("workers=1", seven(1, "cuda").run)
        rc, wc = run("cpu", seven(1, "cpu").run)
        check(json.dumps(r4.to_json()) == json.dumps(r1.to_json()),
              "the seven-app study differs at workers 4 and 1")
        check(r4.best == rc.best and r4.per_app == rc.per_app,
              "the seven-app study differs on the card and the cpu")
        check(parent["cpu"] == 0, "gather_rows launched on the cpu study")
        out["workers"] = {"wall_s": {"workers=4": w4, "workers=1": w1,
                                     "cpu": wc},
                          "parent_launches": parent["workers=4"],
                          "serial_launches": parent["workers=1"],
                          **pool_record(s4)}

        # 2. resume: random over ptb + wdl, a checkpoint every job
        tmp = tempfile.TemporaryDirectory()
        d = Path(tmp.name)

        def small(device, **kw):
            return Study(apps=["ptb", "wdl"], engine="random",
                         budget=SearchBudget(restarts=1, max_rounds=3,
                                             engine_kwargs={"batch": 12}),
                         seed=0, device=device, **kw)

        class Crash(Exception):
            pass

        def crash(n):
            if n == 1:
                raise Crash

        base, wb = run("uninterrupted", small("cuda").run)
        resumed, resume_s = {}, {}
        # a checkpoint written by a run on the card, and one on the host
        for written, dev in (("card", "cuda"), ("host", "cpu")):
            ckpt = d / f"{written}.ckpt"
            try:
                small(dev).run(checkpoint_path=ckpt, checkpoint_every=1,
                               on_checkpoint=crash)
            except Crash:
                pass
            check(ckpt.exists(), f"the crashed {dev} run left no checkpoint")
            resumed[written], resume_s[written] = run(
                f"resume {written} checkpoint",
                lambda: Study.resume(ckpt, workers=2, device="cuda"))
            check(not ckpt.exists(), "resume left its checkpoint behind")
        check(json.dumps(resumed["card"].to_json())
              == json.dumps(base.to_json()),
              "the resumed study differs from the uninterrupted one")
        check(resumed["host"].meta["device"] == base.meta["device"]
              and json.dumps(resumed["host"].to_json())
              == json.dumps(base.to_json()),
              "the cpu checkpoint resumed on the card differs")
        out["resume"] = {"uninterrupted_s": wb,
                         "resume_s": resume_s["card"],
                         "host_checkpoint_resume_s": resume_s["host"],
                         "parent_launches": parent["resume card checkpoint"]}

        # 3. a killed worker costs one retry round, no degradation
        ex = ParallelExecutor(workers=2, fault=FaultPlan(
            state_dir=str(d / "fault"), mode="kill", times=1))
        killed, wk = run("kill", small("cuda", executor=ex).run)
        check(json.dumps(killed.to_json()) == json.dumps(base.to_json()),
              "the study with a killed worker differs")
        out["kill"] = {"wall_s": wk, "parent_launches": parent["kill"],
                       **pool_record(ex, fault=True)}
        tmp.cleanup()

        # 4. composition: benchmarks/composition_sweep.py's configuration
        budget = SearchBudget(restarts=2, max_rounds=16,
                              engine_kwargs={"population": 32, "chains": 4,
                                             "batch": 32})
        traffic = {a: 0.5 for a in COMP_APPS}

        def comp(workers, device):
            return Study(apps=list(COMP_APPS), composition=2,
                         engine="genetic", budget=budget, seed=0,
                         traffic=traffic, area_budgets=[COMP_AREA],
                         workers=workers, device=device,
                         name="composition-sweep")

        c1, wc1 = run("composition workers=1", comp(1, "cuda").run)
        s2 = comp(2, "cuda")
        c2, wc2 = run("composition workers=2", s2.run)
        ccpu, wccpu = run("composition cpu", comp(1, "cpu").run)
        check(json.dumps(c1.to_json()) == json.dumps(c2.to_json()),
              "the composition differs at workers 1 and 2")
        check(problem_json(c1) == problem_json(ccpu),
              "the composition differs on the card and the cpu")
        mono, wm = run("monolithic", Study(
            apps=list(COMP_APPS), objective="pareto", engine="genetic",
            budget=budget, seed=0, area_budgets=[COMP_AREA], device="cuda",
            name="composition-sweep-mono").run)
        ev = CompositionEvaluator(s2.specs, traffic=traffic,
                                  area_budget=COMP_AREA, device="cuda")
        mono_score = ev.score_one(Composition(
            engines=(mono.best,), assignment=(0, 0), apps=tuple(COMP_APPS)))
        best = c1.best
        area = best.area(ev.hw)
        check(isinstance(best, Composition) and area <= COMP_AREA
              and c1.best_score > mono_score,
              f"the composition ({c1.best_score}, area {area}) does not "
              f"beat the monolithic design ({mono_score}) at {COMP_AREA}")
        exp = {dev: explain_composition(best, s2.specs, traffic=traffic,
                                        area_budget=COMP_AREA, device=dev)
               for dev in ("cuda", "cpu")}
        check(exp["cuda"].to_json() == exp["cpu"].to_json(),
              "explain_composition differs on the card and the cpu")
        check(exp["cuda"].score == c1.best_score,
              "explain_composition's score is not the study's")
        out["composition"] = {
            "score": c1.best_score, "area": area,
            "monolithic_score": mono_score,
            "advantage": c1.best_score / mono_score,
            "best": best.to_json(), "front": len(c1.front),
            "wall_s": {"workers=1": wc1, "workers=2": wc2, "cpu": wccpu,
                       "monolithic": wm},
            "parent_launches": parent["composition workers=2"],
            "serial_launches": parent["composition workers=1"],
            "explain": exp["cuda"].to_json(), **pool_record(s2)}
    check_isolated()
    launches = {"parent": sum(v for k, v in parent.items() if k != "cpu"
                              and k != "composition cpu"),
                "workers": sum(out[k]["worker_launches"]
                               for k in ("workers", "kill", "composition"))}
    check(parent["composition cpu"] == 0,
          "gather_rows launched on the cpu composition")
    emit("study parallel", **out, parent_launches_by_run=parent,
         gather_rows_launches=launches,
         phase_s=time.perf_counter() - t_phase)
    return launches


def device_breakdown(calls: dict, kinds: dict) -> dict:
    """Device time of one call of each function in `calls`, in us, from one
    `torch.profiler` session, split by kind: `kinds` maps an output key to
    the kernel-name substrings that mark it; the rest is
    `other_kernels_us`, and host<->device copies are `copies_us`.  Device
    work belongs to the call whose host range holds it (each call ends in
    a synchronise); `wall_us` is that range and `kernels` the number of
    kernels launched in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            with record_function(f"smoke:{name}"):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    spans = {e.name[len("smoke:"):]: e.time_range for e in events
             if e.device_type == DeviceType.CPU
             and e.name.startswith("smoke:")}
    out = {name: {**{k: 0.0 for k in kinds}, "other_kernels_us": 0.0,
                  "copies_us": 0.0} for name in calls}
    counts = dict.fromkeys(calls, 0)
    for e in events:
        if (e.device_type != DeviceType.CUDA or e.name.startswith("smoke:")
                or "Activity Buffer" in e.name):
            continue
        owner = [n for n, r in spans.items()
                 if r.start <= e.time_range.start <= r.end]
        if not owner:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            key = "copies_us"
        else:
            counts[owner[0]] += 1
            key = next((k for k, marks in kinds.items()
                        if any(m in e.name for m in marks)),
                       "other_kernels_us")
        out[owner[0]][key] += e.time_range.elapsed_us()
    for name, us in out.items():
        us["busy_us"] = sum(us.values())
        us["wall_us"] = spans[name].elapsed_us()
        us["kernels"] = counts[name]
    return out


def host_profile(fn, top: int = 10) -> list:
    """The port's functions by cumulative host time over one call of `fn`
    (cProfile, which slows the call down)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(fn)
    stats = pstats.Stats(prof).stats
    rows = [(ct, f"{file.split('repro_torch/')[-1]}:{line}:{func}")
            for (file, line, func), (_, _, _, ct, _) in stats.items()
            if "repro_torch/" in file]
    return [{"fn": name, "cum_s": ct} for ct, name in sorted(rows)[::-1][:top]]


def phase_throughput(specs, space, rng) -> None:
    """Large random-engine pools on the card, with where the time goes."""
    from repro_torch.core.search import optimize_for_app
    from repro_torch.kernels.gather import gather_rows

    batch, rounds = 262144, 4
    per_app, calls = {}, {}
    for spec in specs:
        def search(max_rounds):
            return optimize_for_app(
                spec.stream, space, restarts=1, seed=0,
                max_rounds=max_rounds, engine="random",
                engine_kwargs={"batch": batch},
                peak_weight_bits=spec.peak_weight_bits,
                peak_input_bits=spec.peak_input_bits, device="cuda")

        torch.cuda.reset_peak_memory_stats()
        gather_rows.launches = 0
        t0 = time.perf_counter()
        res = search(rounds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(res.best_perf > 0, f"random search found nothing on "
                                 f"{spec.name}")
        ev = res.evaluator
        launches = gather_rows.launches
        # the scorer alone on one more repaired pool of the same size
        pool = space.repair_for_peaks_many(
            space.decode_batch(space.sample_indices(rng, batch)),
            ev.peak_weight_bits, ev.peak_input_bits_scaled).matrix
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev.scorer.metrics(pool)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        ev.scorer.t.codes(pool)
        codes_s = time.perf_counter() - t1
        calls[spec.name] = lambda sc=ev.scorer, p=pool: sc.metrics(p)
        per_app[spec.name] = {
            "batch": batch, "rounds": rounds, "wall_s": wall,
            "configs_per_s": batch * rounds / wall,
            "scored": ev.n_scored, "scorer_s": score_s,
            "scorer_configs_per_s": batch / score_s,
            "scorer_host_codes_s": codes_s,
            "best_perf": res.best_perf,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "gather_rows_launches": launches,
            "host_profile_one_round": host_profile(lambda: search(1))}
    # the scorer's device time by kind, all apps in one profiler session
    for name, device in device_breakdown(
            calls, {"gather_rows_us": ("gather_rows_kernel",)}).items():
        rec = per_app[name]
        device["idle_share"] = 1.0 - device["busy_us"] / (rec["scorer_s"]
                                                          * 1e6)
        rec["scorer_device"] = device
    emit("throughput", apps=per_app)


def flash_bound(b, sq, skv, h, kv, hd, causal, itemsize) -> dict:
    """Least time for one call: the larger of its operations (two
    products over the visible (query, key) pairs) at the peak for the
    inputs' type (bf16: the tensor cores; fp32: the CUDA cores) and its
    bytes (q, k, v read once, out written once) at the HBM rate.  Causal
    pairs are counted exactly (top-left mask)."""
    if causal:
        full = min(sq, skv)              # row i sees min(i + 1, skv) keys
        pairs = full * (full + 1) // 2 + max(0, sq - skv) * skv
    else:
        pairs = sq * skv
    flops = 4 * b * h * hd * pairs
    nbytes = itemsize * (2 * b * sq * h * hd + 2 * b * skv * kv * hd)
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return {"flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def flash_against_plain(q, k, v, causal: bool) -> dict:
    """The kernel's output on every row against the plain version's, the
    plain version run `PLAIN_ROWS` query rows at a time: the max abs
    error and the worst |error| / (atol + rtol |plain|), which passes at
    <= 1."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models.layers import full_precision_products

    atol, rtol = FLASH_TOL[q.dtype]
    err = ratio = 0.0
    with torch.inference_mode(), full_precision_products():
        got = flash_attention(q, k, v, causal=causal).float()
        for i in range(0, q.shape[1], PLAIN_ROWS):
            want = flash_attention_plain(q[:, i:i + PLAIN_ROWS], k, v,
                                         causal=causal, q_offset=i).float()
            diff = (got[:, i:i + PLAIN_ROWS] - want).abs()
            err = max(err, float(diff.max()))
            ratio = max(ratio, float((diff / (atol + rtol * want.abs()))
                                     .max()))
    return {"max_abs_err": err, "tol_ratio": ratio}


def phase_flash(gen) -> dict:
    """The flash kernel against its plain version, then its times."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (CUDA_CORE, TENSOR_CORE,
                                                     flash_attention,
                                                     flash_attention_plain,
                                                     kernel_for)
    flash_kernels = (TENSOR_CORE, CUDA_CORE)

    def inputs(b, sq, skv, h, kv, hd, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                              (b, skv, kv, hd))]

    cases = [(2, sq, skv, h, kv, hd, causal, dtype)
             for sq, skv, h, kv, hd in ((64, 64, 4, 4, 32), (96, 96, 4, 2, 32),
                                        (128, 128, 8, 1, 16),
                                        (80, 48, 4, 4, 32))
             for causal in (True, False)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1, sq, skv, 14, 2, 64, causal, dtype)
              for sq, skv, causal in ((512, 512, True), (512, 512, False),
                                      (2048, 2048, True), (4096, 4096, True),
                                      (1000, 4096, True), (4096, 1000, True),
                                      (2048, 512, False))
              for dtype in (torch.float32, torch.bfloat16)]
    # recurrentgemma-9b's heads: 16 query heads on one KV head of width 256
    cases += [(2, 130, 130, 16, 1, 256, causal, dtype)
              for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [(1, 1000, 2048, 16, 1, 256, True, torch.bfloat16),
              (1, 2048, 1000, 16, 1, 256, True, torch.float32)]
    # head dim 128 (mistral-nemo-12b's 32 heads on 8 KV heads), Sq != Skv
    cases += [(2, sq, skv, 32, 8, 128, causal, torch.bfloat16)
              for sq, skv in ((1000, 1536), (1536, 1000))
              for causal in (True, False)]
    # the prefills' shapes, all rows (their own inputs: prefill phases)
    cases += [(4, 2048, 2048, 14, 2, 64, True, torch.bfloat16),
              (1, 32768, 32768, 14, 2, 64, True, torch.bfloat16),
              (4, 2048, 2048, 16, 1, 256, True, torch.bfloat16),
              (1, 8192, 8192, 32, 8, 128, True, torch.bfloat16)]
    worst = {"float32": {"max_abs_err": 0.0, "tol_ratio": 0.0},
             "bfloat16": {"max_abs_err": 0.0, "tol_ratio": 0.0}}
    failed = []
    for b, sq, skv, h, kv, hd, causal, dtype in cases:
        res = flash_against_plain(*inputs(b, sq, skv, h, kv, hd, dtype),
                                  causal)
        w = worst[str(dtype).split(".")[-1]]
        for key in w:
            w[key] = max(w[key], res[key])
        if res["tol_ratio"] > 1.0:
            failed.append(f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} hd={hd} "
                          f"causal={causal} {dtype}: {res}")

    # qwen2-0.5b's prefill at S 32768 (the plain version's fp32 scores
    # would need 60 GB there) and 4096; recurrentgemma-9b's at 4 x 2048;
    # head dim 128 at 8192 (mistral-nemo-12b's heads); and the CUDA-core
    # kernel's fp32 at qwen2-0.5b's S 4096
    timings = {}
    for key, (b, s_len, h, kv, hd, dtype, with_plain) in {
            "32768": (1, 32768, 14, 2, 64, torch.bfloat16, False),
            "4096": (1, 4096, 14, 2, 64, torch.bfloat16, True),
            "hd256": (4, 2048, 16, 1, 256, torch.bfloat16, True),
            "hd128": (1, 8192, 32, 8, 128, torch.bfloat16, True),
            "fp32_4096": (1, 4096, 14, 2, 64, torch.float32, True)}.items():
        q, k, v = inputs(b, s_len, s_len, h, kv, hd, dtype)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        reps = dict(reps=3, inner=2) if s_len > 4096 else {}
        # the kernel that ran: the one whose counter the timed calls moved
        before = {fk.name: fk.launches for fk in flash_kernels}
        kernel_ms = device_ms(
            lambda: flash_attention(q, k, v, causal=True), **reps)
        moved = [fk.name for fk in flash_kernels
                 if fk.launches != before[fk.name]]
        check(moved == [kernel_for(dtype, hd).name],
              f"timing {key}: the timed calls launched {moved}, expected "
              f"{kernel_for(dtype, hd).name} alone")
        row = {"B": b, "S": s_len, "H": h, "KV": kv, "hd": hd,
               "causal": True, "dtype": str(dtype).split(".")[-1],
               "kernel": moved[0], "kernel_ms": kernel_ms,
               "library_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=True), **reps),
               "plain_ms": (device_ms(lambda: flash_attention_plain(
                   q, k, v, causal=True), reps=3, inner=2)
                   if with_plain else None)}
        row.update(flash_bound(b, s_len, s_len, h, kv, hd, True,
                               q.element_size()))
        row["tflops"] = row["flop"] / row["kernel_ms"] * 1e-9
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        timings[key] = row
    emit("kernel flash_attention", cases=len(cases), worst=worst,
         tolerance={"float32": FLASH_TOL[torch.float32],
                    "bfloat16": FLASH_TOL[torch.bfloat16]},
         failed=failed, timings=timings)
    check(not failed, f"flash_attention != plain on {len(failed)} cases: "
                      f"{failed[:3]}")
    return {"max_abs_err": {d: w["max_abs_err"] for d, w in worst.items()},
            "timings": timings}


def rglru_bound(b, s, w, itemsize) -> dict:
    """Least time for one call: its bytes (a and b read once, h written
    once) at the HBM rate; its one FMA per element at the fp32 peak takes
    a hundredth of that."""
    nbytes = 3 * b * s * w * itemsize
    return {"flop": 2 * b * s * w, "bytes": nbytes,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def rglru_against_plain(a, b) -> dict:
    """The bare-scan kernel's output on every element against the plain
    version's: the max abs error and the worst |error| / (atol + rtol
    |plain|), which passes at <= 1.  The call must launch the kernel
    once."""
    from repro_torch.kernels.rg_lru import rglru_scan, rglru_scan_plain

    atol, rtol = RGLRU_TOL[a.dtype]
    before = rglru_scan.launches
    with torch.inference_mode():
        got = rglru_scan(a, b).float()
        check(rglru_scan.launches == before + 1,
              f"rglru_scan on {tuple(a.shape)} did not count its launch")
        want = rglru_scan_plain(a, b).float()
        diff = (got - want).abs()
        return {"max_abs_err": float(diff.max()),
                "tol_ratio": float((diff / (atol + rtol * want.abs())).max()),
                "finite": bool(torch.isfinite(got).all())}


def bf16_ulp(x):
    """One bf16 ulp of each |x| (the smallest normal at 0)."""
    _, e = torch.frexp(x.abs())
    return torch.where(x == 0, torch.finfo(torch.bfloat16).tiny,
                       torch.ldexp(torch.ones_like(x), e - 8))


def rglru_gated_bound(args, out_dtype) -> dict:
    """Least time for one `rglru_gated_scan` call: the bytes it must move
    (xc, ra, ri, gate and the three [W] vectors read once in the dtypes
    handed, y written once in `out_dtype`) at the HBM rate, and its
    `GATED_OPS` fp32 operations an element at the fp32 peak; bytes bound
    it."""
    n = args[0].numel()
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + n * torch.empty((), dtype=out_dtype).element_size())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, GATED_OPS * n / FP32_FLOP_PER_S
    return {"flop": GATED_OPS * n, "bytes": nbytes,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def gated_against_plain(args, out_dtype) -> dict:
    """`rglru_gated_scan` on every element against
    `rglru_gated_scan_plain` on the same inputs, within `GATED_TOL` (plus
    one bf16 ulp of |plain| on a bf16 output); the call must launch the
    kernel once."""
    from repro_torch.kernels.rg_lru import (rglru_gated_scan,
                                            rglru_gated_scan_plain)

    atol, rtol = GATED_TOL
    before = rglru_gated_scan.launches
    with torch.inference_mode():
        got = rglru_gated_scan(*args, out_dtype)
        check(rglru_gated_scan.launches == before + 1,
              "rglru_gated_scan did not count its launch")
        check(got.dtype == out_dtype and got.shape == args[0].shape,
              f"rglru_gated_scan gave {got.dtype} {tuple(got.shape)}")
        want = rglru_gated_scan_plain(*args, out_dtype).float()
        got = got.float()
        diff = (got - want).abs()
        lim = atol + rtol * want.abs()
        if out_dtype == torch.bfloat16:
            lim = lim + bf16_ulp(want)
        return {"max_abs_err": float(diff.max()),
                "tol_ratio": float((diff / lim).max()),
                "finite": bool(torch.isfinite(got).all()),
                "out_dtype": str(out_dtype)[6:]}


def rglru_block_times(gen) -> dict:
    """One RG-LRU block of recurrentgemma-9b at full width (d 4096, lru
    width 4096, 16 gate heads of 256, conv width 4), random bf16
    parameters from `gen`, bf16 compute, at the prefill's two shapes, by
    two routes: "today" composes `rglru_scan_inputs` -> `rglru_scan` ->
    `rglru_output` (the route before the gated kernel, the yardstick);
    "fused" is `rglru_block_train` under `use_kernels` (projections, conv
    and the gate einsums, then `rglru_gated_scan`, then `wout`).  Per
    route and shape: the kernels one call launches (counted from 0 just
    before it, read just after: the bare scan once on "today", the gated
    kernel once on "fused"), CUDA-event time and one profiled call split
    into cuBLAS products, the RG-LRU kernels and the rest; the two
    routes' outputs are held to each other within `PREFILL_TOL`.  Returns
    the records and each kernel's launches per route over both shapes."""
    from repro_torch import configs
    from repro_torch.kernels.rg_lru import rglru_gated_scan, rglru_scan
    from repro_torch.models import layers as L

    cfg = configs.get_arch(RG_ARCH)
    w, heads = cfg.lru_width, cfg.num_heads
    rt = L.Runtime(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                   use_kernels=True)
    p = L.init_params(L.rglru_specs(cfg.d_model, w, heads,
                                    cfg.conv1d_width), gen, torch.bfloat16)

    def block(x, route):
        with torch.inference_mode(), L.full_precision_products():
            if route == "fused":
                return L.rglru_block_train(p, x, n_heads=heads, rt=rt)
            a, b, gate = L.rglru_scan_inputs(p, x, n_heads=heads, rt=rt)
            return L.rglru_output(p, rglru_scan(a, b), gate, rt)

    counters = {"rglru_scan": rglru_scan,
                "rglru_gated_scan": rglru_gated_scan}
    want = {"today": {"rglru_scan": 1, "rglru_gated_scan": 0},
            "fused": {"rglru_scan": 0, "rglru_gated_scan": 1}}
    out = {}
    launches = {route: dict.fromkeys(counters, 0) for route in want}
    for b, s_len in ((1, 32768), (4, 2048)):
        x = torch.randn((b, s_len, cfg.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        rec = {"B": b, "S": s_len, "d_model": cfg.d_model, "lru_width": w,
               "heads": heads}
        ys = {}
        for route in want:
            for fn in counters.values():
                fn.launches = 0
            ys[route] = block(x, route)
            torch.cuda.synchronize()
            got = {n: fn.launches for n, fn in counters.items()}
            check(got == want[route], f"one RG-LRU block by the {route} "
                                      f"route launched {got}")
            for n in counters:
                launches[route][n] += got[n]
            rec[f"{route}_launches"] = got
            rec[f"{route}_ms"] = device_ms(lambda: block(x, route), reps=3,
                                           inner=2)
            rec[f"{route}_device"] = device_breakdown(
                {route: lambda: block(x, route)},
                {"cublas_us": ("gemm", "nvjet", "xmma"),
                 "gated_us": ("rglru_gated",),
                 "scan_us": ("rglru_slab",)})[route]
        y0, y1 = ys["today"].float(), ys["fused"].float()
        diff = (y0 - y1).abs()
        rec["max_abs_diff_fused_vs_today"] = float(diff.max())
        rec["fused_over_today"] = rec["fused_ms"] / rec["today_ms"]
        check(bool((diff <= PREFILL_TOL * (1 + y0.abs())).all()),
              f"the fused RG-LRU block differs from today's route by "
              f"{float(diff.max())} at [{b}, {s_len}]")
        out[f"{b}x{s_len}"] = rec
        del x, ys
    return out, launches


def phase_rglru(gen) -> dict:
    """The RG-LRU kernels against their plain versions, then their times:
    the bare scan on every case, the gated kernel on the same shapes,
    head-major and contiguous gate logits, both output dtypes and the
    long-memory end of the decay, each at the recurrentgemma prefill's two
    shapes; then one RG-LRU block by today's route and by the gated
    kernel.  Returns each kernel's launches in the checks (counted from 0
    at the phase's start) and on each block route (from 0 before each
    call)."""
    from repro_torch.kernels import rg_lru as R

    def inputs(b, s_len, w, dtype):
        # a in (0.6, 0.999) as in the sweep of tests/test_kernels.py
        a = torch.rand((b, s_len, w), generator=gen, device="cuda")
        return ((a * 0.399 + 0.6).to(dtype),
                torch.randn((b, s_len, w), generator=gen,
                            device="cuda").to(dtype))

    def gated_inputs(b, s_len, w, heads, gate_dtype, head_major,
                     long_memory=False):
        # the gate logits as the einsum leaves them ([heads, B, S, hd]
        # storage) or contiguous; a_param at the reference's init
        # (logit(u), u in [0.81, 0.998]) or at the long-memory end
        # (softplus(a_param) 1.2e-4 to 5.5e-4: a 0.998 to 0.9995 at r 0.5)
        hd = w // heads

        def logits():
            if head_major:
                return torch.randn((heads, b, s_len, hd), generator=gen,
                                   device="cuda").permute(1, 2, 0, 3)
            return torch.randn((b, s_len, w), generator=gen, device="cuda")

        u = torch.rand(w, generator=gen, device="cuda")
        a_param = (-9.0 + 1.5 * u if long_memory else
                   torch.logit(0.81 + (0.998 - 0.81) * u))
        return (torch.randn((b, s_len, w), generator=gen, device="cuda"),
                logits(), logits(),
                torch.randn((b, s_len, w), generator=gen,
                            device="cuda").to(gate_dtype),
                0.5 * torch.randn(w, generator=gen, device="cuda"),
                0.5 * torch.randn(w, generator=gen, device="cuda"), a_param)

    counters = {"rglru_scan": R.rglru_scan,
                "rglru_gated_scan": R.rglru_gated_scan}
    for fn in counters.values():
        fn.launches = 0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = {f"B{b} S{s_len} W{w} {str(dt)[6:]}": inputs(b, s_len, w, dt)
             for b, s_len, w, dt in ((1, 64, 128, f32), (2, 100, 160, f32),
                                     (3, 257, 130, f32), (3, 257, 130, bf16),
                                     (1, 4096, 4096, bf16))}
    decay = torch.full((1, 1024, 128), 0.999, device="cuda")
    cases["decay B1 S1024 W128 float32"] = (decay, torch.ones_like(decay))
    results, failed = {}, []
    for label, (a, b) in cases.items():
        results[label] = rglru_against_plain(a, b)
    del cases
    # the prefill's two shapes (its own inputs: prefill phase), timed
    timings = {}
    for b, s_len in ((1, 32768), (4, 2048)):
        a, bb = inputs(b, s_len, 4096, f32)
        label = f"B{b} S{s_len} W4096 float32"
        results[label] = rglru_against_plain(a, bb)
        reps = dict(reps=3, inner=2)
        bound = rglru_bound(b, s_len, 4096, 4)
        row = {"B": b, "S": s_len, "W": 4096, "dtype": "float32",
               "kernel_ms": device_ms(lambda: R.rglru_scan(a, bb)),
               "plain_ms": device_ms(lambda: R.rglru_scan_plain(a, bb),
                                     **reps),
               "library_ms": None, "library": RGLRU_LIBRARY, **bound}
        row["bound_share"] = bound["bound_ms"] / row["kernel_ms"]
        timings[f"{b}x{s_len}"] = row
        del a, bb
    for label, res in results.items():
        if res["tol_ratio"] > 1.0 or not res["finite"]:
            failed.append(f"{label}: {res}")

    # the gated kernel: the same shapes, both layouts of the gate logits,
    # bf16 and fp32 gates and outputs, the long-memory decay
    gated, gated_failed = {}, []
    for b, s_len, w, heads in ((1, 64, 128, 4), (2, 100, 160, 5),
                               (3, 257, 130, 1), (1, 4096, 4096, 16)):
        for gdt, odt, hm in ((f32, f32, heads > 1), (bf16, bf16, False),
                             (bf16, f32, heads > 1), (f32, bf16, True)):
            if hm and heads == 1:
                continue
            args = gated_inputs(b, s_len, w, heads, gdt, hm)
            gated[(f"B{b} S{s_len} W{w} h{heads} gate {str(gdt)[6:]} "
                   f"{'head-major' if hm else 'contiguous'}")
                  + f" -> {str(odt)[6:]}"] = gated_against_plain(args, odt)
    for odt in (f32, bf16):
        args = gated_inputs(1, 1024, 128, 4, bf16, True, long_memory=True)
        gated[f"long memory B1 S1024 W128 h4 -> {str(odt)[6:]}"] = \
            gated_against_plain(args, odt)
    gated_timings = {}
    for b, s_len in ((1, 32768), (4, 2048)):
        # the model's operands: xc, ra, ri fp32 (ra, ri head-major), gate
        # and y bf16
        args = gated_inputs(b, s_len, 4096, 16, bf16, True)
        gated[f"B{b} S{s_len} W4096 h16 model dtypes -> bfloat16"] = \
            gated_against_plain(args, bf16)
        bound = rglru_gated_bound(args, bf16)
        row = {"B": b, "S": s_len, "W": 4096, "heads": 16,
               "dtypes": "xc, ra, ri float32; gate, y bfloat16",
               "kernel_ms": device_ms(
                   lambda: R.rglru_gated_scan(*args, bf16)),
               "plain_ms": device_ms(
                   lambda: R.rglru_gated_scan_plain(*args, bf16), reps=3,
                   inner=2),
               "library_ms": None, **bound}
        row["bound_share"] = bound["bound_ms"] / row["kernel_ms"]
        gated_timings[f"{b}x{s_len}"] = row
        del args
    for label, res in gated.items():
        if res["tol_ratio"] > 1.0 or not res["finite"]:
            gated_failed.append(f"{label}: {res}")
    launches = {n: fn.launches for n, fn in counters.items()}

    # the block by today's route (the bare scan) and by the gated kernel
    block, block_launches = rglru_block_times(gen)

    worst = {key: max(r[key] for r in results.values())
             for key in ("max_abs_err", "tol_ratio")}
    gworst = {key: max(r[key] for r in gated.values())
              for key in ("max_abs_err", "tol_ratio")}
    emit("kernel rglru_scan", cases=results, worst=worst,
         tolerance={"float32": RGLRU_TOL[f32], "bfloat16": RGLRU_TOL[bf16]},
         failed=failed, timings=timings, gated_cases=gated, gated_worst=gworst,
         gated_tolerance={"float32": GATED_TOL,
                          "bfloat16": "float32's plus one bf16 ulp"},
         gated_failed=gated_failed, gated_timings=gated_timings,
         launches=launches, block=block, block_launches=block_launches)
    check(not failed, f"rglru_scan != plain on {len(failed)} cases: "
                      f"{failed[:3]}")
    check(not gated_failed, f"rglru_gated_scan != plain on "
                            f"{len(gated_failed)} cases: {gated_failed[:3]}")
    return {"max_abs_err": worst["max_abs_err"],
            "gated_max_abs_err": gworst["max_abs_err"], "timings": timings,
            "gated_timings": gated_timings,
            "launches": launches, "block_launches": block_launches,
            "block": block}


def kernel_inputs(model, params, inputs, rt, layers) -> dict:
    """{layer: (kernel, inputs)} for each of `layers`: what the layer's
    block hands its kernel in the prefill's forward, recomputed with the
    port's own functions — `rglru_gated_scan`'s xc, ra, ri, gate, ba, bi
    and a_param in an RG-LRU layer, `flash_attention`'s q, k, v in an
    attention layer that takes it.  Each is tied to the main path: the
    layer's block output must equal, bit for bit, the same block finished
    from the kernel on the recomputed inputs."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rg_lru import read_in_place, rglru_gated_scan
    from repro_torch.models import layers as L
    from repro_torch.models.lm import block_apply_train

    cfg = model.cfg
    hd, heads, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    out = {}
    with torch.inference_mode(), L.full_precision_products():
        x = model._embed_inputs(params, inputs, rt)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        cos, sin = L.rope_cos_sin(pos, hd, cfg.rope_theta)
        for i, (kind, p) in enumerate(zip(model.kinds, params["layers"])):
            if i in layers:
                h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
                if kind == "rglru":
                    pr, cd = p["rglru"], rt.compute_dtype
                    args = (*L.rglru_gated_inputs(pr, h, n_heads=heads,
                                                  rt=rt),
                            pr["ba"], pr["bi"], pr["a_param"])
                    main = L.rglru_block_train(pr, h, n_heads=heads, rt=rt)
                    mine = L.cd_matmul(rglru_gated_scan(*args, cd),
                                       pr["wout"], cd).to(cd)
                    # xc, gate and the gate logits as the einsums leave
                    # them (head-major views) are what TMA reads: no copy
                    # on the main path
                    copied = [n for n, t in zip(("xc", "ra", "ri", "gate"),
                                                args[:4])
                              if not read_in_place(t)]
                    check(not copied, f"layer {i}'s {copied} are copied "
                                      f"before the gated kernel reads them")
                    out[i] = ("rglru_gated_scan", args)
                else:
                    q, k, v = L.gqa_project(p["attn"], h, heads, kv, hd, rt)
                    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos,
                                                                   sin)
                    main = L.gqa_attention_train(
                        p["attn"], h, n_heads=heads, n_kv=kv, hd=hd,
                        rope_theta=cfg.rope_theta, rt=rt, causal=True,
                        window=cfg.local_window if kind == "local_attn"
                        else 0)
                    mine = L.gqa_out(p["attn"],
                                     flash_attention(q, k, v, causal=True),
                                     rt)
                    out[i] = ("flash_attention", (q, k, v))
                check(torch.equal(main, mine),
                      f"layer {i}'s recomputed kernel inputs are not the "
                      f"main path's")
            if len(out) == len(layers):
                return out
            x = block_apply_train(cfg, kind, p, x, rt)
    raise SmokeFailure(f"the model has no layers {sorted(layers)}")


def kernel_counters() -> dict:
    """Each counted launch site by name: the flash wrapper (both of its
    kernels) and each of its kernels, the gated RG-LRU kernel, the bare
    scan, and the matmul wrapper and each of its kernels."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import rg_lru as rg
    from repro_torch.kernels.flash_attention import (CUDA_CORE, TENSOR_CORE,
                                                     flash_attention)
    return {"flash_attention": flash_attention,
            TENSOR_CORE.name: TENSOR_CORE, CUDA_CORE.name: CUDA_CORE,
            "rglru_gated_scan": rg.rglru_gated_scan,
            "rglru_scan": rg.rglru_scan, "matmul": mm.matmul,
            mm.TENSOR_CORE.name: mm.TENSOR_CORE,
            mm.CUDA_CORE.name: mm.CUDA_CORE}


def expected_launches(model, seq: int) -> dict:
    """Kernel launches of one bf16 prefill forward: one `rglru_gated_scan`
    per RG-LRU layer and no bare scan; one `flash_attention` per attention
    layer, and per local
    one whose window holds the whole sequence (else local-block
    attention), every one on the tensor cores (bf16 at head dim 64 or 256)
    and none on the CUDA cores; no `matmul` (the models' projections are
    not tiled products)."""
    from repro_torch.kernels.flash_attention import CUDA_CORE, TENSOR_CORE
    kinds, window = model.kinds, model.cfg.local_window
    flash = sum(k == "attn" or (k == "local_attn" and seq <= window)
                for k in kinds)
    return {"flash_attention": flash, TENSOR_CORE.name: flash,
            CUDA_CORE.name: 0, "rglru_gated_scan": kinds.count("rglru"),
            "rglru_scan": 0, "matmul": 0, "matmul_tensor_core": 0, "matmul_cuda_core": 0}


def checked_layers(model, seq: int) -> tuple:
    """The first and last layer that hands each launched kernel its
    inputs, at this sequence length."""
    want = expected_launches(model, seq)
    kind_of = {"flash_attention": ("attn", "local_attn"),
               "rglru_gated_scan": ("rglru",)}
    layers = set()
    for name, n in want.items():
        if n and name in kind_of:
            idx = [i for i, k in enumerate(model.kinds)
                   if k in kind_of[name]]
            layers.update((idx[0], idx[-1]))
    return tuple(sorted(layers))


def next_token_check(got, want, label: str) -> dict:
    """The next token through the kernels against the plain path's, row by
    row; a flip passes only where the plain path's top-1 margin is within
    the logit tolerance (then either token is the model's)."""
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    same = got.argmax(-1) == want.argmax(-1)
    excused = ~same & (margin <= PREFILL_TOL * (1 + top2[:, 0].abs()))
    check(bool((same | excused).all()),
          f"{label}: the next token through the kernels differs from the "
          f"plain path's on {int((~same & ~excused).sum())} rows whose "
          f"margin exceeds the tolerance")
    return {"top1_agreement": float(same.float().mean()),
            "flips_excused": int(excused.sum()),
            "plain_top1_margin_min": float(margin.min())}


def phase_prefill(arch: str) -> dict:
    """`arch`'s batched prefill at full width through the kernels, against
    the plain paths; returns each kernel's launches in the forwards."""
    from repro_torch import configs
    from repro_torch.launch.steps import (build_model, make_prefill_step,
                                          make_runtime)

    cfg = configs.get_arch(arch)
    shape = configs.shape_by_name("prefill_32k")
    model = build_model(cfg)
    rt = make_runtime(cfg, shape, use_kernels=True)
    rt_plain = make_runtime(cfg, shape, use_kernels=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, rt)
    step, step_plain = (make_prefill_step(model, rt),
                        make_prefill_step(model, rt_plain))
    counters = kernel_counters()
    runs, all_inputs = {}, {}
    totals = dict.fromkeys(counters, 0)
    for fn in counters.values():
        fn.launches = 0
    # prefill_32k's sequence with its batch cut from 32 to 1, and a
    # shorter batched prefill
    for seq, batch in ((shape.seq_len, 1), (2048, 4)):
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device="cuda")
        inputs = all_inputs[(seq, batch)] = {"tokens": tokens}
        want_launches = expected_launches(model, seq)
        walls = []
        for rep in range(3):                      # warm-up + 2 timed
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = {n: fn.launches for n, fn in counters.items()}
            t0 = time.perf_counter()
            logits = step(params, inputs)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            got_launches = {n: fn.launches - before[n]
                            for n, fn in counters.items()}
            check(got_launches == want_launches,
                  f"{arch} prefill at seq {seq} launched {got_launches} in "
                  f"a forward, expected {want_launches}")
            for n in totals:
                totals[n] += want_launches[n]
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = step_plain(params, inputs)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        v = cfg.vocab_size
        got, want = logits[:, :v].float(), ref[:, :v].float()
        check(tuple(logits.shape) == (batch, model.v_pad),
              f"prefill logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(got).all()), "prefill logits not finite")
        diff = (got - want).abs()
        check(bool((diff <= PREFILL_TOL * (1 + want.abs())).all()),
              f"{arch} prefill logits through the kernels differ from the "
              f"plain path by {float(diff.max())} at seq {seq}")
        tokens_check = next_token_check(got, want, f"{arch} seq {seq}")
        wall = float(np.median(walls[1:]))
        device = device_breakdown(
            {"forward": lambda: step(params, inputs)},
            {"rglru_gated_us": ("rglru_gated",),
             "rglru_scan_us": ("rglru_slab",),
             "flash_attention_us": ("flash_attention_kernel",),
             "matmul_us": ("gemm", "nvjet", "xmma")})["forward"]
        device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
        for n in totals:
            totals[n] += want_launches[n]
        runs[f"seq{seq}_batch{batch}"] = {
            "seq": seq, "batch": batch, "wall_s": wall, "walls_s": walls,
            "tokens_per_s": seq * batch / wall,
            "plain_wall_s": plain_s,
            "max_memory_allocated": peak,
            "launches_per_forward": want_launches,
            "max_abs_diff_vs_plain": float(diff.max()),
            **tokens_check,
            "tolerance": PREFILL_TOL,
            "device_one_forward": device}
    launches = {n: fn.launches for n, fn in counters.items()}
    check(launches == totals,
          f"{arch} prefill launched {launches}, expected {totals}")

    # each kernel against its plain version on every element of what the
    # main path hands it: the first and the last layer of each kind that
    # launches it, at both shapes
    failed = []
    for (seq, batch), inputs in all_inputs.items():
        name = f"seq{seq}_batch{batch}"
        runs[name]["kernel_vs_plain"] = {}
        for layer, (kernel, args) in kernel_inputs(
                model, params, inputs, rt,
                checked_layers(model, seq)).items():
            if kernel == "rglru_gated_scan":
                res = gated_against_plain(args, rt.compute_dtype)
            else:
                res = flash_against_plain(*args, causal=True)
            res["kernel"] = kernel
            res["shape"] = {"inputs": [list(t.shape) for t in args],
                            "dtype": str(args[0].dtype).split(".")[-1]}
            runs[name]["kernel_vs_plain"][f"layer{layer}"] = res
            if res["tol_ratio"] > 1.0:
                failed.append(f"{name} layer {layer} {kernel}: {res}")
    check_isolated()
    emit(f"prefill {arch}", arch=arch, layers=cfg.num_layers,
         kinds={k: model.kinds.count(k) for k in sorted(set(model.kinds))},
         param_dtype="bfloat16", compute_dtype="bfloat16",
         reduced={"prefill_32k": "global_batch 32 -> 1"},
         launches=launches,
         kernel_tolerance={"flash_attention": FLASH_TOL[torch.bfloat16],
                           "rglru_gated_scan": [*GATED_TOL,
                                                "+ one bf16 ulp"]},
         failed=failed, runs=runs)
    check(not failed, f"kernels != plain on the prefill's own inputs: "
                      f"{failed[:2]}")
    return launches


def position(pos: int, device="cuda") -> torch.Tensor:
    """A decode step's position: a 0-d int64 tensor on the device."""
    return torch.full((), pos, dtype=torch.int64, device=device)


def phase_serve() -> None:
    """`serve_requests` at full width on the card, held against the
    port's CPU run on the same weights (teacher-forced logits)."""
    from repro_torch import configs
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.steps import build_model, make_serve_step
    from repro_torch.models.layers import Runtime

    cfg = configs.get_arch(ARCH)
    model = build_model(cfg)
    rt = Runtime(compute_dtype=torch.float32)
    params_cpu = model.init(torch.Generator().manual_seed(0), rt)
    params = {"embed": params_cpu["embed"].cuda(),
              "final_norm": params_cpu["final_norm"].cuda(),
              "layers": [{k: (v.cuda() if torch.is_tensor(v)
                              else {n: t.cuda() for n, t in v.items()})
                          for k, v in layer.items()}
                         for layer in params_cpu["layers"]]}
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=rng.integers(4, 13))]
               for _ in range(8)]
    serve_requests(cfg, prompts[:1], batch=1, max_new=2, device="cuda",
                   params=params)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = serve_requests(cfg, prompts, batch=4, max_new=16,
                             device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(len(results) == 8 and all(len(r.generated) == 16
                                    for r in results),
          "serve did not answer every request with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.generated),
          "serve generated a token outside the vocabulary")

    # teacher-forced: request 0's prompt and its first 8 generated tokens
    # through the decode step on the card and on the CPU
    seq = results[0].prompt + results[0].generated[:8]
    out = {}
    for dev, p in (("cuda", params), ("cpu", params_cpu)):
        step = make_serve_step(model, rt)
        cache = model.init_cache(1, 64, rt, dev)
        rows = []
        for pos, t in enumerate(seq):
            tok = torch.full((1, 1), t, dtype=torch.int64, device=dev)
            logits, cache = step(p, cache, tok, position(pos, dev))
            rows.append(logits[0, 0, :cfg.vocab_size].cpu())
        out[dev] = torch.stack(rows)
    # where one decode step's time goes (the cache already holds `seq`)
    step = make_serve_step(model, rt)
    cache = model.init_cache(1, 64, rt, "cuda")
    tok = torch.full((1, 1), seq[0], dtype=torch.int64, device="cuda")
    step(params, cache, tok, position(0))
    pos1 = position(1)
    device = device_breakdown(
        {"decode_step": lambda: step(params, cache, tok, pos1)},
        {"matmul_us": ("gemm", "gemv", "nvjet", "xmma")})["decode_step"]
    device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
    diff = (out["cuda"] - out["cpu"]).abs()
    check(bool(torch.isfinite(out["cuda"]).all()), "served logits not finite")
    check(bool((diff <= SERVE_TOL * (1 + out["cpu"].abs())).all()),
          f"served logits on the card differ from the CPU by "
          f"{float(diff.max())}")
    same_next = float((out["cuda"].argmax(-1) == out["cpu"].argmax(-1))
                      .float().mean())
    generated = sum(len(r.generated) for r in results)
    check_isolated()
    emit(f"serve {ARCH}", arch=ARCH, layers=cfg.num_layers,
         compute_dtype="float32",
         requests=len(results), batch=4, max_new=16,
         prompt_lens=[len(p) for p in prompts], wall_s=wall,
         generated_tokens=generated, tokens_per_s=generated / wall,
         latency_s=[r.latency_s for r in results],
         teacher_forced_steps=len(seq),
         max_abs_diff_vs_cpu=float(diff.max()), tolerance=SERVE_TOL,
         argmax_agreement_vs_cpu=same_next, device_one_step=device)


def phase_serve_recurrent() -> dict:
    """recurrentgemma-9b's `serve_requests` at full width on the card,
    fp32, held against a teacher-forced full-sequence forward on the card
    (fp32, through the kernels) over each request's prompt and generated
    tokens: every decode logit within `SERVE_RG_TOL` of the forward's, and
    every served token the forward's greedy choice (a flip passes only
    where the forward's top-1 margin is within that tolerance)."""
    import gc

    from repro_torch import configs
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.steps import build_model, make_serve_step
    from repro_torch.models.layers import Runtime, full_precision_products

    gc.collect()
    torch.cuda.empty_cache()                    # the prefill's bf16 weights
    cfg = configs.get_arch(RG_ARCH)
    model = build_model(cfg)
    rt = Runtime(compute_dtype=torch.float32)
    rt_fwd = Runtime(compute_dtype=torch.float32, use_kernels=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=rng.integers(4, 13))]
               for _ in range(8)]
    serve_requests(cfg, prompts[:1], batch=1, max_new=2, max_len=256,
                   device="cuda", params=params)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = serve_requests(cfg, prompts, batch=4, max_new=16, max_len=256,
                             device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == 8 and all(len(r.generated) == 16
                                    for r in results),
          "serve did not answer every request with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.generated),
          "serve generated a token outside the vocabulary")

    atol, rtol = SERVE_RG_TOL
    step = make_serve_step(model, rt)
    v = cfg.vocab_size
    worst = {"max_abs_diff": 0.0, "tol_ratio": 0.0}
    steps = same = excused = reproduced = greedy = served = 0
    margin_min = float("inf")
    counters = kernel_counters()
    fwd_launches = dict.fromkeys(counters, 0)
    for r in results:
        seq = r.prompt + r.generated
        cache = model.init_cache(1, 256, rt, "cuda")
        rows = []
        for pos, t in enumerate(seq):
            tok = torch.full((1, 1), t, dtype=torch.int64, device="cuda")
            logits, cache = step(params, cache, tok, position(pos))
            rows.append(logits[0, 0, :v])
        dec = torch.stack(rows)
        # the forward's launches, counted from 0 just before it
        for fn in counters.values():
            fn.launches = 0
        with torch.inference_mode(), full_precision_products():
            fwd = model.forward(params, {"tokens": torch.tensor(
                [seq], device="cuda")}, rt_fwd)[0, :, :v].float()
        got = {n: fn.launches for n, fn in counters.items()}
        want = expected_launches(model, len(seq))
        want.update({"flash_attention_tensor_core": 0,
                     "flash_attention_cuda_core": want["flash_attention"]})
        check(got == want, f"request {r.request_id}: the fp32 forward "
                           f"launched {got}, expected {want}")
        for n in fwd_launches:
            fwd_launches[n] += got[n]
        check(bool(torch.isfinite(dec).all() and torch.isfinite(fwd).all()),
              "served or forward logits not finite")
        diff = (dec - fwd).abs()
        worst["max_abs_diff"] = max(worst["max_abs_diff"], float(diff.max()))
        worst["tol_ratio"] = max(worst["tol_ratio"], float(
            (diff / (atol + rtol * fwd.abs())).max()))
        top2 = fwd.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        tol_top = atol + rtol * top2[:, 0].abs()
        agree = dec.argmax(-1) == fwd.argmax(-1)
        steps += len(seq)
        same += int(agree.sum())
        excused += int((~agree & (margin <= tol_top)).sum())
        check(bool((agree | (margin <= tol_top)).all()),
              f"request {r.request_id}: a decode argmax differs from the "
              f"forward's where its margin exceeds the tolerance")
        # each served token is the forward's greedy choice at the position
        # before it, and the teacher-forced decode's
        p0 = len(r.prompt) - 1
        gen = torch.tensor(r.generated, device="cuda")
        fwd_next = fwd[p0:p0 + len(gen)].argmax(-1)
        ok = (fwd_next == gen) | (margin[p0:p0 + len(gen)]
                                  <= tol_top[p0:p0 + len(gen)])
        check(bool(ok.all()), f"request {r.request_id}: a served token is "
                              f"not the forward's greedy choice")
        reproduced += int((dec[p0:p0 + len(gen)].argmax(-1) == gen).sum())
        greedy += int((fwd_next == gen).sum())
        served += len(gen)
        margin_min = min(margin_min, float(margin.min()))
    # the fp32 forward's attention runs the CUDA-core kernel only
    check(fwd_launches["flash_attention_cuda_core"]
          == fwd_launches["flash_attention"] > 0
          and fwd_launches["flash_attention_tensor_core"] == 0,
          f"the fp32 forward launched {fwd_launches}: expected flash on "
          f"the CUDA cores only")
    check(worst["tol_ratio"] <= 1.0,
          f"decode logits differ from the forward's by "
          f"{worst['max_abs_diff']} (ratio {worst['tol_ratio']})")
    # where one decode step's time goes (a cache holding one token)
    cache = model.init_cache(1, 256, rt, "cuda")
    tok = torch.full((1, 1), prompts[0][0], dtype=torch.int64, device="cuda")
    _, cache = step(params, cache, tok, position(0))
    pos1 = position(1)
    device = device_breakdown(
        {"decode_step": lambda: step(params, cache, tok, pos1)},
        {"matmul_us": ("gemm", "gemv", "nvjet", "xmma")})["decode_step"]
    device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
    generated = sum(len(r.generated) for r in results)
    check_isolated()
    rec = dict(arch=RG_ARCH, layers=cfg.num_layers, compute_dtype="float32",
               level="smoke: toy context, no serve rate",
               requests=len(results), batch=4, max_new=16, max_len=256,
               prompt_lens=[len(p) for p in prompts], wall_s=wall,
               generated_tokens=generated, tokens_per_s=generated / wall,
               latency_s=[r.latency_s for r in results],
               max_memory_allocated=peak,
               teacher_forced_steps=steps, tolerance=SERVE_RG_TOL,
               max_abs_diff_vs_forward=worst["max_abs_diff"],
               tol_ratio=worst["tol_ratio"],
               argmax_agreement_vs_forward=same / steps,
               flips_excused=excused, forward_top1_margin_min=margin_min,
               served_tokens_reproduced_by_decode=reproduced / served,
               served_tokens_equal_forward_greedy=greedy / served,
               forward_launches=fwd_launches, device_one_step=device)
    emit(f"serve {RG_ARCH}", **rec)
    return rec


def matmul_bound(m, k, n, itemsize) -> dict:
    """Least time for one product: the larger of its 2 M K N FLOP at the
    bf16 tensor-core peak and its bytes (x and y read once, the output
    written once) at the HBM rate."""
    flops = 2 * m * k * n
    nbytes = itemsize * (m * k + k * n + m * n)
    t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return {"flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def matmul_against_plain(x, y, outs: dict, bk: int) -> dict:
    """Each output in `outs` (label -> [M, N]) against `matmul_plain(x, y,
    bk=bk)` on every element: |out - plain| <= 2 gamma_K (|x| @ |y|),
    gamma_K = K u / (1 - K u) with u = 2^-24, the bound of two fp32 sums of
    the same K products in any two orders; plus one bf16 ulp of the larger
    magnitude on bf16 outputs, where both round once.  The plain version
    runs `MATMUL_CHUNK` output elements at a time.  Returns per label the
    max abs error and the worst |error| / limit (passes at <= 1)."""
    from repro_torch.kernels.matmul import matmul_plain
    from repro_torch.models.layers import full_precision_products

    M, K = x.shape
    u = 2.0 ** -24
    rtol = 2 * K * u / (1 - K * u)
    rows = max(1, MATMUL_CHUNK // y.shape[1])
    res = {lab: {"max_abs_err": 0.0, "tol_ratio": 0.0, "finite": True}
           for lab in outs}
    dtype = next(iter(outs.values())).dtype
    with torch.inference_mode(), full_precision_products():
        ay = y.float().abs()
        for i in range(0, M, rows):
            want = matmul_plain(x[i:i + rows], y, bk=bk,
                                out_dtype=dtype).float()
            lim = rtol * (x[i:i + rows].float().abs() @ ay)
            for lab, out in outs.items():
                got = out[i:i + rows].float()
                diff = (got - want).abs()
                cap = lim
                if out.dtype == torch.bfloat16:
                    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
                    cap = lim + torch.ldexp(torch.ones_like(lim), e - 8)
                r = res[lab]
                r["max_abs_err"] = max(r["max_abs_err"], float(diff.max()))
                r["tol_ratio"] = max(r["tol_ratio"], float(
                    (diff / cap.clamp_min(1e-38)).max()))
                r["finite"] = r["finite"] and bool(torch.isfinite(got).all())
                del got, diff, cap
            del want, lim
    return res


def phase_matmul(gen) -> dict:
    """The matmul kernels against their plain version on the sweep of
    `tests/test_kernels.py` at its two tiles (16 cases: fp32 on the
    CUDA-core kernel, bf16 on the tensor-core one, K and N ragged in
    (33, 65, 17), which the wrapper zero-pads for TMA), and on an
    all-positive bf16 product at K = 12288 (x and y uniform in [0, 1): no
    cancellation, so a one-sided rounding bias of the tensor cores'
    accumulation shows at its largest against the bound), at both output
    dtypes; each dtype must move only its own kernel's counter.  The tile
    DSE's shapes are checked in its own phase."""
    from repro_torch.core.kernel_tune import tune_matmul_tiles
    from repro_torch.kernels import matmul as mm

    results, failed, moved = {}, [], {}
    for m, k, n in ((64, 64, 64), (200, 384, 136), (128, 1024, 96),
                    (33, 65, 17)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            y = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            for bm, bk, bn in ((64, 128, 64), (128, 64, 128)):
                label = f"{m}x{k}x{n} {str(dtype)[6:]} ({bm},{bk},{bn})"
                before = (mm.TENSOR_CORE.launches, mm.CUDA_CORE.launches)
                got = mm.matmul(x, y, bm=bm, bk=bk, bn=bn)
                moved[label] = ((mm.TENSOR_CORE.launches - before[0],
                                 mm.CUDA_CORE.launches - before[1]),
                                (0, 1) if dtype == torch.float32 else (1, 0))
                check(got.dtype == dtype and tuple(got.shape) == (m, n),
                      f"matmul {label}: {got.dtype} {tuple(got.shape)}")
                results[label] = matmul_against_plain(
                    x, y, {"out": got}, bk)["out"]
    m, k, n = POSITIVE_SHAPE
    x = torch.rand((m, k), generator=gen, device="cuda").bfloat16()
    y = torch.rand((k, n), generator=gen, device="cuda").bfloat16()
    best, _, _ = tune_matmul_tiles(m, k, n)
    for out_dtype in (torch.float32, torch.bfloat16):
        label = (f"all-positive {m}x{k}x{n} bfloat16 -> {str(out_dtype)[6:]}"
                 f" ({best.bm},{best.bk},{best.bn})")
        before = (mm.TENSOR_CORE.launches, mm.CUDA_CORE.launches)
        got = mm.matmul(x, y, bm=best.bm, bk=best.bk, bn=best.bn,
                        out_dtype=out_dtype)
        moved[label] = ((mm.TENSOR_CORE.launches - before[0],
                         mm.CUDA_CORE.launches - before[1]), (1, 0))
        results[label] = matmul_against_plain(x, y, {"out": got},
                                              best.bk)["out"]
    torch.cuda.synchronize()
    for label, res in results.items():
        if res["tol_ratio"] > 1.0 or not res["finite"]:
            failed.append(f"{label}: {res}")
        got_moved, want = moved[label]
        if got_moved != want:
            failed.append(f"{label}: (tensor-core, CUDA-core) launches "
                          f"{got_moved}, expected {want}")
    worst = {key: max(r[key] for r in results.values())
             for key in ("max_abs_err", "tol_ratio")}
    positive = {lab: r for lab, r in results.items()
                if lab.startswith("all-positive")}
    emit("kernel matmul", cases=results, worst=worst, positive=positive,
         tolerance="2 gamma_K (|x| @ |y|) + one bf16 ulp on bf16 outputs",
         failed=failed)
    check(not failed, f"matmul != plain on {len(failed)} cases: "
                      f"{failed[:3]}")
    return worst


def spearman(a, b):
    """Rank correlation of two sequences (average ranks for ties); None
    where one of them is constant."""
    def ranks(v):
        v = np.asarray(v, dtype=float)
        order = np.argsort(v, kind="stable")
        r = np.empty(len(v))
        r[order] = np.arange(len(v))
        for val in np.unique(v):                 # ties share their mean
            r[v == val] = r[v == val].mean()
        return r
    ra, rb = ranks(a), ranks(b)
    if ra.std() == 0 or rb.std() == 0:
        return None
    return float(np.corrcoef(ra, rb)[0, 1])


def phase_tile_dse(gen) -> dict:
    """The tile DSE on the card: for each of `TILE_SHAPES` (bf16), tune
    under the tensor-core tile model, then run every tile the tensor-core
    kernel is built for, each output against the plain version; then tune
    the fp32 `FP32_SHAPE` under the CUDA-core model and time the CUDA-core
    kernel at its pick.  Returns the launches of each kernel in this phase
    and the per-shape records."""
    from repro_torch.core.kernel_tune import tune_matmul_tiles
    from repro_torch.kernels import matmul as mm
    from repro_torch.models.layers import full_precision_products

    for fn in (mm.matmul, mm.TENSOR_CORE, mm.CUDA_CORE):
        fn.launches = 0
    shapes, failed = {}, []
    for label, (m, k, n) in TILE_SHAPES.items():
        x = torch.randn((m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        y = torch.randn((k, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        best, cost, ranking = tune_matmul_tiles(m, k, n, dtype_bytes=2)
        tuned = (best.bm, best.bk, best.bn)
        tiles = [(t.bm, t.bk, t.bn) for t, _ in ranking]
        if label == ONCE:
            tiles = [tuned]
        predicted = {(t.bm, t.bk, t.bn): lat * 1e3 for t, lat in ranking}
        outs, measured = {}, {}
        for t in tiles:
            outs[t] = mm.matmul(x, y, bm=t[0], bk=t[1], bn=t[2])
            reps = dict(reps=2, inner=1) if label == ONCE \
                else dict(reps=3, inner=2)
            measured[t] = device_ms(
                lambda: mm.matmul(x, y, bm=t[0], bk=t[1], bn=t[2]), **reps)
        torch.cuda.synchronize()
        checks = matmul_against_plain(x, y, {str(t): o
                                             for t, o in outs.items()},
                                      tuned[1])
        del outs
        for t, res in checks.items():
            if res["tol_ratio"] > 1.0 or not res["finite"]:
                failed.append(f"{label} tile {t}: {res}")
        with full_precision_products():
            library_ms = device_ms(lambda: torch.matmul(x, y), reps=3,
                                   inner=2)
            plain_ms = None if label == ONCE else device_ms(
                lambda: mm.matmul_plain(x, y, bk=tuned[1]), reps=1, inner=1)
        fastest = min(measured, key=measured.get)
        bound = matmul_bound(m, k, n, 2)
        shapes[label] = {
            "M": m, "K": k, "N": n, "dtype": "bfloat16",
            "kernel": mm.TENSOR_CORE.name,
            "tuned": list(tuned), "predicted_ms": predicted[tuned],
            "tuned_cost": cost, "fastest": list(fastest),
            "kernel_ms": measured[tuned],
            "bound_share": bound["bound_ms"] / measured[tuned],
            "library_share": library_ms / measured[tuned],
            "regret": (measured[tuned] / measured[fastest] - 1.0
                       if len(measured) > 1 else None),
            "rank_correlation": (spearman(
                [predicted[t] for t in tiles], [measured[t] for t in tiles])
                if len(tiles) > 1 else None),
            "tiles": [{"tile": list(t), "predicted_ms": predicted[t],
                       "measured_ms": measured[t],
                       "tol_ratio": checks[str(t)]["tol_ratio"]}
                      for t in tiles],
            "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
            "tol_ratio": max(r["tol_ratio"] for r in checks.values()),
            "plain_ms": plain_ms, "library_ms": library_ms, **bound}
        del x, y
    # the fp32 product on the CUDA cores, at the CUDA-core model's pick
    m, k, n = FP32_SHAPE
    x = torch.randn((m, k), generator=gen, device="cuda")
    y = torch.randn((k, n), generator=gen, device="cuda")
    best, cost, _ = tune_matmul_tiles(m, k, n, dtype_bytes=4)
    tuned = (best.bm, best.bk, best.bn)
    out = mm.matmul(x, y, bm=tuned[0], bk=tuned[1], bn=tuned[2])
    kernel_ms = device_ms(
        lambda: mm.matmul(x, y, bm=tuned[0], bk=tuned[1], bn=tuned[2]),
        reps=2, inner=1)
    res = matmul_against_plain(x, y, {"out": out}, tuned[1])["out"]
    del out
    if res["tol_ratio"] > 1.0 or not res["finite"]:
        failed.append(f"fp32 {FP32_SHAPE} tile {tuned}: {res}")
    with full_precision_products():
        library_ms = device_ms(lambda: torch.matmul(x, y), reps=2, inner=1)
        plain_ms = device_ms(lambda: mm.matmul_plain(x, y, bk=tuned[1]),
                             reps=1, inner=1)
    flop = 2 * m * k * n
    fp32 = {"M": m, "K": k, "N": n, "dtype": "float32",
            "kernel": mm.CUDA_CORE.name, "tuned": list(tuned),
            "predicted_ms": cost["latency_s"] * 1e3, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "flop": flop, "bytes": 4 * (m * k + k * n + m * n),
            "bound_ms": flop / FP32_FLOP_PER_S * 1e3,
            "bound_by": "operations (67 TFLOP/s fp32 FMA)",
            "bound_share": flop / FP32_FLOP_PER_S * 1e3 / kernel_ms,
            "max_abs_err": res["max_abs_err"], "tol_ratio": res["tol_ratio"]}
    del x, y
    launches = {fn.name: fn.launches for fn in (mm.TENSOR_CORE,
                                                mm.CUDA_CORE)}
    launches["matmul"] = mm.matmul.launches
    check_isolated()
    emit("tile_dse", shapes=shapes, fp32=fp32, launches=launches,
         failed=failed, tolerance="2 gamma_K (|x| @ |y|) + one bf16 ulp")
    check(not failed, f"matmul != plain in the tile DSE on {len(failed)} "
                      f"tiles: {failed[:3]}")
    for name, n_launch in launches.items():
        check(n_launch > 0, f"the tile DSE never launched {name}")
    check(launches["matmul"] == launches[mm.TENSOR_CORE.name]
          + launches[mm.CUDA_CORE.name],
          f"matmul launches {launches} do not add up")
    return {"launches": launches, "shapes": shapes, "fp32": fp32}


def phase_dryrun() -> dict:
    """Dry-runs of the two served archs at their serving cells on fake
    CUDA tensors, one greedy autotune over qwen2-0.5b's decode_32k (every
    record it wrote must be OK, its best score above 0), and the fake
    count of qwen2-0.5b's plain prefill at 2048 x 4 against the same step
    run on the card."""
    import gc
    import tempfile

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.autotune import CellEvaluator, autotune_search
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import (build_model, count_step,
                                          make_prefill_step, trace_step)

    cells, keys = {}, ("flops_per_chip", "hbm_bytes_per_chip",
                       "peak_memory_per_chip", "compute_s", "memory_s",
                       "memory_s_hlo", "roofline_s", "bottleneck",
                       "useful_compute_ratio")
    with tempfile.TemporaryDirectory() as tmp:
        for arch in (ARCH, RG_ARCH):
            for shape in ("prefill_32k", "decode_32k"):
                rec = run_cell(arch, shape, Path(tmp), device="cuda")
                check(rec["status"] == "OK",
                      f"dry-run {arch} {shape}: {rec.get('error')}")
                roof = rec["roofline"]
                check(roof["flops_per_chip"] > 0 and roof["roofline_s"] > 0,
                      f"dry-run {arch} {shape} counted nothing")
                # the three counts of the same step (the record keeps the
                # reference's keys, so they are counted again here)
                counts, _ = trace_step(configs.get_arch(arch),
                                       configs.shape_by_name(shape),
                                       device="cuda")
                check(counts.flops == roof["flops_per_chip"] ==
                      counts.matmul_flops + counts.elementwise_flops,
                      f"dry-run {arch} {shape}: {counts.flops} FLOPs "
                      f"counted, {roof['flops_per_chip']} in the record")
                cells[f"{arch} {shape}"] = {
                    **{k: roof[k] for k in keys},
                    "matmul_flops": counts.matmul_flops,
                    "elementwise_flops": counts.elementwise_flops,
                    "transcendentals": counts.transcendentals,
                    "elementwise_share": counts.elementwise_flops
                    / counts.flops,
                    "fits_hbm": rec["fits_hbm"], "trace_s": rec["compile_s"],
                    "flops_by_op": rec["flops_by_op"]}
        # the greedy search over a cell whose points fit the card's 80 GB
        log = []
        ev = CellEvaluator(ARCH, "decode_32k", cache_dir=tmp, device="cuda")
        t0 = time.perf_counter()
        best, score = autotune_search(ev, shape_mode="decode", seed=0,
                                      log=log)
        seconds = time.perf_counter() - t0
        greedy_runs = ev.n_compiles
        # another engine through FunctionEvaluator and the evaluator-mode
        # Study, over the same cell with its own memo (so it dry-runs its
        # points itself; its records are checked below too)
        rev = CellEvaluator(ARCH, "decode_32k",
                            cache_dir=Path(tmp) / "evaluator_mode",
                            device="cuda")
        t0 = time.perf_counter()
        rbest, rscore = autotune_search(rev, engine="random",
                                        shape_mode="decode", seed=0,
                                        max_rounds=2, batch=2)
        evaluator_mode = {
            "engine": "random", "rounds": 2, "batch": 2,
            "best": json.loads(json.dumps(dataclasses.asdict(rbest))),
            "score": rscore, "dry_runs": rev.n_compiles,
            "seconds": time.perf_counter() - t0}
        check(rscore > 0 and rev.n_compiles > 0,
              f"the random autotune scored {rev.cell} {rscore} after "
              f"{rev.n_compiles} dry-runs")
        records = {}
        for f in sorted(ev.dir.glob("*.json")) + sorted(
                rev.dir.glob("*.json")):
            rec = json.loads(f.read_text())
            check(rec.get("status") == "OK",
                  f"autotune record {f.name}: {rec.get('status')} "
                  f"{rec.get('error')}")
            roof = rec["roofline"]
            check(all(math.isfinite(roof[k]) and roof[k] > 0 for k in
                      ("peak_memory_per_chip", "roofline_s")),
                  f"autotune record {f.name}: peak "
                  f"{roof['peak_memory_per_chip']}, roofline "
                  f"{roof['roofline_s']}")
            records[str(f.relative_to(tmp))] = {
                "point": rec.get("point"),
                "peak_memory_per_chip": roof["peak_memory_per_chip"],
                "roofline_s": roof["roofline_s"]}
        scores = [x for r in log for x in
                  ([r["score"]] if r["event"] == "init" else r["scores"])]
        picked = json.loads(json.dumps(dataclasses.asdict(best)))
        autotune = {"cell": ev.cell, "best": picked,
                    "matmul_only_pick": MATMUL_ONLY_PICK,
                    "pick_moved": picked != MATMUL_ONLY_PICK,
                    "score": score, "dry_runs": greedy_runs,
                    "seconds": seconds, "records": records,
                    "rounds": [{"var": r["var"], "scores": r["scores"]}
                               for r in log if r["event"] == "round"],
                    "evaluator_mode": evaluator_mode}
        check(score > 0 and max(scores) > 0,
              f"the autotune scored {ev.cell} 0 at every point: {scores}")
        check(score == max(scores),
              f"the autotune kept {score}, below its best {max(scores)}")

    # the plain prefill at 2048 x 4: counted on fake tensors, then run
    cfg = configs.get_arch(ARCH)
    shape = ShapeSpec("prefill_2048x4", 2048, 4, "prefill")
    fake, rt = trace_step(cfg, shape, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                     device="cuda")}
    step = make_prefill_step(model, rt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits = step(params, batch)
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated() - base
    check(bool(torch.isfinite(logits.float()).all()),
          "the plain prefill's logits are not finite")
    del logits
    _, real = count_step(step, params, batch)
    torch.cuda.synchronize()
    ratio = real_peak / fake.peak_bytes
    check_isolated()
    three = ("flops", "matmul_flops", "elementwise_flops", "transcendentals")
    rec = {"cells": cells, "autotune": autotune,
           "prefill_2048x4": {
               **{f"fake_{k}": getattr(fake, k) for k in three},
               **{f"real_{k}": getattr(real, k) for k in three},
               "fake_flops_by_op": fake.flops_by_op,
               "fake_peak_bytes": fake.peak_bytes,
               "real_counted_peak_bytes": real.peak_bytes,
               "max_memory_allocated": real_peak,
               "real_over_fake_peak": ratio, "band": DRYRUN_PEAK_BAND,
               "fake_bytes_accessed": fake.bytes_accessed,
               "real_bytes_accessed": real.bytes_accessed}}
    emit("dryrun", **rec)
    for k in three:
        check(getattr(real, k) == getattr(fake, k),
              f"fake-tensor {k} {getattr(fake, k)} != the card's "
              f"{getattr(real, k)}")
    check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
          f"max_memory_allocated / dry-run peak = {ratio}, outside "
          f"{DRYRUN_PEAK_BAND}")
    return rec


def kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol:
    `flash_attention_kernel_wgmma<bf16,64>` (the tensor-core kernel takes
    bf16 only)."""
    base = re.search(r"([a-z_]+_kernel(?:_[a-z]+)?)", mangled)
    args = re.findall(r"Li(\d+)E", mangled)
    dtype = ("bf16" if "bfloat16" in mangled or "wgmma" in mangled
             else "f32")
    return (f"{base.group(1) if base else mangled}<{dtype}"
            + "".join(f",{a}" for a in args) + ">")


def ptxas_report(log: str) -> list:
    """Registers and spills of each kernel in one source's ptxas output,
    the kernel named by its template arguments, and any warning (a wgmma
    serialised, a setmaxnreg ignored)."""
    rows, name, spill = [], "", ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and name:
            rows.append(f"{name}: {ln.split(':', 1)[1].strip()}; {spill}")
            name = ""
        elif "warning" in ln.lower():
            rows.append(ln.strip())
    return rows


def sass_counts(lib: Path, opcode: str) -> dict:
    """Instructions of `opcode` in each kernel of a built library, from
    `cuobjdump -sass`, where the toolkit has it; else {}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            counts[name] = 0
        elif name and re.search(rf"\b{opcode}\b", ln):
            counts[name] += 1
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.apps import APP_NAMES
    from repro_torch.core.multiapp import AppSpec
    from repro_torch.core.space import default_space
    from repro_torch.kernels import build
    from repro_torch.kernels.gather import gather_rows

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc_build_s=build_s,
         ptxas={k: ptxas_report(v) for k, v in logs.items()},
         hgmma={name: sass_counts(build.library_path(name), "HGMMA")
                for name in ("flash_attention", "matmul")})

    rng = np.random.default_rng(0)
    space = default_space()
    specs = [AppSpec.from_app(n) for n in APP_NAMES]
    kern = phase_kernel(specs, space, rng)
    phase_scorer(specs, space, rng)
    launches = phase_study(APP_NAMES)
    zoo = phase_study_zoo()
    pareto_launches = phase_study_pareto()
    parallel = phase_study_parallel()
    phase_throughput([s for s in specs if s.name in ("inception", "nasnet")],
                     space, rng)
    flash = phase_flash(torch.Generator(device="cuda").manual_seed(0))
    rglru = phase_rglru(torch.Generator(device="cuda").manual_seed(1))
    # the kernels' launches on each model path, counted from 0 just before
    # it and read just after
    paths = {ARCH: phase_prefill(ARCH)}
    phase_serve()
    paths[RG_ARCH] = phase_prefill(RG_ARCH)
    fp32_fwd = phase_serve_recurrent()["forward_launches"]
    check_isolated()
    for name in ("flash_attention", "flash_attention_tensor_core",
                 "rglru_gated_scan"):
        check(paths[RG_ARCH][name] > 0,
              f"the {RG_ARCH} prefill never launched {name}")
    check(paths[ARCH]["flash_attention_tensor_core"] > 0,
          f"the {ARCH} prefill never launched the tensor-core flash kernel")
    mm = phase_matmul(torch.Generator(device="cuda").manual_seed(2))
    dse = phase_tile_dse(torch.Generator(device="cuda").manual_seed(3))
    phase_dryrun()

    t = kern["timings"][str(TIMED_POOLS[-1])]
    f, f32 = flash["timings"]["32768"], flash["timings"]["fp32_4096"]
    r = rglru["timings"]["1x32768"]
    rg = rglru["gated_timings"]["1x32768"]
    q = dse["shapes"]["quickstart 8192^3"]
    f32mm = dse["fp32"]
    flash_keys = ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by", "tflops", "bound_share")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "tpu": "src/repro/kernels/costmodel.py:gather_rows",
        "shape": {"C": t["C"], "U": t["U"], "O": t["O"], "dtype": "int64"},
        "launches": launches + parallel["parent"] + parallel["workers"],
        "launches_by_path": {
            "study, seven paper apps": launches,
            "study parallel, parent": parallel["parent"],
            "study parallel, pool workers (their own counts)":
                parallel["workers"],
            "study zoo, twelve traced apps": zoo["study"],
            "study zoo, genetic on qwen2-0.5b:prefill": zoo["genetic"],
            "study zoo, anneal on qwen2-0.5b:prefill": zoo["anneal"],
            "study pareto, genetic and nsga2 on ptb + wdl":
                pareto_launches},
        "max_abs_err": kern["max_abs_err"],
        "bit_equal": True, "ms": t["int64_kernel_ms"],
        "kernel_ms": t["int64_kernel_ms"], "plain_ms": t["int64_plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": t["int64_library_ms"]}, {
        "name": "flash_attention_tensor_core", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_TPU,
        "tpu": "src/repro/kernels/flash_attention.py:_flash_kernel",
        "symbol": "flash_attention_kernel_wgmma",
        "shape": {k: f[k] for k in ("B", "S", "H", "KV", "hd", "causal",
                                     "dtype")},
        "launches": sum(p["flash_attention_tensor_core"]
                        for p in paths.values()),
        "launches_by_path": {f"prefill {a}": p["flash_attention_tensor_core"]
                             for a, p in paths.items()},
        "max_abs_err": flash["max_abs_err"]["bfloat16"],
        "ms": f["kernel_ms"], "kernel_ms": f["kernel_ms"],
        "plain_ms": flash["timings"]["4096"]["plain_ms"],
        "plain_shape": {"S": 4096},
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "library_ms": f["library_ms"], "tflops": f["tflops"],
        "bound_share": f["bound_share"],
        **{f"at_{key}": {k: flash["timings"][key][k]
                         for k in ("B", "S", "H", "KV", "hd") + flash_keys}
           for key in ("4096", "hd256", "hd128")}}, {
        "name": "flash_attention_cuda_core", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_TPU,
        "tpu": "src/repro/kernels/flash_attention.py:_flash_kernel",
        "symbol": "flash_attention_kernel",
        "shape": {k: f32[k] for k in ("B", "S", "H", "KV", "hd", "causal",
                                       "dtype")},
        "launches": fp32_fwd["flash_attention_cuda_core"],
        "launches_by_path": {f"serve {RG_ARCH}, fp32 teacher-forced "
                             "forward": fp32_fwd["flash_attention_cuda_core"],
                             **{f"prefill {a}": p["flash_attention_cuda_core"]
                                for a, p in paths.items()}},
        "max_abs_err": flash["max_abs_err"]["float32"],
        "ms": f32["kernel_ms"], "kernel_ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "tflops": f32["tflops"], "bound_share": f32["bound_share"]}, {
        "name": "rglru_gated_scan", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_TPU,
        "tpu": "src/repro/kernels/rg_lru.py:_scan_kernel",
        "symbol": "rglru_gated_kernel",
        "shape": {k: rg[k] for k in ("B", "S", "W", "heads", "dtypes")},
        "launches": paths[RG_ARCH]["rglru_gated_scan"],
        "launches_by_path": {
            f"prefill {RG_ARCH}": paths[RG_ARCH]["rglru_gated_scan"],
            f"serve {RG_ARCH}, fp32 teacher-forced forward":
                fp32_fwd["rglru_gated_scan"],
            "rglru block, fused route": rglru["block_launches"]["fused"][
                "rglru_gated_scan"]},
        "max_abs_err": rglru["gated_max_abs_err"],
        "ms": rg["kernel_ms"], "kernel_ms": rg["kernel_ms"],
        "plain_ms": rg["plain_ms"], "bound_ms": rg["bound_ms"],
        "bound_by": rg["bound_by"], "bound_share": rg["bound_share"],
        "library_ms": None, "library": RGLRU_LIBRARY,
        "at_4x2048": {k: rglru["gated_timings"]["4x2048"][k]
                      for k in ("kernel_ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_share")},
        "block_ms": {shape: {k: blk[k] for k in ("today_ms", "fused_ms")}
                     for shape, blk in rglru["block"].items()}}, {
        "name": "rglru_scan", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_TPU,
        "tpu": "src/repro/kernels/rg_lru.py:_scan_kernel",
        "symbol": "rglru_slab_kernel",
        "shape": {k: r[k] for k in ("B", "S", "W", "dtype")},
        "launches": rglru["block_launches"]["today"]["rglru_scan"],
        "launches_by_path": {
            "rglru block, the route before the gated kernel":
                rglru["block_launches"]["today"]["rglru_scan"],
            "rglru block, fused route":
                rglru["block_launches"]["fused"]["rglru_scan"],
            f"prefill {RG_ARCH}": paths[RG_ARCH]["rglru_scan"],
            f"serve {RG_ARCH}, fp32 teacher-forced forward":
                fp32_fwd["rglru_scan"]},
        "max_abs_err": rglru["max_abs_err"],
        "ms": r["kernel_ms"], "kernel_ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "bound_share": r["bound_share"],
        "library_ms": None, "library": RGLRU_LIBRARY,
        "at_4x2048": {k: rglru["timings"]["4x2048"][k]
                      for k in ("kernel_ms", "plain_ms", "bound_ms",
                                "bound_by", "bound_share")}}, {
        "name": "matmul_tensor_core", "route": "cuda",
        "source": MATMUL_SOURCE, "replaces": MATMUL_TPU,
        "tpu": "src/repro/kernels/matmul.py:_matmul_kernel",
        "symbol": "tc::matmul_kernel_wgmma",
        "shape": {k: q[k] for k in ("M", "K", "N", "dtype", "tuned")},
        "launches": dse["launches"]["matmul_tensor_core"],
        "launches_by_path": {
            "tile_dse": dse["launches"]["matmul_tensor_core"],
            **{f"prefill {a}": p["matmul_tensor_core"]
               for a, p in paths.items()}},
        "max_abs_err": max([mm["max_abs_err"]]
                           + [r["max_abs_err"]
                              for r in dse["shapes"].values()]),
        "ms": q["kernel_ms"], "kernel_ms": q["kernel_ms"],
        "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
        "bound_by": q["bound_by"], "library_ms": q["library_ms"],
        "library": "torch.matmul", "bound_share": q["bound_share"],
        "at": {label: {k: r[k] for k in ("M", "K", "N", "tuned", "fastest",
                                         "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms",
                                         "bound_by", "bound_share", "regret",
                                         "rank_correlation")}
               for label, r in dse["shapes"].items()}}, {
        "name": "matmul_cuda_core", "route": "cuda", "source": MATMUL_SOURCE,
        "replaces": MATMUL_TPU,
        "tpu": "src/repro/kernels/matmul.py:_matmul_kernel",
        "symbol": "matmul_kernel",
        "shape": {k: f32mm[k] for k in ("M", "K", "N", "dtype", "tuned")},
        "launches": dse["launches"]["matmul_cuda_core"],
        "launches_by_path": {
            "tile_dse": dse["launches"]["matmul_cuda_core"],
            **{f"prefill {a}": p["matmul_cuda_core"]
               for a, p in paths.items()}},
        "max_abs_err": f32mm["max_abs_err"],
        "ms": f32mm["kernel_ms"], "kernel_ms": f32mm["kernel_ms"],
        "plain_ms": f32mm["plain_ms"], "bound_ms": f32mm["bound_ms"],
        "bound_by": "operations", "library_ms": f32mm["library_ms"],
        "library": "torch.matmul (fp32, TF32 off)",
        "bound_share": f32mm["bound_share"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
