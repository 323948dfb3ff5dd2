#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc` (one
nvcc per source, all started together), then runs these phases in order,
printing one JSON line each:

  1. device      the card, its power limit, the nvcc build time, each
                 kernel's registers, spills and ptxas warnings, the HGMMA
                 instructions of each flash and matmul kernel, and the
                 FFMA, HMMA and HGMMA of the fp32 CUDA-core ones, which
                 must hold no tensor-core instruction (`cuobjdump`);
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
  5. study zoo   the model-zoo frontend on the main path: the twenty zoo
                 apps of the ten archs traced on meta tensors (each
                 app's seconds, compute ops and data vertices), a twenty-app
                 `GeomeanAcrossApps` greedy `Study` on the card and on the
                 CPU selecting the same config and per-app bests (the
                 kernel launched on the card only, neither jax nor the JAX
                 package imported), then the genetic and anneal engines on
                 qwen2-0.5b:prefill on both, each with the same best;
  6. study pareto
                 the analysis API on the main path: `evaluate_stream_many`'s
                 two device passes on the card, the table pass (the
                 default: `gather_rows` over the unique op columns) and
                 the broadcast pass, against one numpy oracle
                 (`backend="numpy-ref"`, in worker processes) bit for bit
                 (total cycles, validity and the five [C, O] parts) on the
                 seven paper apps and two traced zoo apps at pools of 4097
                 and 65536 from the Table-2 space (peaks on and off, every
                 loop order), at 262144 (cycles and validity) on inception
                 and qwen2-0.5b:prefill, and on a stream with a zero-size
                 kernel (which the default sends to the broadcast pass);
                 the dispatch at 63 and 64 configs; both passes' times
                 against `FusedTorchScorer.metrics` on the same pools, with
                 their peak memory and `gather_rows` launches a call, and
                 one `torch.profiler` call of each at qwen2-0.5b:prefill
                 262144, by kind, with the host's share; then a
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
  8. examples    the port's four DSE examples (`examples/torch_*.py`:
                 quickstart, dse_accelerator with greedy, compose_serving
                 with --smoke, trace_model) and the serving example
                 (`torch_serve_lm`) as subprocesses on the card and with
                 --device cpu, all at once: exit code 0, wall seconds; the
                 DSE examples' stdout equal and the `gather_rows` launches
                 each prints on stderr (> 0 on the card for the three that
                 search); the serving example's request lines equal, and
                 its card tokens teacher-forced through the decode step
                 on both devices (gated within `SERVE_TOL` where a token
                 differs; the smallest top-two gap printed);
  9. throughput  the random engine at 262144-config pools on inception and
                 nasnet, on the card, with where the time goes: the scorer's
                 device time by kind (`torch.profiler`) and the search's
                 host time by function (`cProfile`, one round);
 10. kernel flash_attention
                 `flash_attention` against its plain PyTorch version, every
                 output element within a tolerance of about one bf16 ulp, on
                 the sweep of `tests/test_kernels.py`, on qwen2-0.5b's heads
                 at S = 512 to 32768, on recurrentgemma-9b's (head dim 256)
                 and on mistral-nemo-12b's (32 heads on 8 KV heads of 128)
                 (causal Sq != Skv included, the prefills' shapes on random
                 inputs): bf16 at head dims 64-256 runs the tensor-core
                 kernel, fp32 and bf16 at 16-32 the CUDA-core one (fp32
                 at olmoe-1b-7b's [4, 2048, 16/16, 128] and recurrentgemma-
                 9b's [4, 2048, 16/1, 256] too).  Then CUDA-event times of
                 the kernel, of `scaled_dot_product_attention` and of the
                 plain version, each row with the kernel that ran, its
                 TFLOP/s and its share of the bound, the CUDA-core kernel's
                 at hd 64, 128 and 256;
 11. kernel rglru_scan
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
 12. prefill qwen2-0.5b
                 the second main path: `make_prefill_step` at full width
                 (24 layers, bf16 weights, `use_kernels=True`) at seq 32768
                 x batch 1 (prefill_32k with its batch cut from 32) and seq
                 2048 x batch 4, held against the same step through the
                 plain paths (logits and next token), with 24 kernel
                 launches a forward, every one on the tensor cores (and
                 none of `matmul`, counted); then the kernel against its
                 plain version on the q, k, v that the first and the last
                 layer hand it at both shapes, every row;
 13. serve qwen2-0.5b
                 `serve_requests` at full width (fp32 compute): 8 requests
                 of 4-12 prompt tokens, batch 4, 16 new tokens each, held
                 against the port's own CPU run on the same weights;
 14. prefill recurrentgemma-9b
                 the third main path, as phase 12 at the same two shapes (38
                 layers: 26 RG-LRU, 12 local attention): 26
                 `rglru_gated_scan` launches a forward at both shapes (and
                 no bare scan), 12 `flash_attention` (on
                 the tensor cores) at seq 2048 (S <= the 2048 window) and
                 none at 32768 (local-block attention); then each kernel
                 against its plain version on what the first and last
                 layer of its kind hand it;
 15. serve recurrentgemma-9b
                 `serve_requests` at full width, fp32 compute: 8 requests of
                 4-12 prompt tokens, batch 4, `SERVE_NEW` new tokens,
                 caches of 256,
                 held against a teacher-forced full-sequence forward on the
                 card (fp32, `use_kernels=True`: its attention on the
                 CUDA-core flash kernel only) over each request's prompt
                 and generated tokens;
 16. prefill olmoe-1b-7b
                 the MoE main path, as phase 12 at the same two shapes (16
                 layers, 64 experts top-8, 6.92e9 parameters in bf16): 16
                 tensor-core flash launches a forward, the kernel against
                 its plain version on the first and last layer's q, k, v.
                 Its bf16 logits are printed against the plain path's with
                 the share of (token, layer) top-k expert sets that agree,
                 not gated (a near-tied router flips on a bf16-level
                 difference); the whole forward is gated in fp32 at seq
                 2048 x batch 4 instead (the CUDA-core flash kernel, 16
                 launches) against the plain fp32 path, logits within
                 `PREFILL_TOL` and the same next token.  Wall, tokens/s,
                 device time by kind (flash, cuBLAS, the MoE dispatch) and
                 `max_memory_allocated` at each shape;
 17. serve olmoe-1b-7b
                 as phase 15 (fp32 weights): the teacher-forced forward
                 runs drop-free (capacity factor 16, as
                 `tests/test_decode_parity.py` holds the reference) and
                 prints the pairs it would drop at the configuration's
                 1.25; it takes the decode's expert choices, so the two
                 compute one function (a near-tied router flips on the
                 bf16 cache's rounding), and each choice that differs from
                 the forward's own must lie within the two paths'
                 router-logit difference; the flips are counted.  Its
                 served decode (bf16 caches) is gated against a third
                 forward that reads the decode's own caches at every
                 attention layer (`reads_the_cache`), within
                 `SERVE_RG_TOL`, and every cache entry the decode wrote
                 within one bf16 rounding of that forward's own value
                 (`cache_against_forward`);
 18. prefill deepseek-v2-lite-16b
                 as phase 16 at the same two shapes (27 layers: one dense,
                 26 MoE with 64 routed experts top-6 and 2 shared; MLA;
                 1.62e10 parameters in bf16): no kernel runs (MLA's
                 attention is `blocked_attention`, as in the reference),
                 0 flash launches counted; wall, tokens/s, device time by
                 kind and `max_memory_allocated`, finite logits;
 19. serve deepseek-v2-lite-16b
                 as phase 17 with bf16 weights and fp32 compute: the
                 weight-absorbed decode over the latent cache against the
                 drop-free expanded forward (its latent and RoPE key read
                 from the decode's cache in the gated third forward); the
                 cache's bytes a token and layer beside GQA's;
 20. xlstm blocks
                 one full-width mLSTM and one sLSTM block of xlstm-1.3b in
                 fp32 at B 2 x S 549 (two chunks of 256, a padded third):
                 the chunkwise and scan forms against the step form in
                 float64, every element within `BLOCK_TOL`;
 21. prefill xlstm-1.3b
                 the xLSTM main path (48 layers: 42 mLSTM, 6 sLSTM; bf16
                 weights): no kernel runs, every counter 0; seq 2048 x
                 batch 4 (device time by kind, idle share) and prefill_32k
                 with its batch cut to 1 and its depth to 8 layers (one
                 whole unit, `XLSTM_LONG_LAYERS`, as its profiled 2048 x 4
                 forward; or 8192, see
                 `XLSTM_LONG_BUDGET_S`); the fp32 forward's last logits at
                 `XLSTM_GATE_SEQ` tokens gated against the fp32 decode loop,
                 the bf16 forward's gap printed;
 22. serve xlstm-1.3b
                 as phase 15 (fp32 weights): the decode's caches are all
                 fp32 state, so its gap to the teacher-forced forward is
                 gated directly;
 23. prefill whisper-medium
                 the encoder-decoder's main path at full width (24 + 24
                 layers, d 1024, 16 heads of 64; bf16 weights, random
                 frames [B, 1500, 1024]): seq 2048 x batch 4 and 32,768 x 1
                 (prefill_32k's batch cut to 1), no kernel runs (its
                 attention is `blocked_attention`, as in the reference),
                 every counter 0; wall, tokens/s, device time by kind, idle
                 share, `max_memory_allocated`; the fp32 forward's last
                 logits at `WHISPER_GATE_SEQ` tokens gated against the
                 fp32 decode loop, its cross caches filled from the same
                 encoder output (`fill_cross`);
 24. serve whisper-medium
                 `serve_requests` at full width, fp32, 8 requests, batch
                 4, `SERVE_NEW` new tokens, caches of 256, the
                 reference's zeroed
                 cross caches: the served decode gated against a forward
                 that reads its own caches (`encdec_reads_the_cache`),
                 every cache entry within one bf16 rounding; and the
                 decode over cross caches filled from random frames gated
                 against the forward over the same frames;
 25. train qwen2-0.5b
                 the training path (no kernel on it, as in the reference:
                 every counter 0 over the phase): the train step on the
                 card against the CPU from the same params (smoke config,
                 fp32, 4 x 32, 5 steps, 1 and 2 microbatches), losses,
                 grad norms and params within `TRAIN_TOL`; `train_loop` at
                 full width (24 layers, 4.94e8 parameters, fp32, 8 x 512,
                 lr 3e-4, 12 steps, checkpoints every 6, each save's
                 seconds and bytes): a run resumed from step 6 gives the
                 last six losses, and the same train step learns one
                 batch of the stream (`TRAIN_LEARNS_BY`; the stream itself
                 is near uniform at full vocab, its fall printed); at
                 full width the gradients under remat none / full / dots
                 and of 2 microbatches against 1 agree; the train cell's
                 runtime (bf16 compute, remat "full") at 4096 x 4 in 2
                 microbatches (train_4k's batch cut from 256): step time,
                 tokens/s, counted FLOPs and their share of 989 TFLOP/s,
                 `max_memory_allocated` within `DRYRUN_PEAK_BAND` of the
                 same step counted on fake CUDA tensors, one profiled
                 step;
 26. mesh qwen2-0.5b
                 the sharding layer: a one-rank NCCL process group made in
                 this process, a (1, 1) mesh on ("data", "model"), the
                 full-width bf16 serving params placed by `step_placements`
                 + `place_params` (seconds of the group's init and of the
                 placement, each leaf's local and global bytes); the
                 prefill at 2048 x 4 through the kernels on the placed
                 leaves' local tensors bit-equal to the unplaced step (24
                 tensor-core flash launches, counted from 0), and one
                 decode step on placed caches bit-equal too; then the
                 plain prefill and a decode step on the DTensors
                 themselves (the models' sharding sites in play) bit-equal
                 to the step bodies on the unplaced params, no kernel
                 launched, the flash branch refusing DTensors, and the
                 placed prefill's fake count (`MESH_COUNT_LAYERS` layers)
                 equal to the unplaced one with no collective; the group
                 is destroyed before the phase returns;
 27. kernel matmul
                 `matmul` against its plain PyTorch version on every element,
                 within the fp32 summation bound (`matmul_against_plain`),
                 on the sweep of `tests/test_kernels.py` at its two tiles
                 (fp32 on the CUDA-core kernel, bf16 on the tensor-core
                 one: each case must move only its kernel's counter) and on
                 an all-positive bf16 product at K = 12288, both output
                 dtypes (phase 28 holds the tile DSE's shapes, at every
                 tile);
 28. tile_dse    the fourth main path: for each of `TILE_SHAPES` (bf16),
                 `tune_matmul_tiles` picks a tile under the tensor-core
                 model and `matmul` runs at it and at every other tile the
                 tensor-core kernel is built for, each output held against
                 the plain version; predicted and measured time per tile,
                 their rank correlation, the tuned tile's regret against
                 the fastest, its share of the bound, and CUDA-event times
                 of the plain version and `torch.matmul`; the LM-head shape
                 (M N > 2^31) runs once, at its tuned tile.  Then the fp32
                 `FP32_SHAPE` on the CUDA-core kernel at every tile it is
                 built for, each output held against the plain version,
                 with the CUDA-core model's pick, its regret and rank
                 correlation as for bf16, beside its 67 TFLOP/s bound;
 29. dryrun      `run_cell` for qwen2-0.5b, recurrentgemma-9b, olmoe-1b-7b,
                 deepseek-v2-lite-16b, whisper-medium and xlstm-1.3b at
                 prefill_32k and decode_32k, xlstm-1.3b at long_500k and
                 qwen2.5-32b at decode_32k over the f8 KV cache (its
                 analytic bytes and peak at one byte an element), these
                 in a spawned process beside the rest, and
                 qwen2-0.5b at train_4k (batch 256, 2 microbatches, remat
                 "full") on fake CUDA tensors (full batch; every record
                 OK with a finite peak and roofline), each cell's matmul
                 and elementwise FLOPs and transcendentals, a random
                 `autotune_search` of 1 point (cut from 4 for the time)
                 over the train cell's execution space (its peak and
                 score), `MESH_DRYRUN_CELLS` counted per rank on 16x16
                 and 2x16x16 in a second spawned process (each
                 OK with its chips, each rank's params its leaves' shard
                 shapes, a finite roofline, its collectives by kind and
                 trace seconds printed; whisper-medium's decode_32k with
                 the all-to-all of its self-attention's reshard) and
                 xlstm-1.3b at train_4k (batch 256, 4 microbatches,
                 remat "full"; its scans replayed) in a third one,
                 one greedy `autotune_search` over
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

import contextlib
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
MOE_ARCH = "olmoe-1b-7b"
MLA_ARCH = "deepseek-v2-lite-16b"
XLSTM_ARCH = "xlstm-1.3b"
WHISPER_ARCH = "whisper-medium"
# the arch whose decode_32k the reference's dry-run gives an f8 KV cache
F8_ARCH = "qwen2.5-32b"
# the xLSTM block check: a chunkwise / scan form against its step form,
# (rtol, atol) of tests/test_recurrent_blocks.py; two chunks of 256 and a
# padded third
BLOCK_TOL = (2e-4, 2e-4)
BLOCK_SHAPE = (2, 2 * 256 + 37)
# the xLSTM prefill's fp32 gate: its last-position logits against the
# fp32 decode loop over the same tokens (two chunks, the second padded)
XLSTM_GATE_SEQ = 300
# the longest xLSTM prefill the phase runs: its sLSTM steps are launch-
# bound, so a forward's time grows with its length; the 32k forward runs
# if 16 times the 2048 x 4 forward's time is within this, else 8192
XLSTM_LONG_BUDGET_S = 120.0
# the training phase (qwen2-0.5b): part 1, the train step on the card
# against the CPU on the smoke config (fp32, batch x seq, steps; both
# microbatch counts; the schedule `make_train_step`'s default); losses and
# grad norms within TRAIN_TOL relative, each step's gradients and the
# optimizer's update of the same gradients within TRAIN_TOL of each
# leaf's largest magnitude
TRAIN_PARITY = {"batch": 4, "seq": 32, "steps": 5, "microbatches": (1, 2),
                "schedule": {"base_lr": 3e-4, "warmup_steps": 100,
                             "total_steps": 10000}}
TRAIN_TOL = 1e-5
# part 2, `train_loop` at full width, fp32, the reference CLI's lr and
# warmup (steps // 10): the uninterrupted run saves every `save_every`
# steps; the resumed run restarts from the middle checkpoint.  Fixed
# before the first run on the card
TRAIN_LOOP = {"steps": 12, "global_batch": 8, "seq_len": 512, "lr": 3e-4,
              "save_every": 6}
# the learning criterion of tests/test_system.py: the mean of the last
# five losses below the first five's by at least this.  `train_loop`'s
# run does not meet it at 151,936 tokens: the stream's next token is
# learnt context by context (previous token and the batch's multiplier),
# and 12 steps of 8 x 512 see each context about once
# (tools/train_learnability.py); the criterion holds the same train step
# (its lr schedule, `TRAIN_LOOP`'s steps) fitting one batch of the
# stream, and `train_loop`'s own fall is printed
TRAIN_LEARNS_BY = 0.05
# part 3, gradients at full width (fp32, batch x seq): remat none / full /
# dots and microbatches 2 against 1; the loss of two microbatches within
# TRAIN_MB_LOSS_TOL relative of one
TRAIN_GRAD_SHAPE = (4, 512)
TRAIN_MB_LOSS_TOL = 1e-6
# part 4, the train cell's runtime (bf16 compute, fp32 params, remat
# "full") at train_4k's sequence, its batch cut from 256
TRAIN_CELL = {"batch": 4, "seq": 4096, "microbatches": 2, "steps": 5}
# the dry-run's train autotune: a random search over the train_4k cell's
# execution space (remat and microbatches move its step, and on one GPU
# the attention's KV tile): one round (cut from 2) of one point (cut from
# 2 when the mesh cells came in), each cut for the time
TRAIN_AUTOTUNE_ROUNDS = 1
TRAIN_AUTOTUNE_POINTS = 1
# the longest xLSTM prefill, and the profiled 2048 x 4 forward, run at
# this depth: one whole 7:1 unit of xlstm-1.3b's six (the depth cuts for
# the training phase's time)
XLSTM_LONG_LAYERS = 8
# whisper's fp32 prefill gate: its last-position logits against the fp32
# decode loop over the same tokens, cross caches from the same frames
WHISPER_GATE_SEQ = 256
# the served requests whose sequences whisper's serve phase also decodes
# over cross caches filled from frames (the first ones)
FILLED_REQUESTS = 4
# the kernels of the MoE block's dispatch and combine (top-k, the one-hot's
# cumsum, the index scatter, the token gathers), by name substring
MOE_DISPATCH_KERNELS = ("gatherTopK", "sort", "Sort", "scan", "index_put",
                        "indexing", "scatter_gather", "gather_kernel")
# prefill logits, kernel path against the plain path, both bf16:
# |a - b| <= PREFILL_TOL * (1 + |b|), about 4x the largest gap measured
# (0.0054 on the H100 for qwen2-0.5b); the blocked path also rounds p to
# bf16.  A next token may differ only where the plain path's top-1 margin
# is within that tolerance: then either token is the model's.
PREFILL_TOL = 0.02
# new tokens a request in the fp32 serve phases of recurrentgemma-9b,
# olmoe-1b-7b, deepseek-v2-lite-16b, xlstm-1.3b and whisper-medium: the
# smoke's time (their checks decode each request token by token; the one
# forward a request launches the same kernels at any length)
SERVE_NEW = 8
# a prefill forward longer than this runs once, its own warm-up, where
# shorter ones run a warm-up and 2 timed (deepseek-v2-lite-16b's and
# whisper-medium's at 32k, 16 and 11 s, whose three runs agreed within
# 0.1 %, and xlstm-1.3b's at 2048 x 4 on a slow host): the smoke's time
LONG_FORWARD_S = 8.0
# served logits, card against CPU, fp32 with TF32 off: the only gap is the
# summation order, plus the odd K/V entry that rounds to the other bf16
# neighbour in the cache; |a - b| <= SERVE_TOL * (1 + |b|)
SERVE_TOL = 2e-3
# recurrentgemma's decode logits against its full-sequence forward, both
# fp32 on the card: the decode path keeps K and V in a bf16 cache, the
# forward does not; (atol, rtol) of tests/test_decode_parity.py
SERVE_RG_TOL = (5e-3, 2e-2)
# a bf16 cache entry against the fp32 value the forward computes for it:
# one bf16 rounding, |cache - fwd| <= CACHE_RTOL |fwd| + CACHE_ATOL (the
# bound of tests/test_torch_mla.py, the reference's cache on the CPU)
CACHE_RTOL, CACHE_ATOL = 2 ** -8, 2 ** -8
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
# the roofline figures the dry-run phase keeps of each cell
ROOFLINE_KEYS = ("flops_per_chip", "hbm_bytes_per_chip",
                 "peak_memory_per_chip", "compute_s", "memory_s",
                 "memory_s_hlo", "roofline_s", "bottleneck",
                 "useful_compute_ratio")
# the dry-run phase's serving cells: every served arch's prefill_32k and
# decode_32k, xlstm-1.3b's long_500k, qwen2.5-32b's decode_32k over the f8
# cache
DRYRUN_SERVING_CELLS = tuple(
    [(a, s) for a in (ARCH, RG_ARCH, MOE_ARCH, MLA_ARCH, WHISPER_ARCH)
     for s in ("prefill_32k", "decode_32k")]
    + [(XLSTM_ARCH, s) for s in ("prefill_32k", "decode_32k", "long_500k")]
    + [(F8_ARCH, "decode_32k")])
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
# the table pass, the broadcast pass and the fused scorer timed at
# BROADCAST_BIG on these (and on BROADCAST_TIMED at every pool), one
# `torch.profiler` call of each at PROFILED_APP
TIMED_APPS = (BROADCAST_TIMED, "nasnet", "qwen2-0.5b:prefill",
              "recurrentgemma-9b:decode")
PROFILED_APP = "qwen2-0.5b:prefill"
PROFILE_KINDS = {"gather_rows_us": ("gather_rows_kernel",),
                 "index_us": ("index_elementwise", "indexSelect",
                              "index_put", "gather_kernel"),
                 "reduce_us": ("reduce_kernel",),
                 "elementwise_us": ("elementwise_kernel",)}
# the numpy oracle is host-bound: it runs in worker processes, each in row
# chunks (rows are independent, so chunks change no bit)
ORACLE_WORKERS = 7
ORACLE_CHUNK = 16384
PARETO_BUDGETS = (30000.0, 60000.0, 90000.0)
# phase mesh: qwen2-0.5b's prefill (batch, seq) on a one-rank mesh, and
# the decode caches' length
MESH_PREFILL = (4, 2048)
MESH_CACHE = 256
# the placed prefill's fake count on the one-rank mesh: full width, its
# depth cut to this many layers (a count's cost grows with the layers)
MESH_COUNT_LAYERS = 2
# the dry-run cells counted per rank on the reference's meshes: (arch,
# shape, multi_pod) — 16x16 (256 ranks) and 2x16x16 (512 ranks)
MESH_DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", False),
                     ("olmoe-1b-7b", "decode_32k", True),
                     ("whisper-medium", "decode_32k", False))
# phase study parallel: benchmarks/composition_sweep.py's apps and budget
# the port's examples (examples/<name>.py) and their arguments, run with
# --device cuda and --device cpu
EXAMPLES = {"torch_quickstart": [],
            "torch_dse_accelerator": ["--engine", "greedy"],
            "torch_compose_serving": ["--smoke"],
            "torch_trace_model": []}
EXAMPLES_THAT_SEARCH = ("torch_quickstart", "torch_dse_accelerator",
                        "torch_compose_serving")
EXAMPLES_TIMEOUT = 300
# the serving example's twin (examples/torch_serve_lm.py) at the reference
# example's flags, run beside the DSE examples on both devices
SERVE_EXAMPLE = "torch_serve_lm"
COMP_APPS = ("qwen2-0.5b:prefill", "qwen2-0.5b:decode")
COMP_AREA = 90000.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


T0 = time.perf_counter()


def emit(phase: str, **rec) -> None:
    """One phase's record, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **rec,
                      "smoke_elapsed_s": time.perf_counter() - T0}),
          flush=True)


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
    """The main path over the traced zoo apps: the twenty apps of the ten
    archs, the greedy geomean study on the card and on the
    CPU, then the genetic and anneal engines on one app on both.  Returns
    the kernel's launches on each card run."""
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
        graph = build_app(name)
        seconds = time.perf_counter() - t0
        ops = len(graph.op_stream())
        traced[name] = {"seconds": seconds, "compute_ops": ops,
                        "data_nodes": sum(n.op is None
                                          for n in graph.nodes.values())}
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
    emit("study zoo", n_apps=len(names), apps=traced,
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
    from repro_torch.core import costmodel as cm
    from repro_torch.core.costmodel import (ConfigBatch, _fused_tables_for,
                                            evaluate_stream_many,
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
    broadcast, tables, routes, timed = {}, {}, {}, {}
    # the longest oracle runs (configs x ops) start first
    order = sorted(range(len(cases)),
                   key=lambda i: -cases[i][1].shape[0] * len(cases[i][2]))
    with ctx.Pool(ORACLE_WORKERS) as pool:
        pending = pool.map_async(
            oracle_digest, [(m, st, space.hw, pw, pi, parts) for
                            _, m, st, pw, pi, parts in (cases[i]
                                                        for i in order)],
            chunksize=1)
        # both device passes on the card while the oracle runs on the host
        for label, m, stream, pw, pi, parts in cases:
            digest = Digest()
            digest.update(evaluate_stream_many(
                ConfigBatch(m), stream, space.hw, pw, pi,
                backend="broadcast", with_parts=parts, device="cuda"))
            broadcast[label] = digest.hexdigest()
            # dtypes and values on a slice, in this process
            head = ConfigBatch(m[:64])
            want = evaluate_stream_many(head, stream, space.hw, pw, pi,
                                        backend="numpy-ref")
            for backend in ("broadcast", "tables"):
                got = evaluate_stream_many(head, stream, space.hw, pw, pi,
                                           backend=backend, device="cuda")
                for k in want[2]:
                    check(got[2][k].dtype == want[2][k].dtype
                          and np.array_equal(got[2][k], want[2][k]),
                          f"{backend} part {k} differs on {label}")
        # the table pass (the default), its launches counted from 0
        gather_rows.launches = 0
        for label, m, stream, pw, pi, parts in cases:
            digest = Digest()
            cm.PASSES.clear()
            digest.update(evaluate_stream_many(
                ConfigBatch(m), stream, space.hw, pw, pi, with_parts=parts,
                device="cuda"))
            tables[label] = digest.hexdigest()
            routes[label] = next(iter(cm.PASSES))
            check(dict(cm.PASSES) == {routes[label]: 1},
                  f"{label}: passes {dict(cm.PASSES)}")
        table_launches = gather_rows.launches
        check(table_launches > 0,
              "the table pass never launched gather_rows")
        oracle = dict(zip(order, pending.get()))
    oracle_s = time.perf_counter() - t_phase
    checked = {}
    for i, (label, m, stream, *_) in enumerate(cases):
        digest, secs = oracle[i]
        for name, dev in (("broadcast", broadcast), ("tables", tables)):
            differ = [k for k in Digest.KEYS if dev[label][k] != digest[k]]
            check(not differ, f"{name} != numpy-ref on {label}: {differ}")
        want = "broadcast" if label.startswith("zero") else "tables"
        check(routes[label] == want,
              f"{label} took the {routes[label]} pass, expected {want}")
        checked[label] = {"ops": len(stream), "oracle_s": secs,
                          "route": routes[label]}
    # the dispatch by pool size
    dispatch, least = {}, cm._TABLES_MIN_POOL
    for n in (least - 1, least):
        cm.PASSES.clear()
        evaluate_stream_many(ConfigBatch(pools[BROADCAST_POOLS[0]][:n]),
                             cases[0][2], space.hw, device="cuda")
        dispatch[n] = dict(cm.PASSES)
    check(dispatch == {least - 1: {"broadcast": 1}, least: {"tables": 1}},
          f"the dispatch at 63 / 64 configs: {dispatch}")

    # times: the table pass and the broadcast pass (cycles and validity
    # only), the fused scorer on the same pool, and the oracle's host
    # seconds
    calls = {}
    for name in TIMED_APPS:
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

            def run(backend, batch=batch, spec=spec):
                return evaluate_stream_many(
                    batch, spec.stream, space.hw, spec.peak_weight_bits,
                    spec.peak_input_bits, backend=backend, with_parts=False,
                    device="cuda")

            rec = {"ops": len(spec.stream),
                   "unique_ops": len(spec.stream.dedup_columns()[0])}
            for backend in ("tables", "broadcast"):
                rec[f"{backend}_ms"] = call_ms(lambda b=backend: run(b))
                torch.cuda.reset_peak_memory_stats()
                gather_rows.launches = 0
                run(backend)
                rec[f"{backend}_max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated()
                rec[f"{backend}_gather_rows_per_call"] = gather_rows.launches
            rec["fused_ms"] = call_ms(lambda: scorer.metrics(m))
            t0 = time.perf_counter()
            _fused_tables_for(spec.stream, space.hw, None).codes(m)
            rec["tables_host_codes_s"] = time.perf_counter() - t0
            rec["tables_over_broadcast"] = rec["tables_ms"] / rec[
                "broadcast_ms"]
            rec["tables_over_fused"] = rec["tables_ms"] / rec["fused_ms"]
            rec["broadcast_over_fused"] = rec["broadcast_ms"] / rec[
                "fused_ms"]
            gops = performance_gops(batch, spec.stream, space.hw,
                                    spec.peak_weight_bits,
                                    spec.peak_input_bits, device="cuda")
            check(np.array_equal(gops, scorer.metrics(m)[0]),
                  f"performance_gops != the fused scorer on {name} C={n}")
            label = f"{name} C={n} peaks"
            if label in checked:
                rec["oracle_s"] = checked[label]["oracle_s"]
            timed[f"{name} C={n}"] = rec
            if name == PROFILED_APP and n == BROADCAST_BIG:
                calls = {"tables": lambda r=run: r("tables"),
                         "broadcast": lambda r=run: r("broadcast"),
                         "fused": lambda sc=scorer, m=m: sc.metrics(m)}
                host = host_profile(lambda: run("tables"))
    # where the time goes at the largest pool, by kind, one call each
    profile = device_breakdown(calls, PROFILE_KINDS)
    for name, rec in profile.items():
        rec["host_share"] = 1.0 - rec["busy_us"] / rec["wall_us"]
    profile["tables_host_profile"] = host

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
         broadcast_bit_equal=True, tables_bit_equal=True, broadcast=checked,
         dispatch=dispatch, table_pass_gather_rows_launches=table_launches,
         oracle_workers=ORACLE_WORKERS, oracle_wall_s=oracle_s,
         timings=timed, profile=profile, studies=out,
         gather_rows_launches=launches,
         radar={r.app: {"n_configs": r.n_configs, "extras": r.extras}
                for r in radar["cuda"][0]},
         radar_cuda_s=radar["cuda"][1], radar_cpu_s=radar["cpu"][1],
         phase_s=time.perf_counter() - t_phase)
    return {"studies": launches, "table pass": table_launches}


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


def phase_examples() -> dict:
    """The port's four DSE examples and the serving example on the card,
    as subprocesses, each against the same command with ``--device cpu``,
    all ten at once: exit code 0, wall seconds; for the DSE examples the
    same stdout and the `gather_rows` launches each prints on stderr (> 0
    on the card for the three that search); for the serving example
    (`serve_example`) its request lines."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    args = {**EXAMPLES, SERVE_EXAMPLE: []}

    def run(key):
        name, device = key
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" / f"{name}.py"),
             *args[name], "--device", device], capture_output=True,
            text=True, env=env, cwd=ROOT, timeout=EXAMPLES_TIMEOUT)
        return proc, time.perf_counter() - t0

    keys = [(n, d) for n in args for d in ("cuda", "cpu")]
    with ThreadPoolExecutor(len(keys)) as pool:
        runs = dict(zip(keys, pool.map(run, keys)))
    for (name, device), (proc, _) in runs.items():
        check(proc.returncode == 0,
              f"{name} --device {device} exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
    out = {}
    for (name, device), (proc, wall) in runs.items():
        if name == SERVE_EXAMPLE:
            continue
        last = proc.stderr.strip().splitlines()[-1]
        check(last.startswith("gather_rows launches: "),
              f"{name} --device {device}: no launch count on stderr")
        rec = out.setdefault(name, {"args": EXAMPLES[name]})
        rec[device] = {"wall_s": wall, "stdout": proc.stdout,
                       "gather_rows_launches": int(last.split()[-1])}
    for name, rec in out.items():
        check(rec["cuda"]["stdout"] == rec["cpu"]["stdout"],
              f"{name}: the card's stdout differs from the cpu's")
        check(rec["cpu"]["gather_rows_launches"] == 0,
              f"{name}: gather_rows launched on the cpu")
        if name in EXAMPLES_THAT_SEARCH:
            check(rec["cuda"]["gather_rows_launches"] > 0,
                  f"{name} never launched gather_rows on the card")
        rec["stdout_lines"] = rec["cuda"]["stdout"].count("\n")
        for device in ("cuda", "cpu"):
            del rec[device]["stdout"]
    out[SERVE_EXAMPLE] = serve_example(
        {d: runs[(SERVE_EXAMPLE, d)] for d in ("cuda", "cpu")})
    emit("examples", examples=out)
    return {n: r["cuda"]["gather_rows_launches"] for n, r in out.items()
            if n != SERVE_EXAMPLE}


def serve_example(runs: dict) -> dict:
    """`examples/torch_serve_lm.py` on the card against ``--device cpu``:
    the request lines must be equal.  The two runs draw their weights
    from one seed on two devices' generators, so their weights differ;
    the smoke model greedily repeats each prompt's last token on any
    random weights, and the lines agree.  Beside that check, the card
    run's weights are rebuilt here and each request's prompt and card
    tokens are teacher-forced through the decode step on the card and on
    the CPU: where a card token differs from the CPU run's, these logits
    must agree within `SERVE_TOL` instead, and the smallest top-two gap
    of the decode's logits is printed."""
    import ast

    from repro_torch import configs
    from repro_torch.launch.steps import build_model, make_serve_step
    from repro_torch.models.layers import Runtime

    lines = {d: proc.stdout.splitlines() for d, (proc, _) in runs.items()}
    pattern = re.compile(r"^  req(\d+) prompt\[ *(\d+)\] -> (\[.*\])$")
    served = {}
    for device, ls in lines.items():
        check(len(ls) == 11 and ls[0].startswith("10 requests, 120 tokens"),
              f"{SERVE_EXAMPLE} --device {device} printed {ls[:2]}")
        served[device] = [ast.literal_eval(pattern.match(ln).group(3))
                          for ln in ls[1:]]
    same_lines = lines["cuda"][1:] == lines["cpu"][1:]

    # the example's prompts and the card run's weights (seed 0)
    cfg = configs.get_smoke("qwen2-0.5b")
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size,
                                          size=int(rng.integers(4, 16)))))
               for _ in range(10)]
    model = build_model(cfg)
    rt = Runtime(compute_dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt)
    params_cpu = torch.utils._pytree.tree_map(lambda t: t.cpu(), params)
    gap, top2, within = 0.0, float("inf"), True
    for prompt, gen in zip(prompts, served["cuda"]):
        seq = prompt + gen[:-1]
        rows = {}
        for dev, p in (("cuda", params), ("cpu", params_cpu)):
            step = make_serve_step(model, rt)
            cache = model.init_cache(1, 256, rt, dev)
            out = []
            for i, t in enumerate(seq):
                tok = torch.full((1, 1), t, dtype=torch.int64, device=dev)
                logits, cache = step(p, cache, tok, position(i, dev))
                out.append(logits[0, 0, :cfg.vocab_size].cpu())
            rows[dev] = torch.stack(out[len(prompt) - 1:])
        check(rows["cuda"].argmax(-1).tolist() == gen,
              f"{SERVE_EXAMPLE}: the rebuilt weights do not give the card "
              f"run's tokens")
        diff = (rows["cuda"] - rows["cpu"]).abs()
        gap = max(gap, float(diff.max()))
        within &= bool((diff <= SERVE_TOL * (1 + rows["cpu"].abs())).all())
        top = rows["cuda"].topk(2, dim=-1).values
        top2 = min(top2, float((top[:, 0] - top[:, 1]).min()))
    check(same_lines or within,
          f"{SERVE_EXAMPLE}: the card's tokens differ from the cpu's and "
          f"the teacher-forced logits differ by {gap}")
    return {"args": [], "request_lines_equal": same_lines,
            "teacher_forced_max_abs_diff": gap, "tolerance": SERVE_TOL,
            "min_top2_gap": top2,
            **{d: {"wall_s": wall, "summary": lines[d][0]}
               for d, (_, wall) in runs.items()}}


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


def device_kinds(fn, kinds: dict) -> dict:
    """`device_breakdown` of one call of `fn` that launches hundreds of
    thousands of kernels: the profiler traces the device only (no host
    events to post-process), every kernel belongs to the call, and
    `wall_us` is the host's clock around it (ending in a synchronise)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {**{k: 0.0 for k in kinds}, "other_kernels_us": 0.0,
           "copies_us": 0.0}
    count = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "Activity Buffer" in e.name:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            key = "copies_us"
        else:
            count += 1
            key = next((k for k, marks in kinds.items()
                        if any(m in e.name for m in marks)),
                       "other_kernels_us")
        out[key] += e.time_range.elapsed_us()
    out["busy_us"] = sum(out.values())
    out["wall_us"] = wall * 1e6
    out["kernels"] = count
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

    batch, rounds = 262144, 1           # one: the smoke's time
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
    """The kernel's output on every row against the plain version's,
    evaluated in float64 on the same inputs and run `PLAIN_ROWS` query
    rows at a time: the max abs error and the worst |error| / (atol + rtol
    |plain|), which passes at <= 1.  In fp32 the plain version's own
    error on outputs that cancel over 32k near-uniform keys (olmoe-1b-7b's
    last layer) exceeds FLASH_TOL's atol: no kernel, the exact function
    included, could be held to it there."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.models.layers import full_precision_products

    atol, rtol = FLASH_TOL[q.dtype]
    err = ratio = 0.0
    k64, v64 = k.double(), v.double()
    with torch.inference_mode(), full_precision_products():
        got = flash_attention(q, k, v, causal=causal).double()
        for i in range(0, q.shape[1], PLAIN_ROWS):
            want = flash_attention_plain(q[:, i:i + PLAIN_ROWS].double(),
                                         k64, v64, causal=causal,
                                         q_offset=i)
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
    cases += [(2, sq, skv, 32, 8, 128, causal, dtype)
              for sq, skv in ((1000, 1536), (1536, 1000))
              for causal in (True, False)
              for dtype in (torch.float32, torch.bfloat16)]
    # the prefills' shapes, all rows (their own inputs: prefill phases)
    cases += [(4, 2048, 2048, 14, 2, 64, True, torch.bfloat16),
              (1, 32768, 32768, 14, 2, 64, True, torch.bfloat16),
              (4, 2048, 2048, 16, 1, 256, True, torch.bfloat16),
              (1, 8192, 8192, 32, 8, 128, True, torch.bfloat16)]
    # the fp32 forwards' shapes on the CUDA-core kernel: olmoe-1b-7b's gate
    # (16 heads of 128 on 16) and recurrentgemma-9b's (16 on one of 256)
    cases += [(4, 2048, 2048, 16, 16, 128, True, torch.float32),
              (4, 2048, 2048, 16, 1, 256, True, torch.float32)]
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
    # kernel's fp32 at qwen2-0.5b's S 4096 and at the fp32 forwards'
    # shapes of olmoe-1b-7b (hd 128) and recurrentgemma-9b (hd 256)
    timings = {}
    for key, (b, s_len, h, kv, hd, dtype, with_plain) in {
            "32768": (1, 32768, 14, 2, 64, torch.bfloat16, False),
            "4096": (1, 4096, 14, 2, 64, torch.bfloat16, True),
            "hd256": (4, 2048, 16, 1, 256, torch.bfloat16, True),
            "hd128": (1, 8192, 32, 8, 128, torch.bfloat16, True),
            "fp32_4096": (1, 4096, 14, 2, 64, torch.float32, True),
            "fp32_hd128": (4, 2048, 16, 16, 128, torch.float32, True),
            "fp32_hd256": (4, 2048, 16, 1, 256, torch.float32, True)}.items():
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
    per RG-LRU layer and no bare scan; one `flash_attention` per GQA
    attention layer, and per local one whose window holds the whole
    sequence (else local-block attention), every one on the tensor cores
    (bf16 at head dim 64-256) and none on the CUDA cores; none in an MLA
    layer (its attention is `blocked_attention`, as in the reference); no
    `matmul` (the models' projections are not tiled products)."""
    from repro_torch.kernels.flash_attention import CUDA_CORE, TENSOR_CORE
    kinds, window = model.kinds, model.cfg.local_window
    flash = 0 if model.cfg.mla is not None else sum(
        k in ("attn", "attn_dense") or (k == "local_attn" and seq <= window)
        for k in kinds)
    return {"flash_attention": flash, TENSOR_CORE.name: flash,
            CUDA_CORE.name: 0, "rglru_gated_scan": kinds.count("rglru"),
            "rglru_scan": 0, "matmul": 0, "matmul_tensor_core": 0,
            "matmul_cuda_core": 0}


def fp32_launches(model, seq: int) -> dict:
    """`expected_launches` of an fp32 forward: its attention runs the
    CUDA-core flash kernel only."""
    want = expected_launches(model, seq)
    want.update({"flash_attention_tensor_core": 0,
                 "flash_attention_cuda_core": want["flash_attention"]})
    return want


def checked_layers(model, seq: int) -> tuple:
    """The first and last layer that hands each launched kernel its
    inputs, at this sequence length."""
    want = expected_launches(model, seq)
    kind_of = {"flash_attention": ("attn", "attn_dense", "local_attn"),
               "rglru_gated_scan": ("rglru",)}
    layers = set()
    for name, n in want.items():
        if n and name in kind_of:
            idx = [i for i, k in enumerate(model.kinds)
                   if k in kind_of[name]]
            layers.update((idx[0], idx[-1]))
    return tuple(sorted(layers))


@contextlib.contextmanager
def routes(force=None, factor=None):
    """Within it every MoE block's routing (`layers.moe_route`) is
    recorded, one record a call: the experts each token chose ([T, k], in
    `moe_route`'s order, on the host), the router's fp32 logits [T, E],
    and with `factor` the pairs it would drop at that capacity factor.
    With `force`, a list of records, the n-th call routes its tokens to
    force[n]'s experts instead, its gates its own probabilities of those
    experts: a forward then takes a decode's discrete choices, and the
    two compute one function.  Yields the list of records."""
    from repro_torch.models import layers as L

    route, log = L.moe_route, []

    def recording(p, xg, *, n_experts, top_k, cap, normalize_gates, rt):
        G, T, _ = xg.shape
        cd = rt.compute_dtype
        kw = dict(n_experts=n_experts, top_k=top_k,
                  normalize_gates=normalize_gates, rt=rt)
        logits = torch.matmul(xg.to(cd).float(), p["router"].to(cd).float())
        gate, e_flat, slot = route(p, xg, cap=cap, **kw)
        rec = {"experts": e_flat.reshape(G * T, top_k).cpu(),
               "logits": logits.reshape(G * T, n_experts).cpu()}
        if factor is not None:
            cap_f = L.moe_capacity(T, top_k, n_experts, factor)
            slot_f = route(p, xg, cap=cap_f, **kw)[2]
            rec["dropped"] = int((slot_f == n_experts * cap_f).sum())
        if force is not None:
            eidx = force[len(log)]["experts"].to(xg.device).reshape(
                G, T, top_k)
            gate = torch.softmax(logits, dim=-1).gather(-1, eidx)
            if normalize_gates:
                gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True),
                                              1e-9)
            e_flat = eidx.reshape(G, T * top_k)
            slot = L.moe_slots(e_flat, n_experts, cap)
        log.append(rec)
        return gate, e_flat, slot

    L.moe_route = recording
    try:
        yield log
    finally:
        L.moe_route = route


def expert_sets(rec) -> torch.Tensor:
    return rec["experts"].sort(-1).values


def route_agreement(got: list, want: list) -> float:
    """The share of (token, MoE layer) pairs whose top-k expert sets are
    the same in two forwards' `routes`."""
    check(len(got) == len(want) > 0, "the forwards routed different "
                                     "numbers of MoE layers")
    same = sum(int((expert_sets(g) == expert_sets(w)).all(-1).sum())
               for g, w in zip(got, want))
    return same / sum(w["experts"].shape[0] for w in want)


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
    the plain paths; returns each kernel's launches in the forwards.

    An MoE arch's bf16 forwards are not gated on their logits: its top-k
    router over near-uniform probabilities flips a token's experts on a
    bf16-level difference, so two correct bf16 paths can disagree past
    `PREFILL_TOL`.  Their logits gap and routing agreement are printed,
    and the whole forward is gated in fp32 at 2048 x 4 instead
    (`fp32_gate`).  An arch whose path runs no kernel (MLA) is timed and
    checked for finite logits: its plain path is the same code."""
    import gc

    from repro_torch import configs
    from repro_torch.launch.steps import (build_model, make_prefill_step,
                                          make_runtime)

    gc.collect()
    torch.cuda.empty_cache()                  # the previous phase's weights
    cfg = configs.get_arch(arch)
    moe = cfg.moe is not None
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
        kernels_run = any(want_launches.values())
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
            if walls[0] > LONG_FORWARD_S:
                break                             # one run, timed
        peak = torch.cuda.max_memory_allocated()
        v = cfg.vocab_size
        got = logits[:, :v].float()
        check(tuple(logits.shape) == (batch, model.v_pad),
              f"prefill logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(got).all()), "prefill logits not finite")
        wall = float(np.median(walls[1:] or walls))
        run = {"seq": seq, "batch": batch, "wall_s": wall, "walls_s": walls,
               "tokens_per_s": seq * batch / wall,
               "max_memory_allocated": peak,
               "launches_per_forward": want_launches}
        if kernels_run:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = step_plain(params, inputs)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            want = ref[:, :v].float()
            diff = (got - want).abs()
            run.update(plain_wall_s=plain_s,
                       max_abs_diff_vs_plain=float(diff.max()),
                       tolerance=PREFILL_TOL)
            if moe:
                # printed, not gated (see the docstring); the routes are
                # recorded in untimed forwards of their own
                with routes() as plain_routes:
                    step_plain(params, inputs)
                with routes() as kernel_routes:
                    step(params, inputs)
                for n in totals:
                    totals[n] += want_launches[n]
                run.update(
                    gated=False,
                    within_tolerance_share=float((
                        diff <= PREFILL_TOL * (1 + want.abs()))
                        .float().mean()),
                    next_token_agreement=float((
                        got.argmax(-1) == want.argmax(-1)).float().mean()),
                    topk_sets_agreeing=route_agreement(kernel_routes,
                                                       plain_routes))
            else:
                check(bool((diff <= PREFILL_TOL * (1 + want.abs())).all()),
                      f"{arch} prefill logits through the kernels differ "
                      f"from the plain path by {float(diff.max())} at seq "
                      f"{seq}")
                run.update(next_token_check(got, want, f"{arch} seq {seq}"))
            del ref
        device = device_breakdown(
            {"forward": lambda: step(params, inputs)},
            {"rglru_gated_us": ("rglru_gated",),
             "rglru_scan_us": ("rglru_slab",),
             "flash_attention_us": ("flash_attention_kernel",),
             "matmul_us": ("gemm", "nvjet", "xmma"),
             "moe_dispatch_us": MOE_DISPATCH_KERNELS})["forward"]
        device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
        for n in totals:
            totals[n] += want_launches[n]
        run["device_one_forward"] = device
        runs[f"seq{seq}_batch{batch}"] = run
        del logits
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
    gate = None
    if moe and any(expected_launches(model, 2048).values()):
        del params
        gate = fp32_gate(model, gen, counters)
        for n in launches:
            launches[n] += gate["launches"][n]
    check_isolated()
    emit(f"prefill {arch}", arch=arch, layers=cfg.num_layers,
         kinds={k: model.kinds.count(k) for k in sorted(set(model.kinds))},
         parameters=cfg.param_count(),
         param_dtype="bfloat16", compute_dtype="bfloat16",
         reduced={"prefill_32k": "global_batch 32 -> 1"},
         launches=launches,
         kernel_tolerance={"flash_attention": FLASH_TOL[torch.bfloat16],
                           "rglru_gated_scan": [*GATED_TOL,
                                                "+ one bf16 ulp"]},
         failed=failed, runs=runs, fp32_gate=gate)
    check(not failed, f"kernels != plain on the prefill's own inputs: "
                      f"{failed[:2]}")
    return launches


def fp32_gate(model, gen, counters) -> dict:
    """An MoE arch's whole forward in fp32 at seq 2048 x batch 4: fp32
    weights from seed 0, through the kernels (the CUDA-core flash kernel)
    against the plain fp32 path, within `PREFILL_TOL` and with the same
    next token.  Returns the record, with the kernels' launches in it."""
    import gc

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import Runtime

    gc.collect()
    torch.cuda.empty_cache()                  # the bf16 weights
    cfg = model.cfg
    rt = Runtime(compute_dtype=torch.float32, param_dtype=torch.float32,
                 use_kernels=True)
    rt_plain = dataclasses.replace(rt, use_kernels=False)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (4, 2048),
                                      generator=gen, device="cuda")}
    want_launches = fp32_launches(model, 2048)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {n: fn.launches for n, fn in counters.items()}
    t0 = time.perf_counter()
    logits = make_prefill_step(model, rt)(params, inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got_launches = {n: fn.launches - before[n] for n, fn in counters.items()}
    check(got_launches == want_launches,
          f"the fp32 forward launched {got_launches}, expected "
          f"{want_launches}")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    ref = make_prefill_step(model, rt_plain)(params, inputs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    v = cfg.vocab_size
    got, want = logits[:, :v].float(), ref[:, :v].float()
    check(bool(torch.isfinite(got).all()), "fp32 prefill logits not finite")
    diff = (got - want).abs()
    check(bool((diff <= PREFILL_TOL * (1 + want.abs())).all()),
          f"{cfg.name} fp32 prefill logits through the kernels differ from "
          f"the plain path by {float(diff.max())}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"seq": 2048, "batch": 4, "param_dtype": "float32",
            "compute_dtype": "float32", "wall_s": wall,
            "tokens_per_s": 2048 * 4 / wall, "plain_wall_s": plain_s,
            "max_memory_allocated": peak,
            "max_abs_diff_vs_plain": float(diff.max()),
            "tolerance": PREFILL_TOL,
            **next_token_check(got, want, f"{cfg.name} fp32"),
            "launches": got_launches}


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


@contextlib.contextmanager
def as_cached(cfg, params):
    """Within it a forward reads what the decode's bf16 caches hold: a
    GQA layer's attention is the decode's arithmetic over every row at
    once (`gqa_attention_decode`'s scores on the bf16 k after RoPE, a
    masked softmax, its probabilities rounded to v's bf16 as `_gqa_values`
    rounds them) in place of the flash kernel; an MLA layer rounds its
    normed latent (where `rms_norm` applies a `kv_norm` scale) and its
    RoPE key (the keys' last `rope_d` columns where they reach
    `blocked_attention`).  Yields the count of each, a layer a forward."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    def bf16(t):
        return t.to(torch.bfloat16).to(t.dtype)

    hits = {"attention": 0, "latent": 0, "rope_key": 0}
    flash, norm, blocked = FA.flash_attention, L.rms_norm, L.blocked_attention
    kv_norms = {id(p["attn"]["kv_norm"]) for p in params["layers"]
                if "kv_norm" in p.get("attn", {})}

    def attend_cached(q, k, v, *, causal=True):
        hits["attention"] += 1
        B, S, H, hd = q.shape
        KV = k.shape[2]
        qg = (q * (1.0 / math.sqrt(hd))).reshape(B, S, KV, H // KV, hd)
        s = L._gqa_scores(qg, k.to(torch.bfloat16))
        pos = torch.arange(S, device=q.device)
        if causal:
            s = s.masked_fill(pos[:, None] < pos[None, :], -math.inf)
        o = L._gqa_values(torch.softmax(s, dim=-1), v.to(torch.bfloat16))
        return o.reshape(B, S, H, hd).to(q.dtype)

    def norm_cached(x, scale, eps):
        y = norm(x, scale, eps)
        if id(scale) in kv_norms:
            hits["latent"] += 1
            y = bf16(y)
        return y

    def blocked_cached(q, k, v, **kw):
        hits["rope_key"] += 1
        nope = k.shape[-1] - cfg.mla.qk_rope_head_dim
        k = torch.cat([k[..., :nope], bf16(k[..., nope:])], -1)
        return blocked(q, k, v, **kw)

    FA.flash_attention, L.rms_norm = attend_cached, norm_cached
    if cfg.mla is not None:
        L.blocked_attention = blocked_cached
    try:
        yield hits
    finally:
        FA.flash_attention, L.rms_norm, L.blocked_attention = (
            flash, norm, blocked)


@contextlib.contextmanager
def reads_the_cache(model, params, cache):
    """Within it a forward over S tokens reads, at every attention layer,
    what a decode over the same tokens wrote into its caches (`cache`, the
    decode's per-layer caches after its last step) at positions 0..S-1,
    in place of its own: a GQA layer's attention
    is the decode's arithmetic (`gqa_attention_decode`: scores of the fp32
    q on the bf16 k, the masked softmax, its probabilities rounded to v's
    bf16 by `_gqa_values`) over the cache's k and v, in place of the flash
    kernel; an MLA layer takes the cache's latent `ckv` for its normed
    latent (where `rms_norm` applies a `kv_norm` scale) and the cache's
    `krope` for its RoPE key (the keys' last `rope_d` columns where they
    reach `blocked_attention`).  Both paths then read the same bf16
    numbers.  Yields a record: "hits", the layers each substitution took
    in call order, and "own", by layer, the forward's own operands it
    replaced (k and v after RoPE; the latent; the RoPE key), in fp32."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L

    cfg = model.cfg
    attn = [i for i, kind in enumerate(model.kinds)
            if kind in ("attn", "attn_dense", "local_attn")]
    rec = {"hits": {"attention": [], "latent": [], "rope_key": []},
           "own": {i: {} for i in attn}}
    kv_norms = {id(p["attn"]["kv_norm"]): i
                for i, p in enumerate(params["layers"])
                if "kv_norm" in p.get("attn", {})}
    flash, norm, blocked = FA.flash_attention, L.rms_norm, L.blocked_attention

    def next_layer(kind):
        layer = attn[len(rec["hits"][kind])]
        rec["hits"][kind].append(layer)
        return layer

    def attend(q, k, v, *, causal=True):
        layer = next_layer("attention")
        rec["own"][layer].update(k=k, v=v)
        B, S, H, hd = q.shape
        kc = cache[layer]["k"][:, :S]
        vc = cache[layer]["v"][:, :S]
        KV = kc.shape[2]
        qg = (q * (1.0 / math.sqrt(hd))).reshape(B, S, KV, H // KV, hd)
        sc = L._gqa_scores(qg, kc)
        pos = torch.arange(S, device=q.device)
        if causal:
            sc = sc.masked_fill(pos[:, None] < pos[None, :], -math.inf)
        o = L._gqa_values(torch.softmax(sc, dim=-1), vc)
        return o.reshape(B, S, H, hd).to(q.dtype)

    def norm_cached(x, scale, eps):
        y = norm(x, scale, eps)
        if id(scale) not in kv_norms:
            return y
        layer = kv_norms[id(scale)]
        rec["hits"]["latent"].append(layer)
        rec["own"][layer]["ckv"] = y
        return cache[layer]["ckv"][:, :y.shape[1]].to(y.dtype)

    def blocked_cached(q, k, v, **kw):
        layer = next_layer("rope_key")
        B, S, H, _ = k.shape
        rope_d = cfg.mla.qk_rope_head_dim
        nope = k.shape[-1] - rope_d
        rec["own"][layer]["krope"] = k[:, :, 0, nope:]
        kr = cache[layer]["krope"][:, :S].to(k.dtype)
        k = torch.cat([k[..., :nope],
                       kr[:, :, None, :].expand(B, S, H, rope_d)], -1)
        return blocked(q, k, v, **kw)

    if cfg.mla is not None:
        L.rms_norm, L.blocked_attention = norm_cached, blocked_cached
    else:
        FA.flash_attention = attend
    try:
        yield rec
    finally:
        FA.flash_attention, L.rms_norm, L.blocked_attention = (
            flash, norm, blocked)


@contextlib.contextmanager
def decode_stabiliser():
    """Within it an xLSTM forward starts its stabiliser m where the decode
    cache starts it, at 0, not at the reference's -1e30
    (`layers.STABILISER_START`): the forward then computes the decode's
    function.  The mLSTM's output does not depend on the start (its num,
    |q n| and exp(-m) all scale with exp(-m)); the sLSTM's h = o c /
    max(n, 1) clamps n at 1 whatever m is, so where an input gate lies
    below its forget gate at the first positions of a sequence the two
    starts give other outputs (the reference's own forward and decode
    differ there alike)."""
    from repro_torch.models import layers as L

    saved, L.STABILISER_START = L.STABILISER_START, 0.0
    try:
        yield
    finally:
        L.STABILISER_START = saved


def cache_against_forward(cache, rec, seq_len: int) -> dict:
    """Each cache entry a decode wrote (positions 0..seq_len-1) against the
    fp32 value the cache-reading forward computed for it at the same layer
    and position (`reads_the_cache`'s "own"): within one bf16 rounding,
    `CACHE_RTOL` |fwd| + `CACHE_ATOL`; every slot past the sequence zero.
    Returns the worst ratio, the entries checked and the nonzero unwritten
    slots."""
    worst, checked, unwritten = 0.0, 0, 0
    for layer, own in rec["own"].items():
        for key, fwd in own.items():
            c = cache[layer][key]
            got = c[:, :seq_len].float().reshape(fwd.shape)
            fwd = fwd.float()
            worst = max(worst, float(((got - fwd).abs() / (
                CACHE_RTOL * fwd.abs() + CACHE_ATOL)).max()))
            checked += got.numel()
            unwritten += int((c[:, seq_len:] != 0).sum())
    return {"worst_ratio": worst, "entries": checked,
            "unwritten_nonzero": unwritten}


def phase_serve_forward(arch: str, param_dtype=torch.float32) -> dict:
    """`arch`'s `serve_requests` at full width on the card, fp32 compute
    (on `param_dtype` weights), held to teacher-forced full-sequence
    forwards on the card (fp32, through the kernels, their launches
    counted) over each request's prompt and generated tokens.  Every
    served token must be the forward's greedy choice, and every argmax of
    the teacher-forced decode (bf16 caches, as served) the forward's (a
    flip passes only where the forward's top-1 margin is within
    `SERVE_RG_TOL`).  The decode's function, with fp32 caches, is held
    within `SERVE_RG_TOL` of the forward (an arch whose caches hold no
    bf16 leaf, xLSTM, has that decode as served).  The served decode's
    logit gap is printed twice: to the forward, and to the forward that
    reads its own K and V rounded to bf16 (`as_cached`); the caller gates
    the first for recurrentgemma-9b and xlstm-1.3b.  An MoE arch's served
    decode is gated against a third forward, which reads at every
    attention layer what the decode wrote into its caches
    (`reads_the_cache`): both then read the same bf16 numbers, so fp32
    ordering is what is left, within `SERVE_RG_TOL`; and every cache
    entry must lie within one bf16 rounding of that forward's own value
    (`cache_against_forward`).  The first two forwards read other bf16
    numbers than the decode: rounding turns the paths' fp32 ordering
    differences into bf16-ulp flips, which at 16-27 layers move the MoE
    archs' logits past `SERVE_RG_TOL` (`PERF.md` §6).  An MoE arch's forwards run drop-free
    (capacity factor 16, as `tests/test_decode_parity.py` holds the
    reference): they route the whole sequence at once, a decode step one
    token, which never drops; the pairs the forward would drop at the
    configuration's own factor are printed.  Its top-k router over
    near-uniform probabilities flips a token's experts on a rounding, so
    each forward takes its decode's expert choices (`routes`); each
    choice that differs from the forward's own must lie within the two
    paths' router-logit difference."""
    import gc

    from repro_torch import configs
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.steps import build_model, make_serve_step
    from repro_torch.models.layers import (Runtime, full_precision_products,
                                           map_specs)

    gc.collect()
    torch.cuda.empty_cache()                    # the prefill's bf16 weights
    cfg = configs.get_arch(arch)
    model = build_model(cfg)
    fwd_model = model if cfg.moe is None else build_model(
        dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0)))
    rt = Runtime(compute_dtype=torch.float32)
    rt_fwd = Runtime(compute_dtype=torch.float32, use_kernels=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        Runtime(param_dtype=param_dtype))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=rng.integers(4, 13))]
               for _ in range(8)]
    serve_requests(cfg, prompts[:1], batch=1, max_new=2, max_len=256,
                   device="cuda", params=params)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = serve_requests(cfg, prompts, batch=4, max_new=SERVE_NEW,
                             max_len=256,
                             device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == 8 and all(len(r.generated) == SERVE_NEW
                                    for r in results),
          f"serve did not answer every request with {SERVE_NEW} tokens")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.generated),
          "serve generated a token outside the vocabulary")

    atol, rtol = SERVE_RG_TOL
    step = make_serve_step(model, rt)
    v = cfg.vocab_size
    attn_kinds = ("attn", "attn_dense", "local_attn")
    n_attn = sum(kind in attn_kinds for kind in model.kinds)
    # the caches' bf16 leaves (KV caches; none in a recurrent-only arch,
    # whose fp32 state the served decode already holds)
    has_bf16 = any(sp.dtype == "bf16" for c in model.cache_specs(1, 1)
                   for sp in c.values())
    want_hits = ({"attention": 0, "latent": n_attn, "rope_key": n_attn}
                 if cfg.mla is not None
                 else {"attention": n_attn, "latent": 0, "rope_key": 0})
    worst = {"max_abs_diff": 0.0, "tol_ratio": 0.0}
    worst32 = {"max_abs_diff": 0.0, "tol_ratio": 0.0}
    cached = {"max_abs_diff": 0.0, "tol_ratio": 0.0}
    own_cache = {"max_abs_diff": 0.0, "tol_ratio": 0.0}
    cache_check = {"worst_ratio": 0.0, "entries": 0, "unwritten_nonzero": 0}
    # the served (bf16-cache) decode held to the forward that reads its own
    # caches: the MoE archs (recurrentgemma-9b's served gap is gated
    # against the forward through the kernels by the caller)
    gate_own_cache = cfg.moe is not None
    # an xLSTM's forwards start their stabiliser where its decode does
    # (`decode_stabiliser`); the gap to the reference's start is printed
    xlstm = any(kind in ("mlstm", "slstm") for kind in model.kinds)
    ref_start = {"max_abs_diff": 0.0, "tol_ratio": 0.0}
    ref_start_worst_pos = []
    attn_layers = [i for i, kind in enumerate(model.kinds)
                   if kind in attn_kinds]
    want_reads = ({"attention": [], "latent": attn_layers,
                   "rope_key": attn_layers} if cfg.mla is not None
                  else {"attention": attn_layers, "latent": [],
                        "rope_key": []})
    steps = same = excused = reproduced = greedy = served = 0
    margin_min = float("inf")
    counters = kernel_counters()
    fwd_launches = dict.fromkeys(counters, 0)
    would_drop = route_flips = routed = 0
    flip_margin_max = 0.0

    def teacher_forced(seq, cache_dtype):
        """Decode steps over `seq` with the caches' bf16 leaves in
        `cache_dtype` (bf16 as served): the logits [S, V], the routing, a
        record a MoE layer over the sequence, and the caches after the
        last step."""
        cache = map_specs(lambda sp: torch.zeros(
            sp.shape, device="cuda", dtype=cache_dtype
            if sp.dtype == "bf16" else torch.float32),
            model.cache_specs(1, 256))
        rows, step_routes = [], []
        for pos, t in enumerate(seq):
            tok = torch.full((1, 1), t, dtype=torch.int64, device="cuda")
            with routes() as rts:
                logits, cache = step(params, cache, tok, position(pos))
            rows.append(logits[0, 0, :v])
            step_routes.append(rts)
        return torch.stack(rows), [
            {key: torch.cat([x[layer][key] for x in step_routes])
             for key in ("experts", "logits")}
            for layer in range(len(step_routes[0]))], cache

    def forced_forward(seq, decoded, hook=None, reference_start=False):
        """The forward over `seq`, taking the decode's expert choices
        (within `hook`, a context that swaps what its attention reads), an
        xLSTM's stabiliser from the decode's start unless
        `reference_start`; with its own routing and what the hook
        yields."""
        start = (decode_stabiliser() if xlstm and not reference_start
                 else contextlib.nullcontext())
        with torch.inference_mode(), full_precision_products(), \
                routes(force=decoded, factor=cfg.moe and
                       cfg.moe.capacity_factor) as own, \
                (hook or contextlib.nullcontext()) as hits, start:
            fwd = fwd_model.forward(params, {"tokens": torch.tensor(
                [seq], device="cuda")}, rt_fwd)[0, :, :v].float()
        return fwd, own, hits

    def gap(got, want, into):
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              "decode or forward logits not finite")
        diff = (got - want).abs()
        into["max_abs_diff"] = max(into["max_abs_diff"], float(diff.max()))
        into["tol_ratio"] = max(into["tol_ratio"], float(
            (diff / (atol + rtol * want.abs())).max()))

    def route_flips_explained(decoded, own, request):
        """Where a decode chose other experts than the forward would, the
        forward's k-th and (k+1)-th router logits must lie within twice
        the largest gap between the two paths' router logits there: a
        flip the paths' own difference explains."""
        nonlocal route_flips, routed, flip_margin_max
        for d, f in zip(decoded, own):
            k = d["experts"].shape[1]
            other = ~(expert_sets(d) == expert_sets(f)).all(-1)
            top = f["logits"].topk(k + 1, dim=-1).values
            margin = top[:, k - 1] - top[:, k]
            delta = (d["logits"] - f["logits"]).abs().amax(-1)
            check(bool((margin[other] <= 2 * delta[other]).all()),
                  f"request {request}: the decode routed a token to other "
                  f"experts than the forward where the router's margin "
                  f"exceeds the paths' own difference")
            route_flips += int(other.sum())
            routed += len(other)
            if other.any():
                flip_margin_max = max(flip_margin_max,
                                      float(margin[other].max()))

    for r in results:
        seq = r.prompt + r.generated
        dec, decoded, dec_cache = teacher_forced(seq, torch.bfloat16)
        # the forward's launches, counted from 0 just before it
        for fn in counters.values():
            fn.launches = 0
        fwd, own, _ = forced_forward(seq, decoded)
        got = {n: fn.launches for n, fn in counters.items()}
        want = fp32_launches(model, len(seq))
        check(got == want, f"request {r.request_id}: the fp32 forward "
                           f"launched {got}, expected {want}")
        for n in fwd_launches:
            fwd_launches[n] += got[n]
        would_drop += sum(f["dropped"] for f in own)
        route_flips_explained(decoded, own, r.request_id)
        gap(dec, fwd, worst)
        if xlstm:
            fwd_r = forced_forward(seq, decoded, reference_start=True)[0]
            gap(dec, fwd_r, ref_start)
            ratio = ((dec - fwd_r).abs() / (atol + rtol * fwd_r.abs()))
            ref_start_worst_pos.append(int(ratio.amax(-1).argmax()))
            del fwd_r
        if has_bf16:
            fwd_c, _, hits = forced_forward(seq, decoded,
                                            as_cached(cfg, params))
            check(hits == want_hits, f"the forward read {hits} as the "
                                     f"caches hold them, expected "
                                     f"{want_hits}")
            gap(dec, fwd_c, cached)
        if gate_own_cache:
            # the forward that reads the decode's own caches: both paths
            # read the same bf16 numbers, fp32 ordering is all that is left
            fwd_o, _, rd = forced_forward(
                seq, decoded, reads_the_cache(model, params, dec_cache))
            check(rd["hits"] == want_reads, f"request {r.request_id}: the "
                  f"forward read the decode's caches at {rd['hits']}, "
                  f"expected {want_reads}")
            gap(dec, fwd_o, own_cache)
            entries = cache_against_forward(dec_cache, rd, len(seq))
            cache_check["worst_ratio"] = max(cache_check["worst_ratio"],
                                             entries["worst_ratio"])
            cache_check["entries"] += entries["entries"]
            cache_check["unwritten_nonzero"] += entries["unwritten_nonzero"]
            del rd
        del dec_cache
        # the decode's function without the caches' rounding (with no
        # bf16 leaf, the served decode itself)
        if has_bf16:
            dec32, decoded32, _ = teacher_forced(seq, torch.float32)
            fwd32, own32, _ = forced_forward(seq, decoded32)
            route_flips_explained(decoded32, own32, r.request_id)
            gap(dec32, fwd32, worst32)
        else:
            gap(dec, fwd, worst32)
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
    check(worst32["tol_ratio"] <= 1.0,
          f"decode logits (fp32 cache) differ from the forward's by "
          f"{worst32['max_abs_diff']} (ratio {worst32['tol_ratio']})")
    if gate_own_cache:
        check(own_cache["tol_ratio"] <= 1.0,
              f"{arch}'s served decode (bf16 caches) differs from the "
              f"forward that reads its caches by "
              f"{own_cache['max_abs_diff']} (ratio "
              f"{own_cache['tol_ratio']})")
        check(cache_check["worst_ratio"] <= 1.0
              and cache_check["unwritten_nonzero"] == 0,
              f"{arch}'s decode caches: an entry beyond one bf16 rounding "
              f"of the forward's own value, or a written slot past the "
              f"sequence: {cache_check}")
    # the fp32 forward's attention runs the CUDA-core kernel only (an MLA
    # arch's none)
    check(fwd_launches["flash_attention_cuda_core"]
          == fwd_launches["flash_attention"]
          and (fwd_launches["flash_attention"] > 0)
          == (cfg.mla is None and n_attn > 0)
          and fwd_launches["flash_attention_tensor_core"] == 0,
          f"the fp32 forward launched {fwd_launches}: expected flash on "
          f"the CUDA cores only")
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
    specs = model.cache_specs(1, 1)
    attn = [i for i, kind in enumerate(model.kinds) if kind in attn_kinds]
    cache_bytes = sum(math.prod(sp.shape[2:]) * 2
                      for sp in specs[attn[0]].values()) if attn else 0
    state_bytes = sum(math.prod(sp.shape) * 4 for i, c in enumerate(specs)
                      if i not in attn for sp in c.values())
    rec = dict(arch=arch, layers=cfg.num_layers, compute_dtype="float32",
               param_dtype=str(param_dtype).split(".")[-1],
               level="smoke: toy context, no serve rate",
               requests=len(results), batch=4, max_new=SERVE_NEW,
               max_len=256,
               prompt_lens=[len(p) for p in prompts], wall_s=wall,
               generated_tokens=generated, tokens_per_s=generated / wall,
               latency_s=[r.latency_s for r in results],
               max_memory_allocated=peak,
               teacher_forced_steps=steps, tolerance=SERVE_RG_TOL,
               max_abs_diff_vs_forward=worst["max_abs_diff"],
               tol_ratio=worst["tol_ratio"],
               fp32_cache_max_abs_diff_vs_forward=worst32["max_abs_diff"],
               fp32_cache_tol_ratio=worst32["tol_ratio"],
               **({"max_abs_diff_vs_as_cached_forward":
                   cached["max_abs_diff"],
                   "tol_ratio_vs_as_cached_forward": cached["tol_ratio"],
                   "as_cached_reads": want_hits} if has_bf16 else {}),
               argmax_agreement_vs_forward=same / steps,
               flips_excused=excused, forward_top1_margin_min=margin_min,
               served_tokens_reproduced_by_decode=reproduced / served,
               served_tokens_equal_forward_greedy=greedy / served,
               forward_launches=fwd_launches, device_one_step=device,
               cache_bytes_per_attention_layer_and_token=cache_bytes,
               fp32_state_bytes_per_sequence=state_bytes,
               bf16_cache=has_bf16)
    if xlstm:
        rec.update(
            forward_stabiliser_start="0, the decode's",
            max_abs_diff_vs_reference_start_forward=ref_start["max_abs_diff"],
            tol_ratio_vs_reference_start_forward=ref_start["tol_ratio"],
            reference_start_worst_position=ref_start_worst_pos)
    if gate_own_cache:
        rec.update(
            gated_vs_cache_reading_forward=True,
            max_abs_diff_vs_cache_reading_forward=own_cache["max_abs_diff"],
            tol_ratio_vs_cache_reading_forward=own_cache["tol_ratio"],
            cache_entries=cache_check["entries"],
            cache_entry_worst_ratio=cache_check["worst_ratio"],
            cache_entry_tolerance=[CACHE_RTOL, CACHE_ATOL],
            cache_unwritten_nonzero=cache_check["unwritten_nonzero"])
    if cfg.moe is not None:
        rec.update(route_flips=route_flips, routed_token_layers=routed,
                   route_agreement=1 - route_flips / routed,
                   flip_router_margin_max=flip_margin_max,
                   forward_capacity_factor=16.0,
                   pairs_dropped_at_the_config_factor=would_drop,
                   config_capacity_factor=cfg.moe.capacity_factor)
    if cfg.mla is not None:
        rec["gqa_cache_bytes_per_attention_layer_and_token"] = \
            2 * cfg.num_heads * cfg.mla.v_head_dim * 2
    emit(f"serve {arch}", **rec)
    del params
    return rec


def phase_xlstm_blocks(gen) -> dict:
    """One full-width mLSTM block and one sLSTM block of xlstm-1.3b in
    fp32 on the card, at B x S = `BLOCK_SHAPE` (two chunks of 256 and a
    padded third): the chunkwise (mLSTM) and scan (sLSTM) forms against
    the step-by-step decode form, evaluated in float64 on the same
    weights and inputs from the chunkwise form's stabiliser (m = -1e30),
    every element within `BLOCK_TOL`.  Prints the worst tol ratio and
    each form's wall time."""
    from repro_torch import configs
    from repro_torch.models import layers as L

    cfg = configs.get_arch(XLSTM_ARCH)
    d, H = cfg.d_model, cfg.num_heads
    rt = L.Runtime(compute_dtype=torch.float32)
    rt64 = L.Runtime(compute_dtype=torch.float64)
    B, S = BLOCK_SHAPE
    rtol, atol = BLOCK_TOL
    out = {}
    for kind, specs, train, decode in (
            ("mlstm", L.mlstm_specs(d, H), L.mlstm_block_train,
             L.mlstm_block_decode),
            ("slstm", L.slstm_specs(d, H), L.slstm_block_train,
             L.slstm_block_decode)):
        p = L.init_params(specs, gen, torch.float32)
        x = torch.randn((B, S, d), generator=gen, device="cuda")
        kw = dict(n_heads=H, eps=cfg.norm_eps)
        with torch.inference_mode(), L.full_precision_products():
            train(p, x, rt=rt, **kw)                        # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = train(p, x, rt=rt, **kw)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            p64 = {k: v.double() for k, v in p.items()}
            x64 = x.double()
            hd = (2 * d if kind == "mlstm" else d) // H
            state = ({"C": torch.zeros((B, H, hd, hd)),
                      "n": torch.zeros((B, H, hd)),
                      "m": torch.full((B, H), -1e30)} if kind == "mlstm"
                     else {"h": torch.zeros((B, d)), "c": torch.zeros((B, d)),
                           "n": torch.zeros((B, d)),
                           "m": torch.full((B, d), -1e30)})
            state = {k: v.to("cuda", torch.float64) for k, v in state.items()}
            rows = []
            t0 = time.perf_counter()
            for t in range(S):
                yt, state = decode(p64, x64[:, t:t + 1], state, rt=rt64,
                                   **kw)
                rows.append(yt[:, 0])
            want = torch.stack(rows, 1)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
        check(y.dtype == torch.float32 and want.dtype == torch.float64
              and tuple(y.shape) == (B, S, d), f"{kind} block: "
              f"{y.dtype} {tuple(y.shape)} against {want.dtype}")
        check(bool(torch.isfinite(y).all()), f"{kind} block not finite")
        diff = (y.double() - want).abs()
        ratio = float((diff / (atol + rtol * want.abs())).max())
        out[kind] = {"shape": [B, S, d], "max_abs_diff": float(diff.max()),
                     "tol_ratio": ratio, "train_form_s": train_s,
                     "float64_step_form_s": step_s}
        check(ratio <= 1.0, f"the {kind} block's {('chunkwise' if kind == 'mlstm' else 'scan')} "
                            f"form differs from its float64 step form by "
                            f"{float(diff.max())} (ratio {ratio})")
        del p, p64, x, x64, y, want, rows, state
    check_isolated()
    emit("xlstm blocks", arch=XLSTM_ARCH, tolerance=list(BLOCK_TOL),
         worst_tol_ratio=max(r["tol_ratio"] for r in out.values()),
         blocks=out)
    return out


def widened(tree):
    """A parameter dict's tensors as fp32 copies."""
    if isinstance(tree, dict):
        return {k: widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [widened(v) for v in tree]
    return tree.float()


def phase_prefill_xlstm() -> dict:
    """xlstm-1.3b's batched prefill at full width (48 layers: 42 mLSTM, 6
    sLSTM; bf16 weights from seed 0): no kernel runs (the reference's
    mLSTM and sLSTM are jnp, outside Pallas), every counter at 0.  Seq
    2048 x batch 4 (warm-up and 2 timed, one profiled forward at
    `XLSTM_LONG_LAYERS` layers: device time by kind, idle share, kernels
    launched), then prefill_32k's sequence with its batch cut to 1 and
    its depth to `XLSTM_LONG_LAYERS` (one whole 7:1 unit; or 8192 if 16
    times the 2048 x 4 forward's time at that depth exceeds
    `XLSTM_LONG_BUDGET_S`; the cuts are listed).
    There is no plain path to compare with: the fp32 forward's last
    logits at `XLSTM_GATE_SEQ` tokens are gated against the fp32 decode
    loop over the same tokens within `SERVE_RG_TOL`, and the bf16
    forward's gap to that loop is printed."""
    import gc

    from repro_torch import configs
    from repro_torch.launch.steps import (build_model, make_prefill_step,
                                          make_runtime, make_serve_step)
    from repro_torch.models.layers import Runtime

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_arch(XLSTM_ARCH)
    shape = configs.shape_by_name("prefill_32k")
    model = build_model(cfg)
    rt = make_runtime(cfg, shape, use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, rt)
    step = make_prefill_step(model, rt)
    counters = kernel_counters()
    runs, reduced = {}, {"prefill_32k": "global_batch 32 -> 1"}

    def forward(inputs, long=False):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = (cut_step(cut_params, inputs) if long
                  else step(params, inputs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in counters.items()}
        check(not any(got.values()), f"the {XLSTM_ARCH} prefill launched "
                                     f"{got}: its path runs no kernel")
        return logits, wall

    long_seq = shape.seq_len
    depth = XLSTM_LONG_LAYERS / cfg.num_layers
    # the long forward and the profiled one at `XLSTM_LONG_LAYERS` layers
    cut_model = build_model(dataclasses.replace(
        cfg, num_layers=XLSTM_LONG_LAYERS))
    cut_params = cut_model.init(gen, rt)
    cut_step = make_prefill_step(cut_model, rt)
    reduced["seq2048_batch4_profiled"] = (
        f"layers {cfg.num_layers} -> {XLSTM_LONG_LAYERS} (one whole 7:1 "
        f"unit)")
    for seq, batch in ((2048, 4), (shape.seq_len, 1)):
        if batch == 1:
            reduced["prefill_32k"] = (
                f"global_batch 32 -> 1, layers {cfg.num_layers} -> "
                f"{XLSTM_LONG_LAYERS} (one whole 7:1 unit)")
            short = runs["seq2048_batch4"]["wall_s"]
            if 16 * short * depth > XLSTM_LONG_BUDGET_S:
                long_seq = seq = 8192
                reduced["prefill_32k"] += (
                    f", seq 32768 -> 8192: 16 x the 2048 x 4 forward "
                    f"({short:.3f} s) at that depth exceeds "
                    f"{XLSTM_LONG_BUDGET_S} s")
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device="cuda")
        inputs = {"tokens": tokens}
        reps = 3 if batch > 1 else 1          # the long one: one forward
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            logits, wall = forward(inputs, long=batch == 1)
            walls.append(wall)
            if walls[0] > LONG_FORWARD_S:
                break                             # one run, timed
        peak = torch.cuda.max_memory_allocated()
        got = logits[:, :cfg.vocab_size].float()
        check(tuple(logits.shape) == (batch, model.v_pad),
              f"prefill logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(got).all()), "prefill logits not finite")
        wall = float(np.median(walls[1:] or walls))
        run = {"seq": seq, "batch": batch, "layers": XLSTM_LONG_LAYERS
               if batch == 1 else cfg.num_layers,
               "wall_s": wall, "walls_s": walls,
               "tokens_per_s": seq * batch / wall,
               "max_memory_allocated": peak,
               "launches_per_forward": {n: 0 for n in counters}}
        if batch > 1:
            t0 = time.perf_counter()
            device = device_kinds(lambda: cut_step(cut_params, inputs),
                                  {"matmul_us": ("gemm", "nvjet", "xmma")})
            device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
            device["profile_s"] = time.perf_counter() - t0
            device["layers"] = XLSTM_LONG_LAYERS
            run["device_one_forward"] = device
        runs[f"seq{seq}_batch{batch}"] = run
        del logits, inputs, tokens
    del cut_model, cut_params, cut_step

    # the fp32 gate: the forward's last logits against the decode loop
    tokens = torch.randint(0, cfg.vocab_size, (1, XLSTM_GATE_SEQ),
                           generator=gen, device="cuda")
    bf16_last = step(params, {"tokens": tokens})[:, :cfg.vocab_size].float()
    rt32 = Runtime(compute_dtype=torch.float32, use_kernels=True)
    # the bf16 weights widened: the fp32 forward on the same weights
    # parts the compute's rounding from the weights'
    params = widened(params)
    same_weights = make_prefill_step(model, rt32)(params, {
        "tokens": tokens})[:, :cfg.vocab_size].float()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt32)
    fwd = make_prefill_step(model, rt32)(params, {"tokens": tokens})
    fwd = fwd[:, :cfg.vocab_size].float()
    serve = make_serve_step(model, rt32)
    cache = model.init_cache(1, XLSTM_GATE_SEQ, rt32, "cuda")
    t0 = time.perf_counter()
    for pos in range(XLSTM_GATE_SEQ):
        dec, cache = serve(params, cache, tokens[:, pos:pos + 1],
                           position(pos))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec = dec[:, 0, :cfg.vocab_size].float()
    atol, rtol = SERVE_RG_TOL
    check(bool(torch.isfinite(fwd).all() and torch.isfinite(dec).all()),
          "the fp32 forward or decode logits are not finite")
    diff = (fwd - dec).abs()
    ratio = float((diff / (atol + rtol * dec.abs())).max())
    bf16_diff = (bf16_last - dec).abs()
    compute_diff = (bf16_last - same_weights).abs()
    weights_diff = (same_weights - fwd).abs()
    gate = {"seq": XLSTM_GATE_SEQ, "tolerance": SERVE_RG_TOL,
            "max_abs_diff": float(diff.max()), "tol_ratio": ratio,
            "decode_loop_s": decode_s,
            "same_next_token": bool(fwd.argmax(-1) == dec.argmax(-1)),
            "bf16_forward_max_abs_diff": float(bf16_diff.max()),
            "bf16_forward_tol_ratio": float(
                (bf16_diff / (atol + rtol * dec.abs())).max()),
            "bf16_forward_same_next_token":
                bool(bf16_last.argmax(-1) == dec.argmax(-1)),
            "bf16_forward_vs_fp32_forward_on_its_weights":
                float(compute_diff.max()),
            "fp32_forward_on_bf16_weights_vs_on_fp32_weights":
                float(weights_diff.max()),
            "fp32_logits_max_abs": float(fwd.abs().max())}
    check(ratio <= 1.0, f"{XLSTM_ARCH}'s fp32 forward differs from its "
                        f"decode loop by {float(diff.max())} (ratio {ratio})")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    check_isolated()
    emit(f"prefill {XLSTM_ARCH}", arch=XLSTM_ARCH, layers=cfg.num_layers,
         kinds={k: model.kinds.count(k) for k in sorted(set(model.kinds))},
         parameters=cfg.param_count(), param_dtype="bfloat16",
         compute_dtype="bfloat16", reduced=reduced, long_seq=long_seq,
         launches={n: 0 for n in counters}, runs=runs, fp32_gate=gate)
    return {n: 0 for n in counters}


def fill_cross(model, params, frames, cache, rt):
    """The decode's cross caches from the encoder's output over `frames`:
    each decoder layer's `xattn` k and v (`layers.gqa_project` through its
    wk/bk and wv/bv) of `encode(frames)`, in the caches' dtype, written in
    place.  A yardstick's helper, not a feature: the reference's server
    never runs the encoder, and its cross caches stay zero."""
    from repro_torch.models.layers import full_precision_products, \
        gqa_project

    cfg = model.cfg
    xattn = params["decoder"]["xattn"]
    with torch.inference_mode(), full_precision_products():
        enc = model.encode(params, frames, rt)
        for i in range(cfg.num_layers):
            _, k, v = gqa_project({n: w[i] for n, w in xattn.items()}, enc,
                                  cfg.num_heads, cfg.num_kv_heads,
                                  cfg.resolved_head_dim, rt)
            cache["xk"][i].copy_(k)
            cache["xv"][i].copy_(v)
    return cache


@contextlib.contextmanager
def encdec_reads_the_cache(cache, cross_own: bool):
    """Within it an `EncDecLM` forward over S tokens reads, in each decoder
    layer, what a decode over the same tokens left in its caches (`cache`,
    stacked on the layers, after the decode's last step): self-attention
    the cache's k and v at positions 0..S-1 in place of its own
    projections, cross-attention the cache's xk and xv (zero, as the
    reference's server leaves them, or filled from the frames,
    `fill_cross`) in place of the encoder output's.  Both paths then read
    the same numbers.  The encoder runs as it is.  Yields a record: the
    decoder layers each read ("self", "cross"), and the forward's own
    values it replaced, in fp32, by layer: k and v ("own"), and with
    `cross_own` the cross k and v of its encoder output ("own_cross")."""
    from repro_torch.models import encdec as E
    from repro_torch.models import layers as L

    mha = E._mha
    rec = {"self": [], "cross": [], "own": {}, "own_cross": {}}

    def read_cached(p, xq, xkv, cfg, rt, causal):
        if xq is xkv and not causal:                    # the encoder
            return mha(p, xq, xkv, cfg, rt, causal)
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        cd = rt.compute_dtype
        if causal:
            layer = len(rec["self"])
            rec["self"].append(layer)
            q, k, v = L.gqa_project(p, xq, H, KV, hd, rt)
            rec["own"][layer] = {"k": k, "v": v}
            S = q.shape[1]
            k, v = (cache[key][layer][:, :S].to(cd) for key in ("k", "v"))
        else:
            layer = len(rec["cross"])
            rec["cross"].append(layer)
            q = E._proj(xq, p["wq"], p.get("bq"), H, hd, rt)
            if cross_own:
                rec["own_cross"][layer] = {
                    "xk": E._proj(xkv, p["wk"], p.get("bk"), KV, hd, rt),
                    "xv": E._proj(xkv, p["wv"], p.get("bv"), KV, hd, rt)}
            k, v = (cache[key][layer].to(cd) for key in ("xk", "xv"))
        o = L.blocked_attention(q, k, v, causal=causal,
                                kv_block=rt.attn_kv_block)
        return L.gqa_out(p, o, rt)

    E._mha = read_cached
    try:
        yield rec
    finally:
        E._mha = mha


def by_layer(cache, keys) -> list:
    """Stacked caches as the per-layer dicts `cache_against_forward`
    reads."""
    n = cache[keys[0]].shape[0]
    return [{k: cache[k][i] for k in keys} for i in range(n)]


def phase_prefill_whisper() -> dict:
    """whisper-medium's batched prefill at full width (24 encoder and 24
    decoder layers, d 1024, 16 heads of 64, d_ff 4096, vocab 51,865
    padded to 51,968; bf16 weights and random frames [B, 1500, 1024] from
    seed 0) through `make_prefill_step` with `use_kernels=True`: no kernel
    runs (the reference's `_mha` always calls `blocked_attention`), every
    counter 0 a forward.  Seq 2048 x batch 4 and 32,768 x 1 (prefill_32k
    with its batch cut from 32, listed in `reduced`): the wall (median of
    2 after a warm-up; one run at 32k, `LONG_FORWARD_S`), tokens/s, one
    profiled forward (device time by
    kind, idle share, kernels) and `max_memory_allocated` at each.  Gate,
    in fp32: the forward's last logits at `WHISPER_GATE_SEQ` tokens
    against the fp32 decode loop over the same tokens (fp32 caches, the
    cross caches filled from the same encoder output by `fill_cross`),
    within `SERVE_RG_TOL`."""
    import gc

    from repro_torch import configs
    from repro_torch.launch.steps import (build_model, input_specs,
                                          make_prefill_step, make_runtime,
                                          make_serve_step)
    from repro_torch.models.layers import Runtime, map_specs

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_arch(WHISPER_ARCH)
    shape = configs.shape_by_name("prefill_32k")
    model = build_model(cfg)
    rt = make_runtime(cfg, shape, use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, rt)
    step = make_prefill_step(model, rt)
    counters = kernel_counters()
    frames_shape, frames_dtype = input_specs(cfg, shape)["frames"]
    check(frames_shape[1:] == (cfg.encoder_seq, cfg.d_model)
          and frames_dtype == torch.bfloat16,
          f"whisper's prefill frames are {frames_shape} {frames_dtype}")
    runs = {}

    def forward(inputs):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {n: fn.launches for n, fn in counters.items()}
        check(not any(got.values()), f"the {WHISPER_ARCH} prefill launched "
                                     f"{got}: its path runs no kernel")
        return logits, wall

    for seq, batch in ((2048, 4), (shape.seq_len, 1)):
        inputs = {"frames": torch.randn(
                      (batch,) + frames_shape[1:], generator=gen,
                      device="cuda").to(frames_dtype),
                  "tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                          generator=gen, device="cuda")}
        walls = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            logits, wall = forward(inputs)
            walls.append(wall)
            if walls[0] > LONG_FORWARD_S:
                break                             # one run, timed
        peak = torch.cuda.max_memory_allocated()
        got = logits[:, :cfg.vocab_size].float()
        check(tuple(logits.shape) == (batch, model.v_pad),
              f"prefill logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(got).all()), "prefill logits not finite")
        wall = float(np.median(walls[1:] or walls))
        t0 = time.perf_counter()
        device = device_kinds(lambda: step(params, inputs),
                              {"matmul_us": ("gemm", "nvjet", "xmma")})
        device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
        device["profile_s"] = time.perf_counter() - t0
        runs[f"seq{seq}_batch{batch}"] = {
            "seq": seq, "batch": batch, "encoder_frames": frames_shape[1],
            "wall_s": wall, "walls_s": walls,
            "tokens_per_s": seq * batch / wall,
            "max_memory_allocated": peak,
            "launches_per_forward": {n: 0 for n in counters},
            "device_one_forward": device}
        del logits, inputs

    # the fp32 gate: the forward's last logits against the decode loop
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rt32 = Runtime(compute_dtype=torch.float32, use_kernels=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt32)
    frames = torch.randn((1,) + frames_shape[1:], generator=gen,
                         device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, WHISPER_GATE_SEQ),
                           generator=gen, device="cuda")
    fwd = make_prefill_step(model, rt32)(params, {
        "frames": frames, "tokens": tokens})[:, :cfg.vocab_size].float()
    serve = make_serve_step(model, rt32)
    cache = map_specs(lambda sp: torch.zeros(sp.shape, device="cuda"),
                      model.cache_specs(1, WHISPER_GATE_SEQ))
    fill_cross(model, params, frames, cache, rt32)
    t0 = time.perf_counter()
    for pos in range(WHISPER_GATE_SEQ):
        dec, cache = serve(params, cache, tokens[:, pos:pos + 1],
                           position(pos))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    dec = dec[:, 0, :cfg.vocab_size].float()
    atol, rtol = SERVE_RG_TOL
    check(bool(torch.isfinite(fwd).all() and torch.isfinite(dec).all()),
          "the fp32 forward or decode logits are not finite")
    diff = (fwd - dec).abs()
    ratio = float((diff / (atol + rtol * dec.abs())).max())
    gate = {"seq": WHISPER_GATE_SEQ, "tolerance": SERVE_RG_TOL,
            "cache_dtype": "float32", "cross_caches": "fill_cross(frames)",
            "max_abs_diff": float(diff.max()), "tol_ratio": ratio,
            "decode_loop_s": decode_s,
            "same_next_token": bool(fwd.argmax(-1) == dec.argmax(-1)),
            "fp32_logits_max_abs": float(fwd.abs().max())}
    check(ratio <= 1.0, f"{WHISPER_ARCH}'s fp32 forward differs from its "
                        f"decode loop by {float(diff.max())} (ratio {ratio})")
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    check_isolated()
    emit(f"prefill {WHISPER_ARCH}", arch=WHISPER_ARCH,
         encoder_layers=cfg.encoder_layers, decoder_layers=cfg.num_layers,
         parameters=cfg.param_count(), param_dtype="bfloat16",
         compute_dtype="bfloat16",
         reduced={"prefill_32k": "global_batch 32 -> 1"},
         launches={n: 0 for n in counters}, runs=runs, fp32_gate=gate)
    return {n: 0 for n in counters}


def phase_serve_whisper() -> dict:
    """whisper-medium's `serve_requests` at full width on the card, fp32
    weights and compute: 8 requests of 4-12 prompt tokens, batch 4,
    `SERVE_NEW` new tokens, caches of 256, the reference's zeroed cross
    caches (its
    server never runs the encoder, so the decode's cross-attention gives
    exactly 0).  Each request's prompt and served tokens are replayed
    through the decode step as served (bf16 caches; the served tokens must
    come back) and held to a forward that reads the decode's own caches
    (`encdec_reads_the_cache`: its self-attention the bf16 k and v, its
    cross-attention the zero xk and xv) within `SERVE_RG_TOL`, every k and
    v entry within one bf16 rounding of the forward's own value
    (`cache_against_forward`).  Second gate, the one in which the decode's
    cross-attention sees values that are not zero: the first
    `FILLED_REQUESTS` sequences decoded over cross caches filled from
    random frames (`fill_cross`),
    against the forward over the same frames reading the decode's caches,
    within `SERVE_RG_TOL`, every k, v, xk and xv entry within one bf16
    rounding of the forward's own; that decode's gap to the plain forward
    over the frames is printed.  The forwards run with `use_kernels=True`
    and launch nothing, counted."""
    import gc

    from repro_torch import configs
    from repro_torch.launch.serve import serve_requests
    from repro_torch.launch.steps import build_model, make_serve_step
    from repro_torch.models.layers import Runtime, full_precision_products

    gc.collect()
    torch.cuda.empty_cache()
    cfg = configs.get_arch(WHISPER_ARCH)
    model = build_model(cfg)
    rt = Runtime(compute_dtype=torch.float32)
    rt_fwd = Runtime(compute_dtype=torch.float32, use_kernels=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, rt)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size,
                                             size=rng.integers(4, 13))]
               for _ in range(8)]
    serve_requests(cfg, prompts[:1], batch=1, max_new=2, max_len=256,
                   device="cuda", params=params)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = serve_requests(cfg, prompts, batch=4, max_new=SERVE_NEW,
                             max_len=256,
                             device="cuda", params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(results) == 8 and all(len(r.generated) == SERVE_NEW
                                    for r in results),
          f"serve did not answer every request with {SERVE_NEW} tokens")
    check(all(0 <= t < cfg.vocab_size for r in results for t in r.generated),
          "serve generated a token outside the vocabulary")

    atol, rtol = SERVE_RG_TOL
    v = cfg.vocab_size
    step = make_serve_step(model, rt)
    counters = kernel_counters()
    fwd_launches = dict.fromkeys(counters, 0)
    layers = list(range(cfg.num_layers))
    gaps = {key: {"max_abs_diff": 0.0, "tol_ratio": 0.0}
            for key in ("served", "filled", "filled_vs_plain_forward")}
    entries = {key: {"worst_ratio": 0.0, "entries": 0,
                     "unwritten_nonzero": 0}
               for key in ("served", "filled")}
    cross_abs = {"served": 0.0, "filled": 0.0}
    frames = torch.randn((1, cfg.encoder_seq, cfg.d_model), generator=gen,
                         device="cuda")
    zero_frames = torch.zeros_like(frames)

    def decode(seq, cache):
        rows = []
        for pos, t in enumerate(seq):
            tok = torch.full((1, 1), t, dtype=torch.int64, device="cuda")
            logits, cache = step(params, cache, tok, position(pos))
            rows.append(logits[0, 0, :v])
        return torch.stack(rows), cache

    def forward(seq, frm, hook):
        for fn in counters.values():
            fn.launches = 0
        with torch.inference_mode(), full_precision_products(), \
                (hook or contextlib.nullcontext()) as rec:
            out = model.forward(params, {"tokens": torch.tensor(
                [seq], device="cuda"), "frames": frm}, rt_fwd)[0, :, :v]
        for n, fn in counters.items():
            fwd_launches[n] += fn.launches
        return out.float(), rec

    def gap(got, want, into):
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              "decode or forward logits not finite")
        diff = (got - want).abs()
        into["max_abs_diff"] = max(into["max_abs_diff"], float(diff.max()))
        into["tol_ratio"] = max(into["tol_ratio"], float(
            (diff / (atol + rtol * want.abs())).max()))

    def add(into, got):
        into["worst_ratio"] = max(into["worst_ratio"], got["worst_ratio"])
        into["entries"] += got["entries"]
        into["unwritten_nonzero"] += got["unwritten_nonzero"]

    reproduced = served = 0
    for r in results:
        seq = r.prompt + r.generated
        p0 = len(r.prompt) - 1
        gen_t = torch.tensor(r.generated, device="cuda")
        keys = ("served", "filled") if r.request_id < FILLED_REQUESTS \
            else ("served",)
        for key in keys:
            cache = model.init_cache(1, 256, rt, "cuda")
            if key == "filled":
                fill_cross(model, params, frames, cache, rt)
            dec, cache = decode(seq, cache)
            cross_abs[key] = max(cross_abs[key],
                                 float(cache["xk"].float().abs().max()))
            if key == "served":
                got = dec[p0:p0 + len(gen_t)].argmax(-1)
                reproduced += int((got == gen_t).sum())
                served += len(gen_t)
            fwd, rec = forward(seq, frames if key == "filled"
                               else zero_frames,
                               encdec_reads_the_cache(cache,
                                                      key == "filled"))
            check(rec["self"] == layers and rec["cross"] == layers,
                  f"the forward read the decode's caches at {rec['self']} "
                  f"/ {rec['cross']}, expected every decoder layer")
            gap(dec, fwd, gaps[key])
            add(entries[key], cache_against_forward(
                by_layer(cache, ("k", "v")), rec, len(seq)))
            if key == "filled":
                add(entries[key], cache_against_forward(
                    by_layer(cache, ("xk", "xv")),
                    {"own": rec["own_cross"]}, cfg.encoder_seq))
                plain, _ = forward(seq, frames, None)
                gap(dec, plain, gaps["filled_vs_plain_forward"])
            del cache, rec
    check(reproduced == served,
          f"the decode replayed {reproduced} of the {served} served tokens")
    check(cross_abs["served"] == 0.0 and cross_abs["filled"] > 0.0,
          f"the cross caches' largest |x|: {cross_abs}, expected 0 as "
          f"served and > 0 filled")
    for key in ("served", "filled"):
        check(gaps[key]["tol_ratio"] <= 1.0,
              f"{WHISPER_ARCH}'s decode ({key} cross caches) differs from "
              f"the forward that reads its caches by "
              f"{gaps[key]['max_abs_diff']} (ratio "
              f"{gaps[key]['tol_ratio']})")
        check(entries[key]["worst_ratio"] <= 1.0
              and entries[key]["unwritten_nonzero"] == 0,
              f"{WHISPER_ARCH}'s decode caches ({key}): an entry beyond one "
              f"bf16 rounding of the forward's own value, or a written slot "
              f"past the sequence: {entries[key]}")
    check(not any(fwd_launches.values()),
          f"the {WHISPER_ARCH} forwards launched {fwd_launches}: its path "
          f"runs no kernel")
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
    rec = dict(arch=WHISPER_ARCH, decoder_layers=cfg.num_layers,
               compute_dtype="float32", param_dtype="float32",
               level="smoke: toy context, no serve rate",
               requests=len(results), batch=4, max_new=SERVE_NEW,
               max_len=256,
               prompt_lens=[len(p) for p in prompts], wall_s=wall,
               generated_tokens=generated, tokens_per_s=generated / wall,
               latency_s=[r.latency_s for r in results],
               max_memory_allocated=peak, tolerance=SERVE_RG_TOL,
               served_tokens_reproduced_by_decode=reproduced / served,
               served_cross_caches="zero (the reference's server)",
               max_abs_diff_vs_cache_reading_forward=gaps["served"][
                   "max_abs_diff"],
               tol_ratio_vs_cache_reading_forward=gaps["served"][
                   "tol_ratio"],
               filled_max_abs_diff_vs_cache_reading_forward=gaps["filled"][
                   "max_abs_diff"],
               filled_tol_ratio_vs_cache_reading_forward=gaps["filled"][
                   "tol_ratio"],
               filled_max_abs_diff_vs_plain_forward=gaps[
                   "filled_vs_plain_forward"]["max_abs_diff"],
               filled_tol_ratio_vs_plain_forward=gaps[
                   "filled_vs_plain_forward"]["tol_ratio"],
               filled_cross_cache_max_abs=cross_abs["filled"],
               cache_entries=entries, cache_entry_tolerance=[CACHE_RTOL,
                                                             CACHE_ATOL],
               forward_launches=fwd_launches, device_one_step=device)
    emit(f"serve {WHISPER_ARCH}", **rec)
    del params
    return rec


def leaf_gap(got, want) -> float:
    """The largest gap of two tensor trees, leaf by leaf, each over its
    leaf's largest magnitude in `want`."""
    from torch.utils import _pytree as pytree
    worst = 0.0
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        w = w.float().cpu()
        gap = float((g.float().cpu() - w).abs().max())
        worst = max(worst, gap / max(float(w.abs().max()), 1e-30))
    return worst


def grads_gap(got: list, want: list) -> float:
    return max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                1e-30)
               for g, w in zip(got, want))


def train_card_against_cpu() -> dict:
    """Part 1 of the training phase: `TRAIN_PARITY["steps"]` train steps
    of qwen2-0.5b's smoke config on the card and on the CPU from the same
    params and batches, at each microbatch count.  Losses and grad norms
    agree within TRAIN_TOL relative.  Each step, from the CPU run's params
    and state, the step's two halves are held apart: the card's gradients
    within TRAIN_TOL of each leaf's largest magnitude, and the card's
    `adamw_update` on the CPU's gradients gives every param and moment
    leaf within TRAIN_TOL of its largest magnitude.  The params after the
    free-running steps are printed, not gated: Adam's m / (sqrt(v) + eps)
    passes an element's own relative gradient error on to its update, so
    where a leaf's elements are near-cancelling sums (the key biases, under
    RoPE) a gap within TRAIN_TOL of the leaf's gradients grows past
    TRAIN_TOL of its params."""
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import (build_model, loss_and_grads,
                                          make_train_step)
    from repro_torch.launch.train import to_device
    from repro_torch.models.layers import Runtime, full_precision_products
    from repro_torch.optim import (adamw_init, adamw_update,
                                   linear_warmup_cosine)

    cfg = configs.get_smoke(ARCH)
    model = build_model(cfg)
    rt = Runtime(compute_dtype=torch.float32)
    base = model.init(torch.Generator().manual_seed(0), rt)
    decay = model.decay_mask()
    sched = TRAIN_PARITY["schedule"]
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size,
                            seq_len=TRAIN_PARITY["seq"],
                            global_batch=TRAIN_PARITY["batch"], seed=0)

    def on(tree, dev):
        return pytree.tree_map(lambda t: t.to(dev, copy=True), tree)

    parity = {}
    for mb in TRAIN_PARITY["microbatches"]:
        runs = {}
        for dev in ("cpu", "cuda"):
            params = on(base, dev)
            state = adamw_init(params)
            step = make_train_step(model, rt, microbatches=mb, **sched)
            mets = []
            for i in range(TRAIN_PARITY["steps"]):
                params, state, m = step(params, state, to_device(
                    ds.global_batch_at(i), dev))
                mets.append({k: float(v) for k, v in m.items()})
            runs[dev] = (params, state, mets)
        metric_gap = max(abs(a[k] - b[k]) / abs(a[k])
                         for a, b in zip(runs["cpu"][2], runs["cuda"][2])
                         for k in ("loss", "grad_norm"))
        # step by step from the CPU run's params and state: the gradients,
        # then the optimizer on the same gradients
        params = on(base, "cpu")
        state = adamw_init(params)
        treedef = pytree.tree_structure(params)
        grad_gap, optim_gap = 0.0, 0.0
        for i in range(TRAIN_PARITY["steps"]):
            batch = ds.global_batch_at(i)
            with full_precision_products():
                _, g_cpu = loss_and_grads(model, rt, params,
                                          to_device(batch, "cpu"), mb)
                _, g_card = loss_and_grads(model, rt, on(params, "cuda"),
                                           to_device(batch, "cuda"), mb)
            grad_gap = max(grad_gap, grads_gap([g.cpu() for g in g_card],
                                               g_cpu))
            grads = pytree.tree_unflatten(g_cpu, treedef)
            card = (on(params, "cuda"), on(state, "cuda"))
            with full_precision_products():
                lr = linear_warmup_cosine(card[1].step + 1, **sched)
                p_card, s_card, _ = adamw_update(
                    on(grads, "cuda"), card[1], card[0], lr, decay=decay)
                lr = linear_warmup_cosine(state.step + 1, **sched)
                params, state, _ = adamw_update(grads, state, params, lr,
                                                decay=decay)
            optim_gap = max(optim_gap, leaf_gap(p_card, params),
                            leaf_gap(s_card.mu, state.mu),
                            leaf_gap(s_card.nu, state.nu))
            del card, p_card, s_card, g_card
        check(leaf_gap(params, runs["cpu"][0]) == 0.0,
              f"the step-by-step CPU run left the CPU train step's path at "
              f"microbatches={mb}")
        # the free-running params: each leaf's gap over its largest
        # magnitude, and the elements past TRAIN_TOL of it, by leaf
        worst, worst_leaf, beyond = 0.0, None, {}
        for (path, w), g in zip(
                pytree.tree_flatten_with_path(runs["cpu"][0])[0],
                pytree.tree_leaves(runs["cuda"][0])):
            err = (g.cpu() - w).abs()
            scale = max(float(w.abs().max()), 1e-30)
            if float(err.max()) / scale > worst:
                worst, worst_leaf = float(err.max()) / scale, \
                    pytree.keystr(path)
            if int((err > TRAIN_TOL * scale).sum()):
                beyond[pytree.keystr(path)] = int(
                    (err > TRAIN_TOL * scale).sum())
        parity[f"microbatches_{mb}"] = {
            "losses_cuda": [m["loss"] for m in runs["cuda"][2]],
            "metric_gap": metric_gap, "grad_gap": grad_gap,
            "optimizer_gap": optim_gap,
            "param_gap": worst, "param_gap_leaf": worst_leaf,
            "elements_beyond_leaf_tol": beyond,
            "elements": sum(p.numel() for p in pytree.tree_leaves(base)),
            "moment_gap": leaf_gap(runs["cuda"][1].nu, runs["cpu"][1].nu)}
        check(metric_gap <= TRAIN_TOL and grad_gap <= TRAIN_TOL
              and optim_gap <= TRAIN_TOL,
              f"the train step on the card differs from the CPU's at "
              f"microbatches={mb}: losses / grad norms by {metric_gap}, "
              f"gradients by {grad_gap} and the optimizer's update of the "
              f"same gradients by {optim_gap} of a leaf's scale")
    return parity


def phase_train() -> dict:
    """qwen2-0.5b's training path (the reference's: no kernel on it,
    `use_pallas=False`).  1: the train step on the card against the CPU
    from the same params and batches (smoke config, fp32, both microbatch
    counts; `train_card_against_cpu`).  2: `train_loop` at full width in fp32 (`TRAIN_LOOP`): the
    uninterrupted run checkpoints, a run resumed from its middle
    checkpoint gives its last losses, and the same step learns one batch
    of the stream (`TRAIN_LEARNS_BY`).  3: at full
    width, the gradients under remat none / full / dots, and of two
    microbatches against one, agree.  4: the train cell's runtime (bf16
    compute, remat "full", `TRAIN_CELL`): step time, tokens/s, counted
    FLOPs and their share of the peak, `max_memory_allocated` against the
    same step counted on fake CUDA tensors, one profiled step.  5: every
    kernel counter at 0 over the phase."""
    import gc
    import tempfile

    from torch.utils import _pytree as pytree

    import repro_torch.launch.train as train_mod
    from repro_torch import configs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.roofline import model_flops
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.launch.steps import (build_model, loss_and_grads,
                                          make_runtime, make_train_step,
                                          trace_step)
    from repro_torch.launch.train import to_device, train_loop
    from repro_torch.models.layers import Runtime, full_precision_products
    from repro_torch.optim import adamw_init

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    rec = {"arch": ARCH}

    # 1. the card against the CPU, smoke config
    rec["card_against_cpu"] = train_card_against_cpu()

    # 2. train_loop at full width, fp32; checkpoints timed
    saves = []

    class TimedManager(CheckpointManager):
        def save(self, step, tree, blocking=True):
            t0 = time.perf_counter()
            super().save(step, tree, blocking)
            saves.append({"step": step, "blocking": blocking,
                          "call_s": time.perf_counter() - t0,
                          "bytes": sum(t.numel() * t.element_size()
                                       for t in pytree.tree_leaves(tree))})

        def wait(self):
            t0 = time.perf_counter()
            joined = self._thread is not None
            super().wait()
            if joined and saves:
                saves[-1]["write_wait_s"] = time.perf_counter() - t0

    full = configs.get_arch(ARCH)
    loop = {}
    train_mod.CheckpointManager = TimedManager
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        gc.collect()
        torch.cuda.empty_cache()
        kw = dict(global_batch=TRAIN_LOOP["global_batch"],
                  seq_len=TRAIN_LOOP["seq_len"], lr=TRAIN_LOOP["lr"],
                  ckpt_dir=tmp, log_every=1, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        whole = train_loop(full, steps=TRAIN_LOOP["steps"],
                           save_every=TRAIN_LOOP["save_every"], **kw)
        torch.cuda.synchronize()
        loop["uninterrupted_s"] = time.perf_counter() - t0
        loop["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        losses = whole["losses"]
        n_params = whole["n_params"]
        del whole
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(Path(tmp) / f"step_{TRAIN_LOOP['steps']}")
        t0 = time.perf_counter()
        resumed = train_loop(full, steps=TRAIN_LOOP["steps"], resume=True,
                             **kw)
        torch.cuda.synchronize()
        loop["resumed_s"] = time.perf_counter() - t0
        again = resumed["losses"]
        del resumed
    finally:
        train_mod.CheckpointManager = CheckpointManager
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    half = TRAIN_LOOP["save_every"]
    resume_gap = max(abs(a - b) / abs(b)
                     for a, b in zip(again, losses[half:]))
    loop.update(config=TRAIN_LOOP, n_params=n_params, losses=losses,
                resumed_losses=again,
                first5_mean=float(np.mean(losses[:5])),
                last5_mean=float(np.mean(losses[-5:])),
                learned_by=float(np.mean(losses[:5]) - np.mean(losses[-5:])),
                resume_gap=resume_gap,
                step_s_mean=loop["uninterrupted_s"] / TRAIN_LOOP["steps"],
                saves=saves)
    check(all(math.isfinite(x) for x in losses + again),
          "train_loop's losses are not finite")
    check(len(again) == TRAIN_LOOP["steps"] - half
          and resume_gap <= TRAIN_TOL,
          f"the resumed run's losses {again} differ from the uninterrupted "
          f"run's {losses[half:]} by {resume_gap}")
    # the learning criterion: train_loop's step (its lr schedule and
    # steps) on one batch of the stream, from the same seed-0 params
    model = build_model(full)
    rt32 = Runtime(compute_dtype=torch.float32)
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt32)
    state = adamw_init(params)
    batch = to_device(SyntheticLMDataset(
        vocab_size=full.vocab_size, seq_len=TRAIN_LOOP["seq_len"],
        global_batch=TRAIN_LOOP["global_batch"], seed=0).global_batch_at(0),
        "cuda")
    step = make_train_step(model, rt32, base_lr=TRAIN_LOOP["lr"],
                           warmup_steps=max(TRAIN_LOOP["steps"] // 10, 1),
                           total_steps=TRAIN_LOOP["steps"])
    fit = []
    for _ in range(TRAIN_LOOP["steps"]):
        params, state, m = step(params, state, batch)
        fit.append(float(m["loss"]))
    first, last = float(np.mean(fit[:5])), float(np.mean(fit[-5:]))
    loop["one_batch"] = {"losses": fit, "first5_mean": first,
                         "last5_mean": last, "learned_by": first - last}
    rec["train_loop"] = loop
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in fit) and first - last
          >= TRAIN_LEARNS_BY,
          f"the train step does not learn one batch: the last five losses "
          f"average {last}, the first five {first}")

    # 3. gradients at full width: remat and microbatches
    model = build_model(full)
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        Runtime(compute_dtype=torch.float32))
    B, S = TRAIN_GRAD_SHAPE
    batch = to_device(SyntheticLMDataset(
        vocab_size=full.vocab_size, seq_len=S, global_batch=B,
        seed=0).global_batch_at(0), "cuda")
    grads = {}
    with full_precision_products():
        loss0, g0 = loss_and_grads(
            model, Runtime(compute_dtype=torch.float32), params, batch)
        for remat in ("full", "dots"):
            loss_r, g = loss_and_grads(
                model, Runtime(compute_dtype=torch.float32, remat=remat),
                params, batch)
            grads[f"remat_{remat}"] = {
                "loss_gap": abs(float(loss_r) / float(loss0) - 1),
                "grad_gap": grads_gap(g, g0)}
            del g
        loss_m, g = loss_and_grads(
            model, Runtime(compute_dtype=torch.float32), params, batch, 2)
        grads["microbatches_2"] = {
            "loss_gap": abs(float(loss_m) / float(loss0) - 1),
            "grad_gap": grads_gap(g, g0)}
        del g, g0
    rec["gradients"] = {"shape": TRAIN_GRAD_SHAPE, "loss": float(loss0),
                        **grads}
    for k, v in grads.items():
        check(v["grad_gap"] <= TRAIN_TOL,
              f"full-width gradients under {k} differ by {v['grad_gap']} "
              f"of a leaf's scale")
    check(grads["remat_full"]["loss_gap"] <= TRAIN_MB_LOSS_TOL
          and grads["remat_dots"]["loss_gap"] <= TRAIN_MB_LOSS_TOL
          and grads["microbatches_2"]["loss_gap"] <= TRAIN_MB_LOSS_TOL,
          f"full-width losses differ: {grads}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the train cell's runtime at 4096 x 4
    shape = configs.shape_by_name("train_4k")
    rt = make_runtime(full, shape)
    cut = ShapeSpec("train_4k", TRAIN_CELL["seq"], TRAIN_CELL["batch"],
                    "train")
    mb = TRAIN_CELL["microbatches"]
    t0 = time.perf_counter()
    fake, _ = trace_step(full, cut, device="cuda", microbatches=mb)
    trace_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), rt)
    state = adamw_init(params)
    batch = to_device(SyntheticLMDataset(
        vocab_size=full.vocab_size, seq_len=cut.seq_len,
        global_batch=cut.global_batch, seed=0).global_batch_at(0), "cuda")
    step = make_train_step(model, rt, microbatches=mb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, mets = [], []
    for _ in range(TRAIN_CELL["steps"]):
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mets.append({k: float(v) for k, v in m.items()})
    real_peak = torch.cuda.max_memory_allocated() - base_bytes
    wall = float(np.median(walls[1:]))
    tokens = cut.seq_len * cut.global_batch
    device = device_kinds(lambda: step(params, state, batch),
                          {"matmul_us": ("gemm", "nvjet", "xmma",
                                         "cutlass")})
    device["idle_share"] = 1.0 - device["busy_us"] / device["wall_us"]
    ratio = real_peak / fake.peak_bytes
    rec["train_cell"] = {
        "shape": {"seq": cut.seq_len, "batch": cut.global_batch,
                  "microbatches": mb},
        "reduced": {"train_4k": "global_batch 256 -> 4"},
        "runtime": {"param_dtype": str(rt.param_dtype),
                    "compute_dtype": str(rt.compute_dtype),
                    "remat": rt.remat},
        "walls_s": walls, "step_s": wall, "tokens_per_s": tokens / wall,
        "metrics": mets,
        "counted_flops": fake.flops, "counted_matmul_flops":
            fake.matmul_flops,
        "counted_flop_share_of_989": fake.flops / wall / BF16_FLOP_PER_S,
        "model_flops_6nd": model_flops(full, cut),
        "model_flop_share_of_989": model_flops(full, cut) / wall
        / BF16_FLOP_PER_S,
        "fake_peak_bytes": fake.peak_bytes, "trace_s": trace_s,
        "max_memory_allocated": real_peak,
        "real_over_fake_peak": ratio, "band": DRYRUN_PEAK_BAND,
        "device_one_step": device}
    check(all(math.isfinite(v) for m in mets for v in m.values()),
          f"the train cell's losses or grad norms are not finite: {mets}")
    check(DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1],
          f"the train step's max_memory_allocated / fake peak = {ratio}, "
          f"outside {DRYRUN_PEAK_BAND}")
    del params, state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # 5. no kernel on the training path, counted
    got = {n: fn.launches for n, fn in counters.items()}
    rec["launches"] = got
    check(not any(got.values()),
          f"the training phase launched {got}: it runs no kernel")
    check_isolated()
    emit(f"train {ARCH}", **rec)
    return got


def leaf_bytes(tree) -> dict:
    """Each DTensor leaf's local and global bytes, by its path."""
    from torch.utils import _pytree as pytree

    return {pytree.keystr(path): [
        d.to_local().numel() * d.element_size(),
        math.prod(d.shape) * d.element_size()]
        for path, d in pytree.tree_flatten_with_path(tree)[0]}


def phase_mesh(smi: str) -> dict:
    """The sharding layer on the card: a one-rank NCCL process group made
    in this process (a `HashStore`: no environment, no network), a
    (1, 1) mesh on ("data", "model"), and qwen2-0.5b's full-width bf16
    serving params placed on it by `step_placements` + `place_params`.
    The prefill step under `Runtime(use_kernels=True, mesh=..., rules=...)`
    at `MESH_PREFILL` on the placed leaves' local tensors must give the
    logits of the same step on the unplaced params bit for bit, through
    the tensor-core flash kernel (its launches counted from 0 over the
    placed run); one decode step on placed caches (random bf16 contents,
    a position inside them) likewise, its logits and written caches.
    Then the same steps on the DTensors themselves, through the plain
    paths (the models' sharding sites redistributing on the mesh), must
    give the step bodies' results on the unplaced params bit for bit
    (both under `no_grad`: a step on DTensors cannot run under
    `inference_mode`, and ATen decomposes some products otherwise there),
    with no kernel launched; under `use_kernels=True` the flash branch
    must refuse the DTensors; and the placed prefill counted on fake
    tensors (`trace_step(mesh=...)`, `MESH_COUNT_LAYERS` layers) must
    count what the unplaced one counts, with no collective.  The group is
    destroyed before the phase returns.  On one rank this shows that the
    placements, DTensor and NCCL run on the card under the main path, not
    any multi-chip speed.  Returns the placed prefill's launches."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (build_model, make_prefill_step,
                                          make_runtime, make_serve_step,
                                          place_params, step_placements,
                                          trace_step)

    gc.collect()
    torch.cuda.empty_cache()
    check(not dist.is_initialized(), "a process group is already initialised")
    cfg = configs.get_arch(ARCH)
    batch, seq = MESH_PREFILL
    prefill = dataclasses.replace(configs.shape_by_name("prefill_32k"),
                                  global_batch=batch, seq_len=seq)
    decode = dataclasses.replace(configs.shape_by_name("decode_32k"),
                                 global_batch=batch, seq_len=MESH_CACHE)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.set_device(0)       # the mesh's NCCL communicators' card
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        init_s = time.perf_counter() - t0
        rt = make_runtime(cfg, prefill, use_kernels=True, mesh=mesh)
        rt_plain = make_runtime(cfg, prefill, use_kernels=True)
        check(rt.rules is not None and rt.mesh is mesh,
              "make_runtime(mesh=...) gave no rules")
        params = model.init(gen, rt)
        sp = step_placements(cfg, prefill, mesh)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        placed = place_params(params, mesh, sp.inputs[0])
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t1
        local = pytree.tree_map(lambda d: d.to_local(), placed)
        by_leaf = leaf_bytes(placed)
        check(all(lo == gl for lo, gl in by_leaf.values()),
              "a leaf's local bytes differ from its global bytes on one "
              "rank")

        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=gen, device="cuda")
        counters = kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        got = make_prefill_step(model, rt)(local, {"tokens": tokens})
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in counters.items()}
        want = make_prefill_step(model, rt_plain)(params,
                                                  {"tokens": tokens})
        check(launches == expected_launches(model, seq),
              f"the placed prefill launched {launches}")
        check(bool(torch.isfinite(got).all()), "placed logits not finite")
        check(torch.equal(got, want),
              f"the placed prefill's logits differ from the unplaced "
              f"step's by {float((got - want).abs().max())}")
        del got, want, placed, local

        # one decode step on placed caches, under decode's rules (tp)
        rt_dec = make_runtime(cfg, decode, use_kernels=True, mesh=mesh)
        sp_dec = step_placements(cfg, decode, mesh)
        cache = pytree.tree_map(
            lambda c: torch.randn(c.shape, generator=gen, device="cuda",
                                  dtype=torch.float32).to(c.dtype),
            model.init_cache(batch, MESH_CACHE, rt_dec, "cuda"))
        cache_plain = pytree.tree_map(torch.clone, cache)
        t2 = time.perf_counter()
        placed_params = place_params(params, mesh, sp_dec.inputs[0])
        placed_cache = place_params(cache, mesh, sp_dec.inputs[1])
        torch.cuda.synchronize()
        place_decode_s = time.perf_counter() - t2
        cache_bytes = leaf_bytes(placed_cache)
        check(all(lo == gl for lo, gl in cache_bytes.values()),
              "a cache leaf's local bytes differ from its global bytes")
        token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                              device="cuda")
        pos = position(MESH_CACHE // 2)
        for fn in counters.values():
            fn.launches = 0
        logits, new_cache = make_serve_step(model, rt_dec)(
            pytree.tree_map(lambda d: d.to_local(), placed_params),
            pytree.tree_map(lambda d: d.to_local(), placed_cache),
            token, pos)
        torch.cuda.synchronize()
        decode_launches = {n: fn.launches for n, fn in counters.items()}
        logits_plain, cache_plain = make_serve_step(model, rt_dec)(
            params, cache_plain, token, pos)
        check(torch.equal(logits, logits_plain),
              f"the placed decode's logits differ from the unplaced "
              f"step's by {float((logits - logits_plain).abs().max())}")
        check(all(torch.equal(a, b) for a, b in zip(
            pytree.tree_leaves(new_cache), pytree.tree_leaves(cache_plain))),
            "the placed decode wrote other cache values")
        del logits, logits_plain, new_cache, cache_plain, placed_cache
        on_dtensors = dtensor_steps(model, cfg, mesh, params, tokens,
                                    prefill, decode, counters, gen)

        # the placed prefill counted on fake tensors over this mesh
        short = dataclasses.replace(cfg, num_layers=MESH_COUNT_LAYERS)
        t3 = time.perf_counter()
        placed_count, _ = trace_step(short, prefill, device="cuda",
                                     mesh=mesh)
        count_s = time.perf_counter() - t3
        plain_count, _ = trace_step(short, prefill, device="cuda")
        fields = ("flops", "matmul_flops", "elementwise_flops",
                  "transcendentals", "bytes_accessed", "peak_bytes", "ops")
        count = {k: [getattr(placed_count, k), getattr(plain_count, k)]
                 for k in fields}
        check(all(a == b for a, b in count.values()),
              f"the placed prefill counts {count} (placed, unplaced)")
        check(placed_count.collectives.count == 0,
              f"collectives on one rank: {placed_count.collectives}")
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "the process group outlived the phase")
    check_isolated()
    emit(f"mesh {ARCH}", arch=ARCH, nvidia_smi=smi, backend="nccl",
         world_size=1, mesh={"shape": [1, 1], "axes": ["data", "model"]},
         rules=rt.rules.asdict(),
         decode_rules=rt_dec.rules.asdict(),
         group_init_s=init_s, place_params_s=place_s,
         place_decode_s=place_decode_s,
         prefill={"batch": batch, "seq": seq, "dtype": "bfloat16",
                  "logits_bit_equal": True, "launches": launches},
         decode={"batch": batch, "cache_len": MESH_CACHE,
                 "pos": MESH_CACHE // 2, "logits_bit_equal": True,
                 "cache_bit_equal": True, "launches": decode_launches},
         param_leaves=len(by_leaf),
         param_bytes={"local": sum(v[0] for v in by_leaf.values()),
                      "global": sum(v[1] for v in by_leaf.values())},
         cache_leaves=len(cache_bytes),
         leaf_bytes_local_global={"params": by_leaf, "cache": cache_bytes},
         on_dtensors=on_dtensors,
         placed_count={"layers": MESH_COUNT_LAYERS, "seconds": count_s,
                       "placed_and_unplaced": count,
                       "collectives": placed_count.collectives.count})
    return launches


def dtensor_steps(model, cfg, mesh, params, tokens, prefill, decode,
                  counters, gen) -> dict:
    """`phase_mesh`'s steps on the DTensors themselves: the plain prefill
    and one decode step over the placed params (and placed batch, caches,
    token and position) against the step bodies on the unplaced ones, bit
    for bit, no kernel launched; and the kernel branch's refusal."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch.steps import (make_prefill_step, make_runtime,
                                          make_serve_step, place_params,
                                          step_placements)
    from repro_torch.models.layers import full_precision_products

    batch, seq = tokens.shape
    rt = make_runtime(cfg, prefill, mesh=mesh)
    rt_plain = make_runtime(cfg, prefill)
    sp = step_placements(cfg, prefill, mesh)
    placed = place_params(params, mesh, sp.inputs[0])
    placed_batch = place_params({"tokens": tokens}, mesh, sp.inputs[1])
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = make_prefill_step(model, rt)(placed, placed_batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    check(not any(launches.values()),
          f"the plain prefill on DTensors launched {launches}")
    with torch.no_grad(), full_precision_products():
        want = model.forward(params, {"tokens": tokens}, rt_plain,
                             last_only=True)[:, -1, :]
    got = got.full_tensor()
    check(bool(torch.isfinite(got).all()), "DTensor logits not finite")
    check(torch.equal(got, want),
          f"the prefill on DTensors differs from the unplaced step by "
          f"{float((got - want).abs().max())}")
    # the kernels read memory: a DTensor is refused, not cut to its shard
    rt_k = make_runtime(cfg, prefill, use_kernels=True, mesh=mesh)
    refused = ""
    try:
        make_prefill_step(model, rt_k)(placed, placed_batch)
    except TypeError as e:
        refused = str(e)
    check("DTensor" in refused,
          f"the flash branch took a DTensor: {refused!r}")
    del got, want, placed

    rt_dec = make_runtime(cfg, decode, mesh=mesh)
    rt_dec_plain = make_runtime(cfg, decode)
    sp_dec = step_placements(cfg, decode, mesh)
    cache = pytree.tree_map(
        lambda c: torch.randn(c.shape, generator=gen, device="cuda",
                              dtype=torch.float32).to(c.dtype),
        model.init_cache(batch, MESH_CACHE, rt_dec, "cuda"))
    cache_plain = pytree.tree_map(torch.clone, cache)
    token = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen,
                          device="cuda")
    pos = position(MESH_CACHE // 2)
    args = [place_params(t, mesh, lay) for t, lay in
            zip((params, cache, token, pos), sp_dec.inputs)]
    t0 = time.perf_counter()
    logits, new_cache = make_serve_step(model, rt_dec)(*args)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches_dec = {n: fn.launches for n, fn in counters.items()}
    check(not any(launches_dec.values()),
          f"the plain decode on DTensors launched {launches_dec}")
    with torch.no_grad(), full_precision_products():
        want, want_cache = model.decode_step(params, cache_plain, token,
                                             pos, rt_dec_plain)
    check(torch.equal(logits.full_tensor(), want),
          "the decode on DTensors differs from the unplaced step by "
          f"{float((logits.full_tensor() - want).abs().max())}")
    check(all(torch.equal(a.full_tensor(), b) for a, b in zip(
        pytree.tree_leaves(new_cache), pytree.tree_leaves(want_cache))),
        "the decode on DTensors wrote other cache values")
    return {"prefill": {"batch": batch, "seq": seq, "use_kernels": False,
                        "logits_bit_equal": True, "seconds": prefill_s,
                        "launches": launches},
            "decode": {"logits_bit_equal": True, "cache_bit_equal": True,
                       "seconds": decode_s, "launches": launches_dec},
            "kernel_branch_refused": refused}


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
    kernel is built for, each output against the plain version; then the
    same for the fp32 `FP32_SHAPE` under the CUDA-core model and every
    tile of the CUDA-core kernel.  Returns the launches of each kernel in
    this phase and the per-shape records."""
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
    # the fp32 product on the CUDA cores, at every tile the CUDA-core
    # kernel is built for, each output against the plain version
    m, k, n = FP32_SHAPE
    x = torch.randn((m, k), generator=gen, device="cuda")
    y = torch.randn((k, n), generator=gen, device="cuda")
    best, cost, ranking = tune_matmul_tiles(m, k, n, dtype_bytes=4)
    tuned = (best.bm, best.bk, best.bn)
    predicted = {(t.bm, t.bk, t.bn): lat * 1e3 for t, lat in ranking}
    tiles = list(predicted)
    outs, measured = {}, {}
    for t in tiles:
        outs[t] = mm.matmul(x, y, bm=t[0], bk=t[1], bn=t[2])
        measured[t] = device_ms(
            lambda: mm.matmul(x, y, bm=t[0], bk=t[1], bn=t[2]), reps=2,
            inner=1)
    torch.cuda.synchronize()
    checks = matmul_against_plain(x, y, {str(t): o for t, o in outs.items()},
                                  tuned[1])
    del outs
    for t, res in checks.items():
        if res["tol_ratio"] > 1.0 or not res["finite"]:
            failed.append(f"fp32 {FP32_SHAPE} tile {t}: {res}")
    with full_precision_products():
        library_ms = device_ms(lambda: torch.matmul(x, y), reps=2, inner=1)
        plain_ms = device_ms(lambda: mm.matmul_plain(x, y, bk=tuned[1]),
                             reps=1, inner=1)
    fastest = min(measured, key=measured.get)
    kernel_ms = measured[tuned]
    flop = 2 * m * k * n
    fp32 = {"M": m, "K": k, "N": n, "dtype": "float32",
            "kernel": mm.CUDA_CORE.name, "tuned": list(tuned),
            "predicted_ms": predicted[tuned], "tuned_cost": cost,
            "fastest": list(fastest), "kernel_ms": kernel_ms,
            "regret": kernel_ms / measured[fastest] - 1.0,
            "rank_correlation": spearman([predicted[t] for t in tiles],
                                         [measured[t] for t in tiles]),
            "tiles": [{"tile": list(t), "predicted_ms": predicted[t],
                       "measured_ms": measured[t],
                       "tol_ratio": checks[str(t)]["tol_ratio"]}
                      for t in tiles],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_share": library_ms / kernel_ms,
            "flop": flop, "bytes": 4 * (m * k + k * n + m * n),
            "bound_ms": flop / FP32_FLOP_PER_S * 1e3,
            "bound_by": "operations (67 TFLOP/s fp32 FMA)",
            "bound_share": flop / FP32_FLOP_PER_S * 1e3 / kernel_ms,
            "max_abs_err": max(r["max_abs_err"] for r in checks.values()),
            "tol_ratio": max(r["tol_ratio"] for r in checks.values())}
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
    """Dry-runs of the six served archs at their serving cells on fake
    CUDA tensors (`dryrun_serving_cells`, in a spawned process beside the
    rest: xlstm-1.3b's `long_500k` too, and qwen2.5-32b's decode_32k over
    the f8 cache, its analytic bytes and peak at one byte a cache element;
    every record OK, with a finite peak and roofline), qwen2-0.5b's
    train_4k cell (batch 256, the reference's 2 microbatches
    and remat "full", both in its record), xlstm-1.3b's
    (`dryrun_xlstm_train`) and `MESH_DRYRUN_CELLS` (`dryrun_mesh_cells`),
    each in a spawned process beside the rest, and a random autotune of
    `TRAIN_AUTOTUNE_ROUNDS` rounds of `TRAIN_AUTOTUNE_POINTS` points over
    its execution space
    (each point's remat, microbatches and KV tile, its peak and score,
    whether one fits 80 GB), one
    greedy autotune over qwen2-0.5b's decode_32k (every record it wrote
    must be OK, its best score above 0), and the fake count of
    qwen2-0.5b's plain prefill at 2048 x 4 against the same step run on
    the card."""
    import gc
    import multiprocessing
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.core.autotune import (CellEvaluator, ExecPoint,
                                           autotune_search)
    from repro_torch.launch.dryrun import DEFAULT_MICROBATCHES, run_cell
    from repro_torch.launch.steps import (build_model, count_step,
                                          make_prefill_step, trace_step)

    cells = {}
    # the serving cells, the mesh cells and xlstm-1.3b's train cell are
    # host work of their own: three spawned processes count them beside
    # the rest of the phase
    mesh_pool = ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            serving_run = mesh_pool.submit(dryrun_serving_cells,
                                           Path(tmp) / "serving")
            mesh_run = mesh_pool.submit(dryrun_mesh_cells, Path(tmp) / "mesh")
            xlstm_run = mesh_pool.submit(dryrun_xlstm_train,
                                         Path(tmp) / "xlstm")
            # the train cell: qwen2-0.5b's train_4k at its full batch (256),
            # the reference's microbatches (2) and remat ("full")
            t0 = time.perf_counter()
            rec = run_cell(ARCH, "train_4k", Path(tmp), device="cuda")
            check(rec["status"] == "OK",
                  f"dry-run {ARCH} train_4k: {rec.get('error')}")
            roof = rec["roofline"]
            check(roof["flops_per_chip"] > 0 and all(
                math.isfinite(roof[k]) and roof[k] > 0
                for k in ("peak_memory_per_chip", "roofline_s"))
                  and roof["flops_per_chip"] == rec["matmul_flops"]
                  + rec["elementwise_flops"] and rec["transcendentals"] > 0,
                  f"dry-run {ARCH} train_4k: {roof}")
            check(rec["config"]["remat"] == "full"
                  and rec["config"]["microbatches"]
                  == DEFAULT_MICROBATCHES[ARCH],
                  f"dry-run {ARCH} train_4k config {rec['config']}")
            cells[f"{ARCH} train_4k"] = {
                **{k: roof[k] for k in ROOFLINE_KEYS},
                **{k: rec[k] for k in ("matmul_flops", "elementwise_flops",
                                       "transcendentals", "config")},
                "fits_hbm": rec["fits_hbm"], "trace_s": rec["compile_s"],
                "wall_s": time.perf_counter() - t0,
                "analytic_bytes": rec["analytic_bytes"],
                "flops_by_op": rec["flops_by_op"]}
            # a random search over its execution space
            tev = CellEvaluator(ARCH, "train_4k",
                                cache_dir=Path(tmp) / "train",
                                device="cuda")
            tlog = []
            t0 = time.perf_counter()
            tbest, tscore = autotune_search(
                tev, engine="random", shape_mode="train", seed=0,
                max_rounds=TRAIN_AUTOTUNE_ROUNDS, batch=TRAIN_AUTOTUNE_POINTS,
                log=tlog)
            search = next(r for r in tlog if r["event"] == "search")
            points = []
            for pt, score in zip(search["evaluated"], search["scores"]):
                prec = tev.evaluate(ExecPoint(**{
                    k: tuple(tuple(r) for r in v) if k == "extra_rules" else v
                    for k, v in pt.items()}))
                check(prec["status"] == "OK",
                      f"train autotune point {pt}: {prec.get('error')}")
                points.append({"remat": pt["remat"],
                               "microbatches": pt["microbatches"],
                               "attn_kv_block": pt["attn_kv_block"],
                               "score": score, "peak_memory_per_chip":
                                   prec["roofline"]["peak_memory_per_chip"],
                               "roofline_s": prec["roofline"]["roofline_s"]})
            train_autotune = {
                "cell": tev.cell, "engine": "random",
                "rounds": TRAIN_AUTOTUNE_ROUNDS,
                "batch": TRAIN_AUTOTUNE_POINTS,
                "reduced": "points 4 -> 1 (rounds 2 -> 1, points a round "
                           "2 -> 1), for the smoke's time",
                "points": points, "dry_runs": tev.n_compiles,
                "best": json.loads(json.dumps(dataclasses.asdict(tbest))),
                "score": tscore,
                "any_point_fits_80gb": any(p["score"] > 0 for p in points),
                "seconds": time.perf_counter() - t0}
            check(points and tev.n_compiles > 0,
                  f"the train autotune evaluated {points}")
            # the greedy search over a cell whose points fit the card's 80 GB
            log = []
            ev = CellEvaluator(ARCH, "decode_32k", cache_dir=tmp,
                               device="cuda")
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
            cells.update(serving_run.result())
            mesh_cells = mesh_run.result()
            cells[f"{XLSTM_ARCH} train_4k"] = xlstm_run.result()
    finally:
        mesh_pool.shutdown(cancel_futures=True)

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
           "train_autotune": train_autotune, "mesh_cells": mesh_cells,
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


def dryrun_serving_cells(out: Path, device: str = "cuda") -> dict:
    """The dry-run phase's serving cells (`DRYRUN_SERVING_CELLS`), each OK
    with a finite peak and roofline and its three counts, and the f8
    cell's analytic bytes and peak against the same step over a bf16
    cache; their records, by cell."""
    from repro_torch import configs
    from repro_torch.core.roofline import analytic_hbm_bytes
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.steps import build_model

    cells = {}
    for arch, shape in DRYRUN_SERVING_CELLS:
        rec = run_cell(arch, shape, out, device=device)
        check(rec["status"] == "OK",
              f"dry-run {arch} {shape}: {rec.get('error')}")
        roof = rec["roofline"]
        check(roof["flops_per_chip"] > 0 and roof["roofline_s"] > 0
              and all(math.isfinite(roof[k]) for k in
                      ("peak_memory_per_chip", "roofline_s")),
              f"dry-run {arch} {shape} counted nothing, or a "
              f"peak or roofline that is not finite")
        # the record's three counts of the step
        check(roof["flops_per_chip"] ==
              rec["matmul_flops"] + rec["elementwise_flops"],
              f"dry-run {arch} {shape}: {rec['matmul_flops']} + "
              f"{rec['elementwise_flops']} FLOPs counted, "
              f"{roof['flops_per_chip']} in the roofline")
        cells[f"{arch} {shape}"] = {
            **{k: roof[k] for k in ROOFLINE_KEYS},
            **{k: rec[k] for k in ("matmul_flops", "elementwise_flops",
                                   "transcendentals")},
            "elementwise_share": rec["elementwise_flops"]
            / roof["flops_per_chip"],
            "fits_hbm": rec["fits_hbm"], "trace_s": rec["compile_s"],
            "kv_dtype": rec["runtime"]["kv_dtype"],
            "analytic_bytes": rec["analytic_bytes"],
            "flops_by_op": rec["flops_by_op"]}
    # the f8 cell: its analytic traffic takes the cache at one byte an
    # element, as the reference's, and so does its peak: the same step
    # over a bf16 cache holds one byte an element more
    f8 = cells[f"{F8_ARCH} decode_32k"]
    cfg = configs.get_arch(F8_ARCH)
    shape = configs.shape_by_name("decode_32k")
    check(f8["kv_dtype"] == "f8" and f8["analytic_bytes"] ==
          analytic_hbm_bytes(cfg, shape, 1, tp=1, kv_bytes=1),
          f"dry-run {F8_ARCH} decode_32k: kv {f8['kv_dtype']}, "
          f"analytic "
          f"bytes {f8['analytic_bytes']}")
    bf16 = run_cell(F8_ARCH, "decode_32k", out, device=device,
                    overrides={"kv_dtype": "bf16"}, tag="_bf16")
    cache = sum(math.prod(sp.shape) for layer in build_model(
        cfg).cache_specs(shape.global_batch, shape.seq_len)
        for sp in layer.values())
    f8["peak_over_bf16_cache"] = (
        bf16["roofline"]["peak_memory_per_chip"]
        - f8["peak_memory_per_chip"])
    f8["cache_bytes"] = cache
    check(f8["peak_over_bf16_cache"] == cache,
          f"dry-run {F8_ARCH} decode_32k: the f8 peak is "
          f"{f8['peak_over_bf16_cache']} bytes under the bf16 one, "
          f"the "
          f"cache holds {cache} elements")
    return cells


def dryrun_mesh_cells(out: Path) -> dict:
    """`MESH_DRYRUN_CELLS` counted per rank on the reference's meshes
    (`run_cell(multi_pod=...)`: a fake process group of 256 / 512 ranks,
    fake CUDA tensors): each OK with its mesh's chips, each rank's params
    the sum of their leaves' shard shapes, a finite roofline and collective
    bytes; their collectives by kind and trace seconds."""
    from torch.utils import _pytree as pytree

    from repro_torch import configs
    from repro_torch.distributed import shard_shape
    from repro_torch.launch.dryrun import fake_mesh, run_cell
    from repro_torch.launch.steps import build_model, step_placements

    cells = {}
    for arch, shape_name, multi_pod in MESH_DRYRUN_CELLS:
        t0 = time.perf_counter()
        rec = run_cell(arch, shape_name, out, multi_pod=multi_pod,
                       device="cuda")
        wall = time.perf_counter() - t0
        check(rec["status"] == "OK",
              f"dry-run {arch} {shape_name} {multi_pod}: {rec.get('error')}")
        roof = rec["roofline"]
        chips = 512 if multi_pod else 256
        check(rec["chips"] == roof["chips"] == chips,
              f"dry-run {rec['cell']}: {rec['chips']} chips")
        check(all(math.isfinite(roof[k]) and roof[k] > 0 for k in
                  ("peak_memory_per_chip", "roofline_s",
                   "collective_bytes_per_chip")),
              f"dry-run {rec['cell']}: roofline {roof}")
        cfg, shape = configs.get_arch(arch), configs.shape_by_name(shape_name)
        dt = torch.float32 if shape.mode == "train" else torch.bfloat16
        with fake_mesh(multi_pod, "cuda") as mesh:
            lay = step_placements(cfg, shape, mesh).inputs[0]
            want = sum(
                math.prod(shard_shape(lo.shape, mesh, lo.placements))
                * torch.empty((), dtype=s.resolved_dtype(dt)).element_size()
                for lo, s in zip(pytree.tree_leaves(lay), pytree.tree_leaves(
                    build_model(cfg).param_specs())))
        got = rec["arg_bytes_per_chip"]["params"]
        check(got == want, f"dry-run {rec['cell']}: {got} bytes of params "
              f"a rank, its leaves' shard shapes hold {want}")
        if arch == WHISPER_ARCH and shape.mode == "decode":
            # the self-attention's cache, split on its sequence, reshards
            # to the KV heads by an all-to-all, as XLA's step does
            check(rec["collectives"]["by_kind"].get("all-to-all", 0) > 0,
                  f"dry-run {rec['cell']}: no all-to-all in "
                  f"{rec['collectives']['by_kind']}")
        cells[rec["cell"]] = {
            "chips": chips, "params_bytes_per_chip": got,
            "arg_bytes_per_chip": rec["arg_bytes_per_chip"],
            "collectives": rec["collectives"],
            "config": rec["config"], "fits_hbm": rec["fits_hbm"],
            "trace_s": rec["compile_s"], "wall_s": wall,
            **{k: roof[k] for k in (
                "flops_per_chip", "peak_memory_per_chip",
                "collective_bytes_per_chip", "compute_s", "memory_s",
                "collective_s", "roofline_s", "bottleneck")}}
        print(f"[smoke] dry-run {rec['cell']}: collectives "
              f"{rec['collectives']['by_kind']} in "
              f"{rec['collectives']['count']}, trace {rec['compile_s']} s",
              flush=True)
    return cells


def dryrun_xlstm_train(out: Path) -> dict:
    """xlstm-1.3b's train_4k on one card (batch 256, the reference's 4
    microbatches and remat "full"), its scans replayed under grad
    (`launch.steps._Counter.replay_scan`): OK, a finite peak and roofline,
    its three FLOP counts, its config and trace seconds."""
    from repro_torch.launch.dryrun import DEFAULT_MICROBATCHES, run_cell

    t0 = time.perf_counter()
    rec = run_cell(XLSTM_ARCH, "train_4k", out, device="cuda")
    wall = time.perf_counter() - t0
    check(rec["status"] == "OK",
          f"dry-run {XLSTM_ARCH} train_4k: {rec.get('error')}")
    roof = rec["roofline"]
    check(all(math.isfinite(roof[k]) and roof[k] > 0
              for k in ("peak_memory_per_chip", "roofline_s"))
          and roof["flops_per_chip"] == rec["matmul_flops"]
          + rec["elementwise_flops"] and rec["transcendentals"] > 0,
          f"dry-run {XLSTM_ARCH} train_4k: {roof}")
    check(rec["config"]["remat"] == "full"
          and rec["config"]["microbatches"]
          == DEFAULT_MICROBATCHES[XLSTM_ARCH],
          f"dry-run {XLSTM_ARCH} train_4k config {rec['config']}")
    print(f"[smoke] dry-run {rec['cell']}: peak "
          f"{roof['peak_memory_per_chip']} B, trace {rec['compile_s']} s",
          flush=True)
    return {**{k: roof[k] for k in (
                "flops_per_chip", "hbm_bytes_per_chip",
                "peak_memory_per_chip", "compute_s", "memory_s",
                "roofline_s", "bottleneck", "model_flops_total",
                "useful_compute_ratio")},
            **{k: rec[k] for k in ("matmul_flops", "elementwise_flops",
                                   "transcendentals", "config",
                                   "fits_hbm", "flops_by_op")},
            "trace_s": rec["compile_s"], "wall_s": wall}


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


def sass_counts(lib: Path, opcodes) -> dict:
    """Instructions of each of `opcodes` in each kernel of a built library
    (opcode -> kernel -> count), from one `cuobjdump -sass`, where the
    toolkit has it; else {}."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {op: {} for op in opcodes}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = kernel_label(m.group(1))
            for op in opcodes:
                counts[op][name] = 0
        elif name:
            for op in opcodes:
                if re.search(rf"\b{op}\b", ln):
                    counts[op][name] += 1
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
    # the fp32 CUDA-core kernels multiply with FFMA alone: no HMMA (TF32 or
    # bf16 mma.sync) and no HGMMA in their SASS
    sass = {name: sass_counts(build.library_path(name),
                              ("HGMMA", "HMMA", "FFMA"))
            for name in ("flash_attention", "matmul")}
    cuda_core = {kernel: {op: counts[op][kernel] for op in counts}
                 for counts in sass.values() if counts
                 for kernel in counts["FFMA"]
                 if kernel.startswith(("matmul_kernel<",
                                       "flash_attention_kernel<"))}
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc_build_s=build_s,
         ptxas={k: ptxas_report(v) for k, v in logs.items()},
         hgmma={name: s.get("HGMMA", {}) for name, s in sass.items()},
         cuda_core_sass=cuda_core)
    check(all(c["HGMMA"] == c["HMMA"] == 0 < c["FFMA"]
              for c in cuda_core.values()),
          f"a CUDA-core kernel holds tensor-core instructions: {cuda_core}")

    rng = np.random.default_rng(0)
    space = default_space()
    specs = [AppSpec.from_app(n) for n in APP_NAMES]
    kern = phase_kernel(specs, space, rng)
    phase_scorer(specs, space, rng)
    launches = phase_study(APP_NAMES)
    zoo = phase_study_zoo()
    pareto_launches = phase_study_pareto()
    parallel = phase_study_parallel()
    example_launches = phase_examples()
    phase_throughput([s for s in specs if s.name in ("inception", "nasnet")],
                     space, rng)
    flash = phase_flash(torch.Generator(device="cuda").manual_seed(0))
    rglru = phase_rglru(torch.Generator(device="cuda").manual_seed(1))
    # the kernels' launches on each model path, counted from 0 just before
    # it and read just after
    paths = {ARCH: phase_prefill(ARCH)}
    phase_serve()
    paths[RG_ARCH] = phase_prefill(RG_ARCH)
    served = phase_serve_forward(RG_ARCH)
    # recurrentgemma-9b's served decode is held to the forward through the
    # kernels too: one layer in three attends through the bf16 cache
    check(served["tol_ratio"] <= 1.0,
          f"{RG_ARCH}'s served decode differs from the forward through the "
          f"kernels by {served['max_abs_diff_vs_forward']}")
    fp32_fwd = {RG_ARCH: served["forward_launches"]}
    paths[MOE_ARCH] = phase_prefill(MOE_ARCH)
    fp32_fwd[MOE_ARCH] = phase_serve_forward(MOE_ARCH)["forward_launches"]
    paths[MLA_ARCH] = phase_prefill(MLA_ARCH)
    fp32_fwd[MLA_ARCH] = phase_serve_forward(
        MLA_ARCH, torch.bfloat16)["forward_launches"]
    phase_xlstm_blocks(torch.Generator(device="cuda").manual_seed(4))
    paths[XLSTM_ARCH] = phase_prefill_xlstm()
    served = phase_serve_forward(XLSTM_ARCH)
    # its caches are all fp32 state: the served decode is gated directly
    check(served["tol_ratio"] <= 1.0,
          f"{XLSTM_ARCH}'s served decode differs from its forward by "
          f"{served['max_abs_diff_vs_forward']}")
    fp32_fwd[XLSTM_ARCH] = served["forward_launches"]
    paths[WHISPER_ARCH] = phase_prefill_whisper()
    fp32_fwd[WHISPER_ARCH] = phase_serve_whisper()["forward_launches"]
    check(not any(paths[WHISPER_ARCH].values())
          and not any(fp32_fwd[WHISPER_ARCH].values()),
          f"the {WHISPER_ARCH} paths launched {paths[WHISPER_ARCH]} / "
          f"{fp32_fwd[WHISPER_ARCH]}: its attention is blocked_attention")
    # the training path, counted from 0 over the whole phase: no kernel
    trained = phase_train()
    # the sharding layer: a one-rank NCCL mesh, counted from 0
    meshed = phase_mesh(smi)
    check_isolated()
    for name in ("flash_attention", "flash_attention_tensor_core",
                 "rglru_gated_scan"):
        check(paths[RG_ARCH][name] > 0,
              f"the {RG_ARCH} prefill never launched {name}")
    for arch in (ARCH, MOE_ARCH):
        check(paths[arch]["flash_attention_tensor_core"] > 0,
              f"the {arch} prefill never launched the tensor-core flash "
              f"kernel")
    check(paths[MOE_ARCH]["flash_attention_cuda_core"] > 0,
          f"the {MOE_ARCH} fp32 gate never launched the CUDA-core flash "
          f"kernel")
    check(paths[MLA_ARCH]["flash_attention"] == 0
          and fp32_fwd[MLA_ARCH]["flash_attention"] == 0,
          f"the {MLA_ARCH} paths launched flash_attention: MLA's attention "
          f"is blocked_attention")
    cuda_core = {**{f"serve {a}, fp32 teacher-forced forward":
                    f["flash_attention_cuda_core"]
                    for a, f in fp32_fwd.items()},
                 **{f"prefill {a}": p["flash_attention_cuda_core"]
                    for a, p in paths.items()}}
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
            "study zoo, twenty traced apps": zoo["study"],
            "study zoo, genetic on qwen2-0.5b:prefill": zoo["genetic"],
            "study zoo, anneal on qwen2-0.5b:prefill": zoo["anneal"],
            "study pareto, genetic and nsga2 on ptb + wdl":
                pareto_launches["studies"],
            "study pareto, table pass": pareto_launches["table pass"],
            "examples": example_launches},
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
                        for p in paths.values())
        + meshed["flash_attention_tensor_core"],
        "launches_by_path": {
            **{f"prefill {a}": p["flash_attention_tensor_core"]
               for a, p in paths.items()},
            f"train {ARCH}": trained["flash_attention_tensor_core"],
            f"mesh {ARCH}, placed prefill":
                meshed["flash_attention_tensor_core"]},
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
        "launches": sum(cuda_core.values()),
        "launches_by_path": {**cuda_core, f"train {ARCH}":
                             trained["flash_attention_cuda_core"],
                             f"mesh {ARCH}, placed prefill":
                             meshed["flash_attention_cuda_core"]},
        "max_abs_err": flash["max_abs_err"]["float32"],
        "ms": f32["kernel_ms"], "kernel_ms": f32["kernel_ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "tflops": f32["tflops"], "bound_share": f32["bound_share"],
        **{f"at_{key}": {k: flash["timings"][key][k]
                         for k in ("B", "S", "H", "KV", "hd") + flash_keys}
           for key in ("fp32_hd128", "fp32_hd256")}}, {
        "name": "rglru_gated_scan", "route": "cuda", "source": RGLRU_SOURCE,
        "replaces": RGLRU_TPU,
        "tpu": "src/repro/kernels/rg_lru.py:_scan_kernel",
        "symbol": "rglru_gated_kernel",
        "shape": {k: rg[k] for k in ("B", "S", "W", "heads", "dtypes")},
        "launches": paths[RG_ARCH]["rglru_gated_scan"],
        "launches_by_path": {
            f"prefill {RG_ARCH}": paths[RG_ARCH]["rglru_gated_scan"],
            f"serve {RG_ARCH}, fp32 teacher-forced forward":
                fp32_fwd[RG_ARCH]["rglru_gated_scan"],
            "rglru block, fused route": rglru["block_launches"]["fused"][
                "rglru_gated_scan"],
            f"train {ARCH}": trained["rglru_gated_scan"],
            f"mesh {ARCH}, placed prefill": meshed["rglru_gated_scan"]},
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
                fp32_fwd[RG_ARCH]["rglru_scan"],
            f"train {ARCH}": trained["rglru_scan"],
            f"mesh {ARCH}, placed prefill": meshed["rglru_scan"]},
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
               for a, p in paths.items()},
            f"train {ARCH}": trained["matmul_tensor_core"],
            f"mesh {ARCH}, placed prefill": meshed["matmul_tensor_core"]},
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
               for a, p in paths.items()},
            f"train {ARCH}": trained["matmul_cuda_core"],
            f"mesh {ARCH}, placed prefill": meshed["matmul_cuda_core"]},
        "max_abs_err": f32mm["max_abs_err"],
        "ms": f32mm["kernel_ms"], "kernel_ms": f32mm["kernel_ms"],
        "plain_ms": f32mm["plain_ms"], "bound_ms": f32mm["bound_ms"],
        "bound_by": "operations", "library_ms": f32mm["library_ms"],
        "library": "torch.matmul (fp32, TF32 off)",
        "bound_share": f32mm["bound_share"],
        **{k: f32mm[k] for k in ("predicted_ms", "fastest", "regret",
                                 "rank_correlation", "tol_ratio")},
        "tiles_ms": {str(tuple(r["tile"])): r["measured_ms"]
                     for r in f32mm["tiles"]}}]}), flush=True)
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
