#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/kernels/csrc`, then
runs these phases in order, printing one JSON line each:

  1. device      the card, its power limit, the nvcc build time;
  2. kernel      `gather_rows` against its plain PyTorch version on the
                 card (the five screen tables of all seven paper apps and a
                 random float64 table; pools of 4097, 65536 and 262144;
                 out-of-range indices), bit-equal, with CUDA-event times of
                 the kernel, the plain version and `torch.index_select`;
  3. scorer      `FusedTorchScorer` on the card against the same scorer on
                 the CPU, all seven apps, 65536-config pools;
  4. study       the main path: a seven-app `GeomeanAcrossApps` greedy
                 `Study` on the card and on the CPU must select the same
                 config, with the kernel launched and jax never imported;
  5. throughput  the random engine at 262144-config pools on inception and
                 nasnet, on the card, with where the time goes: the scorer's
                 device time by kind (`torch.profiler`) and the search's
                 host time by function (`cProfile`, one round).

Then the card's name and power limit as `nvidia-smi` gives them, a
`{"kernels": [...]}` line, and last `{"ok": true, "device": {...}}`.  Any
failure exits non-zero before the last line.  Without a GPU, or without
the repository's `src/` beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM data sheet: 3.35 TB/s of HBM3
HBM_BYTES_PER_S = 3.35e12
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/gather_rows.cu"
TPU_KERNEL = "src/repro/kernels/costmodel.py:57"
POOLS = (4097, 65536, 262144)
TIMED_POOLS = (65536, 262144)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


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
        runs[dev] = {
            "result": result, "seconds": time.perf_counter() - t0,
            "launches": gather_rows.launches,
            "scorer_calls": sum(ev.scorer.n_calls
                                for ev in study._evaluators)}
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(gpu["result"].best == cpu["result"].best,
          "the cuda and cpu studies selected different configs")
    check(gpu["result"].per_app == cpu["result"].per_app,
          "the cuda and cpu studies found different per-app bests")
    check(gpu["launches"] > 0, "the cuda study never launched gather_rows")
    check(cpu["launches"] == 0, "gather_rows launched on the cpu study")
    check(gpu["scorer_calls"] > 0, "the cuda study never called the scorer")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "repro"))
    check(not leaked, f"the port imported {leaked[:5]}")
    emit("study", apps=list(names), selected=gpu["result"].best.asdict(),
         same_selection=True, best_score=gpu["result"].best_score,
         cuda_s=gpu["seconds"], cpu_s=cpu["seconds"],
         gather_rows_launches=gpu["launches"],
         scorer_calls=gpu["scorer_calls"])
    return gpu["launches"]


def device_breakdown(calls: dict) -> dict:
    """Device time of one call of each function in `calls`, in us, from one
    `torch.profiler` session: `gather_rows`'s, the other kernels', and the
    host<->device copies'.  Device work belongs to the call whose host
    range holds it (each call ends in a synchronise)."""
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
    out = {name: {"gather_rows_us": 0.0, "other_kernels_us": 0.0,
                  "copies_us": 0.0} for name in calls}
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
        elif "gather_rows_kernel" in e.name:
            key = "gather_rows_us"
        else:
            key = "other_kernels_us"
        out[owner[0]][key] += e.time_range.elapsed_us()
    for us in out.values():
        us["busy_us"] = sum(us.values())
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
    for name, device in device_breakdown(calls).items():
        rec = per_app[name]
        device["idle_share"] = 1.0 - device["busy_us"] / (rec["scorer_s"]
                                                          * 1e6)
        rec["scorer_device"] = device
    emit("throughput", apps=per_app)


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
         ptxas={k: v.strip().splitlines()[-3:] for k, v in logs.items()})

    rng = np.random.default_rng(0)
    space = default_space()
    specs = [AppSpec.from_app(n) for n in APP_NAMES]
    kern = phase_kernel(specs, space, rng)
    phase_scorer(specs, space, rng)
    launches = phase_study(APP_NAMES)
    phase_throughput([s for s in specs if s.name in ("inception", "nasnet")],
                     space, rng)

    t = kern["timings"][str(TIMED_POOLS[-1])]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "gather_rows", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "tpu": "src/repro/kernels/costmodel.py:gather_rows",
        "shape": {"C": t["C"], "U": t["U"], "O": t["O"], "dtype": "int64"},
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "bit_equal": True, "ms": t["int64_kernel_ms"],
        "kernel_ms": t["int64_kernel_ms"], "plain_ms": t["int64_plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": "bytes",
        "library_ms": t["int64_library_ms"]}]}), flush=True)
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
