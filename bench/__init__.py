"""Benchmark of the PyTorch and CUDA port (`repro_torch`) on one NVIDIA H100.

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` runs one cell of `BENCHMARK.json` and prints one JSON line.  The
harness is driven by data: a cell's configuration, traffic mix, plain
reference, per-layer metric readers and correctness limits are files
under `bench/`, found by the names in `BENCHMARK.json` (`bench.spec`).

Nothing here imports `jax` or the JAX package `repro`, and the plain
references under `bench/reference/` import nothing of `repro_torch`.
"""
