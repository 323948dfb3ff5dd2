"""Per-layer metric readers, one file a metric of `BENCHMARK.json`,
found by its name (`bench.spec`)."""
