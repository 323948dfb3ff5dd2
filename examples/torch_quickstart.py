"""Quickstart on the PyTorch port: the paper's DSE framework in about a
minute.

1. Build a DNN computation graph (ResNet-50), analyze it (§4.2).
2. Run the multi-step greedy DSE (§4.3) for an accelerator config, its
   cost model on `--device` (the GPU by default).
3. Re-target the SAME optimizer at the H100's matmul tile space — the
   "software-defined" part.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The `gather_rows` kernel's launches go to stderr.
"""

import argparse
import sys

from repro_torch.core import apps
from repro_torch.core.kernel_tune import H100_TC_TILES, tune_matmul_tiles
from repro_torch.core.multiapp import AppSpec
from repro_torch.core.search import multi_step_greedy
from repro_torch.core.space import default_space
from repro_torch.kernels.gather import gather_rows

ap = argparse.ArgumentParser(description=__doc__)
ap.add_argument("--device", default="cuda",
                help="torch device of the cost model (cuda or cpu)")
args = ap.parse_args()

# -- 1. application analysis ------------------------------------------------
graph = apps.resnet_v1_50()
summary = graph.summary()
print(f"ResNet-50: {summary['n_ops']} compute ops, "
      f"{summary['total_macs']/1e9:.2f} GMACs, "
      f"peak activations {summary['peak_input_memory_bytes']/1e6:.2f} MB, "
      f"peak weights {summary['peak_weight_memory_bytes']/1e6:.2f} MB")

# -- 2. accelerator design space exploration (Algorithm 1) -------------------
spec = AppSpec.from_graph("resnet", graph)
space = default_space()
res = multi_step_greedy(spec.stream, space, k=3, seed=0, max_rounds=20,
                        peak_input_bits=spec.peak_input_bits, patience=3,
                        device=args.device)
print(f"\nDSE: {len(res.evaluated)} configs evaluated, "
      f"best = {res.best_perf:.0f} GOPS under area "
      f"{res.best.area(space.hw):.0f} / {space.area_budget:.0f}")
print("best config:", {k: v for k, v in res.best.asdict().items()
                       if k in ("pe_group", "mac_per_group", "tif", "tix",
                                "tiy", "tof", "loop_order")})

# -- 3. the same optimization idea on the H100's matmul tile space -----------
best, cost, _ = tune_matmul_tiles(8192, 8192, 8192, chip=H100_TC_TILES)
print(f"\nH100 matmul tile DSE (8k^3 bf16): best tile "
      f"(bm,bk,bn)=({best.bm},{best.bk},{best.bn}) "
      f"-> {cost['latency_s']*1e3:.2f} ms predicted by the tile model for "
      f"an H100, not measured "
      f"({'compute' if cost['compute_s']>=cost['memory_s'] else 'memory'}"
      f"-bound, shared memory {cost['smem_bytes']/2**10:.0f} KiB)")
print(f"gather_rows launches: {gather_rows.launches}", file=sys.stderr)
