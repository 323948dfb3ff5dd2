"""Device code of the PyTorch port.

  * `gather`      — `gather_rows`, the validity screen's table gather: a
                    hand-written CUDA kernel (`csrc/gather_rows.cu`) for
                    Hopper, with its plain PyTorch version beside it.
  * `costmodel`   — `FusedTorchScorer`, the fused (GOPS, area) scorer that
                    runs on a torch device and calls `gather_rows`.
  * `flash_attention` — causal or full GQA attention (`csrc/
                    flash_attention.cu`: a tensor-core kernel for bf16 at
                    head dims 64-256, a CUDA-core one for the rest), with
                    its plain version.
  * `rg_lru`      — `rglru_scan`, the RG-LRU recurrence over the sequence
                    (`csrc/rglru_scan.cu`), with its plain version.
  * `matmul`      — the tiled matrix product whose tiles the tile DSE
                    (`core.kernel_tune`) picks (`csrc/matmul.cu`: a
                    tensor-core kernel for bf16, a CUDA-core one for fp32),
                    with its plain version.
  * `build`       — nvcc build and ctypes loading of the CUDA sources
                    (`csrc/hopper.cuh` holds the Hopper helpers the two
                    tensor-core sources share).

Nothing is compiled or loaded when these modules are imported.
"""
