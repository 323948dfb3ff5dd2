"""PyTorch/CUDA port of the software-defined accelerator design-space
explorer (`repro`).

The DSE loop — app graph (`core.apps`: the paper's seven, or a model-zoo
decoder traced on meta tensors by `frontend`) -> op stream + peak floors
(`core.multiapp.AppSpec`) -> memoizing `core.search.Evaluator` -> fused
(GOPS, area) scorer (`kernels.costmodel.FusedTorchScorer`) -> ask/tell
engine -> `dse.Study` selection — runs on a GPU through
`repro_torch.dse.Study` and ``python -m repro_torch.dse``.  Host-side
bookkeeping (row cache, table coding, engines, space repair) is numpy; the
scoring pass is torch on an explicit device, with the validity screen's
table gathers in a hand-written CUDA kernel (`kernels.gather`).

The package also serves and trains every arch of the model zoo
(`models`, `launch.serve`, `launch.train` with `optim`, `data` and
`checkpoint`) and runs the execution-space DSE: the Hopper tile model
(`core.kernel_tune`) picks the tiles of the hand-written matmul kernels
(`kernels.matmul`), and a dry-run of a training or serving step on fake
tensors (`launch.dryrun`) feeds the roofline (`core.roofline`) that the
execution-point search (`core.autotune`) scores.

The package imports neither jax nor the JAX package `repro`; it keeps its
own copy of every piece it needs.
"""
