"""PyTorch/CUDA port of the software-defined accelerator design-space
explorer (`repro`).

The DSE loop — paper app graph (`core.apps`) -> op stream + peak floors
(`core.multiapp.AppSpec`) -> memoizing `core.search.Evaluator` -> fused
(GOPS, area) scorer (`kernels.costmodel.FusedTorchScorer`) -> ask/tell
engine -> `dse.Study` selection — runs on a GPU through
`repro_torch.dse.Study` and ``python -m repro_torch.dse``.  Host-side
bookkeeping (row cache, table coding, engines, space repair) is numpy; the
scoring pass is torch on an explicit device, with the validity screen's
table gathers in a hand-written CUDA kernel (`kernels.gather`).

The package imports neither jax nor the JAX package `repro`; it keeps its
own copy of every piece it needs.
"""
