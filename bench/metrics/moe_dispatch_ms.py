"""`moe_dispatch_ms` (ms): device time a forward of the MoE block's
routing and dispatch kernels (`models/layers.py` `moe_route`,
`_moe_dispatch`, `_moe_combine`), by kernel name over the traced stretch.
Moves `prefill_tok_s`.  Nothing to read where no such kernel ran.

`KERNELS` is a frozen copy of `chip_smoke.MOE_DISPATCH_KERNELS`: top-k,
sorts, the one-hot's scan, the index scatter and the gathers.  Matched by
name, it is approximate: an indexing kernel outside the MoE block (the
embedding's gather, the last position's slice) counts too."""

KERNELS = ("gatherTopK", "sort", "Sort", "scan", "index_put", "indexing",
           "scatter_gather", "gather_kernel")


def read(ctx):
    s = ctx.stretch
    if s is None:
        return None
    total = sum(t for name, t in s.device_ops.items()
                if any(k in name for k in KERNELS))
    if total <= 0:
        return None
    return 1e3 * total / s.forwards
