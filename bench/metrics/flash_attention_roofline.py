"""`flash_attention_roofline` (%): the port's flash attention kernels
(`kernels/flash_attention.py` -> `csrc/flash_attention.cu`) against their
roofline: the least time the card needs for the causal score and value
products of every layer (`bench.flops.attention_core`; the larger of
FLOPs at the bf16 peak and the bytes of q, k, v and the output at the
memory bandwidth) over the kernels' device time a forward in the traced
stretch.  Moves `prefill_tok_s`.  Nothing to read where no flash kernel
ran (latent attention runs none)."""

from bench import flops, peaks

KERNEL = "flash_attention_kernel"


def read(ctx):
    s, peak = ctx.stretch, peaks.peaks_for(ctx.device_kind)
    if s is None or peak is None:
        return None
    t = sum(v for name, v in s.device_ops.items() if KERNEL in name)
    if t <= 0:
        return None
    tr = ctx.traffic
    work = flops.attention_core(ctx.config, tr["batch"], tr["seq"])
    bound = max(work["flops"] / peak["bf16_flops"],
                work["bytes"] / peak["hbm_bytes_per_s"])
    return 100.0 * bound / (t / s.forwards)
