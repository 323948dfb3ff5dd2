"""`prefill_mfu` (%): the prefill step's useful FLOPs (`bench.flops`,
from the published configuration) over the time of the window's
forwards, send to ready, against the card's bf16 peak (`bench.peaks`).
Moves `prefill_tok_s`.  Nothing to read on a card the table lacks."""

from bench import flops, peaks


def read(ctx):
    peak = peaks.peaks_for(ctx.device_kind)
    if peak is None or not ctx.times:
        return None
    tr = ctx.traffic
    work = flops.prefill_flops(ctx.config, tr["batch"], tr["seq"])["total"]
    return 100.0 * work * len(ctx.times) / sum(ctx.times) \
        / peak["bf16_flops"]
