"""`device_idle_pct` (%): the share of the traced stretch in which no
operation ran on the device, 1 - busy / stretch (`bench.trace`).  Moves
`prefill_tok_s`.  Nothing to read without a device trace."""


def read(ctx):
    s = ctx.stretch
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
