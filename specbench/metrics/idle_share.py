"""Share of the traced window in which no operation ran on the device
(one minus the union of the device intervals over the window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.trace_s)
