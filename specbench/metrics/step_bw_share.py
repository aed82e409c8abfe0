"""The whole step's share of the chip's memory bandwidth: the bytes the
traced steps needed (weights once a call, caches once) over the traced
wall time."""


def read(ctx):
    if ctx.trace is None or ctx.trace_s <= 0 or not ctx.trace_rounds:
        return None
    return 100.0 * ctx.trace_work[1] / (ctx.trace_s * ctx.peaks["bytes"])
