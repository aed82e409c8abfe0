"""The whole step's share of the chip's bf16 peak: the operations the
traced steps needed (rounds and prefills, specbench/work) over the
traced wall time."""


def read(ctx):
    if ctx.trace is None or ctx.trace_s <= 0 or not ctx.trace_rounds:
        return None
    return 100.0 * ctx.trace_work[0] / (ctx.trace_s * ctx.peaks["flops"])
