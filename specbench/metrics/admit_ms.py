"""Mean of the engine's fenced ``admit`` spans in the window (B=1
prefill of target and draft plus the splice into the slot)."""


def read(ctx):
    return 1e3 * sum(ctx.admit_s) / len(ctx.admit_s) if ctx.admit_s else None
