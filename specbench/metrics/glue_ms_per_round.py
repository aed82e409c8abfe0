"""Device ms a traced round spends outside the program's kernels and
cuBLAS (the "everything else" group)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_rounds:
        return None
    s, _ = ctx.groups.get("everything else", (0.0, 0))
    return 1e3 * s / ctx.trace_rounds
