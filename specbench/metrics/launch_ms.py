"""Host ms a traced round spends launching the round's CUDA graphs: the
program's ``launch/*`` spans (``record_function`` ranges around each
graph replay: ``launch/fused``, ``launch/rollback``, ``launch/draft``)
in the traced slice, over its rounds."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_rounds:
        return None
    spans = [t1 - t0 for cat, name, t0, t1 in ctx.trace["host"]
             if cat == "user_annotation" and name.startswith("launch/")]
    return sum(spans) / 1e3 / ctx.trace_rounds if spans else None
