"""Prefill's share of the bf16 peak: target and draft operations of each
admitted prompt over the engine's fenced ``zigzag_prefill`` spans."""
from specbench.work import model


def read(ctx):
    if not ctx.prefill_spans:
        return None
    flops = sum(model.prefill(ctx.target, n)[0] + model.prefill(ctx.draft,
                                                                 n)[0]
                for _, n in ctx.prefill_spans)
    secs = sum(s for s, _ in ctx.prefill_spans)
    return 100.0 * flops / (secs * ctx.peaks["flops"]) if secs > 0 else None
