"""``flash_attention``'s share of its roofline over the traced steps:
the prefills of target and draft of each prompt admitted there."""
from specbench.work import model


def read(ctx):
    if ctx.trace is None or not ctx.trace_prompts:
        return None
    secs, _ = ctx.groups.get("flash_attention kernel", (0.0, 0))
    if secs <= 0:
        return None
    total = 0.0
    for n in ctx.trace_prompts:
        for cfg in (ctx.target, ctx.draft):
            fl, by = model.flash_prefill(cfg, n)
            n_calls = len(model.attention_layers(cfg))
            # each call bounded alone: the layers are alike
            if n_calls:
                total += n_calls * max(fl / n_calls / ctx.peaks["flops"],
                                       by / n_calls / ctx.peaks["bytes"])
    return 100.0 * total / secs
