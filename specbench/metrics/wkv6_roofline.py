"""``wkv6``'s share of its roofline over the traced steps (as
``moe_ffn_roofline``): one call a layer in each verify (batch, n_cand + 1
steps, every state kept) and in each admitted prompt's prefill."""
from specbench.work import wkv6


def read(ctx):
    if ctx.trace is None:
        return None
    secs, _ = ctx.groups.get("wkv6 kernels", (0.0, 0))
    if secs <= 0:
        return None
    t = ctx.target
    hs = t["rwkv_head_size"]
    h = t["d_model"] // hs
    layers = sum(1 for l in range(t["n_layers"])
                 if t["layer_pattern"][l % len(t["layer_pattern"])] == "rwkv")

    def bound(b, s, stack):
        fl, by = wkv6.call(b, h, s, hs, stack)
        return max(fl / ctx.peaks["flops"], by / ctx.peaks["bytes"])
    total = ctx.trace_rounds * layers * bound(
        ctx.engine["max_batch"], ctx.engine["n_cand"] + 1, True)
    total += sum(layers * bound(1, n, False) for n in ctx.trace_prompts)
    return 100.0 * total / secs
