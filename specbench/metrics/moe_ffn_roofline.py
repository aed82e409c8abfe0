"""``moe_ffn``'s share of its roofline over the traced steps: the least
time its calls could take (each call's larger of operations over the
bf16 peak and bytes over the bandwidth) over its kernels' device time.
Calls: one a MoE layer in each verify (batch x (n_cand + 1) tokens) and
in each admitted prompt's prefill."""
from specbench.work import model, moe_ffn


def read(ctx):
    if ctx.trace is None:
        return None
    secs, _ = ctx.groups.get("moe_ffn kernels", (0.0, 0))
    if secs <= 0:
        return None
    t = ctx.target
    layers = sum(model._is_moe(t, l) for l in range(t["n_layers"]))
    k, e, d, f = t["top_k"], t["n_experts"], t["d_model"], t["d_ff"]

    def bound(n):
        fl, by = moe_ffn.call(n, k, d, f, moe_ffn.experts_touched(n, k, e))
        return max(fl / ctx.peaks["flops"], by / ctx.peaks["bytes"])
    n_verify = ctx.engine["max_batch"] * (ctx.engine["n_cand"] + 1)
    total = ctx.trace_rounds * layers * bound(n_verify)
    total += sum(layers * bound(n) for n in ctx.trace_prompts)
    return 100.0 * total / secs
