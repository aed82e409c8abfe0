"""Device ms of the fused round's verify: from the round's first mark
(``obs_mark_round_begin``) to its verify / draft boundary
(``obs_mark_draft_begin``, after the target's commit), mean over the
traced slice's rounds."""
from specbench.metrics._marks import mean_between_ms


def read(ctx):
    return mean_between_ms(ctx.trace, "round_begin", "draft_begin")
