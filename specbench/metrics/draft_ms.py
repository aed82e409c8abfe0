"""Device ms of the fused round's draft: from the verify / draft
boundary (``obs_mark_draft_begin``) to the round's last mark
(``obs_mark_round_end``): the draft's passes and the round's buffer
copies, mean over the traced slice's rounds."""
from specbench.metrics._marks import mean_between_ms


def read(ctx):
    return mean_between_ms(ctx.trace, "draft_begin", "round_end")
