"""Device ms of the draft cache's rollback, between its graph's marks
(``obs_mark_rollback_begin`` to ``obs_mark_rollback_end``), mean over the
traced slice's rounds."""
from specbench.metrics._marks import mean_between_ms


def read(ctx):
    return mean_between_ms(ctx.trace, "rollback_begin", "rollback_end")
