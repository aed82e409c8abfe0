"""Median time to first token of the requests due in the window (the
harness's stamps, from each request's due time)."""
import numpy as np


def read(ctx):
    return float(np.median(ctx.ttft_s)) * 1e3 if ctx.ttft_s else None
