"""Arrival traces for serving runs.

Counterpart of ``repro/serving/trace.py`` (closed loop): the scheduler
replays requests on a virtual clock, so a trace is a deterministic list
of (arrival time, prompt, max_new_tokens) requests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.engine import ServeRequest


def poisson_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Arrival times (s) of a Poisson process: i.i.d. Exp(rate) gaps."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / max(rate_rps, 1e-9), n))


def poisson_requests(prompts: list, max_new: list | int,
                     rate_rps: float, seed: int = 0) -> list:
    """Wrap prompts into :class:`ServeRequest`s with Poisson arrivals;
    ``max_new`` is a scalar or a per-request list."""
    arr = poisson_arrivals(rate_rps, len(prompts), seed)
    if np.isscalar(max_new):
        max_new = [int(max_new)] * len(prompts)
    return [ServeRequest(i, np.asarray(p, np.int32), int(g),
                         arrival_s=float(t))
            for i, (p, g, t) in enumerate(zip(prompts, max_new, arr))]
