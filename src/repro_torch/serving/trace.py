"""Arrival traces for serving runs (the port of ``repro/serving/trace.py``).

The continuous-batching scheduler replays requests on a virtual clock
(:class:`repro_torch.serving.engine.ServeRequest.arrival_s`), so a closed-loop
trace is just a deterministic list of (arrival time, prompt,
max_new_tokens) tuples — no threads or sleeps involved.

For the asyncio front door (:mod:`repro_torch.serving.server`) the same trace
becomes an **open-loop load generator**: :func:`replay_open_loop`
submits each request when its arrival time comes due on the real clock
and consumes every stream concurrently, token by token.
"""
from __future__ import annotations

import asyncio

import numpy as np

from repro_torch.serving.engine import ServeRequest


def poisson_arrivals(rate_rps: float, n: int, seed: int = 0) -> np.ndarray:
    """Arrival times (s) of a Poisson process: i.i.d. Exp(rate) gaps."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / max(rate_rps, 1e-9), n))


def poisson_requests(prompts: list, max_new: list | int,
                     rate_rps: float, seed: int = 0) -> list:
    """Wrap prompts into :class:`ServeRequest`s with Poisson arrivals.

    ``max_new`` may be a scalar or a per-request list (heterogeneous
    generation lengths exercise EOS-aware early retirement).
    """
    arr = poisson_arrivals(rate_rps, len(prompts), seed)
    if np.isscalar(max_new):
        max_new = [int(max_new)] * len(prompts)
    return [ServeRequest(i, np.asarray(p, np.int32), int(g),
                         arrival_s=float(t))
            for i, (p, g, t) in enumerate(zip(prompts, max_new, arr))]


def tenant_poisson_requests(prompts: list, max_new: list | int,
                            rate_rps: float, tenants: dict,
                            seed: int = 0) -> list:
    """Multi-tenant Poisson trace: one merged arrival process whose
    requests are assigned to tenants i.i.d. by traffic share.

    ``tenants`` maps tenant name -> ``{"share": float, "priority": int}``
    (both optional; share defaults to equal, priority to 1).  The same
    ``seed`` always yields the same (arrival, tenant, priority) labeling,
    so closed-loop and open-loop legs can serve the identical trace.
    """
    reqs = poisson_requests(prompts, max_new, rate_rps, seed)
    names = sorted(tenants)
    shares = np.asarray([float(tenants[t].get("share", 1.0))
                         for t in names], np.float64)
    shares /= shares.sum()
    rng = np.random.default_rng(seed + 1)
    picks = rng.choice(len(names), size=len(reqs), p=shares)
    for r, k in zip(reqs, picks):
        r.tenant = names[int(k)]
        r.priority = int(tenants[r.tenant].get("priority", 1))
    return reqs


async def replay_open_loop(server, reqs: list, speed: float = 1.0
                           ) -> tuple[dict, list]:
    """Open-loop replay of a pre-stamped trace against an
    :class:`repro_torch.serving.server.AsyncServingServer`.

    Each request is submitted when its ``arrival_s / speed`` comes due
    on the server's real clock (open loop: submission never waits for
    earlier requests to finish — only admission backpressure can slow
    it), and a consumer task drains its stream concurrently.  Returns
    ``(tokens, handles)``: ``tokens`` maps rid -> streamed token list
    (None for rejected submissions), ``handles`` is the live
    :class:`ServeRequest` list with scheduler-stamped metrics.
    """
    from repro_torch.serving.server import RequestRejected

    tokens: dict = {}
    handles: list = []
    consumers = []

    async def _consume(handle):
        tokens[handle.rid] = await server.collect(handle)

    t0 = server.engine.now()
    for r in sorted(reqs, key=lambda r: r.arrival_s):
        delay = r.arrival_s / speed - (server.engine.now() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        try:
            h = await server.submit(r.prompt, r.max_new_tokens,
                                    tenant=r.tenant, priority=r.priority,
                                    rid=r.rid)
        except RequestRejected:
            tokens[r.rid] = None
            continue
        handles.append(h)
        consumers.append(asyncio.create_task(_consume(h)))
    await asyncio.gather(*consumers)
    return tokens, handles
