"""Always-on asyncio front door over the continuous-batching scheduler
(the port of ``repro/serving/server.py``).

The closed-loop :meth:`repro_torch.serving.engine.ServingEngine.run` replays a
pre-built trace on a virtual clock; this module turns the same stepwise
core into a **live ingest path** — the prerequisite for any sustained-
load claim.  One background task drives ``engine.run_step()`` (in a
worker thread, so the event loop keeps accepting work mid-round) and
fans verified tokens out to per-request streams the moment
``_process_emissions`` retires them:

    eng = ServingEngine(tcfg, dcfg,
                        config=SchedulerConfig(max_batch=4, clock="real",
                                               qos=True, preempt=True))
    eng.init_from_seed(0)
    async with AsyncServingServer(eng, max_queue=32) as srv:
        req = await srv.submit(prompt, max_new_tokens=64,
                               tenant="acme", priority=0)
        async for tok in srv.stream(req):
            ...                        # token-by-token, as verified
    # __aexit__ == drain(): stop admitting, serve out, stop the loop

Semantics:

* **Backpressure** — ``submit()`` awaits while the bounded admission
  queue (``max_queue``) is full; space frees as the engine admits.  A
  ``submit_timeout_s`` turns starvation into :class:`RequestRejected`
  (counted under ``serve_requests_rejected_total``), and a request that
  could *never* fit the engine's KV capacity is rejected immediately —
  the engine-level graceful-rejection path, reused.
* **QoS** — tenancy/priority ride on the engine's admission layer
  (``SchedulerConfig.qos`` / ``tenant_weights`` / ``preempt``): priority
  classes preempt long-tail decodes (progress saved, stream resumes
  losslessly) and weighted fair ordering keeps one tenant from starving
  the rest.  Per-tenant TTFT histograms and queue-depth gauges land in
  the engine's metrics registry.
* **Draining** — :meth:`drain` stops admission (new submits are
  rejected), serves every queued/in-flight request to completion,
  flushes all streams, and stops the background task.

Thread discipline: the engine is only ever touched from one logical
context at a time.  Its rounds run on the worker thread, whose current
CUDA stream is the device's default stream: nothing on the serving path
relies on a ``torch.cuda.stream(...)`` context or a ``set_device`` made
on another thread, and the first kernel build may happen on the worker
(``kernels/_build.py`` loads each library once, under a lock).  ``submit()`` never calls into the engine directly —
requests park on an ingress deque the serve loop transfers at round
boundaries, and emissions buffered by the engine hooks (fired inside the
worker thread) are flushed to ``asyncio.Queue`` streams from the event
loop after each step returns.
"""
from __future__ import annotations

import asyncio
import itertools
import time
from collections import deque

import numpy as np

from repro_torch.serving.engine import (ServeRequest, ServingEngine,
                                        latency_percentiles)


class RequestRejected(RuntimeError):
    """A submission was refused: never fits, backpressure timeout, or
    the server is draining.  ``reason`` carries which."""

    def __init__(self, reason: str, rid: int | None = None):
        super().__init__(f"request {rid if rid is not None else '?'} "
                         f"rejected: {reason}")
        self.reason = reason
        self.rid = rid


class AsyncServingServer:
    """``submit()`` / ``stream()`` asyncio facade over a
    :class:`ServingEngine` built with ``SchedulerConfig(clock="real")``.

    ``max_queue`` bounds the admission queue (backpressure);
    ``submit_timeout_s`` bounds how long a submit may wait for room
    (None: forever); ``idle_sleep_s`` is the event-loop nap between
    steps while queued arrivals are not yet due.
    """

    def __init__(self, engine: ServingEngine, max_queue: int = 64,
                 submit_timeout_s: float | None = None,
                 idle_sleep_s: float = 0.002):
        if engine.config.clock != "real":
            raise ValueError("AsyncServingServer needs SchedulerConfig("
                             "clock='real'); the virtual trace clock "
                             "cannot stamp live arrivals")
        self.engine = engine
        self.max_queue = max_queue
        self.submit_timeout_s = submit_timeout_s
        self.idle_sleep_s = idle_sleep_s
        engine.emit_hook = self._on_token      # worker thread
        engine.finish_hook = self._on_finish   # worker thread
        self._emissions: deque = deque()       # (rid, token | None)
        self._ingress: deque = deque()         # (ServeRequest, Future)
        self._streams: dict[int, asyncio.Queue] = {}
        self._space = asyncio.Condition()
        self._wake = asyncio.Event()
        self._rids = itertools.count()
        self._task: asyncio.Task | None = None
        self._draining = False
        self.completed: list[ServeRequest] = []

    # ------------------------------------------------------------------
    # engine hooks — called inside the worker thread mid-run_step; only
    # touch the thread-safe deque, never asyncio primitives

    def _on_token(self, req: ServeRequest, tok: int):
        self._emissions.append((req.rid, tok))

    def _on_finish(self, req: ServeRequest):
        self.completed.append(req)
        self._emissions.append((req.rid, None))

    # ------------------------------------------------------------------
    async def start(self):
        if self._task is None:
            self._draining = False
            self._task = asyncio.create_task(self._serve_loop())

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.drain()

    def _depth(self) -> int:
        return self.engine.pending() + len(self._ingress)

    def _reject(self, reason: str, rid: int, tenant: str):
        eng = self.engine
        eng.rejected_total += 1
        if eng.obs.enabled:
            eng.obs.metrics.counter(
                "serve_requests_rejected_total",
                "requests rejected at submit (never fits / bounded "
                "queue full)").inc(1, reason=reason, tenant=tenant)
        raise RequestRejected(reason, rid)

    async def submit(self, prompt, max_new_tokens: int = 32,
                     tenant: str = "default", priority: int = 1,
                     rid: int | None = None) -> ServeRequest:
        """Queue one request, awaiting while the bounded admission queue
        is full (backpressure).  Returns the live :class:`ServeRequest`
        handle — consume its tokens with :meth:`stream`.  Raises
        :class:`RequestRejected` when draining, on backpressure timeout,
        or when the request could never fit the engine."""
        if self._task is None and not self._draining:
            await self.start()    # a drained server needs explicit start()
        rid = next(self._rids) if rid is None else rid
        if self._draining:
            raise RequestRejected("draining", rid)
        req = ServeRequest(rid, np.asarray(prompt, np.int32),
                           int(max_new_tokens),
                           arrival_s=self.engine.now(),
                           tenant=tenant, priority=priority)
        deadline = (None if self.submit_timeout_s is None
                    else time.monotonic() + self.submit_timeout_s)
        async with self._space:
            while self._depth() >= self.max_queue and not self._draining:
                timeout = (None if deadline is None
                           else deadline - time.monotonic())
                if timeout is not None and timeout <= 0:
                    self._reject("backpressure_timeout", rid, tenant)
                try:
                    await asyncio.wait_for(self._space.wait(),
                                           timeout=timeout)
                except asyncio.TimeoutError:
                    self._reject("backpressure_timeout", rid, tenant)
            if self._draining:
                raise RequestRejected("draining", rid)
        fut = asyncio.get_running_loop().create_future()
        self._ingress.append((req, fut))
        self._wake.set()
        if not await fut:             # engine-level graceful rejection
            raise RequestRejected(req.rejected or "rejected", rid)
        return req

    async def stream(self, req: ServeRequest):
        """Async-iterate the request's verified tokens as they retire;
        ends (StopAsyncIteration) after the last token."""
        q = self._streams.get(req.rid)
        if q is None:
            return                    # already fully streamed
        while True:
            tok = await q.get()
            if tok is None:
                self._streams.pop(req.rid, None)
                return
            yield tok

    async def collect(self, req: ServeRequest) -> list:
        """Convenience: drain :meth:`stream` into a list."""
        return [tok async for tok in self.stream(req)]

    async def drain(self):
        """Graceful shutdown: reject new submissions, serve everything
        already queued or in flight, flush all streams, stop the loop."""
        self._draining = True
        self._wake.set()
        async with self._space:       # release backpressure waiters
            self._space.notify_all()
        if self._task is not None:
            await self._task
            self._task = None
        self.engine._close_window()   # seal the serving wall window

    # ------------------------------------------------------------------
    def _drain_ingress(self):
        """Move parked submissions into the engine queue (event-loop
        thread, worker idle — the engine is never touched from two
        threads at once)."""
        while self._ingress:
            req, fut = self._ingress.popleft()
            ok = self.engine.submit(req)
            if ok:
                self._streams[req.rid] = asyncio.Queue()
            if not fut.done():
                fut.set_result(ok)

    def _flush_emissions(self):
        tracker = self.engine.requests
        while self._emissions:
            rid, tok = self._emissions.popleft()
            q = self._streams.get(rid)
            if q is not None:
                q.put_nowait(tok)
                if tok is not None and tracker.enabled:
                    # stream delivery lands on the request's timeline
                    tracker.on_delivery(rid)

    async def _serve_loop(self):
        eng = self.engine
        while True:
            self._drain_ingress()
            if not eng.has_work():
                if self._draining:
                    break
                self._wake.clear()
                if not self._ingress:  # park until the next submit
                    await self._wake.wait()
                continue
            # one fused round off-thread: the event loop stays live for
            # submits/streams while the engine verifies+drafts
            await asyncio.to_thread(eng.run_step)
            self._flush_emissions()
            async with self._space:
                self._space.notify_all()
            if eng.idle_step:
                # queued arrivals lie in the future on the real clock
                await asyncio.sleep(self.idle_sleep_s)
            else:
                await asyncio.sleep(0)
        self._flush_emissions()

    # ------------------------------------------------------------------
    def tenant_report(self) -> dict:
        """Per-tenant serving digest over completed requests: counts,
        tokens, and TTFT / end-to-end latency percentiles."""
        by_tenant: dict[str, list] = {}
        for r in self.completed:
            by_tenant.setdefault(r.tenant, []).append(r)
        return {
            t: {"requests": len(rs),
                "tokens": int(sum(len(r.result) for r in rs)),
                "preemptions": int(sum(r.preemptions for r in rs)),
                "ttft_s": latency_percentiles(rs, "ttft_s"),
                "e2e_s": latency_percentiles(rs, "latency_s")}
            for t, rs in sorted(by_tenant.items())}
