"""Request-scoped tracing: per-request span timelines over the serving
stack (the port's copy of ``repro/obs/request_trace.py``).

The round-level tracer (:mod:`repro_torch.obs.trace`) measures the *engine* —
GPU busy fraction, pipeline stall, the paper's utilization claim.  A
serving stack is judged per *request*: time queued, time prefilling,
time riding fused decode rounds, time parked by a preemption, TTFT and
inter-token cadence per tenant.  This module attributes every phase of
a request's life to its request ID (minted in
``AsyncServingServer.submit()`` / ``ServingEngine.submit``):

* :class:`RequestTracker` — the engine calls ``on_submit`` /
  ``on_admit`` / ``on_round`` / ``on_preempt`` / ``on_finish`` as the
  request moves through admission, zig-zag prefill, every fused round
  its slot participates in (verify *and* anti-phase draft rounds),
  preemption/resume, and retirement; the async front door adds
  ``on_delivery`` as tokens are flushed to the stream.
* **Per-request Chrome tracks** — when a live span tracer is attached,
  every phase is mirrored onto a ``req:{rid}`` track in the same
  Chrome/Perfetto trace the pipeline spans land in, so one trace shows
  rounds *and* the requests inside them.
* **JSON timeline digest** — :meth:`RequestTracker.timeline` /
  :meth:`timelines` return plain dicts (``queue_s``, ``prefill_s``,
  ``decode_s``, ``stall_s``, ``preempted_s``, ``tokens``, per-round
  acceptance) validated by ``repro_torch.obs.schema.validate_request_timeline``.
  ``stall_s`` is the admitted-to-finished wall time not covered by any
  recorded phase — host scheduling the request sat through.

Zero cost when disabled: :data:`NULL_REQUEST_TRACKER` no-ops every
entry point (``SchedulerConfig(request_timeline=False)``, the default,
keeps the engine loop allocation-free).  Tracking is host-side only —
it never touches jit boundaries, so traced and untraced runs stay
token-identical with one fused compile (tested in
``tests/test_torch_request_obs.py``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from repro_torch.obs.trace import NULL_TRACER

#: per-request phases, in display order on the request's Chrome track
PHASES = ("queue", "prefill", "decode", "draft_wait", "preempted")


class NullRequestTracker:
    """Disabled tracker: every entry point is an allocation-free no-op."""
    enabled = False

    def on_submit(self, req, wall=None):
        return None

    def on_reject(self, req, reason):
        return None

    def on_admit(self, req, t0, t1, half=0, slot=0, resumed=False):
        return None

    def on_round(self, req, round_idx, t0, t1, accepted=0, emitted=0,
                 role="verify"):
        return None

    def on_preempt(self, req, wall=None):
        return None

    def on_finish(self, req, wall=None):
        return None

    def on_delivery(self, rid, n=1, wall=None):
        return None

    def timeline(self, rid):
        return None

    def timelines(self):
        return []


NULL_REQUEST_TRACKER = NullRequestTracker()


@dataclass
class _ReqState:
    """Live per-request accumulator (wall = perf_counter seconds)."""
    rid: int
    tenant: str
    priority: int
    arrival_s: float              # scheduler clock
    submit_wall: float
    admitted_s: float = float("nan")
    finished_s: float = float("nan")
    first_admit_wall: float = float("nan")
    last_park_wall: float = float("nan")   # submit or preempt -> next admit
    finish_wall: float = float("nan")
    queue_s: float = 0.0          # wall parked before (re-)admission
    prefill_s: float = 0.0
    decode_s: float = 0.0         # fused rounds, verify + draft roles
    preempted_s: float = 0.0
    preemptions: int = 0
    tokens: int = 0
    deliveries: int = 0
    accepted_total: int = 0
    rounds: list = field(default_factory=list)  # per-round records
    rejected: str | None = None


class RequestTracker:
    """Recording tracker; the engine owns one per serving lifetime.

    ``tracer`` (optional) mirrors phases onto per-request Chrome tracks;
    ``clock`` (optional callable) stamps scheduler-clock seconds onto
    the digest; ``max_done`` bounds retained finished timelines (ring —
    a long-lived server never grows without bound).
    """
    enabled = True

    def __init__(self, tracer=None, clock=None, max_done: int = 4096,
                 max_rounds_per_req: int = 4096):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.clock = clock
        self.max_rounds_per_req = max_rounds_per_req
        self._live: dict[int, _ReqState] = {}
        self._done: deque = deque(maxlen=max_done)
        self._done_by_rid: dict[int, dict] = {}

    # ------------------------------------------------------------------
    def _track(self, rid: int) -> str:
        return f"req:{rid}"

    def _span(self, rid: int, name: str, t0: float, t1: float,
              args: dict | None = None):
        if self.tracer.enabled:
            self.tracer.complete(self._track(rid), name, t0, t1,
                                 cat="request", args=args)

    def _now_wall(self, wall):
        return time.perf_counter() if wall is None else wall

    # ------------------------------------------------------------------
    # engine lifecycle hooks

    def on_submit(self, req, wall=None):
        wall = self._now_wall(wall)
        self._live[req.rid] = _ReqState(
            rid=req.rid, tenant=req.tenant, priority=req.priority,
            arrival_s=req.arrival_s, submit_wall=wall,
            last_park_wall=wall)

    def on_reject(self, req, reason):
        st = self._live.pop(req.rid, None)
        if st is None:
            st = _ReqState(rid=req.rid, tenant=req.tenant,
                           priority=req.priority,
                           arrival_s=req.arrival_s,
                           submit_wall=self._now_wall(None))
        st.rejected = reason
        self._retire(st)

    def on_admit(self, req, t0, t1, half=0, slot=0, resumed=False):
        """One admission: ``t0``/``t1`` bound the prefill+splice work
        (wall).  The park interval since submit (or since the preempt
        that parked it) closes here as ``queue`` or ``preempted``."""
        st = self._live.get(req.rid)
        if st is None:
            return
        park = max(0.0, t0 - st.last_park_wall)
        if resumed:
            st.preempted_s += park
            self._span(req.rid, "preempted", st.last_park_wall, t0,
                       {"preemptions": st.preemptions})
        else:
            st.queue_s += park
            self._span(req.rid, "queue", st.last_park_wall, t0,
                       {"tenant": st.tenant})
        st.last_park_wall = float("nan")
        if st.first_admit_wall != st.first_admit_wall:  # NaN: first admit
            st.first_admit_wall = t0
        st.prefill_s += max(0.0, t1 - t0)
        if self.clock is not None and st.admitted_s != st.admitted_s:
            st.admitted_s = float(self.clock())
        self._span(req.rid, "prefill", t0, t1,
                   {"half": half, "slot": slot, "resumed": resumed})

    def on_round(self, req, round_idx, t0, t1, accepted=0, emitted=0,
                 role="verify"):
        """One fused round the request's slot participated in.  ``role``
        is ``"verify"`` (its half was verified: tokens may have been
        emitted) or ``"draft"`` (the anti-phase half: candidates were
        drafted for it — still pipeline work done on its behalf)."""
        st = self._live.get(req.rid)
        if st is None:
            return
        dur = max(0.0, t1 - t0)
        st.decode_s += dur
        if role == "verify":
            st.accepted_total += int(accepted)
            st.tokens += int(emitted)
            if len(st.rounds) < self.max_rounds_per_req:
                st.rounds.append({"round": int(round_idx), "dur_s": dur,
                                  "accepted": int(accepted),
                                  "emitted": int(emitted), "t1": t1})
        self._span(req.rid, role, t0, t1,
                   {"round": int(round_idx), "accepted": int(accepted),
                    "emitted": int(emitted)})

    def on_preempt(self, req, wall=None):
        st = self._live.get(req.rid)
        if st is None:
            return
        st.preemptions += 1
        st.last_park_wall = self._now_wall(wall)
        if self.tracer.enabled:
            self.tracer.instant(self._track(req.rid), "preempted",
                                {"progress": len(req.progress)})

    def on_finish(self, req, wall=None):
        st = self._live.pop(req.rid, None)
        if st is None:
            return
        st.finish_wall = self._now_wall(wall)
        st.tokens = (len(req.result) if req.result is not None
                     else st.tokens)
        if self.clock is not None:
            st.finished_s = float(self.clock())
        self._retire(st)

    def on_delivery(self, rid, n=1, wall=None):
        """Stream delivery (async front door): ``n`` tokens flushed to
        the request's consumer queue."""
        st = self._live.get(rid)
        if st is not None:
            st.deliveries += int(n)
            return
        tl = self._done_by_rid.get(rid)
        if tl is not None:
            tl["deliveries"] = tl.get("deliveries", 0) + int(n)

    # ------------------------------------------------------------------
    def _retire(self, st: _ReqState):
        tl = self._digest(st)
        if len(self._done) == self._done.maxlen and self._done:
            self._done_by_rid.pop(self._done[0]["rid"], None)
        self._done.append(tl)
        self._done_by_rid[st.rid] = tl

    def _digest(self, st: _ReqState) -> dict:
        admitted = st.first_admit_wall
        finish = st.finish_wall
        span_s = (max(0.0, finish - admitted)
                  if admitted == admitted and finish == finish else 0.0)
        stall = max(0.0, span_s - st.prefill_s - st.decode_s
                    - st.preempted_s)
        gaps = inter_token_gaps(st.rounds)
        return {
            "schema": "repro.request_timeline/v1",
            "rid": st.rid, "tenant": st.tenant, "priority": st.priority,
            "arrival_s": st.arrival_s, "admitted_s": st.admitted_s,
            "finished_s": st.finished_s,
            "queue_s": st.queue_s, "prefill_s": st.prefill_s,
            "decode_s": st.decode_s, "stall_s": stall,
            "preempted_s": st.preempted_s,
            "preemptions": st.preemptions,
            "tokens": st.tokens, "deliveries": st.deliveries,
            "accepted_total": st.accepted_total,
            "verify_rounds": len(st.rounds),
            "per_round": [{k: r[k] for k in
                           ("round", "dur_s", "accepted", "emitted")}
                          for r in st.rounds],
            "inter_token_p99_s": (percentile_of(gaps, 99)
                                  if gaps else None),
            "rejected": st.rejected,
        }

    # ------------------------------------------------------------------
    def timeline(self, rid: int) -> dict | None:
        """Digest for one request: finished/rejected requests get their
        final timeline, live ones a provisional one."""
        tl = self._done_by_rid.get(rid)
        if tl is not None:
            return tl
        st = self._live.get(rid)
        return None if st is None else self._digest(st)

    def timelines(self) -> list:
        """Final digests of every retired request, retirement order."""
        return list(self._done)

    def live_count(self) -> int:
        return len(self._live)


# ---------------------------------------------------------------------------


def inter_token_gaps(rounds: list) -> list:
    """Wall gaps between consecutive token emissions, from per-round
    records: every token emitted by a round becomes available at the
    round's end, so the gap series is (a) zeros inside a round for its
    2nd..nth token and (b) the round-to-round wall delta for the first
    token of each emitting round."""
    gaps, prev_t1 = [], None
    for r in rounds:
        n = int(r.get("emitted", 0))
        if n <= 0:
            continue
        t1 = float(r.get("t1", 0.0))
        if prev_t1 is not None:
            gaps.append(max(0.0, t1 - prev_t1))
        gaps.extend([0.0] * (n - 1))
        prev_t1 = t1
    return gaps


def percentile_of(vals: list, p: float) -> float:
    """Nearest-rank percentile of a small python list (no numpy dep)."""
    s = sorted(vals)
    if not s:
        return float("nan")
    k = max(0, min(len(s) - 1, int(-(-p * len(s) // 100)) - 1))
    return float(s[k])


def timelines_summary(timelines: list) -> dict:
    """Aggregate digest over many request timelines (bench export)."""
    done = [t for t in timelines if not t.get("rejected")]
    if not done:
        return {"requests": 0}

    def _tot(key):
        return float(sum(t[key] for t in done))

    return {
        "requests": len(done),
        "rejected": len(timelines) - len(done),
        "tokens": int(sum(t["tokens"] for t in done)),
        "queue_s_total": _tot("queue_s"),
        "prefill_s_total": _tot("prefill_s"),
        "decode_s_total": _tot("decode_s"),
        "stall_s_total": _tot("stall_s"),
        "preempted_s_total": _tot("preempted_s"),
        "accepted_total": int(sum(t["accepted_total"] for t in done)),
        "verify_rounds_total": int(sum(t["verify_rounds"]
                                       for t in done)),
    }
