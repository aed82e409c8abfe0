"""Declarative SLOs + anomaly-triggered flight recorder (the port's
copy of ``repro/obs/slo.py``).

The request timelines (:mod:`repro_torch.obs.request_trace`) give every
request a measured TTFT, inter-token cadence and end-to-end latency;
this module turns those into *enforced* objectives and keeps an
always-on black box for when they are missed:

* :class:`SLO` — one declarative objective: a metric (``ttft_s``,
  ``e2e_s``, ``queue_s``, ``inter_token_p99_s``), a threshold, and an
  optional tenant / priority-class scope.
* :class:`SLOMonitor` — evaluates SLOs as requests hit first token and
  retirement, emitting ``slo_violations_total{slo,tenant}`` counters,
  ``slo_compliance{slo,tenant}`` gauges (fraction of evaluated requests
  inside the objective), tracer instant events on an ``slo`` track, and
  an ``on_violation`` callback the engine wires to the flight recorder.
* :class:`FlightRecorder` — a bounded ring buffer of recent round
  records + instants that is *always on* (cheap: one small dict per
  round, ``maxlen`` deque).  On an SLO violation or an anomaly signal —
  acceptance-EMA collapse, GPU-busy-fraction drop, queue-depth spike
  (:meth:`FlightRecorder.check`) — it dumps a **postmortem bundle** to
  ``out_dir``: the ring contents rendered as a Chrome trace window
  (``trace.json``), a metrics snapshot (``metrics.json``), the planner/
  scheduler config (``config.json``), an engine state digest
  (``engine.json``) and a ``manifest.json``, all schema-validated by
  :func:`repro_torch.obs.schema.validate_postmortem_bundle`.  A cooldown +
  bundle cap keeps a sustained violation storm from flooding the disk:
  one incident, one bundle.

Everything here is host-side and jit-free; with ``out_dir=None`` the
recorder never touches the filesystem (triggers are still counted).
"""
from __future__ import annotations

import json
import math
import os
import time
from collections import deque
from dataclasses import dataclass

from repro_torch.obs.metrics import NULL_REGISTRY
from repro_torch.obs.trace import NULL_TRACER

#: timeline keys an SLO may target (all seconds)
SLO_METRICS = ("ttft_s", "e2e_s", "queue_s", "inter_token_p99_s")


@dataclass(frozen=True)
class SLO:
    """One declarative service-level objective."""
    name: str
    metric: str                   # one of SLO_METRICS
    threshold_s: float
    tenant: str | None = None     # None: applies to every tenant
    priority: int | None = None   # None: applies to every class

    def __post_init__(self):
        if self.metric not in SLO_METRICS:
            raise ValueError(f"SLO metric must be one of {SLO_METRICS}, "
                             f"got {self.metric!r}")

    def applies(self, tenant: str, priority: int) -> bool:
        return ((self.tenant is None or self.tenant == tenant)
                and (self.priority is None or self.priority == priority))

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "threshold_s": self.threshold_s, "tenant": self.tenant,
                "priority": self.priority}


def as_slos(specs) -> tuple:
    """Normalize a config value (SLOs or plain dicts) into SLO tuples."""
    out = []
    for s in specs or ():
        out.append(s if isinstance(s, SLO) else SLO(**s))
    return tuple(out)


class SLOMonitor:
    """Evaluates SLOs over request metrics as they become available.

    ``observe_ttft`` fires at first token (TTFT/queue objectives can be
    violated long before retirement); ``observe_finish`` fires at
    retirement and covers end-to-end + inter-token objectives (the
    latter needs the request's timeline for round records).  Each
    (slo, request) pair is evaluated at most once.
    """

    def __init__(self, slos, metrics=None, tracer=None,
                 on_violation=None):
        self.slos = as_slos(slos)
        self.metrics = metrics if metrics is not None else NULL_REGISTRY
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.on_violation = on_violation
        self._ok: dict[tuple, int] = {}
        self._bad: dict[tuple, int] = {}
        self.violations: list = []

    # ------------------------------------------------------------------
    def _value(self, slo: SLO, req, timeline) -> float | None:
        if slo.metric == "ttft_s":
            return float(req.ttft_s)
        if slo.metric == "e2e_s":
            return float(req.latency_s)
        if slo.metric == "queue_s":
            return float(req.queue_s)
        if timeline is None:
            return None
        v = timeline.get(slo.metric)
        return None if v is None else float(v)

    def _evaluate(self, slo: SLO, req, timeline):
        value = self._value(slo, req, timeline)
        if value is None or value != value:      # unavailable / NaN
            return
        key = (slo.name, req.tenant)
        violated = value > slo.threshold_s
        tally = self._bad if violated else self._ok
        tally[key] = tally.get(key, 0) + 1
        ok = self._ok.get(key, 0)
        bad = self._bad.get(key, 0)
        if self.metrics.enabled:
            self.metrics.gauge(
                "slo_compliance",
                "fraction of evaluated requests meeting the SLO").set(
                    ok / max(ok + bad, 1), slo=slo.name,
                    tenant=req.tenant)
        if not violated:
            return
        event = {"slo": slo.name, "metric": slo.metric,
                 "threshold_s": slo.threshold_s, "value_s": value,
                 "rid": req.rid, "tenant": req.tenant,
                 "priority": req.priority}
        self.violations.append(event)
        if self.metrics.enabled:
            self.metrics.counter(
                "slo_violations_total",
                "requests that missed a declared SLO").inc(
                    1, slo=slo.name, tenant=req.tenant)
        if self.tracer.enabled:
            self.tracer.instant("slo", "violation", dict(event))
        if self.on_violation is not None:
            self.on_violation(slo, event)

    # ------------------------------------------------------------------
    def observe_ttft(self, req):
        """Evaluate TTFT/queue objectives the moment first token lands."""
        for slo in self.slos:
            if (slo.metric in ("ttft_s", "queue_s")
                    and slo.applies(req.tenant, req.priority)):
                self._evaluate(slo, req, None)

    def observe_finish(self, req, timeline=None):
        """Evaluate end-to-end + inter-token objectives at retirement."""
        for slo in self.slos:
            if (slo.metric in ("e2e_s", "inter_token_p99_s")
                    and slo.applies(req.tenant, req.priority)):
                self._evaluate(slo, req, timeline)

    # ------------------------------------------------------------------
    def report(self) -> dict:
        """Compliance per (slo, tenant) + the violation log."""
        out: dict = {"slos": [s.to_dict() for s in self.slos],
                     "compliance": {}, "violations": len(self.violations),
                     "violation_log": list(self.violations[-64:])}
        for key in sorted(set(self._ok) | set(self._bad)):
            ok, bad = self._ok.get(key, 0), self._bad.get(key, 0)
            out["compliance"]["/".join(key)] = {
                "evaluated": ok + bad, "violations": bad,
                "compliance": ok / max(ok + bad, 1)}
        return out


# ---------------------------------------------------------------------------
# flight recorder


#: bundle schema version stamped into every manifest
BUNDLE_SCHEMA = "repro.postmortem/v1"
#: files every postmortem bundle must contain
BUNDLE_FILES = ("manifest.json", "trace.json", "metrics.json",
                "engine.json", "config.json")


class FlightRecorder:
    """Always-on bounded black box + postmortem dumper.

    ``record_round`` appends one small record per scheduler round to a
    ring (``capacity`` rounds); ``record_instant`` logs noteworthy
    one-off events (admissions storms, replans, violations).
    :meth:`check` runs the anomaly detectors against slow-EMA baselines
    learned from the stream itself; :meth:`trigger` dumps the bundle
    (subject to ``cooldown_s`` between dumps and ``max_bundles`` total).

    Anomaly detectors (all need ``warmup`` rounds of baseline first):

    * **acceptance collapse** — mean live-slot acceptance EMA drops
      below ``accept_collapse`` x its learned baseline.
    * **GPU-busy drop** — the round's fused-step fraction of wall time
      falls below ``busy_drop`` x baseline.
    * **queue spike** — queue depth exceeds ``queue_spike`` x baseline
      (plus a +2 absolute guard so tiny queues can't trip it).
    """

    def __init__(self, capacity: int = 256, out_dir: str | None = None,
                 cooldown_s: float = 30.0, max_bundles: int = 4,
                 warmup: int = 16, accept_collapse: float = 0.25,
                 busy_drop: float = 0.25, queue_spike: float = 4.0,
                 ema: float = 0.05):
        self.capacity = capacity
        self.out_dir = out_dir
        self.cooldown_s = cooldown_s
        self.max_bundles = max_bundles
        self.warmup = warmup
        self.accept_collapse = accept_collapse
        self.busy_drop = busy_drop
        self.queue_spike = queue_spike
        self.ema = ema
        self.ring: deque = deque(maxlen=capacity)
        self.instants: deque = deque(maxlen=capacity)
        self.bundles: list = []       # paths of dumped bundles
        self.triggers: list = []      # every trigger, dumped or not
        self._last_dump_wall = -math.inf
        self._seen = 0
        self._base = {"accept": None, "busy": None, "queue": None}

    # ------------------------------------------------------------------
    def record_round(self, rec: dict):
        """One scheduler round; ``rec`` must carry ``round``/``t0``/
        ``t1`` (perf_counter seconds) and may carry anything else."""
        self.ring.append(rec)

    def record_instant(self, name: str, args: dict | None = None,
                       wall: float | None = None):
        self.instants.append({
            "name": name,
            "t": time.perf_counter() if wall is None else wall,
            "args": args or {}})

    # ------------------------------------------------------------------
    def _drift(self, key: str, value: float) -> float | None:
        """Update the slow baseline; return it as it was *before* this
        sample (so a collapsing signal is judged against history)."""
        prev = self._base[key]
        if prev is None:
            self._base[key] = value
        else:
            self._base[key] = (1 - self.ema) * prev + self.ema * value
        return prev

    def check(self, accept_mean: float | None = None,
              busy_frac: float | None = None,
              queue_depth: int | None = None) -> tuple | None:
        """Run the anomaly detectors on this round's signals.  Returns
        ``(reason, args)`` on the first firing detector, else None."""
        self._seen += 1
        hits = []
        if accept_mean is not None:
            base = self._drift("accept", accept_mean)
            if (base is not None and self._seen > self.warmup
                    and base > 1e-6
                    and accept_mean < self.accept_collapse * base):
                hits.append(("accept_collapse",
                             {"accept_mean": accept_mean,
                              "baseline": base}))
        if busy_frac is not None:
            base = self._drift("busy", busy_frac)
            if (base is not None and self._seen > self.warmup
                    and base > 1e-6
                    and busy_frac < self.busy_drop * base):
                hits.append(("busy_drop", {"busy_frac": busy_frac,
                                           "baseline": base}))
        if queue_depth is not None:
            base = self._drift("queue", float(queue_depth))
            if (base is not None and self._seen > self.warmup
                    and queue_depth > self.queue_spike * max(base, 1.0)
                    + 2.0):
                hits.append(("queue_spike", {"queue_depth": queue_depth,
                                             "baseline": base}))
        return hits[0] if hits else None

    # ------------------------------------------------------------------
    def _ring_chrome_trace(self) -> dict:
        """Render the ring + instants as a standalone Chrome trace
        window (timestamps rebased so the window starts at 0)."""
        t0s = ([r["t0"] for r in self.ring]
               + [i["t"] for i in self.instants])
        base = min(t0s) if t0s else 0.0

        def us(t):
            return max(0.0, (t - base) * 1e6)

        events = [
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 0,
             "args": {"name": "flight:rounds"}},
            {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
             "args": {"name": "flight:instants"}},
        ]
        for r in self.ring:
            args = {k: v for k, v in r.items() if k not in ("t0", "t1")}
            events.append({"ph": "X", "name": "round", "pid": 1,
                           "tid": 0, "ts": us(r["t0"]),
                           "dur": max(0.0, (r["t1"] - r["t0"]) * 1e6),
                           "cat": "flight", "args": args})
        for i in self.instants:
            events.append({"ph": "i", "s": "t", "name": i["name"],
                           "pid": 1, "tid": 1, "ts": us(i["t"]),
                           "args": i["args"]})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.slo.FlightRecorder",
                              "window_rounds": len(self.ring)}}

    def trigger(self, reason: str, args: dict | None = None,
                metrics=None, engine=None, config=None) -> str | None:
        """Dump a postmortem bundle for ``reason``.

        ``metrics``/``engine``/``config`` are zero-arg callables (or
        plain dicts) producing the snapshot sections — callables so a
        cooldown-suppressed trigger costs nothing.  Returns the bundle
        directory path, or None when suppressed / ``out_dir`` unset.
        """
        wall = time.perf_counter()
        self.triggers.append({"reason": reason, "args": args or {},
                              "wall": wall})
        if self.out_dir is None:
            return None
        if wall - self._last_dump_wall < self.cooldown_s:
            return None
        if len(self.bundles) >= self.max_bundles:
            return None
        self._last_dump_wall = wall

        def _call(x):
            return x() if callable(x) else (x or {})

        seq = len(self.bundles)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)
        path = os.path.join(self.out_dir, f"postmortem_{seq:03d}_{safe}")
        os.makedirs(path, exist_ok=True)
        manifest = {"schema": BUNDLE_SCHEMA, "reason": reason,
                    "args": args or {}, "bundle_seq": seq,
                    "ring_rounds": len(self.ring),
                    "ring_instants": len(self.instants),
                    "wall_s": wall}
        sections = {"manifest.json": manifest,
                    "trace.json": self._ring_chrome_trace(),
                    "metrics.json": _call(metrics),
                    "engine.json": _call(engine),
                    "config.json": _call(config)}
        for fname, obj in sections.items():
            with open(os.path.join(path, fname), "w") as f:
                json.dump(obj, f, indent=2, default=str)
        self.bundles.append(path)
        return path
