"""Low-overhead span tracer for the serving pipeline (the port's copy of
``repro/obs/trace.py``).

The paper's headline metric is *utilization* — how much of the offload
bubble the interleaved draft fills (§5: 4.49x GPU core utilization).
Measuring that needs per-phase wall time with device fencing, not
end-of-run tokens/s.  This module provides:

* :class:`Tracer` — context-manager spans on named **tracks** (one per
  pipeline phase: ``target_verify``, ``draft_generate``, ``rollback``,
  ``prefill``, ``h2d``/``d2h`` weight/KV streaming, ``kv`` ops,
  ``round``), instant events (replans, admissions, evictions), and
  counter samples.  Timestamps come from ``time.perf_counter`` (CLOCK_
  MONOTONIC); a settable ``virtual_clock`` additionally stamps each
  event with the scheduler's virtual time so trace replays line up with
  request metrics.
* **Honest device timing** — CUDA launches are asynchronous, so a span
  around a round measures dispatch, not compute.  Inside a span,
  ``sp.fence(tensors)`` synchronises the CUDA device of the fenced
  tensors before the span closes (only when the tracer fences; nothing
  for CPU tensors), and with ``annotations`` the span enters
  ``torch.profiler.record_function(f"{track}/{name}")`` so the same
  phase names show up as ranges in a ``torch.profiler`` trace.
* **Chrome trace-event export** — :meth:`Tracer.to_chrome_trace`
  returns the JSON object format (``{"traceEvents": [...]}``) loadable
  in Perfetto / ``chrome://tracing``, with one named thread per track.
* :func:`bubble_report` — the paper's utilization metric, derived from
  spans: per round, GPU busy fraction = union of device-category span
  time inside the round / round wall time; pipeline stall (bubble) =
  the remainder.  A device span's wall includes the host's dispatch
  inside it, so on a host-bound round the report reads busier than the
  profiler's kernel time does.

Zero cost when disabled: :data:`NULL_TRACER` returns one shared no-op
span object from every call — nothing is allocated per round (asserted
by ``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import threading
import time


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a nested dict/list/tuple."""
    if isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif getattr(tree, "is_cuda", False):
        out.add(tree.device)
    return out


def _synchronize(tree) -> None:
    """Wait for the work queued on the CUDA devices of ``tree``'s
    tensors; nothing for CPU tensors."""
    devices = _cuda_devices(tree, set())
    if devices:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)


# Canonical pipeline tracks, in display order (Perfetto sorts by tid).
TRACKS = ("round", "target_verify", "draft_generate", "rollback",
          "prefill", "h2d", "d2h", "kv", "admit", "planner")

#: span categories that count as accelerator-busy for bubble accounting
DEVICE_CATS = frozenset({"device"})


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def fence(self, arrays):
        return arrays

    def rename(self, name):
        return self

    def set(self, key, value):
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every entry point is allocation-free."""
    enabled = False
    virtual_clock = None

    def span(self, track, name, cat=None):
        return NULL_SPAN

    def instant(self, track, name, args=None):
        return None

    def complete(self, track, name, t0, t1, cat=None, args=None):
        return None

    def counter(self, track, name, value):
        return None

    def to_chrome_trace(self):
        return {"traceEvents": []}


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tr", "track", "name", "cat", "t0", "t1", "args",
                 "_fence", "_annot")

    def __init__(self, tracer, track, name, cat):
        self._tr = tracer
        self.track = track
        self.name = name
        self.cat = cat
        self.t0 = self.t1 = 0.0
        self.args = None
        self._fence = None
        self._annot = None

    def __enter__(self):
        if self._tr.use_annotations:
            import torch
            self._annot = torch.profiler.record_function(
                f"{self.track}/{self.name}")
            self._annot.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._fence is not None:
            _synchronize(self._fence)
        self.t1 = time.perf_counter()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        self._tr._record(self)
        return False

    def fence(self, arrays):
        """Block on ``arrays`` at span exit (when the tracer fences) so
        the span measures device compute, not async dispatch."""
        if self._tr.fence_spans:
            self._fence = arrays
        return arrays

    def rename(self, name):
        self.name = name
        return self

    def set(self, key, value):
        """Attach one key to the span's Chrome-trace ``args``."""
        if self.args is None:
            self.args = {}
        self.args[key] = value
        return self


class Tracer:
    """Recording tracer.  See the module docstring for the API."""
    enabled = True

    def __init__(self, fence: bool = True, annotations: bool = False,
                 virtual_clock=None):
        self.fence_spans = fence
        self.use_annotations = annotations
        self.virtual_clock = virtual_clock   # callable -> scheduler seconds
        self.t0 = time.perf_counter()
        self.events: list[dict] = []         # chrome trace events (us)
        self._tids: dict[str, int] = {}
        # Guards track creation only: event appends are GIL-atomic, and
        # readers (to_chrome_trace / bubble accounting) take one atomic
        # list() copy: the engine's worker thread can keep recording
        # while the asyncio side exports mid-round.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _tid(self, track: str) -> int:
        tid = self._tids.get(track)          # fast path: known track
        if tid is None:
            with self._lock:
                tid = self._tids.get(track)
                if tid is None:
                    try:
                        tid = TRACKS.index(track)
                    except ValueError:
                        tid = len(TRACKS) + len(self._tids)
                    self._tids[track] = tid
                    self.events.append(
                        {"ph": "M", "name": "thread_name", "pid": 1,
                         "tid": tid, "args": {"name": track}})
        return tid

    def _us(self, t: float) -> float:
        return (t - self.t0) * 1e6

    def _stamp(self, args: dict | None) -> dict | None:
        if self.virtual_clock is None:
            return args
        args = dict(args) if args else {}
        args["virtual_s"] = float(self.virtual_clock())
        return args

    def _record(self, sp: _Span):
        ev = {"name": sp.name, "ph": "X", "pid": 1, "tid": self._tid(sp.track),
              "ts": self._us(sp.t0),
              "dur": max(0.0, (sp.t1 - sp.t0) * 1e6)}
        if sp.cat:
            ev["cat"] = sp.cat
        args = self._stamp(sp.args)
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ------------------------------------------------------------------
    def span(self, track: str, name: str, cat: str | None = None) -> _Span:
        """Open a complete-event span on ``track`` (context manager)."""
        return _Span(self, track, name, cat)

    def complete(self, track: str, name: str, t0: float, t1: float,
                 cat: str | None = None, args: dict | None = None):
        """Record an already-timed interval (perf_counter seconds): used
        to mirror the fused round onto both anti-phase tracks."""
        ev = {"name": name, "ph": "X", "pid": 1, "tid": self._tid(track),
              "ts": self._us(t0), "dur": max(0.0, (t1 - t0) * 1e6)}
        if cat:
            ev["cat"] = cat
        args = self._stamp(args)
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, track: str, name: str, args: dict | None = None):
        """Thread-scoped instant event (admission, eviction, replan)."""
        ev = {"name": name, "ph": "i", "s": "t", "pid": 1,
              "tid": self._tid(track),
              "ts": self._us(time.perf_counter())}
        args = self._stamp(args)
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, track: str, name: str, value: float):
        """Chrome counter sample (rendered as a stacked area track)."""
        self.events.append({"name": name, "ph": "C", "pid": 1,
                            "tid": self._tid(track),
                            "ts": self._us(time.perf_counter()),
                            "args": {name: float(value)}})

    # ------------------------------------------------------------------
    def to_chrome_trace(self) -> dict:
        """Chrome trace-event JSON (object format), Perfetto-loadable."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace",
                              "clock": "CLOCK_MONOTONIC (perf_counter)"}}


# ---------------------------------------------------------------------------
# bubble accounting: the paper's utilization metric, derived from spans


def _union_s(intervals: list[tuple]) -> float:
    """Total length of the union of (t0, t1) intervals, seconds."""
    total, hi = 0.0, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total += b - a
            hi = b
        elif b > hi:
            total += b - hi
            hi = b
    return total


def bubble_report(tracer, round_track: str = "round",
                  round_name: str = "round") -> dict:
    """Per-round GPU busy fraction + pipeline-stall (bubble) accounting.

    A *round* is one ``round_name`` span on ``round_track`` (one
    scheduler iteration: admit -> fused verify+draft -> retire).  Busy
    time is the union of device-category spans overlapping the round
    (union, so the verify/draft anti-phase mirrors of the one fused
    round are not double counted); the stall is the remainder — host
    scheduling, Python bookkeeping, un-overlapped transfers.  ``idle``
    spans (empty engine waiting for arrivals) are excluded from stall
    and summed separately.

    Returns ``{"rounds", "per_round": [{busy_s, stall_s, busy_frac,
    dur_s}...], "busy_s", "stall_s", "idle_s", "wall_s",
    "gpu_busy_frac", "mean_round_busy_frac"}``.
    """
    rounds, idle_s, device = [], 0.0, []
    for ev in list(tracer.events):   # atomic copy: recorder may append
        if ev.get("ph") != "X":
            continue
        t0 = ev["ts"] * 1e-6
        t1 = t0 + ev["dur"] * 1e-6
        track = tracer_track_name(tracer, ev["tid"])
        if track == round_track:
            if ev["name"] == round_name:
                rounds.append((t0, t1))
            elif ev["name"] == "idle":
                idle_s += t1 - t0
        elif ev.get("cat") in DEVICE_CATS:
            device.append((t0, t1))
    per_round = []
    for (r0, r1) in rounds:
        inside = [(max(a, r0), min(b, r1)) for a, b in device
                  if b > r0 and a < r1]
        busy = _union_s(inside)
        dur = r1 - r0
        per_round.append({"dur_s": dur, "busy_s": busy,
                          "stall_s": max(0.0, dur - busy),
                          "busy_frac": busy / dur if dur > 0 else 0.0})
    wall = sum(r["dur_s"] for r in per_round)
    busy = sum(r["busy_s"] for r in per_round)
    stall = sum(r["stall_s"] for r in per_round)
    return {"rounds": len(per_round), "per_round": per_round,
            "busy_s": busy, "stall_s": stall, "idle_s": idle_s,
            "wall_s": wall,
            "gpu_busy_frac": busy / wall if wall > 0 else 0.0,
            "mean_round_busy_frac":
                (sum(r["busy_frac"] for r in per_round) / len(per_round))
                if per_round else 0.0}


def tracer_track_name(tracer, tid: int) -> str | None:
    for name, t in list(tracer._tids.items()):
        if t == tid:
            return name
    return None
