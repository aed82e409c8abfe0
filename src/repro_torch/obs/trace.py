"""Low-overhead span tracer for the serving pipeline (the port's copy of
``repro/obs/trace.py``).

The paper's headline metric is *utilization* — how much of the offload
bubble the interleaved draft fills (§5: 4.49x GPU core utilization).
Measuring that needs per-phase device time, not end-of-run tokens/s.
This module provides:

* :class:`Tracer` — context-manager spans on named **tracks** (one per
  pipeline phase: ``target_verify``, ``draft_generate``, ``rollback``,
  ``prefill``, ``h2d``/``d2h`` weight/KV streaming, ``kv`` ops,
  ``round``, and ``launch``, the host's launches of the round's CUDA
  graphs), instant events (replans, admissions, evictions), and counter
  samples.  Host times come from ``time.perf_counter``; a settable
  ``virtual_clock`` additionally stamps each event with the scheduler's
  virtual time so trace replays line up with request metrics.
* **Device-timed spans** — CUDA launches are asynchronous, so a span
  around a round measures dispatch, not compute.  A tracer with a stamp
  source (``marks``: :class:`repro_torch.kernels.obs_mark.MarkRing` on a
  card, None on the CPU) times device work by marks: a span opened with
  ``stream=True`` enqueues a mark on the current stream at enter and at
  exit, and a caller that put marks of its own on the stream (the
  round's graphs) hands them to the span with ``sp.device(begin, end)``.
  Nothing synchronises: such a span is *resolved* by :meth:`resolve`,
  which the program calls after a synchronisation it makes anyway (the
  round's host read of its tokens, a prefill's first token), and only
  then lands in ``events``.  Its Chrome event keeps ``ts`` at the host's
  entry and stretches ``dur`` to the later of the host's exit and the
  device's end mark; ``args`` holds the device interval
  (``device_ts``, ``device_dur``).  Without marks a span is timed on the
  host alone.  With ``annotations`` every span also enters
  ``torch.profiler.record_function(f"{track}/{name}")`` so the same
  phase names show up as ranges in a ``torch.profiler`` trace.
* **One clock** — ``ts`` is in microseconds on ``torch.profiler``'s time
  base (``CLOCK_REALTIME`` less Kineto's ``baseTimeNanoseconds``, the
  real time floored to 7,889,238-second intervals), so
  :meth:`Tracer.to_chrome_trace` and the profiler's trace load into one
  Perfetto view.  Device stamps map onto it by an offset bounded at
  every resolve: a mark ran after the host enqueued it and before the
  host read it.
* :func:`bubble_report` — the paper's utilization metric, derived from
  spans: per round, GPU busy fraction = union of device-category span
  time inside the round / round wall time (device intervals where spans
  have them, host walls otherwise); pipeline stall (bubble) = the
  remainder.

Zero cost when disabled: :data:`NULL_TRACER` returns one shared no-op
span object from every call — nothing is allocated per round (asserted
by ``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import collections
import threading
import time

# Canonical pipeline tracks, in display order (Perfetto sorts by tid).
TRACKS = ("round", "target_verify", "draft_generate", "rollback",
          "prefill", "h2d", "d2h", "kv", "admit", "planner", "launch")

#: span categories that count as accelerator-busy for bubble accounting
DEVICE_CATS = frozenset({"device"})

#: Kineto floors its trace base to intervals of this many seconds
_KINETO_BASE_S = 7889238


def profiler_base_ns() -> int:
    """``torch.profiler``'s trace base now: real-time ns floored as Kineto
    floors its ``baseTimeNanoseconds``."""
    return (int(time.time()) // _KINETO_BASE_S) * _KINETO_BASE_S * 10**9


class _NullSpan:
    """Shared do-nothing span: the disabled-mode fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def device(self, begin, end):
        return self

    def rename(self, name):
        return self

    def set(self, key, value):
        return self


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every entry point is allocation-free."""
    enabled = False
    virtual_clock = None
    marks = None

    def span(self, track, name, cat=None, stream=False):
        return NULL_SPAN

    def mark(self, kind, keep=False):
        return None

    def resolve(self, synced=None):
        return None

    def instant(self, track, name, args=None):
        return None

    def complete(self, track, name, t0, t1, cat=None, args=None,
                 device=None):
        return None

    def counter(self, track, name, value):
        return None

    def to_chrome_trace(self):
        return {"traceEvents": []}


NULL_TRACER = NullTracer()


class _Span:
    __slots__ = ("_tr", "track", "name", "cat", "t0", "t1", "args",
                 "_stream", "_marks", "_annot")

    def __init__(self, tracer, track, name, cat, stream):
        self._tr = tracer
        self.track = track
        self.name = name
        self.cat = cat
        self.t0 = self.t1 = 0.0
        self.args = None
        self._stream = stream
        self._marks = None
        self._annot = None

    def __enter__(self):
        if self._tr.use_annotations:
            import torch
            self._annot = torch.profiler.record_function(
                f"{self.track}/{self.name}")
            self._annot.__enter__()
        self.t0 = time.perf_counter()
        if self._stream:
            self._marks = (self._tr.mark("span"), None)
        return self

    def __exit__(self, *exc):
        if self._stream:
            self._marks = (self._marks[0], self._tr.mark("span"))
        self.t1 = time.perf_counter()
        if self._annot is not None:
            self._annot.__exit__(*exc)
        self._tr._record(self)
        return False

    def device(self, begin, end):
        """The span's device interval runs from mark ``begin`` to mark
        ``end`` (handles of :meth:`Tracer.mark`), which the caller put on
        the stream itself; None for either keeps the host's wall."""
        self._marks = (begin, end)
        return self

    def rename(self, name):
        self.name = name
        return self

    def set(self, key, value):
        """Attach one key to the span's Chrome-trace ``args``."""
        if self.args is None:
            self.args = {}
        self.args[key] = value
        return self


class _DeviceClock:
    """Offset (ns) from a stamp source's clock to the host's real clock,
    bounded by the recent resolves: a mark ran after the host enqueued it
    (offset >= real enqueue time - stamp) and before the host read it
    (offset <= real read time - stamp).  The estimate is the middle of
    the tightest bounds of the last ``window`` resolves."""

    def __init__(self, window: int = 64):
        self._lo = collections.deque(maxlen=window)
        self._hi = collections.deque(maxlen=window)

    def add(self, lo: int, hi: int) -> None:
        self._lo.append(lo)
        self._hi.append(hi)

    def offset(self) -> int:
        return (max(self._lo) + min(self._hi)) // 2


class Tracer:
    """Recording tracer.  See the module docstring for the API.

    ``marks``: the stamp source of device spans, with ``mark(kind, keep)``
    (enqueue on the current stream; the slot, or None), ``read(slot)``
    (ns, 0 while unwritten) and ``release(slot)``; None times every span
    on the host."""
    enabled = True

    def __init__(self, annotations: bool = False, virtual_clock=None,
                 marks=None):
        self.use_annotations = annotations
        self.virtual_clock = virtual_clock   # callable -> scheduler seconds
        self.marks = marks
        self.base_ns = profiler_base_ns()
        # perf_counter ns -> real-time ns
        self._real_ns = time.time_ns() - time.perf_counter_ns()
        self._shift_ns = self._real_ns - self.base_ns
        self._clock = _DeviceClock()
        self._pending: list = []             # device spans awaiting marks
        self._resolving = threading.Lock()   # the engine thread and an
                                             # exporting thread may resolve
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
        """perf_counter seconds -> us on the profiler's time base."""
        return (t * 1e9 + self._shift_ns) / 1e3

    def _stamp(self, args: dict | None) -> dict | None:
        if self.virtual_clock is None:
            return args
        args = dict(args) if args else {}
        args["virtual_s"] = float(self.virtual_clock())
        return args

    def _event(self, track, name, t0, t1, cat, args) -> dict:
        ev = {"name": name, "ph": "X", "pid": 1, "tid": self._tid(track),
              "ts": self._us(t0), "dur": max(0.0, (t1 - t0) * 1e6)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        return ev

    def _record(self, sp: _Span):
        self.complete(sp.track, sp.name, sp.t0, sp.t1, sp.cat, sp.args,
                      sp._marks)

    # ------------------------------------------------------------------
    def span(self, track: str, name: str, cat: str | None = None,
             stream: bool = False) -> _Span:
        """Open a complete-event span on ``track`` (context manager);
        ``stream``: its work goes on the current stream, timed by a mark
        at enter and at exit (with a stamp source)."""
        return _Span(self, track, name, cat, stream and self.marks is not None)

    def mark(self, kind: str, keep: bool = False):
        """Enqueue a mark of ``kind`` on the current stream: the handle
        (slot, host perf_counter before the launch), or None without a
        stamp source or a free slot.  ``keep``: made in a graph capture."""
        if self.marks is None:
            return None
        t = time.perf_counter()
        slot = self.marks.mark(kind, keep)
        return None if slot is None else (slot, t)

    def complete(self, track: str, name: str, t0: float, t1: float,
                 cat: str | None = None, args: dict | None = None,
                 device=None):
        """Record an already-timed interval (perf_counter seconds).
        ``device``: its (begin, end) mark handles; the event then waits
        for :meth:`resolve`."""
        args = self._stamp(args)
        if device is None or None in device:
            self.events.append(self._event(track, name, t0, t1, cat, args))
        else:
            with self._resolving:
                self._pending.append((track, name, t0, t1, cat, args,
                                      device))

    def resolve(self, synced: float | None = None) -> None:
        """Record every pending device span whose two marks have run;
        call after a synchronisation that covers them (never waits).
        ``synced``: the perf_counter time at which a synchronisation
        covering every mark enqueued so far returned (the tightest bound
        on the device clock; else the time of the read)."""
        if not self._pending:
            return
        with self._resolving:
            self._resolve(synced)

    def _resolve(self, synced) -> None:
        src = self.marks
        ready, wait = [], []
        for p in self._pending:
            (s0, q0), (s1, q1) = p[6]
            g0, g1 = src.read(s0), src.read(s1)
            (ready if g0 and g1 else wait).append((p, g0, g1))
        if not ready:
            return
        t_read = (time.perf_counter_ns() if synced is None
                  else int(synced * 1e9)) + self._real_ns
        lo = max(int(q * 1e9) + self._real_ns - g
                 for p, g0, g1 in ready
                 for (_, q), g in zip(p[6], (g0, g1)))
        hi = t_read - max(g1 for _, _, g1 in ready)
        self._clock.add(lo, hi)
        off = self._clock.offset() - self.base_ns
        for (track, name, t0, t1, cat, args, _), g0, g1 in ready:
            dev_ts, dev_end = (g0 + off) / 1e3, (g1 + off) / 1e3
            args = dict(args) if args else {}
            args["device_ts"] = dev_ts
            args["device_dur"] = (g1 - g0) / 1e3
            ev = self._event(track, name, t0, t1, cat, args)
            ev["dur"] = max(ev["dur"], dev_end - ev["ts"])
            self.events.append(ev)
        self._pending = [p for p, _, _ in wait]
        held = {h[0] for p in self._pending for h in p[6]}
        for p, _, _ in ready:
            for slot, _ in p[6]:
                if slot not in held:
                    held.add(slot)
                    src.release(slot)

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
        """Chrome trace-event JSON (object format), Perfetto-loadable, on
        ``torch.profiler``'s time base."""
        self.resolve()
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.base_ns,
                "otherData": {"producer": "repro_torch.obs.trace",
                              "clock": "CLOCK_REALTIME - "
                                       "baseTimeNanoseconds (torch.profiler)"}}


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
    (union, so the verify/draft mirrors of the one fused round on the
    host are not double counted); the stall is the remainder — host
    scheduling, Python bookkeeping, un-overlapped transfers.  ``idle``
    spans (empty engine waiting for arrivals) are excluded from stall
    and summed separately.

    A device span that was timed by marks counts its device interval
    (``args["device_ts"]``, ``args["device_dur"]``), one timed on the
    host its wall.

    Returns ``{"rounds", "per_round": [{busy_s, stall_s, busy_frac,
    dur_s}...], "busy_s", "stall_s", "idle_s", "wall_s",
    "gpu_busy_frac", "mean_round_busy_frac"}``.
    """
    resolve = getattr(tracer, "resolve", None)
    if resolve is not None:
        resolve()
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
            args = ev.get("args") or {}
            if "device_ts" in args:
                t0 = args["device_ts"] * 1e-6
                t1 = t0 + args["device_dur"] * 1e-6
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
