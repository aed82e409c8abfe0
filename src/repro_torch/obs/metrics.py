"""Labeled Counters / Gauges / Histograms with JSON snapshot and
Prometheus text exposition.  Dependency-free (stdlib only); the
port's copy of ``repro/obs/metrics.py``, whose text it matches byte for
byte for the same observations.

The registry is the serving stack's metrics backbone: the scheduler
exports queue depth / occupancy / paged-KV block gauges, the pipeline
exports retrace counters, the offload layer exports per-tier transfer
bytes+seconds, and speculative decoding exports per-round acceptance
histograms (see ``repro_torch.serving.engine.ServingEngine.metrics``).

* Instruments are created through :meth:`Registry.counter` /
  :meth:`gauge` / :meth:`histogram` (get-or-create by name, so modules
  can share one instrument without coordination).
* Labels are passed as keyword arguments at observation time:
  ``reg.counter("transfer_bytes_total").inc(n, tier="h2d")``.
* :meth:`Registry.snapshot` returns a plain-JSON dict;
  :meth:`Registry.prometheus_text` emits the text exposition format
  (``# HELP`` / ``# TYPE`` / cumulative ``_bucket{le=...}`` rows) that a
  Prometheus scraper — or the round-trip parser in ``obs/schema.py`` —
  can consume.
* Histograms keep per-bucket counts plus sum/count/min/max and support
  :meth:`Histogram.percentile` (linear interpolation inside the bucket,
  exact when observations sit on bucket bounds — tested).

:data:`NULL_REGISTRY` is the disabled-mode twin: every instrument is a
shared no-op singleton, so a metrics-off engine loop allocates nothing.

Thread discipline: the async front door runs engine rounds in a worker
thread while the event loop may scrape ``snapshot()`` /
``prometheus_text()`` mid-round.  The hot ``inc()``/``observe()`` path
stays **lock-free** (single engine writer; CPython list/dict primitives
are atomic under the GIL) — the registry lock only serializes the cold
paths: instrument creation and snapshot/exposition, which copy every
dict with one C-level ``list(d.items())`` call so a concurrent labelset
insertion can never raise ``dictionary changed size during iteration``.
Histogram reads derive ``count`` from one atomic copy of the bucket
array, so the ``count == +Inf cumulative`` invariant holds even when a
snapshot races an ``observe`` (tested in ``tests/test_torch_obs.py``).
"""
from __future__ import annotations

import math
import threading


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _esc(v) -> str:
    """Escape a label value per the Prometheus text exposition spec
    (0.0.4): backslash, double-quote and line-feed."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in key)
    return "{" + inner + "}"


class Counter:
    """Monotonically increasing per-labelset float."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)

    def snapshot(self):
        # list() is one C call: atomic vs a concurrent inc-new-labelset
        return {_fmt_labels(k) or "": v
                for k, v in list(self.values.items())}

    def expose(self) -> list:
        return [f"{self.name}{_fmt_labels(k)} {_num(v)}"
                for k, v in sorted(list(self.values.items()))]

    kind = "counter"


class Gauge:
    """Set-to-current-value per-labelset float."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.values: dict[tuple, float] = {}

    def set(self, value: float, **labels):
        self.values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        k = _label_key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self.values.get(_label_key(labels), 0.0)

    def snapshot(self):
        return {_fmt_labels(k) or "": v
                for k, v in list(self.values.items())}

    def expose(self) -> list:
        return [f"{self.name}{_fmt_labels(k)} {_num(v)}"
                for k, v in sorted(list(self.values.items()))]

    kind = "gauge"


#: default buckets suit sub-second pipeline phases (seconds)
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

#: wider buckets for request-level latencies — per-tenant TTFT and
#: end-to-end histograms reach minutes under queueing (seconds)
LATENCY_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                   5.0, 10.0, 30.0, 60.0, 120.0)


def acceptance_buckets(n_cand: int) -> tuple:
    """Integer buckets 0..n_cand for accepted-draft-token histograms."""
    return tuple(float(i) for i in range(n_cand + 1))


class Histogram:
    """Prometheus-style cumulative-bucket histogram (+min/max)."""

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.series: dict[tuple, dict] = {}

    def _series(self, labels: dict) -> dict:
        k = _label_key(labels)
        s = self.series.get(k)
        if s is None:
            s = {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                 "count": 0, "min": math.inf, "max": -math.inf}
            self.series[k] = s
        return s

    def observe(self, value: float, **labels):
        s = self._series(labels)
        v = float(value)
        i = len(self.buckets)
        for j, ub in enumerate(self.buckets):   # first bucket with v <= ub
            if v <= ub:
                i = j
                break
        # sum/min/max first, bucket count last: a reader that sees the
        # bucket increment is then guaranteed to see finite min/max
        s["sum"] += v
        s["count"] += 1
        s["min"] = min(s["min"], v)
        s["max"] = max(s["max"], v)
        s["counts"][i] += 1

    # ------------------------------------------------------------------
    def percentile(self, p: float, **labels) -> float:
        """p in [0, 100]: bucket-interpolated percentile.  Exact when the
        observations coincide with bucket upper bounds (e.g. the integer
        acceptance buckets); otherwise accurate to the bucket width."""
        s = self.series.get(_label_key(labels))
        if s is None:
            return float("nan")
        counts = list(s["counts"])        # one atomic copy per read
        count = sum(counts)
        if count == 0:
            return float("nan")
        lo_all, hi_all = s["min"], s["max"]
        rank = (p / 100.0) * count
        cum = 0
        for j, c in enumerate(counts):
            if c == 0:
                continue
            lo = lo_all if j == 0 else self.buckets[j - 1]
            hi = self.buckets[j] if j < len(self.buckets) else hi_all
            if cum + c >= rank:
                frac = (rank - cum) / c
                return min(max(lo + frac * (hi - lo), lo_all), hi_all)
            cum += c
        return hi_all

    def snapshot(self):
        out = {}
        for k, s in list(self.series.items()):
            # copy counts atomically and derive count from the copy so
            # the count == +Inf invariant survives a racing observe()
            counts = list(s["counts"])
            count = sum(counts)
            cum, buckets = 0, {}
            for j, c in enumerate(counts[:-1]):
                cum += c
                buckets[str(self.buckets[j])] = cum
            buckets["+Inf"] = cum + counts[-1]
            out[_fmt_labels(k) or ""] = {
                "buckets": buckets, "sum": s["sum"], "count": count,
                "min": None if count == 0 else s["min"],
                "max": None if count == 0 else s["max"]}
        return out

    def expose(self) -> list:
        lines = []
        for k, s in sorted(list(self.series.items())):
            counts = list(s["counts"])
            cum = 0
            for j, c in enumerate(counts[:-1]):
                cum += c
                lk = k + (("le", _num(self.buckets[j])),)
                lines.append(f"{self.name}_bucket{_fmt_labels(lk)} {cum}")
            lk = k + (("le", "+Inf"),)
            lines.append(f"{self.name}_bucket{_fmt_labels(lk)} "
                         f"{cum + counts[-1]}")
            lines.append(f"{self.name}_sum{_fmt_labels(k)} {_num(s['sum'])}")
            lines.append(f"{self.name}_count{_fmt_labels(k)} "
                         f"{sum(counts)}")
        return lines

    kind = "histogram"


def _num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


# ---------------------------------------------------------------------------


class Registry:
    """Get-or-create instrument registry with JSON + Prometheus export.

    The lock guards instrument creation and snapshot/exposition only —
    the per-observation hot path (``inc``/``set``/``observe``) never
    acquires it (see the module docstring's thread discipline).
    """
    enabled = True

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name, cls, help, **kw):
        inst = self._instruments.get(name)   # fast path: exists already
        if inst is None:
            with self._lock:
                inst = self._instruments.get(name)
                if inst is None:
                    inst = cls(name, help, **kw)
                    self._instruments[name] = inst
        if not isinstance(inst, cls):
            raise TypeError(f"{name} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help, buckets=buckets)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-JSON dict: {kind: {name: {labelstr: value}}}.
        Copy-under-lock: safe to call from a scrape thread while the
        engine thread observes."""
        with self._lock:
            insts = sorted(list(self._instruments.items()))
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, inst in insts:
            out[inst.kind + "s"][name] = inst.snapshot()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4); copy-under-lock
        like :meth:`snapshot`."""
        with self._lock:
            insts = sorted(list(self._instruments.items()))
        lines = []
        for name, inst in insts:
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            lines.extend(inst.expose())
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# disabled mode: shared no-op instruments, nothing allocated per call


class _NullInstrument:
    __slots__ = ()

    def inc(self, amount=1.0, **labels):
        return None

    def set(self, value, **labels):
        return None

    def observe(self, value, **labels):
        return None

    def value(self, **labels):
        return 0.0

    def percentile(self, p, **labels):
        return float("nan")


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    enabled = False

    def counter(self, name, help=""):
        return _NULL_INSTRUMENT

    def gauge(self, name, help=""):
        return _NULL_INSTRUMENT

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return _NULL_INSTRUMENT

    def snapshot(self):
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def prometheus_text(self):
        return ""


NULL_REGISTRY = NullRegistry()
