"""Schema validation for the obs subsystem's two export formats.

Dependency-free validators (no jsonschema), the port's copy of
``repro/obs/schema.py``; the schema names (``repro.request_timeline/v1``,
``repro.postmortem/v1``) are the JAX package's, so either package's
validators read the other's exports:

* :func:`validate_chrome_trace` — Chrome trace-event JSON object format
  (the Perfetto / ``chrome://tracing`` input): required keys per event
  phase, non-negative ``ts``/``dur``, consistent pid/tid tracks, and a
  ``thread_name`` metadata event for every tid that carries spans.
* :func:`validate_metrics_snapshot` — the registry's JSON snapshot:
  kind sections, histogram bucket monotonicity, ``count`` == ``+Inf``
  cumulative count.
* :func:`parse_prometheus_text` — minimal exposition-format parser used
  by the round-trip test (``# TYPE`` tracking, label unpacking).

Validators return a list of problem strings — empty means valid — so
callers can assert ``== []`` and get every violation at once.

CLI::

    python -m repro_torch.obs.schema trace.json metrics.json
"""
from __future__ import annotations

import json
import re

_REQUIRED_BY_PHASE = {
    "X": ("name", "ts", "dur", "pid", "tid"),
    "i": ("name", "ts", "pid", "tid"),
    "C": ("name", "ts", "pid", "tid", "args"),
    "M": ("name", "pid", "args"),
}


def validate_chrome_trace(obj) -> list:
    """Problems with a Chrome trace-event JSON object ([] == valid)."""
    probs = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["'traceEvents' must be a list"]
    named_tids, span_tids = set(), set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            probs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _REQUIRED_BY_PHASE:
            probs.append(f"event {i}: unsupported phase {ph!r}")
            continue
        for key in _REQUIRED_BY_PHASE[ph]:
            if key not in ev:
                probs.append(f"event {i} (ph={ph}): missing {key!r}")
        if ph == "M" and ev.get("name") == "thread_name":
            named_tids.add((ev.get("pid"), ev.get("tid")))
        if ph in ("X", "i", "C"):
            span_tids.add((ev.get("pid"), ev.get("tid")))
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                probs.append(f"event {i}: ts {ts!r} not a number >= 0")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                probs.append(f"event {i}: dur {dur!r} not a number >= 0")
        if ph == "i" and ev.get("s") not in (None, "t", "p", "g"):
            probs.append(f"event {i}: instant scope {ev.get('s')!r}")
    for pidtid in sorted(span_tids - named_tids):
        probs.append(f"track {pidtid} has events but no thread_name "
                     f"metadata")
    return probs


def validate_metrics_snapshot(obj) -> list:
    """Problems with a Registry.snapshot() dict ([] == valid)."""
    probs = []
    if not isinstance(obj, dict):
        return ["snapshot must be an object"]
    for kind in ("counters", "gauges", "histograms"):
        if kind not in obj or not isinstance(obj[kind], dict):
            probs.append(f"missing {kind!r} section")
    for name, series in obj.get("counters", {}).items():
        for labels, v in series.items():
            if not isinstance(v, (int, float)) or v < 0:
                probs.append(f"counter {name}{labels}: {v!r} not >= 0")
    for name, series in obj.get("gauges", {}).items():
        for labels, v in series.items():
            if not isinstance(v, (int, float)):
                probs.append(f"gauge {name}{labels}: {v!r} not a number")
    for name, series in obj.get("histograms", {}).items():
        for labels, h in series.items():
            buckets = h.get("buckets")
            if not isinstance(buckets, dict) or "+Inf" not in buckets:
                probs.append(f"histogram {name}{labels}: no +Inf bucket")
                continue
            cum = list(buckets.values())
            if any(b > a for a, b in zip(cum[1:], cum[:-1])):
                probs.append(f"histogram {name}{labels}: cumulative "
                             f"bucket counts must be non-decreasing")
            if h.get("count") != buckets["+Inf"]:
                probs.append(f"histogram {name}{labels}: count "
                             f"{h.get('count')} != +Inf {buckets['+Inf']}")
    return probs


# ---------------------------------------------------------------------------
# minimal Prometheus exposition parser (round-trip testing)

# Label values are quoted strings with \\, \" and \n escapes (exposition
# format 0.0.4), so the label block is parsed as a sequence of quoted
# strings — a value may legally contain '}' or ','.
_QUOTED = r'"(?:[^"\\]|\\.)*"'
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>(?:[a-zA-Z_][a-zA-Z0-9_]*=" + _QUOTED
    + r",?)*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(
    r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    """Invert the exposition-format label escaping (\\\\, \\", \\n)."""
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt,
                                                             c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus_text(text: str) -> dict:
    """Parse exposition text into ``{name: {"type": t, "samples":
    {(sorted label items): float}}}`` (``_bucket``/``_sum``/``_count``
    series keep their suffixed names)."""
    out: dict = {}
    types: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(None, 3)
            types[name] = kind
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable sample line: {line!r}")
        name = m.group("name")
        labels = tuple(sorted(
            (lm.group("k"), _unescape_label(lm.group("v")))
            for lm in _LABEL_RE.finditer(m.group("labels") or "")))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        entry = out.setdefault(name, {"type": types.get(base, "untyped"),
                                      "samples": {}})
        entry["samples"][labels] = float(m.group("value"))
    return out


# ---------------------------------------------------------------------------
# request timelines (repro_torch.obs.request_trace)

_TIMELINE_SCHEMA = "repro.request_timeline/v1"
_TIMELINE_NUM = ("queue_s", "prefill_s", "decode_s", "stall_s",
                 "preempted_s")
_TIMELINE_INT = ("tokens", "preemptions", "accepted_total",
                 "verify_rounds")


def validate_request_timeline(tl) -> list:
    """Problems with one request-timeline digest ([] == valid)."""
    probs = []
    if not isinstance(tl, dict):
        return ["timeline must be an object"]
    if tl.get("schema") != _TIMELINE_SCHEMA:
        probs.append(f"schema {tl.get('schema')!r} != "
                     f"{_TIMELINE_SCHEMA!r}")
    if not isinstance(tl.get("rid"), int):
        probs.append("rid must be an int")
    rid = tl.get("rid", "?")
    for key in _TIMELINE_NUM:
        v = tl.get(key)
        if not isinstance(v, (int, float)) or v < 0:
            probs.append(f"rid {rid}: {key} {v!r} not a number >= 0")
    for key in _TIMELINE_INT:
        v = tl.get(key)
        if not isinstance(v, int) or v < 0:
            probs.append(f"rid {rid}: {key} {v!r} not an int >= 0")
    rounds = tl.get("per_round")
    if not isinstance(rounds, list):
        probs.append(f"rid {rid}: per_round must be a list")
    else:
        if (isinstance(tl.get("verify_rounds"), int)
                and tl["verify_rounds"] != len(rounds)):
            probs.append(f"rid {rid}: verify_rounds "
                         f"{tl['verify_rounds']} != per_round "
                         f"length {len(rounds)}")
        for i, r in enumerate(rounds):
            if not isinstance(r, dict) or not {"round", "dur_s",
                                               "accepted",
                                               "emitted"} <= set(r):
                probs.append(f"rid {rid}: per_round[{i}] missing keys")
            elif r["dur_s"] < 0 or r["accepted"] < 0 or r["emitted"] < 0:
                probs.append(f"rid {rid}: per_round[{i}] negative field")
        if (not probs and rounds
                and isinstance(tl.get("accepted_total"), int)):
            if sum(r["accepted"] for r in rounds) != tl["accepted_total"]:
                probs.append(f"rid {rid}: accepted_total != sum of "
                             f"per-round accepted")
    return probs


# ---------------------------------------------------------------------------
# postmortem bundles (repro_torch.obs.slo.FlightRecorder)

_BUNDLE_SCHEMA = "repro.postmortem/v1"
_BUNDLE_FILES = ("manifest.json", "trace.json", "metrics.json",
                 "engine.json", "config.json")
_ENGINE_DIGEST_KEYS = ("rounds", "tokens_out", "queue_depth")


def validate_postmortem_bundle(path: str) -> list:
    """Problems with an on-disk postmortem bundle ([] == valid): the
    five section files exist, the manifest matches the schema, the ring
    trace validates as a Chrome trace, the metrics snapshot validates,
    and the engine digest carries its required keys."""
    import os
    probs = []
    if not os.path.isdir(path):
        return [f"{path}: not a directory"]
    objs = {}
    for fname in _BUNDLE_FILES:
        fp = os.path.join(path, fname)
        if not os.path.isfile(fp):
            probs.append(f"missing {fname}")
            continue
        try:
            with open(fp) as f:
                objs[fname] = json.load(f)
        except ValueError as e:
            probs.append(f"{fname}: not valid JSON ({e})")
    man = objs.get("manifest.json")
    if man is not None:
        if man.get("schema") != _BUNDLE_SCHEMA:
            probs.append(f"manifest schema {man.get('schema')!r} != "
                         f"{_BUNDLE_SCHEMA!r}")
        for key in ("reason", "bundle_seq", "ring_rounds"):
            if key not in man:
                probs.append(f"manifest missing {key!r}")
    if "trace.json" in objs:
        probs += [f"trace: {p}"
                  for p in validate_chrome_trace(objs["trace.json"])]
    if "metrics.json" in objs:
        snap = objs["metrics.json"]
        snap = snap.get("metrics", snap)   # accept both wrapper shapes
        if snap:                            # empty == metrics disabled
            probs += [f"metrics: {p}"
                      for p in validate_metrics_snapshot(snap)]
    eng = objs.get("engine.json")
    if eng is not None:
        for key in _ENGINE_DIGEST_KEYS:
            if key not in eng:
                probs.append(f"engine digest missing {key!r}")
    if "config.json" in objs and not isinstance(objs["config.json"],
                                                dict):
        probs.append("config.json must be an object")
    return probs


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="validate obs trace/metrics JSON exports")
    ap.add_argument("trace", help="Chrome trace-event JSON path")
    ap.add_argument("metrics", nargs="?",
                    help="metrics snapshot JSON path (optional)")
    ap.add_argument("--bundle", action="append", default=[],
                    help="postmortem bundle directory to validate "
                         "(repeatable)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        probs = validate_chrome_trace(json.load(f))
    for p in probs:
        print(f"trace: {p}")
    n_events = 0
    with open(args.trace) as f:
        n_events = len(json.load(f).get("traceEvents", []))
    print(f"{args.trace}: {n_events} events, "
          f"{'OK' if not probs else f'{len(probs)} problems'}")
    if args.metrics:
        with open(args.metrics) as f:
            obj = json.load(f)
        # the bench writes {"metrics": snapshot, ...}; accept both shapes
        snap = obj.get("metrics", obj)
        mp = validate_metrics_snapshot(snap)
        for p in mp:
            print(f"metrics: {p}")
        print(f"{args.metrics}: "
              f"{'OK' if not mp else f'{len(mp)} problems'}")
        probs += mp
    for bundle in args.bundle:
        bp = validate_postmortem_bundle(bundle)
        for p in bp:
            print(f"bundle {bundle}: {p}")
        print(f"{bundle}: {'OK' if not bp else f'{len(bp)} problems'}")
        probs += bp
    return 1 if probs else 0


if __name__ == "__main__":
    raise SystemExit(main())
