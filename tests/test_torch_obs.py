"""The port's observability (``repro_torch.obs``) against the JAX
package's ``repro.obs``: the registry, histogram percentiles and the
Prometheus text byte for byte on the same observations, label escaping,
the null tracer shared and allocation-free, the bubble union (of device
intervals where marks timed a span), device spans that never
synchronise and are resolved by the end of each round, and a
traced serving run whose streams, counters and Chrome trace agree with
an untraced one and with the JAX engine's (both packages' validators
accept the trace), with one fused-round shape."""
import dataclasses
import threading
import time
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.obs import NULL_OBS, Obs, make_obs  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402
from repro_torch.obs.metrics import (DEFAULT_BUCKETS,  # noqa: E402
                                     LATENCY_BUCKETS, NULL_REGISTRY,
                                     Registry, acceptance_buckets)
from repro_torch.obs.schema import (parse_prometheus_text,  # noqa: E402
                                    validate_chrome_trace,
                                    validate_metrics_snapshot)
from repro_torch.obs.trace import NULL_TRACER, Tracer, bubble_report  # noqa: E402,E501
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402

CPU = "cpu"
CFG = dict(max_batch=2, n_cand=2, block_size=4)


@pytest.fixture(scope="module")
def models():
    jt = J_MIXTRAL.reduced(d_model=64)
    jd = dataclasses.replace(J_MISTRAL.reduced(d_model=32,
                                               vocab=jt.vocab_size),
                             sliding_window=8)
    tt = MIXTRAL_8X7B.reduced(d_model=64)
    td = dataclasses.replace(MISTRAL_7B.reduced(d_model=32,
                                                vocab=tt.vocab_size),
                             sliding_window=8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtp, jdp = JM.init_params(jt, k1), JM.init_params(jd, k2)
    conv = lambda p, c: from_jax(jax.tree.map(np.asarray, p), c, CPU)
    return (jt, jd, jtp, jdp), (tt, td, conv(jtp, tt), conv(jdp, td))


def _requests(mod, vocab, n=5, seed=0):
    """``n`` requests arriving at t = 0 (the admission order depends on
    the policy alone, not on either engine's wall clock), prompts sharing
    an 8-token prefix."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    return [mod.ServeRequest(i, np.concatenate(
                [shared, rng.integers(0, vocab, int(rng.integers(2, 7)))]
            ).astype(np.int32), max_new_tokens=int(rng.integers(3, 8)))
            for i in range(n)]


def _serve(models, trace: bool, seed: int = 0, n: int = 5):
    """(port engine, JAX engine, port requests, JAX requests), both
    served to the end."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    te = tserve.ServingEngine(tt, td, device=CPU, config=tserve.SchedulerConfig(
        trace=trace, **CFG))
    te.load(ttp, tdp)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(
        trace=trace, **CFG))
    je.load(jtp, jdp)
    treqs = _requests(tserve, tt.vocab_size, n, seed)
    jreqs = _requests(jserve, jt.vocab_size, n, seed)
    for eng, reqs in ((te, treqs), (je, jreqs)):
        for r in reqs:
            assert eng.submit(r)
        assert len(eng.run()) == n
    return te, je, treqs, jreqs


@pytest.fixture(scope="module")
def traced(models):
    """One trace-enabled serving run of each package, shared below."""
    return _serve(models, trace=True)


# ---------------------------------------------------------------------------
# Chrome trace-event export


def test_chrome_trace_schema_by_both_validators(traced):
    te, _, _, _ = traced
    trace = te.chrome_trace()
    assert validate_chrome_trace(trace) == []
    assert jschema.validate_chrome_trace(trace) == []
    evs = trace["traceEvents"]
    assert any(e["ph"] == "X" for e in evs)
    assert any(e["ph"] == "i" for e in evs)
    assert trace["otherData"]["producer"] == "repro_torch.obs.trace"


def test_trace_tracks_match_jax(traced):
    """The port records the JAX engine's tracks, and the same number of
    spans of each name (counts depend on the schedule, not on time)."""
    te, je, _, _ = traced

    def summary(trace):
        evs = trace["traceEvents"]
        tracks = {e["args"]["name"] for e in evs
                  if e["ph"] == "M" and e["name"] == "thread_name"}
        names: dict = {}
        for e in evs:
            if e["ph"] in ("X", "i"):
                names[e["name"]] = names.get(e["name"], 0) + 1
        return tracks, names
    t_tracks, t_names = summary(te.chrome_trace())
    j_tracks, j_names = summary(je.chrome_trace())
    for track in ("round", "target_verify", "draft_generate", "rollback",
                  "prefill", "admit", "h2d"):
        assert track in t_tracks, f"missing {track} track"
    assert t_tracks == j_tracks
    assert t_names == j_names


def test_trace_ts_dur_sane(traced):
    te, _, _, _ = traced
    evs = [e for e in te.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert evs
    for e in evs:
        assert e["ts"] >= 0 and e["dur"] >= 0
    # the anti-phase twins: each fused verify span has a draft mirror
    # covering exactly the same interval
    verify = [e for e in evs if e["name"] == "verify(fused)"]
    draft = [e for e in evs if e["name"] == "draft(fused)"]
    assert len(verify) == len(draft) == te.stats()["rounds"]
    for ve, de in zip(verify, draft):
        assert ve["ts"] == pytest.approx(de["ts"], abs=1.0)
        assert ve["dur"] == pytest.approx(de["dur"], abs=1.0)


def test_virtual_clock_stamped(traced):
    te, _, _, _ = traced
    evs = [e for e in te.chrome_trace()["traceEvents"]
           if e["ph"] == "X" and "args" in e]
    assert any("virtual_s" in e["args"] for e in evs)


# ---------------------------------------------------------------------------
# bubble accounting (the paper's utilization metric)


def test_bubble_report_consistency_and_equal_to_jax_on_the_same_spans(traced):
    te, _, _, _ = traced
    util = te.metrics()["utilization"]
    assert util["rounds"] == te.stats()["rounds"]
    assert len(util["per_round"]) == util["rounds"]
    for r in util["per_round"]:
        assert 0.0 <= r["busy_frac"] <= 1.0
        assert r["busy_s"] + r["stall_s"] == pytest.approx(r["dur_s"],
                                                           rel=1e-6)
    assert util["busy_s"] + util["stall_s"] == pytest.approx(
        util["wall_s"], rel=1e-6)
    assert 0.0 < util["gpu_busy_frac"] <= 1.0
    # the JAX package's bubble_report reads the port's tracer alike
    assert jtrace.bubble_report(te.obs.tracer) == util


def test_bubble_union_does_not_double_count():
    tr = Tracer()
    with tr.span("round", "round"):
        with tr.span("target_verify", "v", cat="device") as sp:
            pass
    tr.complete("draft_generate", "d", sp.t0, sp.t1, cat="device")
    rep = bubble_report(tr)
    assert rep["rounds"] == 1
    assert rep["per_round"][0]["busy_s"] <= rep["per_round"][0]["dur_s"]
    assert rep["busy_s"] == pytest.approx(sp.t1 - sp.t0, abs=1e-6)
    assert jtrace.bubble_report(tr) == rep


def test_bubble_idle_rounds_excluded():
    tr = Tracer()
    with tr.span("round", "idle"):
        pass
    with tr.span("round", "round"):
        with tr.span("prefill", "p", cat="device"):
            pass
    rep = bubble_report(tr)
    assert rep["rounds"] == 1
    assert rep["idle_s"] >= 0.0
    assert jtrace.bubble_report(tr) == rep


def test_bubble_report_unions_device_intervals():
    """Spans timed by marks count their device intervals: a round's
    verify (1 ms) and draft (2 ms), which meet at the boundary mark,
    union to 3 ms, however short the host's walls around them."""
    src = _Stamps()
    tr = Tracer(marks=src)
    with tr.span("round", "round"):
        with tr.span("target_verify", "v", cat="device") as sp:
            b, m, e = (tr.mark(k) for k in ("round_begin", "draft_begin",
                                             "round_end"))
            sp.device(b, m)
        tr.complete("draft_generate", "d", sp.t0, sp.t1, cat="device",
                    device=(m, e))
        g0 = tr._real_ns + int(b[1] * 1e9) + 500_000
        for (slot, _), dt in zip((b, m, e), (0, 1_000_000, 3_000_000)):
            src.stamps[slot] = g0 + dt
        time.sleep(0.008)
    rep = bubble_report(tr)
    assert rep["rounds"] == 1
    assert rep["busy_s"] == pytest.approx(3e-3, abs=1e-7)
    assert rep["per_round"][0]["dur_s"] > 7e-3
    host = [e for e in tr.events if e["name"] in ("v", "d")]
    assert all(e["dur"] >= e["args"]["device_dur"] - 1e-3 for e in host)


# ---------------------------------------------------------------------------
# the serving run's metrics against JAX's


def test_traced_and_untraced_streams_equal_jax_with_one_fused_shape(models,
                                                                    traced):
    te, je, treqs, jreqs = traced
    plain, _, preqs, _ = _serve(models, trace=False)
    for tr, jr, pr in zip(treqs, jreqs, preqs):
        np.testing.assert_array_equal(tr.result, jr.result)
        np.testing.assert_array_equal(pr.result, tr.result)
    assert te.stats()["fused_compiles"] == plain.stats()["fused_compiles"] == 1
    # trace-off mode records no spans and no utilization report
    assert "utilization" not in plain.metrics()
    assert plain.chrome_trace()["traceEvents"] == []


def test_metrics_snapshot_matches_jax(traced):
    """Every counter, gauge and histogram that counts (not times)
    equals the JAX engine's; the timed ones carry the same label sets and
    observation counts."""
    te, je, _, _ = traced
    t, j = te.metrics()["metrics"], je.metrics()["metrics"]
    assert validate_metrics_snapshot(t) == []
    assert jschema.validate_metrics_snapshot(t) == []
    for kind in ("counters", "gauges", "histograms"):
        assert set(t[kind]) == set(j[kind]), kind
    timed = {"transfer_seconds_total", "admit_seconds", "serve_ttft_seconds"}
    for kind in ("counters", "gauges"):
        for name in set(t[kind]) - timed:
            assert t[kind][name] == j[kind][name], name
    for name, series in t["histograms"].items():
        if name in timed:
            assert {k: s["count"] for k, s in series.items()} == \
                {k: s["count"] for k, s in j["histograms"][name].items()}
        else:
            assert series == j["histograms"][name], name
    ctr = t["counters"]["pipeline_traces_total"]
    assert ctr['{entry="fused"}'] == 1 and ctr['{entry="rollback"}'] == 1
    assert t["counters"]["transfer_bytes_total"]['{tier="h2d"}'] > 0
    assert t["gauges"]["kv_blocks"]['{alloc="h0",state="used"}'] == 0
    hist = t["histograms"]["spec_accepted_tokens"][""]
    rate = hist["sum"] / (hist["count"] * CFG["n_cand"])
    assert hist["count"] > 0 and 0.0 <= rate <= 1.0


def test_fused_compiles_once_via_metrics_registry(models):
    """A default (metrics on, trace off) serving run reports exactly one
    fused shape through the registry, as the JAX engine does."""
    te, je, _, _ = _serve(models, trace=False, seed=3, n=4)
    for eng in (te, je):
        ctr = eng.metrics()["metrics"]["counters"]["pipeline_traces_total"]
        assert ctr['{entry="fused"}'] == 1
        assert ctr['{entry="rollback"}'] == 1
    parsed = parse_prometheus_text(te.prometheus())
    assert parsed["pipeline_traces_total"]["samples"][
        (("entry", "fused"),)] == 1.0


# ---------------------------------------------------------------------------
# registry and Prometheus exposition against the JAX package


NASTY = 'he"llo\n{x}\\'


def _observe(reg):
    """The same observations into either package's registry."""
    reg.counter("req_total", "requests").inc(3, tenant="a")
    reg.counter("req_total").inc(1, tenant="b")
    reg.counter("esc_total").inc(7, tenant=NASTY, ok="plain")
    reg.gauge("occupancy", "slots").set(0.625)
    reg.gauge("big").set(1e16)
    h = reg.histogram("acc", "accepted", buckets=acceptance_buckets(4))
    for v in (0, 1, 1, 4, 2):
        h.observe(v)
    lat = reg.histogram("lat", "latency", buckets=LATENCY_BUCKETS)
    for v in np.linspace(0.001, 150.0, 37):
        lat.observe(float(v), tenant="t1")
    reg.histogram("esc_lat", buckets=(1.0,)).observe(0.5, tenant=NASTY)
    reg.histogram("d", buckets=DEFAULT_BUCKETS).observe(0.042)
    return reg


def test_prometheus_text_byte_identical_to_jax():
    mine = _observe(Registry())
    theirs = _observe(jmetrics.Registry())
    assert mine.prometheus_text() == theirs.prometheus_text()
    assert mine.snapshot() == theirs.snapshot()
    parsed = parse_prometheus_text(mine.prometheus_text())
    assert parsed == jschema.parse_prometheus_text(theirs.prometheus_text())
    assert parsed["req_total"]["type"] == "counter"
    assert parsed["req_total"]["samples"][(("tenant", "a"),)] == 3.0
    assert parsed["occupancy"]["samples"][()] == 0.625
    buckets = parsed["acc_bucket"]["samples"]
    assert buckets[(("le", "0"),)] == 1.0          # cumulative
    assert buckets[(("le", "1"),)] == 3.0
    assert buckets[(("le", "+Inf"),)] == 5.0
    assert parsed["acc_sum"]["samples"][()] == 8.0
    assert parsed["acc_count"]["samples"][()] == 5.0


def test_prometheus_label_escaping_round_trip():
    reg = Registry()
    reg.counter("esc_total").inc(7, tenant=NASTY, ok="plain")
    reg.histogram("esc_lat", buckets=(1.0,)).observe(0.5, tenant=NASTY)
    text = reg.prometheus_text()
    assert '\\"' in text and "\\n" in text and "\\\\" in text
    assert "\n{x}" not in text            # a raw newline would split lines
    parsed = parse_prometheus_text(text)
    key = (("ok", "plain"), ("tenant", NASTY))
    assert parsed["esc_total"]["samples"][key] == 7.0
    assert parsed["esc_lat_count"]["samples"][(("tenant", NASTY),)] == 1.0


def test_histogram_percentiles_equal_jax():
    mine, theirs = Registry(), jmetrics.Registry()
    vals = np.linspace(0.0, 1.0, 201)
    for reg in (mine, theirs):
        h = reg.histogram("u", buckets=tuple(np.linspace(0, 1, 21)))
        for v in vals:
            h.observe(float(v))
        reg.histogram("x", buckets=acceptance_buckets(4)).observe(2.0)
    h, hj = mine.histogram("u"), theirs.histogram("u")
    for p in (0, 10, 50, 90, 99, 100):
        assert h.percentile(p) == hj.percentile(p)
        assert abs(h.percentile(p) - float(np.percentile(vals, p))) <= 0.05
    assert mine.histogram("x").percentile(50) == pytest.approx(2.0)
    assert h.percentile(100) == pytest.approx(1.0)


def test_histogram_percentile_edge_cases():
    reg = Registry()
    h = reg.histogram("edge", buckets=acceptance_buckets(4))
    assert np.isnan(h.percentile(50))
    assert np.isnan(h.percentile(50, tenant="ghost"))
    h.observe(3.0)
    for p in (0, 50, 100):
        assert h.percentile(p) == pytest.approx(3.0)
    h2 = reg.histogram("one_bucket", buckets=DEFAULT_BUCKETS)
    for _ in range(50):
        h2.observe(0.042)
    for p in (0, 25, 99, 100):
        assert h2.percentile(p) == pytest.approx(0.042)
    h3 = reg.histogram("spread", buckets=DEFAULT_BUCKETS)
    for v in (0.002, 0.3, 7.0):
        h3.observe(v)
    assert h3.percentile(0) == pytest.approx(0.002)
    assert h3.percentile(100) == pytest.approx(7.0)


def test_registry_kind_collision_rejected():
    reg = Registry()
    reg.counter("x_total")
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total").inc(-1)


def test_registry_concurrent_snapshot_while_observe():
    """A scrape from the event loop while the engine thread observes: no
    exception, and every histogram keeps count == +Inf cumulative."""
    reg = Registry()
    stop = threading.Event()
    errs: list = []

    def writer():
        i = 0
        try:
            while not stop.is_set():
                reg.counter("w_total").inc(1, shard=str(i % 37))
                reg.gauge("w_g").set(i, shard=str(i % 11))
                reg.histogram("w_h").observe((i % 100) / 100.0,
                                             shard=str(i % 7))
                i += 1
        except Exception as e:          # pragma: no cover - failure path
            errs.append(e)

    threads = [threading.Thread(target=writer) for _ in range(2)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            snap = reg.snapshot()
            assert validate_metrics_snapshot(snap) == []
            parse_prometheus_text(reg.prometheus_text())
            for series in snap["histograms"].get("w_h", {}).values():
                assert series["count"] == series["buckets"]["+Inf"]
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert errs == []


# ---------------------------------------------------------------------------
# disabled mode: shared, allocation-free; device marks and annotations


def _null_round(tr, reg):
    with tr.span("round", "round", stream=True) as sp:
        sp.device(tr.mark("round_begin"), tr.mark("draft_begin"))
        sp.set("k", 1)
        sp.rename("idle")
    tr.instant("admit", "admitted")
    tr.complete("draft_generate", "d", 0.0, 1.0, cat="device",
                device=(None, None))
    tr.resolve()
    reg.counter("c_total").inc(1.0, tier="h2d")
    reg.gauge("g").set(2.0)
    reg.histogram("h").observe(0.5)


def test_disabled_tracing_shares_one_span():
    assert NULL_TRACER.span("round", "round") is NULL_TRACER.span(
        "h2d", "stream", cat="device")
    assert NULL_OBS.enabled is False
    assert NULL_OBS.tracer.to_chrome_trace() == {"traceEvents": []}
    assert NULL_REGISTRY.prometheus_text() == ""


def test_disabled_tracing_no_retained_allocations():
    rounds = 5000
    _null_round(NULL_TRACER, NULL_REGISTRY)     # warm the call sites
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    for _ in range(rounds):
        _null_round(NULL_TRACER, NULL_REGISTRY)
    grown = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown < 4096, f"null obs retained {grown} bytes"

    live = Obs(Tracer(), Registry())
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    for _ in range(rounds):
        _null_round(live.tracer, live.metrics)
    grown_live = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown_live > 100 * 1024, "sanity: a live tracer retains events"


class _Stamps:
    """A stand-in stamp source: a mark's slot holds 0 until the marks run
    (``run``, or at once with ``auto``), as a card's ring holds nothing
    until the device runs them; a mark stamps the real time when it runs,
    plus ``lag_ns`` of queued device work for every mark after the
    first."""

    def __init__(self, auto=False):
        self.auto, self.log, self.stamps, self.released = auto, [], [], []

    def mark(self, kind, keep=False):
        self.log.append((kind, keep))
        self.stamps.append(time.time_ns() if self.auto else 0)
        return len(self.stamps) - 1

    def run(self, lag_ns=0):
        todo = [i for i, g in enumerate(self.stamps) if not g]
        for n, slot in enumerate(todo):
            self.stamps[slot] = time.time_ns() + (lag_ns if n else 0)

    def read(self, slot):
        return self.stamps[slot]

    def release(self, slot):
        self.released.append(slot)


def test_device_spans_never_synchronise(monkeypatch):
    """No span synchronises the card, with a stamp source or without:
    a stream span enqueues a mark at enter and exit and waits, unrecorded,
    for a resolve after the marks ran; the host spans record at exit."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: calls.append(dev))
    src = _Stamps()
    tr = Tracer(marks=src)
    with tr.span("prefill", "p", cat="device", stream=True):
        pass
    with tr.span("admit", "host"):
        pass
    assert [k for k, _ in src.log] == ["span", "span"]
    names = [e["name"] for e in tr.events if e["ph"] == "X"]
    assert names == ["host"]               # "p" waits for its marks
    tr.resolve()
    assert [e["name"] for e in tr.events if e["ph"] == "X"] == ["host"]
    src.run()
    tr.resolve()
    assert [e["name"] for e in tr.events if e["ph"] == "X"] == ["host", "p"]
    assert sorted(src.released) == [0, 1]
    with Tracer().span("prefill", "cpu", cat="device", stream=True):
        pass                               # no stamp source: the host
    assert calls == []


def test_device_span_resolved_by_the_end_of_run_step_reaching_its_end_mark():
    """A device span keeps ``ts`` at the host's entry and stretches
    ``dur`` to the device's end mark when the device ends later; ``args``
    hold the device interval, exactly the stamps' difference."""
    src = _Stamps()
    tr = Tracer(marks=src)
    with tr.span("prefill", "p", cat="device", stream=True) as sp:
        pass
    src.run(lag_ns=3_000_000)              # the device ends 3 ms later
    time.sleep(0.005)
    tr.resolve()
    (ev,) = [e for e in tr.events if e["ph"] == "X"]
    assert ev["ts"] == pytest.approx(tr._us(sp.t0))
    args = ev["args"]
    assert args["device_dur"] == (src.stamps[1] - src.stamps[0]) / 1e3
    assert ev["ts"] + ev["dur"] == pytest.approx(
        args["device_ts"] + args["device_dur"])
    assert ev["dur"] > (sp.t1 - sp.t0) * 1e6


def test_device_spans_resolved_by_the_end_of_run_step(models):
    """A serving run whose tracer has a (stand-in) stamp source: the
    round's marks run in order, and after every ``run_step`` no device
    span is left pending; the verify, draft, rollback, prefill and admit
    spans carry device intervals that their ``dur`` reaches."""
    _, (tt, td, ttp, tdp) = models
    eng = tserve.ServingEngine(tt, td, device=CPU, config=tserve.
                               SchedulerConfig(trace=True, **CFG))
    eng.load(ttp, tdp)
    src = eng.obs.tracer.marks = _Stamps(auto=True)
    for r in _requests(tserve, tt.vocab_size, n=3):
        assert eng.submit(r)
    while eng.has_work():
        eng.run_step()
        assert eng.obs.tracer._pending == []
    round_marks = [k for k, _ in src.log if k != "span"]
    assert round_marks == ["round_begin", "draft_begin", "round_end",
                           "rollback_begin", "rollback_end"] * \
        eng.stats()["rounds"]
    timed = {}
    for e in eng.obs.tracer.events:
        if e["ph"] == "X" and "device_ts" in e.get("args", {}):
            timed[e["name"]] = timed.get(e["name"], 0) + 1
            a = e["args"]
            assert e["ts"] + e["dur"] >= a["device_ts"] + a["device_dur"] \
                - 1e-3
    rounds = eng.stats()["rounds"]
    assert timed["verify(fused)"] == timed["draft(fused)"] == rounds
    assert timed["rollback"] == rounds
    assert timed["admit"] == timed["zigzag_prefill"] == 3
    assert sorted(src.released) == sorted(set(src.released))


def test_annotations_enter_record_function():
    tr = Tracer(annotations=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tr.span("target_verify", "verify(fused)", cat="device"):
            torch.ones(4) @ torch.ones(4)
    names = {e.key for e in prof.key_averages()}
    assert "target_verify/verify(fused)" in names
    assert ttrace.Tracer().use_annotations is False


def test_make_obs_modes():
    assert make_obs(trace=False, metrics=False) is NULL_OBS
    obs = make_obs(trace=True, metrics=False)
    assert obs.tracer.enabled and not obs.metrics.enabled
    assert obs.enabled
