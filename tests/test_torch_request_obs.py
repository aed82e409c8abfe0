"""The port's request-scoped observability against the JAX package's:
per-request timelines (validated by both packages' validators, their
token, round and acceptance counts equal to the JAX engine's) and
Chrome tracks, SLO scoping and compliance, the flight recorder's
detectors, cooldown and cap, postmortem bundles and tamper detection,
and ``inter_token_gaps``."""
import asyncio
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.obs import request_trace as jrt  # noqa: E402
from repro.obs import schema as jschema  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.obs import (NULL_REQUEST_TRACKER, SLO,  # noqa: E402
                             FlightRecorder)
from repro_torch.obs.request_trace import (RequestTracker,  # noqa: E402
                                           inter_token_gaps, percentile_of,
                                           timelines_summary)
from repro_torch.obs.schema import (validate_postmortem_bundle,  # noqa: E402
                                    validate_request_timeline)
from repro_torch.obs.slo import SLOMonitor, as_slos  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402
from repro_torch.serving.server import AsyncServingServer  # noqa: E402

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
    """``n`` requests of two tenants, all arriving at t = 0."""
    rng = np.random.default_rng(seed)
    return [mod.ServeRequest(i, rng.integers(0, vocab, int(rng.integers(
                5, 13))).astype(np.int32),
            max_new_tokens=int(rng.integers(3, 8)),
            tenant="acme" if i % 2 else "beta") for i in range(n)]


def _port(models, **kw):
    _, (tt, td, ttp, tdp) = models
    te = tserve.ServingEngine(tt, td, device=CPU,
                              config=tserve.SchedulerConfig(**CFG, **kw))
    te.load(ttp, tdp)
    return te


@pytest.fixture(scope="module")
def tracked(models):
    """Request timelines + span tracer, one run of each package."""
    (jt, jd, jtp, jdp), (tt, _, _, _) = models
    te = _port(models, request_timeline=True, trace=True)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(
        request_timeline=True, trace=True, **CFG))
    je.load(jtp, jdp)
    out = []
    for eng, mod in ((te, tserve), (je, jserve)):
        reqs = _requests(mod, tt.vocab_size)
        for r in reqs:
            assert eng.submit(r)
        out.append(eng.run())
    return te, je, out[0], out[1]


# ---------------------------------------------------------------------------
# timelines: schema, phase accounting, per-request Chrome tracks


def test_timelines_validate_and_match_jax(tracked):
    te, je, done, jdone = tracked
    tls, jtls = te.request_timelines(), je.request_timelines()
    assert len(tls) == len(done) == 5
    for tl in tls:
        assert validate_request_timeline(tl) == []
        assert jschema.validate_request_timeline(tl) == []
    by_rid = {tl["rid"]: tl for tl in tls}
    jby_rid = {tl["rid"]: tl for tl in jtls}
    assert [tl["rid"] for tl in tls] == [tl["rid"] for tl in jtls]
    for r in done:
        tl, jtl = by_rid[r.rid], jby_rid[r.rid]
        assert tl["tokens"] == len(r.result)
        assert tl["tenant"] == r.tenant and tl["rejected"] is None
        for key in ("tokens", "tenant", "priority", "preemptions",
                    "accepted_total", "verify_rounds", "deliveries"):
            assert tl[key] == jtl[key], key
        assert [(p["round"], p["accepted"], p["emitted"])
                for p in tl["per_round"]] == \
            [(p["round"], p["accepted"], p["emitted"])
             for p in jtl["per_round"]]
        assert (sum(p["dur_s"] for p in tl["per_round"])
                <= tl["decode_s"] + 1e-9)
        assert tl["queue_s"] >= 0 and tl["stall_s"] >= 0
        p99 = tl["inter_token_p99_s"]
        assert p99 is None or p99 >= 0.0


def test_per_request_tracks_in_chrome_trace(tracked):
    te, _, done, _ = tracked
    evs = te.chrome_trace()["traceEvents"]
    tids = {e["args"]["name"]: e["tid"] for e in evs
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    for r in done:
        assert f"req:{r.rid}" in tids, f"missing req:{r.rid} track"
        spans = [e["name"] for e in evs
                 if e.get("ph") == "X" and e["tid"] == tids[f"req:{r.rid}"]]
        assert "queue" in spans and "prefill" in spans
        assert "verify" in spans


def test_request_decode_spans_inside_round_spans(tracked):
    te, _, _, _ = tracked
    evs = te.chrome_trace()["traceEvents"]
    tids = {e["tid"]: e["args"]["name"] for e in evs
            if e.get("ph") == "M" and e["name"] == "thread_name"}
    rounds = [(e["ts"], e["ts"] + e["dur"]) for e in evs
              if e.get("ph") == "X" and tids[e["tid"]] == "round"
              and e["name"] == "round"]
    verify = [(e["ts"], e["ts"] + e["dur"]) for e in evs
              if e.get("ph") == "X" and e.get("cat") == "request"
              and e["name"] == "verify"]
    assert rounds and verify
    tol = 1e3   # us
    for v0, v1 in verify:
        assert any(r0 - tol <= v0 and v1 <= r1 + tol
                   for r0, r1 in rounds), "verify span outside all rounds"


def test_timelines_summary_aggregates(tracked):
    te, je, done, _ = tracked
    s = timelines_summary(te.request_timelines())
    js = jrt.timelines_summary(je.request_timelines())
    assert s["requests"] == len(done)
    assert s["tokens"] == sum(len(r.result) for r in done)
    assert s["decode_s_total"] > 0.0
    for key in ("requests", "rejected", "tokens", "accepted_total",
                "verify_rounds_total"):
        assert s[key] == js[key], key


def test_token_parity_and_one_shape_traced_vs_untraced(models, tracked):
    te, _, done, jdone = tracked
    assert te.stats()["fused_compiles"] == 1
    plain = _port(models)                 # metrics only, no tracking
    assert plain.requests is NULL_REQUEST_TRACKER
    for r in _requests(tserve, plain.target_cfg.vocab_size):
        plain.submit(r)
    plain_done = plain.run()
    assert plain.stats()["fused_compiles"] == 1
    assert plain.request_timelines() == []
    want = {r.rid: list(map(int, r.result)) for r in jdone}
    assert {r.rid: list(map(int, r.result)) for r in done} == want
    assert {r.rid: list(map(int, r.result)) for r in plain_done} == want


# ---------------------------------------------------------------------------
# SLOs: scoping, monitor, violation -> exactly one postmortem bundle


def test_slo_scoping_and_normalization():
    slo = SLO("gold_ttft", "ttft_s", 0.5, tenant="acme", priority=0)
    assert slo.applies("acme", 0) and not slo.applies("acme", 1)
    assert not slo.applies("beta", 0)
    every = SLO("any", "e2e_s", 1.0)
    assert every.applies("x", 9)
    norm = as_slos([{"name": "n", "metric": "queue_s",
                     "threshold_s": 2.0}, every])
    assert norm[0].metric == "queue_s" and norm[1] is every
    assert norm[0].to_dict() == jslo.SLO("n", "queue_s", 2.0).to_dict()
    with pytest.raises(ValueError):
        SLO("bad", "nope_s", 1.0)


def test_slo_monitor_compliance_counts_match_jax():
    reports = []
    for mod, mon_mod in ((tserve, SLOMonitor), (jserve, jslo.SLOMonitor)):
        mon = mon_mod([{"name": "ttft", "metric": "ttft_s",
                        "threshold_s": 0.5},
                       {"name": "e2e", "metric": "e2e_s",
                        "threshold_s": 1.0, "tenant": "t"}])
        for rid, ttft, lat, tenant in ((0, 0.2, 0.5, "t"),
                                       (1, 3.0, 4.0, "t"),
                                       (2, 0.1, 9.0, "u")):
            r = mod.ServeRequest(rid, np.zeros(1, np.int32), tenant=tenant)
            r.first_token_s, r.latency_s = ttft, lat
            mon.observe_ttft(r)
            mon.observe_finish(r)
        reports.append(mon.report())
    rep, jrep = reports
    assert rep == jrep
    assert rep["violations"] == 2
    c = rep["compliance"]["ttft/t"]
    assert c["evaluated"] == 2 and c["compliance"] == 0.5
    assert rep["compliance"]["e2e/t"]["violations"] == 1
    assert "e2e/u" not in rep["compliance"]       # scoped to tenant t


def test_tight_ttft_slo_dumps_exactly_one_valid_bundle(models, tmp_path):
    """A two-tenant trace through the asyncio front door with an
    unmeetable TTFT objective: every request violates, and the cooldown
    collapses the storm into exactly one bundle, valid for both
    packages' validators."""
    te = _port(models, clock="real", qos=True, max_len=64,
               request_timeline=True,
               slos=({"name": "tight_ttft", "metric": "ttft_s",
                      "threshold_s": 1e-9},),
               postmortem_dir=str(tmp_path))
    rng = np.random.default_rng(1)

    async def drive():
        async with AsyncServingServer(te, max_queue=8) as srv:
            handles = []
            for i in range(4):
                p = rng.integers(0, te.target_cfg.vocab_size,
                                 6).astype(np.int32)
                handles.append(await srv.submit(
                    p, max_new_tokens=4,
                    tenant="acme" if i % 2 else "beta"))
            return [await srv.collect(h) for h in handles]

    streams = asyncio.run(drive())
    assert all(len(s) == 4 for s in streams)
    rep = te.slo_report()
    assert rep["violations"] == 4
    assert {k.split("/")[1] for k in rep["compliance"]} == {"acme", "beta"}
    assert te.stats()["slo_violations"] == 4
    bundles = [p for p in te.recorder.bundles
               if os.path.basename(p).endswith("slo_tight_ttft")]
    assert len(te.recorder.bundles) == len(bundles) == 1
    assert te.stats()["postmortems"] == 1
    assert validate_postmortem_bundle(bundles[0]) == []
    assert jschema.validate_postmortem_bundle(bundles[0]) == []
    with open(os.path.join(bundles[0], "manifest.json")) as f:
        assert json.load(f)["reason"] == "slo_tight_ttft"
    with open(os.path.join(bundles[0], "config.json")) as f:
        assert json.load(f)["slos"][0]["name"] == "tight_ttft"
    tls = te.request_timelines()
    assert sum(tl["deliveries"] for tl in tls) == sum(len(s)
                                                     for s in streams)


def test_bundle_tampering_detected(tmp_path):
    rec = FlightRecorder(capacity=8, out_dir=str(tmp_path), cooldown_s=0.0)
    rec.record_round({"round": 0, "t0": 1.0, "t1": 1.5})
    rec.record_instant("spike", {"depth": 9})
    path = rec.trigger("unit", {}, metrics={}, engine={
        "rounds": 1, "tokens_out": 0, "queue_depth": 9}, config={})
    assert path is not None and validate_postmortem_bundle(path) == []
    man_p = os.path.join(path, "manifest.json")
    with open(man_p) as f:
        man = json.load(f)
    man["schema"] = "bogus/v0"
    with open(man_p, "w") as f:
        json.dump(man, f)
    assert any("schema" in p for p in validate_postmortem_bundle(path))
    os.remove(os.path.join(path, "engine.json"))
    assert any("engine.json" in p for p in validate_postmortem_bundle(path))
    assert validate_postmortem_bundle(str(tmp_path / "none")) != []


# ---------------------------------------------------------------------------
# flight recorder: anomaly detectors, cooldown, bundle cap


def _signals(rec):
    """A fixed signal stream through a recorder: its detector hits."""
    hits = []
    for i in range(30):
        hits.append(rec.check(accept_mean=0.8 if i != 20 else 0.05,
                              busy_frac=0.9 if i != 25 else 0.1,
                              queue_depth=1 if i != 28 else 40))
    return hits


def test_recorder_detectors_match_jax():
    hits = _signals(FlightRecorder(warmup=4))
    assert hits == _signals(jslo.FlightRecorder(warmup=4))
    fired = [(i, h[0]) for i, h in enumerate(hits) if h is not None]
    assert fired == [(20, "accept_collapse"), (25, "busy_drop"),
                     (28, "queue_spike")]


def test_recorder_warmup_suppresses_detectors():
    rec = FlightRecorder(warmup=50)
    for _ in range(10):
        rec.check(accept_mean=0.8)
    assert rec.check(accept_mean=0.01) is None


def test_recorder_cooldown_and_cap(tmp_path):
    rec = FlightRecorder(out_dir=str(tmp_path), cooldown_s=3600.0)
    assert rec.trigger("a", metrics={}, engine={}, config={}) is not None
    assert rec.trigger("b", metrics={}, engine={}, config={}) is None
    assert len(rec.triggers) == 2 and len(rec.bundles) == 1
    capped = FlightRecorder(out_dir=str(tmp_path / "cap"), cooldown_s=0.0,
                            max_bundles=2)
    dumped = [capped.trigger(f"r{i}", metrics={}, engine={}, config={})
              for i in range(5)]
    assert sum(1 for p in dumped if p) == 2


def test_recorder_no_dir_never_touches_disk(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rec = FlightRecorder(out_dir=None, cooldown_s=0.0)
    sentinel = []
    assert rec.trigger("x", metrics=lambda: sentinel.append(1)) is None
    assert rec.triggers and rec.bundles == [] and sentinel == []
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# tracker units: inter-token cadence, preemption accounting, disabled mode


def test_inter_token_gaps_and_percentile():
    rounds = [{"emitted": 2, "t1": 1.0}, {"emitted": 0, "t1": 1.5},
              {"emitted": 1, "t1": 2.0}, {"emitted": 3, "t1": 2.1}]
    gaps = inter_token_gaps(rounds)
    assert gaps == [0.0, 1.0, pytest.approx(0.1), 0.0, 0.0]
    assert gaps == jrt.inter_token_gaps(rounds)
    assert percentile_of(gaps, 99) == pytest.approx(1.0)
    assert percentile_of([5.0], 50) == 5.0
    assert np.isnan(percentile_of([], 50))
    for p in (1, 50, 90, 100):
        assert percentile_of(gaps, p) == jrt.percentile_of(gaps, p)


def _preempted_timeline(tracker, mod):
    req = mod.ServeRequest(7, np.zeros(3, np.int32), max_new_tokens=8,
                           tenant="t")
    tracker.on_submit(req, wall=0.0)
    tracker.on_admit(req, 1.0, 1.25)
    req.first_token_s = 0.0
    tracker.on_round(req, 0, 1.3, 1.6, accepted=1, emitted=2)
    tracker.on_preempt(req, wall=2.0)
    tracker.on_admit(req, 3.0, 3.5, resumed=True)
    tracker.on_round(req, 5, 3.6, 3.9, accepted=0, emitted=1, role="verify")
    tracker.on_round(req, 6, 4.0, 4.2, role="draft")
    req.result = np.zeros(3, np.int32)
    tracker.on_finish(req, wall=4.5)
    return tracker.timeline(7)


def test_tracker_preemption_accounting_matches_jax():
    tl = _preempted_timeline(RequestTracker(), tserve)
    jtl = _preempted_timeline(jrt.RequestTracker(), jserve)
    assert json.dumps(tl, sort_keys=True) == json.dumps(jtl, sort_keys=True)
    assert validate_request_timeline(tl) == []
    assert tl["queue_s"] == pytest.approx(1.0)
    assert tl["preempted_s"] == pytest.approx(1.0)
    assert tl["preemptions"] == 1
    assert tl["prefill_s"] == pytest.approx(0.75)
    assert tl["decode_s"] == pytest.approx(0.8)
    assert tl["verify_rounds"] == 2 and tl["accepted_total"] == 1
    assert tl["stall_s"] == pytest.approx(3.5 - 0.75 - 0.8 - 1.0)


def test_null_tracker_is_shared_noop():
    assert NULL_REQUEST_TRACKER.enabled is False
    assert NULL_REQUEST_TRACKER.timelines() == []
    assert NULL_REQUEST_TRACKER.timeline(0) is None
    NULL_REQUEST_TRACKER.on_round(None, 0, 0.0, 1.0)   # never raises
