"""The port's asyncio front door (``repro_torch.serving.server``) and the
QoS, preemption, bounded-queue and replanning paths of its scheduler,
against the JAX package's engine on the same weights: stream parity with
the closed loop, backpressure and its timeout, submit after drain,
weighted fairness, lossless preemption driven round by round (equal to
JAX's streams and events and to the greedy decode), the open-loop
multi-tenant replay, ``max_queue`` rejections and ``replan_events``."""
import asyncio
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro.serving import trace as jtrace  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402
from repro_torch.serving.server import (AsyncServingServer,  # noqa: E402
                                        RequestRejected)
from repro_torch.serving.trace import (replay_open_loop,  # noqa: E402
                                       tenant_poisson_requests)

CPU = "cpu"


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


def _engines(models, jax_too=False, **kw):
    """The port's engine (and the JAX package's) with
    ``SchedulerConfig(max_batch=2, n_cand=2, clock="real", max_len=48)``
    updated by ``kw``."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    cfg = dict(max_batch=2, n_cand=2, clock="real", max_len=48,
               block_size=4)
    cfg.update(kw)
    te = tserve.ServingEngine(tt, td, device=CPU,
                              config=tserve.SchedulerConfig(**cfg))
    te.load(ttp, tdp)
    if not jax_too:
        return te
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    return te, je


def _prompts(n, rng, vocab, lo=5, hi=13):
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _greedy(params, cfg, prompt, steps):
    """The port's target-only greedy decode (prefill + decode_step)."""
    cache = init_cache(cfg, 1, len(prompt) + steps + 1, CPU)
    lg, cache = TM.prefill(params, cfg, torch.as_tensor(prompt[None]).long(),
                           cache)
    out = []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        out.append(int(tok[0]))
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None])
    return np.asarray(out)


def test_server_requires_real_clock(models):
    with pytest.raises(ValueError):
        AsyncServingServer(_engines(models, clock="virtual"))
    with pytest.raises(ValueError):
        _engines(models, clock="wall")


def test_stream_parity_with_closed_loop(models):
    """Tokens streamed by the front door equal the closed-loop run() of
    the port and of the JAX engine, and the greedy decode."""
    _, (tt, _, ttp, _) = models
    rng = np.random.default_rng(0)
    prompts = _prompts(5, rng, tt.vocab_size)
    gens = [int(g) for g in rng.integers(3, 8, 5)]
    closed, jclosed = _engines(models, jax_too=True, clock="virtual")
    want = []
    for eng, mod in ((closed, tserve), (jclosed, jserve)):
        for i, (p, g) in enumerate(zip(prompts, gens)):
            eng.submit(mod.ServeRequest(i, p, g))
        want.append({r.rid: list(map(int, r.result)) for r in eng.run()})
    assert want[0] == want[1]

    se = _engines(models)

    async def drive():
        async with AsyncServingServer(se, max_queue=8) as srv:
            handles = [await srv.submit(p, g, rid=i)
                       for i, (p, g) in enumerate(zip(prompts, gens))]
            outs = await asyncio.gather(*[srv.collect(h) for h in handles])
        return {h.rid: o for h, o in zip(handles, outs)}

    streamed = asyncio.run(drive())
    assert streamed == want[0]
    for i, (p, g) in enumerate(zip(prompts, gens)):
        assert streamed[i] == _greedy(ttp, tt, p, g).tolist()
    assert not se.has_work()
    assert se.stats()["fused_compiles"] == 1


def test_backpressure_bounds_queue_and_timeout_rejects(models):
    se = _engines(models, max_batch=1)
    prompts = _prompts(8, np.random.default_rng(1), se.target_cfg.vocab_size)

    async def drive():
        rejected = []
        async with AsyncServingServer(se, max_queue=2,
                                      submit_timeout_s=0.02) as srv:
            handles = []
            for i, p in enumerate(prompts):
                try:
                    handles.append(await srv.submit(p, 6, rid=i))
                except RequestRejected as e:
                    rejected.append(e.reason)
                assert srv._depth() <= 2          # the bound holds
            outs = await asyncio.gather(*[srv.collect(h) for h in handles])
        return handles, outs, rejected

    handles, outs, rejected = asyncio.run(drive())
    assert all(r == "backpressure_timeout" for r in rejected)
    assert len(handles) + len(rejected) == len(prompts)
    assert all(len(o) == 6 for o in outs)
    assert se.obs.metrics.counter("serve_requests_rejected_total").value(
        reason="backpressure_timeout", tenant="default") == len(rejected)
    assert se.stats()["rejected"] == len(rejected)


def test_submit_after_drain_rejected(models):
    se = _engines(models)

    async def drive():
        srv = AsyncServingServer(se)
        await srv.start()
        h = await srv.submit(np.arange(5, dtype=np.int32), 3)
        toks = await srv.collect(h)
        await srv.drain()
        assert len(toks) == 3
        with pytest.raises(RequestRejected) as e:
            await srv.submit(np.arange(5, dtype=np.int32), 3)
        assert e.value.reason == "draining"

    asyncio.run(drive())


def test_weighted_fairness_two_tenants(models):
    """A flood from tenant a must not starve tenant b: b's last admission
    beats a's though all of a was submitted first.  Driven round by round
    on the virtual clock, the admission order equals the JAX engine's."""
    se = _engines(models, max_batch=1, qos=True,
                  tenant_weights={"a": 1.0, "b": 1.0})
    rng = np.random.default_rng(2)
    pa = _prompts(6, rng, se.target_cfg.vocab_size)
    pb = _prompts(2, rng, se.target_cfg.vocab_size)

    async def drive():
        async with AsyncServingServer(se, max_queue=16) as srv:
            a = [await srv.submit(p, 6, tenant="a") for p in pa]
            b = [await srv.submit(p, 6, tenant="b") for p in pb]
            await asyncio.gather(*[srv.collect(h) for h in a + b])
        return a, b

    a, b = asyncio.run(drive())
    assert max(r.admitted_s for r in b) < max(r.admitted_s for r in a)
    assert all(len(r.result) == 6 for r in a + b)

    orders = []
    for eng, mod in zip(_engines(models, jax_too=True, max_batch=1, qos=True,
                                 clock="virtual",
                                 tenant_weights={"a": 2.0, "b": 1.0}),
                        (tserve, jserve)):
        reqs = ([mod.ServeRequest(i, p, 6, tenant="a")
                 for i, p in enumerate(pa)]
                + [mod.ServeRequest(10 + i, p, 6, tenant="b")
                   for i, p in enumerate(pb)])
        for r in reqs:
            eng.submit(r)
        while eng.has_work():
            eng.run_step()
        orders.append([(r.rid, r.tenant) for r in
                       sorted(reqs, key=lambda r: r.admitted_s)])
        assert eng.stats()["fused_compiles"] == 1
    assert orders[0] == orders[1]
    assert orders[0][-1][1] == "a"


def test_preemption_lossless_against_jax_and_greedy(models):
    """Both slots of each half hold low-priority long decodes; a
    priority-0 request submitted after round 4 preempts one.  Driven
    round by round, the port's victims, preemption counts, admission
    order and streams equal the JAX engine's, and every stream (the
    preempted and resumed ones included) equals the greedy decode."""
    _, (tt, _, ttp, _) = models
    rng = np.random.default_rng(3)
    long_p = _prompts(4, rng, tt.vocab_size)
    short_p = _prompts(1, rng, tt.vocab_size)[0]
    results = []
    for eng, mod in zip(_engines(models, jax_too=True, max_batch=2, qos=True,
                                 preempt=True, preempt_min_remaining=2,
                                 max_len=64, clock="virtual"),
                        (tserve, jserve)):
        longs = [mod.ServeRequest(i, p, 14, priority=2)
                 for i, p in enumerate(long_p)]
        short = mod.ServeRequest(9, short_p, 3, priority=0)
        for r in longs:
            eng.submit(r)
        for _ in range(4):
            eng.run_step()
        assert not any(s.done for half in eng._slots for s in half)
        eng.submit(short)
        steps = 0
        while eng.has_work():
            eng.run_step()
            steps += 1
        victims = [r.rid for r in longs if r.preemptions > 0]
        assert victims, "a long decode should have been preempted"
        assert eng.preempted_total == sum(r.preemptions for r in longs)
        assert short.finished_s <= min(r.finished_s for r in longs
                                       if r.preemptions > 0)
        results.append((victims, eng.stats()["preempted"], steps,
                        [r.rid for r in sorted(longs + [short],
                                               key=lambda r: r.admitted_s)],
                        [r.result.tolist() for r in longs + [short]],
                        [r.progress for r in longs]))
        if mod is tserve:
            for r in longs + [short]:
                np.testing.assert_array_equal(
                    r.result, _greedy(ttp, tt, r.prompt, r.max_new_tokens),
                    err_msg=f"rid {r.rid} vs greedy")
            assert eng.stats()["fused_compiles"] == 1
            snap = eng.metrics()["metrics"]["counters"]
            assert snap["serve_requests_preempted_total"][
                '{tenant="default"}'] == eng.preempted_total
    assert results[0] == results[1]


def test_open_loop_replay_multi_tenant(models):
    rng = np.random.default_rng(4)
    se = _engines(models, qos=True, preempt=True)
    prompts = _prompts(6, rng, se.target_cfg.vocab_size)
    tenants = {"acme": {"share": 2.0, "priority": 1},
               "beta": {"share": 1.0, "priority": 0}}
    reqs = tenant_poisson_requests(prompts, 5, 50.0, tenants, seed=5)
    jreqs = jtrace.tenant_poisson_requests(prompts, 5, 50.0, tenants, seed=5)
    assert [(r.tenant, r.priority, r.arrival_s) for r in reqs] == \
        [(r.tenant, r.priority, r.arrival_s) for r in jreqs]
    assert len({r.tenant for r in reqs}) == 2

    async def drive():
        async with AsyncServingServer(se, max_queue=8) as srv:
            tokens, handles = await replay_open_loop(srv, reqs, speed=50.0)
            report = srv.tenant_report()
        return tokens, handles, report

    tokens, handles, report = asyncio.run(drive())
    assert len(handles) == len(reqs) and not se.has_work()
    assert all(len(t) == 5 for t in tokens.values())
    assert set(report) == {"acme", "beta"}
    assert sum(d["requests"] for d in report.values()) == len(reqs)
    snap = se.metrics()["metrics"]["histograms"]["serve_ttft_seconds"]
    assert sum(s["count"] for s in snap.values()) == len(reqs)


def test_max_queue_rejections_match_jax(models):
    """A bounded queue of 3: the 4th..6th submissions are rejected as
    queue_full in both packages, counted per tenant alike."""
    outs = []
    for eng, mod in zip(_engines(models, jax_too=True, max_queue=3,
                                 clock="virtual"), (tserve, jserve)):
        prompts = _prompts(6, np.random.default_rng(6),
                           eng.target_cfg.vocab_size)
        oks = [eng.submit(mod.ServeRequest(i, p, 4,
                                           tenant="t" + str(i % 2)))
               for i, p in enumerate(prompts)]
        done = eng.run()
        snap = eng.metrics()["metrics"]["counters"]
        outs.append((oks, eng.stats()["rejected"],
                     snap["serve_requests_rejected_total"],
                     {r.rid: r.result.tolist() for r in done}))
    assert outs[0] == outs[1]
    assert outs[0][0] == [True] * 3 + [False] * 3


@pytest.mark.parametrize("knobs", [
    dict(replan_threshold=0.05, replan_interval=2),
    dict(replan_accept_drift=0.05, replan_interval=3)],
    ids=["occupancy", "acceptance"])
def test_replan_events_match_jax(models, knobs):
    """Online replanning on the same trace with the same hardware spec:
    the port's replan events (round, occupancy, acceptance, policy, tree,
    modeled throughput) equal the JAX engine's."""
    events = []
    for eng, mod in zip(_engines(models, jax_too=True, clock="virtual",
                                 **knobs), (tserve, jserve)):
        prompts = _prompts(6, np.random.default_rng(7),
                           eng.target_cfg.vocab_size)
        for i, p in enumerate(prompts):
            eng.submit(mod.ServeRequest(i, p, 3 + 2 * i))
        eng.run()
        events.append([(e["round"], e["occupancy"], e["accept_rate"],
                        dataclasses.astuple(e["policy"]), e["tree"],
                        e["throughput"]) for e in eng.replan_events])
        if mod is tserve:
            assert eng.stats()["replans"] == len(eng.replan_events) > 0
            snap = eng.metrics()["metrics"]
            assert snap["counters"]["planner_searches_total"][""] >= 1
            assert snap["gauges"]["serve_replans_total"][""] == \
                len(eng.replan_events)
    assert events[0] == events[1]


def test_preemption_lossless_where_the_moe_prefill_drops():
    """Eight experts at capacity factor 2 (Mixtral's): the prefill's MoE
    dispatch is capacity-bound, and an 80-token prompt drops tokens.  The
    port resumes a preempted request by prefilling its prompt as at its
    first admission and decoding its progress, so every stream equals the
    greedy decode; the JAX engine prefills prompt + progress in one pass,
    which routes other tokens, and its resumed stream leaves the greedy
    one (the reason the port resumes differently)."""
    jt = J_MIXTRAL.reduced(d_model=64, n_experts=8)
    tt = MIXTRAL_8X7B.reduced(d_model=64, n_experts=8)
    jd = J_MISTRAL.reduced(d_model=32, vocab=jt.vocab_size)
    td = MISTRAL_7B.reduced(d_model=32, vocab=tt.vocab_size)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtp, jdp = JM.init_params(jt, k1), JM.init_params(jd, k2)
    conv = lambda p, c: from_jax(jax.tree.map(np.asarray, p), c, CPU)
    ttp, tdp = conv(jtp, tt), conv(jdp, td)
    rng = np.random.default_rng(0)
    long_p = [rng.integers(0, tt.vocab_size, 80).astype(np.int32)
              for _ in range(4)]
    short_p = rng.integers(0, tt.vocab_size, 40).astype(np.int32)
    cfg = dict(max_batch=2, n_cand=2, qos=True, preempt=True,
               preempt_min_remaining=2, max_len=128, block_size=4)
    te = tserve.ServingEngine(tt, td, device=CPU,
                              config=tserve.SchedulerConfig(**cfg))
    te.load(ttp, tdp)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    matches = []
    for eng, mod in ((te, tserve), (je, jserve)):
        longs = [mod.ServeRequest(i, p, 14, priority=2)
                 for i, p in enumerate(long_p)]
        reqs = longs + [mod.ServeRequest(9, short_p, 3, priority=0)]
        for r in longs:
            eng.submit(r)
        for _ in range(4):
            eng.run_step()
        eng.submit(reqs[-1])
        while eng.has_work():
            eng.run_step()
        assert [r.preemptions for r in reqs] == [0, 0, 0, 1, 0]
        matches.append([bool((r.result == _greedy(
            ttp, tt, r.prompt, r.max_new_tokens)).all()) for r in reqs])
    assert matches[0] == [True] * 5
    assert matches[1] == [True, True, True, False, True]
    assert te.stats()["fused_compiles"] == 1
