"""The port's engine and scheduler against the JAX package's on the same
weights: ``SpecOffloadEngine.generate`` tokens, and the continuous-
batching ``ServingEngine`` stream over one Poisson trace with mid-flight
admission and prefix sharing — equal to the JAX engine's stream and to
the port's own target-only greedy decode, with one fused-round shape."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.core.pipeline import SpecOffloadEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro.serving.trace import poisson_requests as j_poisson  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402
from repro_torch.serving.trace import poisson_requests  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def models():
    """Target/draft configs of both packages (the draft's ring wraps) and
    one set of JAX weights converted to the port."""
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


def _greedy(params, cfg, prompt, steps):
    """The port's target-only greedy decode (prefill + decode_step)."""
    cache = init_cache(cfg, 1, len(prompt) + steps + 1, CPU)
    lg, cache = TM.prefill(params, cfg,
                           torch.as_tensor(prompt[None]).long(), cache)
    out = []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        out.append(int(tok[0]))
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None])
    return np.asarray(out)


def test_generate_matches_jax(models):
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    prompts = np.random.default_rng(0).integers(
        0, tt.vocab_size, (4, 10)).astype(np.int32)
    je = JEngine(jt, jd)
    je.load(jtp, jdp)
    want = je.generate(prompts, gen_len=8, n_cand=2)
    te = SpecOffloadEngine(tt, td, device=CPU)
    te.load(ttp, tdp)
    got = te.generate(prompts, gen_len=8, n_cand=2)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.rounds == want.rounds
    assert te.pipeline(2).trace_counts["fused"] == 1
    for r in range(prompts.shape[0]):
        np.testing.assert_array_equal(got.tokens[r],
                                      _greedy(ttp, tt, prompts[r], 8))


def _trace(vocab, mod, rate_rps=40.0):
    """7 requests, two prompt lengths, a shared 8-token prefix, mixed
    generation lengths, arrivals faster than the 4 slots drain."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               .astype(np.int32) for n in (5, 2, 5, 2, 5, 2, 5)]
    gens = rng.integers(3, 10, len(prompts)).tolist()
    return mod(prompts, gens, rate_rps=rate_rps, seed=7)


def test_serving_stream_matches_jax_and_greedy(models):
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    cfg = dict(max_batch=2, n_cand=2, block_size=4)
    je = jserve.ServingEngine(jt, jd,
                              config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    jreqs = _trace(jt.vocab_size, j_poisson)
    for r in jreqs:
        je.submit(r)
    je.run()
    te = tserve.ServingEngine(tt, td, config=tserve.SchedulerConfig(**cfg),
                              device=CPU)
    te.load(ttp, tdp)
    treqs = _trace(tt.vocab_size, poisson_requests)
    for r in treqs:
        te.submit(r)
    done = te.run()
    assert len(done) == len(treqs) and te.pending() == 0
    assert any(r.queue_s > 0 for r in treqs), "no mid-flight admission"
    assert te.kv_stats()["prefix_hits"] > 0
    counts = te.engine.pipeline(2).trace_counts
    assert counts["fused"] == 1 and counts["rollback"] == 1
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
        np.testing.assert_array_equal(
            tr.result, _greedy(ttp, tt, tr.prompt, tr.max_new_tokens),
            err_msg=f"rid {tr.rid} vs greedy")
    st = te.stats()
    assert st["rounds"] > 0 and 0 < st["mean_occupancy"] <= 1
    assert st["round_s_p50"] <= st["round_s_p95"]
    assert te.throughput(done) > 0


def test_sjf_bucketed_int8_stream_matches_jax(models):
    """Shortest-job-first admission, length-bucketed prompts and an int8
    pool (quantize on write) give the JAX engine's streams exactly.  All
    requests arrive at once, so the admission order depends on the
    policy alone, not on either engine's wall clock."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    cfg = dict(max_batch=2, n_cand=2, block_size=4, admission="sjf",
               length_bucket=8, kv_quant_cold=True)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    te = tserve.ServingEngine(tt, td, config=tserve.SchedulerConfig(**cfg),
                              device=CPU)
    te.load(ttp, tdp)
    jreqs = _trace(jt.vocab_size, j_poisson, rate_rps=1e6)
    treqs = _trace(tt.vocab_size, poisson_requests, rate_rps=1e6)
    for eng, reqs in ((je, jreqs), (te, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert [r.rid for r in sorted(treqs, key=lambda r: r.admitted_s)] == \
        [r.rid for r in sorted(jreqs, key=lambda r: r.admitted_s)]
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.admitted_prompt, jr.admitted_prompt)
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
    assert te.kv_stats()["pool_bytes_total"] < \
        je.kv_stats()["pool_bytes_total"] * 1.01


def test_contiguous_sjf_bucketed_stream_matches_jax(models):
    """``paged=False`` (per-slot contiguous caches, dummy-parked slots,
    whole-cache splice on admission) with SJF and length buckets gives
    the JAX engine's streams and KV accounting exactly."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    cfg = dict(max_batch=2, n_cand=2, admission="sjf", length_bucket=8,
               paged=False)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    te = tserve.ServingEngine(tt, td, config=tserve.SchedulerConfig(**cfg),
                              device=CPU)
    te.load(ttp, tdp)
    jreqs = _trace(jt.vocab_size, j_poisson, rate_rps=1e6)
    treqs = _trace(tt.vocab_size, poisson_requests, rate_rps=1e6)
    for eng, reqs in ((je, jreqs), (te, treqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
    assert te.kv_stats() == je.kv_stats()
    assert te.engine.pipeline(2).trace_counts["fused"] == 1


def test_submit_rejects_what_never_fits(models):
    _, (tt, td, ttp, tdp) = models
    te = tserve.ServingEngine(tt, td, device=CPU, config=tserve.SchedulerConfig(
        max_batch=1, n_cand=2, block_size=4, num_blocks=4))
    req = tserve.ServeRequest(0, np.zeros(12, np.int32), max_new_tokens=8)
    assert te.submit(req) is False and req.rejected == "never_fits"
    assert te.pending() == 0


def test_launcher_serves_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--gen", "4",
                "--prompt-len", "6", "--rate", "5"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "fused compiles=1" in out


def test_launcher_serves_async_with_timelines_on_cpu(capsys):
    """``--async --timelines``: the two-tenant open-loop replay through
    the asyncio front door, per-tenant TTFT lines, the timeline digest
    and the SLO compliance lines."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--async", "--timelines", "--requests",
                "5", "--gen", "6", "--prompt-len", "10", "--rate", "3",
                "--slo-ttft", "30"])
    out = capsys.readouterr().out
    assert "async-served 5 requests" in out and "fused compiles=1" in out
    assert "drained=True" in out
    assert "tenant acme:" in out and "tenant beta:" in out
    assert "timelines: 5 reqs" in out and "slo ttft/" in out


def _burst(vocab, mod):
    """9 requests arriving at once: a shared 8-token prefix, mixed prompt
    and generation lengths."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               .astype(np.int32) for n in (5, 2, 5, 2, 5, 2, 5, 3, 4)]
    gens = rng.integers(4, 12, len(prompts)).tolist()
    return mod(prompts, gens, rate_rps=1e6, seed=3)


BURST_CASES = {
    "paged_eos": dict(eos_id=113),
    "paged_eos_14_blocks": dict(eos_id=113, num_blocks=14),
    "paged_sjf_14_blocks": dict(admission="sjf", num_blocks=14),
    "contiguous_eos": dict(eos_id=113, paged=False),
    "paged_eos_ncand3_bucket8": dict(eos_id=113, n_cand=3, length_bucket=8),
}


@pytest.mark.parametrize("case", sorted(BURST_CASES))
def test_burst_matches_jax(models, case):
    """Nine requests at once against the JAX engine, with early EOS
    retirement, admission under block pressure (14 blocks a half), SJF,
    the contiguous cache and a length bucket: the streams, the admission
    order, ``kv_stats()`` and the ``stats()`` counters are equal."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    cfg = dict(dict(max_batch=2, n_cand=2, block_size=4), **BURST_CASES[case])
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    te = tserve.ServingEngine(tt, td, config=tserve.SchedulerConfig(**cfg),
                              device=CPU)
    te.load(ttp, tdp)
    jreqs = _burst(jt.vocab_size, j_poisson)
    treqs = _burst(tt.vocab_size, poisson_requests)
    for eng, reqs in ((je, jreqs), (te, treqs)):
        for r in reqs:
            assert eng.submit(r)
        eng.run()
    order = lambda reqs: [r.rid for r in sorted(reqs,
                                                key=lambda r: r.admitted_s)]
    assert order(treqs) == order(jreqs)
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
    if cfg.get("eos_id", -1) >= 0:
        stopped = [r for r in treqs if len(r.result) < r.max_new_tokens]
        assert stopped and all(r.result[-1] == cfg["eos_id"]
                               for r in stopped)
    assert te.kv_stats() == je.kv_stats()
    ts, js = te.stats(), je.stats()
    for k in ("rounds", "tokens_out", "fused_compiles", "rejected"):
        assert ts[k] == js[k], k
    assert ts["fused_compiles"] == 1
