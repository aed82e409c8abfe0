"""The port's recurrent families and its contiguous serving path against
the JAX package on the same weights (``params.from_jax``):

* RecurrentGemma (RG-LRU + sliding-window attention) and RWKV-6 at
  ``reduced(d_model=64)``: prefill logits over a prompt longer than the
  reduced window of 64 (RecurrentGemma's ring wraps), multi-token decode
  logits, f32 at atol 1e-4, and the recurrent state after a partial
  commit equal to JAX's ``commit_cache``;
* the RG-LRU and RWKV-6 blocks' per-step state stacks (the ``wkv6``
  stack against JAX ``apply_rwkv_tmix``'s ``S_stack``);
* ``ServingEngine(paged=False)`` streams for both families and the
  Mixtral smoke target, on one Poisson trace with mid-flight admission:
  equal to the JAX engine's streams and to the port's own target-only
  greedy decode, with one fused-round shape signature."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.configs.recurrentgemma_2b import CONFIG as J_RG  # noqa: E402
from repro.configs.rwkv6_7b import CONFIG as J_RWKV  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro.serving.trace import poisson_requests as j_poisson  # noqa: E402
from repro_torch.configs import (MISTRAL_7B, MIXTRAL_8X7B,  # noqa: E402
                                 RECURRENTGEMMA_2B, RGLRU, RWKV, RWKV6_7B,
                                 draft_for, get_config)
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax, init_params  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402
from repro_torch.serving.trace import poisson_requests  # noqa: E402

ATOL = 1e-4
CPU = "cpu"
FAMILIES = {"recurrentgemma": (J_RG, RECURRENTGEMMA_2B),
            "rwkv6": (J_RWKV, RWKV6_7B),
            "mixtral": (J_MIXTRAL, MIXTRAL_8X7B)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


@pytest.fixture(scope="module", params=["recurrentgemma", "rwkv6"])
def family(request):
    """(jax cfg, torch cfg, jax weights, torch weights) of one family."""
    jc0, tc0 = FAMILIES[request.param]
    jc, tc = jc0.reduced(d_model=64), tc0.reduced(d_model=64)
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    return jc, tc, jp, from_jax(jax.tree.map(np.asarray, jp), tc, CPU)


def test_configs_copy_the_jax_fields():
    for jc, tc in (v for k, v in FAMILIES.items() if k != "mixtral"):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert get_config(tc.name) is tc
    assert RECURRENTGEMMA_2B.n_layers == 27 and RECURRENTGEMMA_2B.tie_embeddings


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_draft_for_pairs_mistral_widths_with_the_target_vocab(name):
    _, tc = FAMILIES[name]
    tc = dataclasses.replace(tc, dtype="float32")
    want = dataclasses.replace(J_MISTRAL, n_layers=2,
                               vocab_size=tc.vocab_size, dtype="float32")
    assert dataclasses.asdict(draft_for(tc, 2)) == dataclasses.asdict(want)


def test_init_params_matches_the_jax_structure(family):
    jc, tc, jp, tp = family
    mine = init_params(tc, torch.Generator().manual_seed(0), CPU)

    def leaves(t, pre=""):
        if isinstance(t, dict):
            return sum((leaves(v, f"{pre}/{k}") for k, v in t.items()), [])
        if isinstance(t, list):
            return sum((leaves(v, f"{pre}/{i}") for i, v in enumerate(t)), [])
        return [(pre, tuple(t.shape), t.dtype)]
    assert sorted(leaves(mine)) == sorted(leaves(tp))
    if tc.tie_embeddings:                    # the unembedding reads tok.T
        assert "head" not in tp["embed"] and "head" not in mine["embed"]
    if tc.layer_kind(0) == RGLRU:
        a = torch.exp(-8.0 * torch.nn.functional.softplus(
            mine["layers"][0]["rec"]["a_param"]))
        assert 0.9 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-6


def test_prefill_decode_and_partial_commit_match_jax(family):
    """Prompt of 80 > the reduced window of 64, then two verify steps
    with partial commits: logits and every committed recurrent state
    equal JAX's (states at the logits' atol: RWKV's S reaches ~13 after
    80 steps, where f32 products summed in another order differ by
    ~1e-5)."""
    jc, tc, jp, tp = family
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab_size, (2, 80)).astype(np.int32)
    jcache, tcache = JT.init_cache(jc, 2, 100), TT.init_cache(tc, 2, 100, CPU)
    jl, jcache = JM.prefill(jp, jc, jnp.asarray(toks), jcache)
    tl, tcache = TM.prefill(tp, tc, torch.from_numpy(toks).long(), tcache)
    _close(tl, jl)
    for commit in ([2, 4], [0, 3]):
        d = rng.integers(0, tc.vocab_size, (2, 4)).astype(np.int32)
        jl, jcache, jpend = JM.decode(jp, jc, jcache, jnp.asarray(d))
        tl, tcache, tpend = TM.decode(tp, tc, tcache,
                                      torch.from_numpy(d).long())
        _close(tl, jl)
        jcache = JM.commit(jc, jcache, jpend, jnp.asarray(commit, jnp.int32),
                           4)
        tcache = TM.commit(tc, tcache, tpend, torch.tensor(commit), 4)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        pat = len(tc.layer_pattern)
        for l in range(tc.n_layers):
            if tc.layer_kind(l) in (RGLRU, RWKV):
                for key, val in tcache["layers"][l].items():
                    _close(val, np.asarray(
                        jcache["layers"][l % pat][key])[l // pat])


def test_recurrent_state_stacks_match_jax():
    """Verify-size blocks (s=5 <= 16) return every per-step state: the
    ``wkv6`` stack against JAX ``apply_rwkv_tmix``'s ``S_stack``, the
    RG-LRU ``h``/``conv`` stacks against ``apply_rglru_block``'s."""
    rng = np.random.default_rng(4)
    b, s, d, hs = 2, 5, 64, 32
    rw = J_RWKV.reduced(d_model=d)
    p = JM.init_params(rw, jax.random.PRNGKey(1))["layers"][0]["tmix"]
    p = jax.tree.map(lambda a: np.asarray(a)[0], p)
    x = rng.standard_normal((b, s, d), np.float32)
    s0 = rng.standard_normal((b, d // hs, hs, hs), np.float32) * 0.1
    ts = rng.standard_normal((b, d), np.float32)
    j_out, j_stack, _ = jrwkv.apply_rwkv_tmix(p, jnp.asarray(x),
                                              jnp.asarray(s0),
                                              jnp.asarray(ts), hs)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    t_out, t_stack, _ = trwkv.apply_rwkv_tmix(tp, torch.from_numpy(x),
                                              torch.from_numpy(s0),
                                              torch.from_numpy(ts), hs)
    assert t_stack.shape == (b, s + 1, d // hs, hs, hs)
    _close(t_stack[:, 0], s0, atol=0)
    _close(t_stack[:, 1:], j_stack, atol=2e-5)
    _close(t_out, j_out)

    rg = J_RG.reduced(d_model=d)
    p = JM.init_params(rg, jax.random.PRNGKey(2))["layers"][0]["rec"]
    p = jax.tree.map(lambda a: np.asarray(a)[0], p)
    st = {"h": rng.standard_normal((b, d), np.float32),
          "conv": rng.standard_normal((b, rg.conv_width - 1, d), np.float32)}
    j_out, j_new, j_stack = jrglru.apply_rglru_block(
        p, jnp.asarray(x), jax.tree.map(jnp.asarray, st))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    t_out, t_new, t_stack = trglru.apply_rglru_block(
        tp, torch.from_numpy(x), {k: torch.from_numpy(v)
                                  for k, v in st.items()})
    _close(t_out, j_out)
    for key in ("h", "conv"):
        _close(t_stack[key], j_stack[key], atol=1e-5)
        _close(t_new[key], j_new[key], atol=1e-5)


def test_microbatched_prefill_concatenates_recurrent_state(family):
    """Zig-zag prefill in chunks of one gives the state of one batched
    prefill (``_concat_caches`` carries the recurrent dicts)."""
    jc, tc, jp, tp = family
    eng = SpecOffloadEngine(tc, tc, device=CPU)
    eng.load(tp, tp)
    prompts = np.random.default_rng(6).integers(0, tc.vocab_size, (3, 12))
    one = eng.prefill_batch(prompts, 32, bs_prefill=3)
    chunked = eng.prefill_batch(prompts, 32, bs_prefill=1)
    np.testing.assert_array_equal(chunked.t_next.numpy(), one.t_next.numpy())
    for a, b in zip(chunked.target_cache["layers"],
                    one.target_cache["layers"]):
        for key in a:
            _close(a[key], b[key], atol=1e-5)


# ---------------------------------------------------------------------------
# contiguous serving


def _greedy(params, cfg, prompt, steps):
    """The port's target-only greedy decode (prefill + decode_step)."""
    cache = TT.init_cache(cfg, 1, len(prompt) + steps + 1, CPU)
    lg, cache = TM.prefill(params, cfg, torch.as_tensor(prompt[None]).long(),
                           cache)
    out = []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        out.append(int(tok[0]))
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None])
    return np.asarray(out)


def _trace(vocab, mod):
    """6 requests of mixed prompt and generation lengths, arriving faster
    than the 4 slots drain."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (9, 20, 5, 14, 7, 11)]
    gens = rng.integers(3, 9, len(prompts)).tolist()
    return mod(prompts, gens, rate_rps=40.0, seed=3)


@pytest.mark.parametrize("name", ["recurrentgemma", "rwkv6", "mixtral"])
def test_contiguous_serving_matches_jax_and_greedy(name):
    jc0, tc0 = FAMILIES[name]
    jt, tt = jc0.reduced(d_model=64), tc0.reduced(d_model=64)
    jd = dataclasses.replace(J_MISTRAL.reduced(d_model=32,
                                               vocab=jt.vocab_size),
                             sliding_window=8)
    td = dataclasses.replace(MISTRAL_7B.reduced(d_model=32,
                                                vocab=tt.vocab_size),
                             sliding_window=8)
    k1, k2 = jax.random.split(jax.random.PRNGKey(5))
    jtp, jdp = JM.init_params(jt, k1), JM.init_params(jd, k2)
    conv = lambda p, c: from_jax(jax.tree.map(np.asarray, p), c, CPU)
    ttp, tdp = conv(jtp, tt), conv(jdp, td)
    cfg = dict(max_batch=2, n_cand=2, paged=False)

    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
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
        assert te.submit(r)
    done = te.run()
    assert len(done) == len(treqs) and te.pending() == 0
    assert any(r.queue_s > 0 for r in treqs), "no mid-flight admission"
    assert te.engine.pipeline(2).trace_counts["fused"] == 1
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
        np.testing.assert_array_equal(
            tr.result, _greedy(ttp, tt, tr.prompt, tr.max_new_tokens),
            err_msg=f"rid {tr.rid} vs greedy")
    kv = te.kv_stats()
    assert kv["paged"] is False
    assert kv["peak_kv_bytes"] == je.kv_stats()["peak_kv_bytes"]


# ---------------------------------------------------------------------------
# recurrent drafts: the chain round's rollback of RG-LRU and RWKV layers


@pytest.fixture(scope="module", params=["recurrentgemma", "rwkv6"])
def recurrent_draft(request):
    """A Mixtral smoke target with a recurrent draft of the target's
    vocabulary (RecurrentGemma: one RG-LRU, RG-LRU, SWA group; RWKV-6: 2
    layers), JAX weights and their port."""
    jc0, tc0 = FAMILIES[request.param]
    jt, tt = J_MIXTRAL.reduced(d_model=64), MIXTRAL_8X7B.reduced(d_model=64)
    n = len(jc0.layer_pattern) if request.param == "recurrentgemma" else 2
    jd = jc0.reduced(d_model=32, n_layers=n, vocab=jt.vocab_size)
    td = tc0.reduced(d_model=32, n_layers=n, vocab=tt.vocab_size)
    k1, k2 = jax.random.split(jax.random.PRNGKey(11))
    jtp, jdp = JM.init_params(jt, k1), JM.init_params(jd, k2)
    conv = lambda p, c: from_jax(jax.tree.map(np.asarray, p), c, CPU)
    return (jt, jd, jtp, jdp), (tt, td, conv(jtp, tt), conv(jdp, td))


def test_rollback_draft_matches_jax_at_every_n_keep(recurrent_draft):
    """``draft_generate`` then ``rollback_draft`` keeping n_keep in
    1..m+1 steps per row (every value across the rows of two calls):
    position and every recurrent and ring state equal JAX's.  Before the
    repair the port raised NotImplementedError for these layers."""
    from repro.core import spec_decode as JS
    from repro_torch.core import spec_decode as TS
    (_, jd, _, jdp), (_, td, _, tdp) = recurrent_draft
    m, b, length = 3, 4, 10
    prompts = np.random.default_rng(12).integers(
        0, td.vocab_size, (b, length)).astype(np.int32)
    jl, jc0 = JM.prefill(jdp, jd, jnp.asarray(prompts),
                         JT.init_cache(jd, b, 32))
    for keep in ([1, 2, 3, 4], [4, 3, 2, 1]):
        jc = jc0
        tl, tc = TM.prefill(tdp, td, torch.from_numpy(prompts).long(),
                            TT.init_cache(td, b, 32, CPU))
        t_next = np.array(jnp.argmax(jl, -1))
        np.testing.assert_array_equal(torch.argmax(tl, -1).numpy(), t_next)
        jdr, _, jc, jpend = JS.draft_generate(jdp, jd, jc,
                                              jnp.asarray(t_next), m)
        tdr, _, tc, tpend = TS.draft_generate(
            tdp, td, tc, torch.from_numpy(t_next).long(), m)
        np.testing.assert_array_equal(tdr.numpy(), np.asarray(jdr))
        nk = np.asarray(keep, np.int32)
        jc = JS.rollback_draft(jd, jc, jpend, jnp.asarray(nk))
        tc = TS.rollback_draft(td, tc, tpend, torch.from_numpy(nk).long())
        np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
        pat = len(td.layer_pattern)
        for l in range(td.n_layers):
            if td.layer_kind(l) in (RGLRU, RWKV):
                for key, val in tc["layers"][l].items():
                    _close(val, np.asarray(
                        jc["layers"][l % pat][key])[l // pat], atol=1e-5)


def test_recurrent_draft_generate_matches_jax(recurrent_draft):
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = recurrent_draft
    from repro.core.pipeline import SpecOffloadEngine as JEngine
    prompts = np.random.default_rng(13).integers(
        0, tt.vocab_size, (4, 9)).astype(np.int32)
    je = JEngine(jt, jd)
    je.load(jtp, jdp)
    want = je.generate(jnp.asarray(prompts), gen_len=6, n_cand=3)
    te = SpecOffloadEngine(tt, td, device=CPU)
    te.load(ttp, tdp)
    got = te.generate(prompts, gen_len=6, n_cand=3)
    assert got.tokens.shape == (4, 6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.rounds == want.rounds
    for r in range(4):
        np.testing.assert_array_equal(got.tokens[r],
                                      _greedy(ttp, tt, prompts[r], 6))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_recurrent_draft_serving_matches_jax_and_greedy(recurrent_draft,
                                                        paged):
    """The ServingEngine stream with a recurrent draft, paged and
    contiguous, on a trace with mid-flight admission: equal to the JAX
    engine's streams and to the port's own greedy decode."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = recurrent_draft
    cfg = dict(max_batch=2, n_cand=2, paged=paged, block_size=4)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
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
        assert te.submit(r)
    done = te.run()
    assert len(done) == len(treqs)
    assert any(r.queue_s > 0 for r in treqs), "no mid-flight admission"
    counts = te.engine.pipeline(2).trace_counts
    assert counts["fused"] == 1 and counts["rollback"] == 1
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
        np.testing.assert_array_equal(
            tr.result, _greedy(ttp, tt, tr.prompt, tr.max_new_tokens),
            err_msg=f"rid {tr.rid} vs greedy")
