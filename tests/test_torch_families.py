"""The remaining decoder-only families (Chameleon, Gemma-3, Llama-3,
Llama-4 Maverick, Phi-3.5-MoE, Phi-3-medium, StarCoder2) at
``reduced(d_model=128)``, as tests/test_arch_smoke.py builds them, on
the same weights (``params.from_jax``) in both packages: prefill logits
and three ``decode_step``s, and a 5-token verify, a partial commit and a
decode after it (f32, atol and rtol 1e-4; cache ``pos`` exact).  Prompts
of 70 tokens wrap Gemma-3's reduced 64-token sliding-window rings in the
prefill and in the verify.  Then 3-request bursts through
``ServingEngine`` (paged, chain) against the JAX engine for Gemma-3
(sliding-window and global layers) and Llama-4 (interleaved MoE, top-1):
the token streams and the ``stats()`` counters are equal."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro.serving.trace import poisson_requests as j_poisson  # noqa: E402
from repro_torch.configs import MISTRAL_7B, get_config  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402
from repro_torch.serving.trace import poisson_requests  # noqa: E402

CPU = "cpu"
TOL = 1e-4
FAMILIES = ("chameleon-34b", "gemma3-12b", "llama3-405b",
            "llama4-maverick-400b-a17b", "phi3.5-moe-42b-a6.6b",
            "phi3-medium-14b", "starcoder2-7b")
B, L, M, MAX_LEN = 2, 70, 5, 96

_JIT = {}


def _jit(name):
    if name not in _JIT:
        fn = {"prefill": JM.prefill, "decode": JM.decode,
              "decode_step": JM.decode_step}[name]
        _JIT[name] = jax.jit(fn, static_argnums=(1,))
    return _JIT[name]


def _setup(name, seed=0):
    jcfg = j_get_config(name).reduced(d_model=128)
    tcfg = get_config(name).reduced(d_model=128)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _prefill(jcfg, tcfg, jp, tp, toks):
    jc = JT.init_cache(jcfg, B, MAX_LEN)
    tc = TT.init_cache(tcfg, B, MAX_LEN, CPU)
    jl, jc = _jit("prefill")(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc)
    _close(tl, jl)
    return jl, jc, tl, tc


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_steps_match_jax(name):
    jcfg, tcfg, jp, tp = _setup(name)
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                             (B, L)).astype(np.int32)
    jl, jc, tl, tc = _prefill(jcfg, tcfg, jp, tp, toks)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = _jit("decode_step")(jp, jcfg, jc, jnp.asarray(tok))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long())
        _close(tl, jl)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [L + 3] * B


@pytest.mark.parametrize("name", FAMILIES)
def test_verify_and_partial_commit_match_jax(name):
    """A 5-token verify (the engine's n_cand 4), commits of 2 and 4
    tokens (the rejected ring rows restored), then one decode."""
    jcfg, tcfg, jp, tp = _setup(name, seed=1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tcfg.vocab_size, (B, L)).astype(np.int32)
    _, jc, _, tc = _prefill(jcfg, tcfg, jp, tp, toks)
    step = rng.integers(0, tcfg.vocab_size, (B, M)).astype(np.int32)
    jl, jc, jpend = _jit("decode")(jp, jcfg, jc, jnp.asarray(step))
    tl, tc, tpend = TM.decode(tp, tcfg, tc, torch.from_numpy(step).long())
    _close(tl, jl)
    n_commit = [2, 4]
    jc = JM.commit(jcfg, jc, jpend, jnp.asarray(n_commit, jnp.int32), M)
    tc = TM.commit(tcfg, tc, tpend, torch.as_tensor(n_commit), M)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    nxt = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
    jl, _ = _jit("decode_step")(jp, jcfg, jc, jnp.asarray(nxt))
    tl, _ = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt).long())
    _close(tl, jl)


def _burst(vocab, mod):
    """3 requests at once, prompts past the reduced 64-token window."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, vocab, n).astype(np.int32)
               for n in (70, 80, 66)]
    gens = rng.integers(6, 12, len(prompts)).tolist()
    return mod(prompts, gens, rate_rps=1e6, seed=3)


@pytest.mark.parametrize("name", ["gemma3-12b",
                                  "llama4-maverick-400b-a17b"])
def test_served_burst_matches_jax(name):
    jt, tt, jtp, ttp = _setup(name, seed=2)
    jd = dataclasses.replace(J_MISTRAL.reduced(d_model=32,
                                               vocab=jt.vocab_size),
                             sliding_window=8)
    td = dataclasses.replace(MISTRAL_7B.reduced(d_model=32,
                                                vocab=tt.vocab_size),
                             sliding_window=8)
    jdp = JM.init_params(jd, jax.random.PRNGKey(3))
    tdp = from_jax(jax.tree.map(np.asarray, jdp), td, CPU)
    cfg = dict(max_batch=2, n_cand=2, block_size=16)
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
    for jr, tr in zip(jreqs, treqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
    ts, js = te.stats(), je.stats()
    for k in ("rounds", "tokens_out", "fused_compiles", "rejected"):
        assert ts[k] == js[k], k
    assert ts["fused_compiles"] == 1
    assert te.kv_stats() == je.kv_stats()


@pytest.mark.parametrize("name", FAMILIES)
def test_launcher_serves_the_family_on_cpu(name, capsys):
    """``python -m repro_torch.launch.serve --arch <name> --device cpu``:
    the reduced family behind a reduced Mistral draft, one fused shape."""
    from repro_torch.launch import serve
    serve.main(["--arch", name, "--device", "cpu", "--requests", "3",
                "--gen", "4", "--prompt-len", "10", "--rate", "3"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "fused compiles=1" in out
    assert f"reduced config '{name}-smoke'" in out


def test_launcher_refuses_whisper_like_jax():
    """The JAX launcher's default paged cache raises for the
    encoder-decoder Whisper-base; the port's does the same."""
    from repro_torch.launch import serve
    with pytest.raises(ValueError) as te:
        serve.main(["--arch", "whisper-base", "--device", "cpu",
                    "--requests", "1", "--gen", "2", "--prompt-len", "4"])
    with pytest.raises(ValueError) as je:
        JT.init_paged_cache(j_get_config("whisper-base"), 1, 4, 16, 2)
    assert str(te.value) == str(je.value)
