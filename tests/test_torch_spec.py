"""The port's acceptance model and sampled acceptance against the JAX
package's: the paper's pmf and expectations (and the tree model with its
chain degeneracy), Leviathan sampled acceptance with the JAX noise
injected as tensors (token for token at temperatures 1.0 and 0.7), and
whole chain rounds (``spec_round``) greedy and sampled on the same
weights."""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.core import spec_decode as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.core import spec_decode as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
BRANCHINGS = [(1,), (2,), (3, 2), (2, 2, 1), (2, 2, 2, 2)]


# ---------------------------------------------------------------------------
# the acceptance models


@pytest.mark.parametrize("p", [0.0, 0.3, 0.7, 1.0])
@pytest.mark.parametrize("n_cand", [1, 4])
def test_chain_acceptance_model_matches_jax(p, n_cand):
    np.testing.assert_allclose(TS.acceptance_pmf(p, n_cand),
                               np.asarray(JS.acceptance_pmf(p, n_cand)),
                               atol=1e-6)
    assert abs(TS.acceptance_pmf(p, n_cand).sum() - 1.0) < 1e-12
    for name in ("expected_generated", "expected_generated_paper_eq12"):
        assert getattr(TS, name)(p, n_cand) == pytest.approx(
            getattr(JS, name)(p, n_cand), abs=1e-12)


@pytest.mark.parametrize("branching", BRANCHINGS)
@pytest.mark.parametrize("p", [0.2, 0.6])
def test_tree_acceptance_model_matches_jax(branching, p):
    np.testing.assert_allclose(TS.acceptance_pmf_tree(p, branching),
                               np.asarray(JS.acceptance_pmf_tree(p,
                                                                 branching)),
                               atol=1e-6)
    assert TS.expected_generated_tree(p, branching) == pytest.approx(
        JS.expected_generated_tree(p, branching), abs=1e-12)


def test_tree_model_chain_degeneracy():
    """A (1, 1, ..., 1) tree is exactly the linear chain model."""
    for p in (0.2, 0.5, 0.9):
        for m in (1, 3, 5):
            np.testing.assert_allclose(TS.acceptance_pmf_tree(p, (1,) * m),
                                       TS.acceptance_pmf(p, m), atol=1e-12)
            assert TS.expected_generated_tree(p, (1,) * m) == pytest.approx(
                TS.expected_generated(p, m), abs=1e-12)
    assert TS.expected_generated_tree(1.0, (2, 2)) == 3.0


# ---------------------------------------------------------------------------
# sampled acceptance with the JAX noise injected


def jax_chain_noise(key, b, m, vocab):
    """The draws ``sampled_acceptance`` makes from ``key``
    (``repro/core/spec_decode.py:161-177``): the uniforms and the Gumbel
    noise of its two ``jax.random.categorical`` calls."""
    k_acc, k_res, k_bonus = jax.random.split(key, 3)
    return tuple(torch.from_numpy(np.array(x)) for x in (
        jax.random.uniform(k_acc, (b, m)),
        jax.random.gumbel(k_res, (b, vocab), jnp.float32),
        jax.random.gumbel(k_bonus, (b, vocab), jnp.float32)))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_sampled_acceptance_matches_jax(temperature):
    b, m, v = 64, 4, 16
    rng = np.random.default_rng(0)
    dl = rng.standard_normal((b, m, v)).astype(np.float32)
    # target near the draft, so acceptance runs a few steps deep
    tl = (np.concatenate([dl, rng.standard_normal((b, 1, v))], 1)
          + 0.5 * rng.standard_normal((b, m + 1, v))).astype(np.float32)
    drafts = dl.argmax(-1).astype(np.int32)
    drafts[::3, 1] = rng.integers(0, v, len(drafts[::3]))
    key = jax.random.PRNGKey(3)
    want = JS.sampled_acceptance(jnp.asarray(drafts), jnp.asarray(dl),
                                 jnp.asarray(tl), key,
                                 temperature=temperature)
    got = TS.sampled_acceptance(torch.from_numpy(drafts).long(),
                                torch.from_numpy(dl), torch.from_numpy(tl),
                                *jax_chain_noise(key, b, m, v),
                                temperature=temperature)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    a = got[0].numpy()
    assert (a == 0).any() and (a == m).any() and ((a > 0) & (a < m)).any()


def test_acceptance_noise_draws():
    g = torch.Generator().manual_seed(0)
    u, g_res, g_bonus = TS.acceptance_noise(g, 4096, 3, 8, CPU)
    assert u.shape == (4096, 3) and g_res.shape == g_bonus.shape == (4096, 8)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    # standard Gumbel: mean = Euler-Mascheroni, variance = pi^2 / 6
    assert float(g_res.mean()) == pytest.approx(0.5772, abs=0.02)
    assert float(g_bonus.var()) == pytest.approx(np.pi ** 2 / 6, abs=0.05)
    again = TS.acceptance_noise(torch.Generator().manual_seed(0), 4096, 3, 8,
                                CPU)
    assert torch.equal(again[1], g_res)
    u2, gs = TS.tree_acceptance_noise(g, 5, (3, 2), 8, CPU)
    assert u2.shape == (5, 5) and gs.shape == (5, 3, 8)


# ---------------------------------------------------------------------------
# whole chain rounds


@pytest.fixture(scope="module")
def chain_models():
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


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_spec_round_matches_jax(chain_models, sample):
    """Four chain rounds (n_cand 3, the draft's 8-slot ring wrapping):
    tokens, counts and ``pos`` exact, the caches' rows at f32 rounding."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = chain_models
    b, n_cand, max_len = 3, 3, 48
    prompts = np.random.default_rng(1).integers(
        0, tt.vocab_size, (b, 9)).astype(np.int32)
    jpre = jax.jit(JM.prefill, static_argnums=(1,))
    jtc, jdc = JT.init_cache(jt, b, max_len), JT.init_cache(jd, b, max_len)
    jl, jtc = jpre(jtp, jt, jnp.asarray(prompts), jtc)
    _, jdc = jpre(jdp, jd, jnp.asarray(prompts), jdc)
    ttc, tdc = TT.init_cache(tt, b, max_len, CPU), TT.init_cache(td, b,
                                                                 max_len, CPU)
    tl, ttc = TM.prefill(ttp, tt, torch.from_numpy(prompts).long(), ttc)
    _, tdc = TM.prefill(tdp, td, torch.from_numpy(prompts).long(), tdc)
    jn, tn = jnp.argmax(jl, -1), torch.argmax(tl, -1)
    round_fn = jax.jit(partial(JS.spec_round, sample=sample),
                       static_argnames=("target_cfg", "draft_cfg", "n_cand",
                                        "mesh"))
    key = jax.random.PRNGKey(11)
    for _ in range(4):
        key, sub = jax.random.split(key)
        want = round_fn(jtp, jt, jtc, jdp, jd, jdc, jn, n_cand, key=sub)
        noise = (jax_chain_noise(sub, b, n_cand, tt.vocab_size) if sample
                 else None)
        got = TS.spec_round(ttp, tt, ttc, tdp, td, tdc, tn, n_cand,
                            noise=noise, sample=sample)
        for k in ("tokens", "n_emitted", "n_accept", "t_next"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        jtc, jdc = want["target_cache"], want["draft_cache"]
        jn = want["t_next"]
        ttc, tdc, tn = got["target_cache"], got["draft_cache"], got["t_next"]
        for jc, tc, cfg in ((jtc, ttc, jt), (jdc, tdc, jd)):
            np.testing.assert_array_equal(tc["pos"].numpy(),
                                          np.asarray(jc["pos"]))
            pat = len(cfg.layer_pattern)
            for l in range(cfg.n_layers):
                for k in ("k", "v"):
                    # JAX stacks a layer's leaves over the pattern's groups
                    want = np.asarray(jc["layers"][l % pat][k][l // pat])
                    np.testing.assert_allclose(
                        tc["layers"][l][k].numpy(), want, atol=ATOL,
                        err_msg=f"layer {l} {k}")
