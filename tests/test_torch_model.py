"""The port's model against the JAX package's on the same weights
(``params.from_jax``): prefill logits and multi-token decode logits,
f32, atol 1e-4, on a contiguous cache, a paged pool and an int8 paged
pool; the MoE capacity drop order; the sliding-window ring wrapping."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax, init_params  # noqa: E402

ATOL = 1e-4
CPU = "cpu"


def _configs(kind):
    """(jax cfg, torch cfg) built from the same fields."""
    if kind == "target":
        return (J_MIXTRAL.reduced(d_model=64), MIXTRAL_8X7B.reduced(d_model=64))
    return (dataclasses.replace(J_MISTRAL.reduced(d_model=32), sliding_window=8),
            dataclasses.replace(MISTRAL_7B.reduced(d_model=32), sliding_window=8))


_JIT = {}


def _jit(name):
    if name not in _JIT:
        fn = {"prefill": JM.prefill, "decode": JM.decode}[name]
        _JIT[name] = jax.jit(fn, static_argnums=(1,))
    return _JIT[name]


def _jcommit(cfg, cache, pend, nc, sq):
    return JM.commit(cfg, cache, pend, jnp.asarray(nc, jnp.int32), sq)


def _tcommit(cfg, cache, pend, nc, sq):
    return TM.commit(cfg, cache, pend, torch.as_tensor(nc), sq)


def _weights(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("kind", ["target", "draft"])
def test_contiguous_prefill_and_decode_logits(kind):
    """Prefill, then two 3-token verify steps with partial commits (the
    draft's 8-slot ring wraps past its window)."""
    jcfg, tcfg = _configs(kind)
    jp, tp = _weights(jcfg, tcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
    max_len = 32
    jc = JT.init_cache(jcfg, 2, max_len)
    tc = TT.init_cache(tcfg, 2, max_len, CPU)
    jl, jc = _jit("prefill")(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc)
    _close(tl, jl)
    for commit in ([2, 3], [1, 2]):
        step = rng.integers(0, tcfg.vocab_size, (2, 3)).astype(np.int32)
        jl, jc, jpend = _jit("decode")(jp, jcfg, jc, jnp.asarray(step))
        tl, tc, tpend = TM.decode(tp, tcfg, tc, torch.from_numpy(step).long())
        _close(tl, jl)
        jc = _jcommit(jcfg, jc, jpend, commit, 3)
        tc = _tcommit(tcfg, tc, tpend, commit, 3)
        assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    # single-token decode after the commits reads the restored ring rows
    step = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
    jl, _, _ = _jit("decode")(jp, jcfg, jc, jnp.asarray(step))
    tl, _, _ = TM.decode(tp, tcfg, tc, torch.from_numpy(step).long())
    _close(tl, jl)


@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8_pool"])
def test_paged_pool_decode_logits(quant):
    """Two sequences admitted into a paged pool (the second sharing the
    first's two full prompt blocks), then multi-token verify steps."""
    jcfg, tcfg = _configs("target")
    jp, tp = _weights(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(1)
    bs, mbs, nb = 4, 8, 20
    shared = rng.integers(0, tcfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, tcfg.vocab_size, n)
                               .astype(np.int32)]) for n in (3, 6)]
    rows = [np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32),
            np.array([1, 2, 9, 10, 11, 12, 13, 14], np.int32)]
    n_shared = [0, 2]
    jc = JT.init_paged_cache(jcfg, 2, nb, bs, mbs, kv_quant=quant)
    tc = TT.init_paged_cache(tcfg, 2, nb, bs, mbs, kv_quant=quant, device=CPU)
    for slot, (p, row, ns) in enumerate(zip(prompts, rows, n_shared)):
        jpc = JT.init_cache(jcfg, 1, mbs * bs)
        tpc = TT.init_cache(tcfg, 1, mbs * bs, CPU)
        jl, jpc = _jit("prefill")(jp, jcfg, jnp.asarray(p[None]), jpc)
        tl, tpc = TM.prefill(tp, tcfg, torch.from_numpy(p[None]).long(), tpc)
        _close(tl, jl)
        jc = JT.admit_sequence_paged(jcfg, jc, jpc, slot, jnp.asarray(row),
                                     len(p), ns)
        TT.admit_sequence_paged(tcfg, tc, tpc, slot, row, len(p), ns)
    for commit in ([3, 1], [2, 4]):
        step = rng.integers(0, tcfg.vocab_size, (2, 4)).astype(np.int32)
        jl, jc, jpend = _jit("decode")(jp, jcfg, jc, jnp.asarray(step))
        tl, tc, tpend = TM.decode(tp, tcfg, tc, torch.from_numpy(step).long())
        _close(tl, jl)
        jc = _jcommit(jcfg, jc, jpend, commit, 4)
        tc = _tcommit(tcfg, tc, tpend, commit, 4)
    # the pools hold the same rows (int8 values exactly, f32 to rounding)
    jk = np.asarray(jc["layers"][0]["k"][0])
    tk = tc["layers"][0]["k"]
    if quant:
        np.testing.assert_array_equal(tk.numpy(), jk)
    else:
        np.testing.assert_allclose(tk.numpy(), jk, atol=1e-5)


def test_moe_prefill_drop_order_matches():
    """cf=2.0 with 8 experts drops tokens at prefill; which ones depends on
    the cumsum rank over the token-major (N*k) order, and must match."""
    d, f, e, k, n = 32, 64, 8, 2, 64
    jparams = jmoe.init_moe(jax.random.PRNGKey(3), d, f, e, "swiglu",
                            jnp.float32)
    tparams = {kk: torch.from_numpy(np.array(v)) for kk, v in
               jparams.items()}
    rng = np.random.default_rng(3)
    # a shared component skews routing so a few experts overflow
    x = (rng.standard_normal((n, d)) * 0.3
         + 3.0 * rng.standard_normal(d)).astype(np.float32)
    cap = jmoe._capacity(n, k, e, 2.0)
    assert cap == tmoe._capacity(n, k, e, 2.0) < n
    jidx, _ = jmoe._route(jparams["router"], jnp.asarray(x), e, k)
    tidx, _ = tmoe._route(tparams["router"], torch.from_numpy(x), e, k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _, jslot = jmoe._dispatch(jnp.asarray(x), jidx, e, cap)
    _, tslot = tmoe._dispatch(torch.from_numpy(x), tidx, e, cap)
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert (tslot.numpy() < 0).any(), "the case must drop tokens"
    want = jmoe._moe_local(jparams, jnp.asarray(x), n_experts=e, top_k=k,
                           capacity_factor=2.0, activation="swiglu")
    got = tmoe._moe_local(tparams, torch.from_numpy(x), n_experts=e, top_k=k,
                          capacity_factor=2.0, activation="swiglu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_init_params_structure_matches_from_jax():
    """Seeded init gives the converted JAX tree's structure, shapes and
    dtypes (the draws themselves differ by design)."""
    jcfg, tcfg = _configs("target")
    _, conv = _weights(jcfg, tcfg)
    mine = init_params(tcfg, torch.Generator().manual_seed(0), CPU)

    def flat(tree, pre=""):
        if isinstance(tree, dict):
            return {kk: vv for k, v in tree.items()
                    for kk, vv in flat(v, f"{pre}/{k}").items()}
        if isinstance(tree, list):
            return {kk: vv for i, v in enumerate(tree)
                    for kk, vv in flat(v, f"{pre}/{i}").items()}
        return {pre: (tuple(tree.shape), tree.dtype)}

    assert flat(mine) == flat(conv)
    w = mine["layers"][0]["ffn"]["w_gate"]
    assert w.abs().max() <= 3 * tcfg.d_model ** -0.5 + 1e-6
