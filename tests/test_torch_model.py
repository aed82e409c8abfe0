"""The port's model against the JAX package's on the same weights
(``params.from_jax``): prefill logits and multi-token decode logits,
f32, atol 1e-4, on a contiguous cache, a paged pool and an int8 paged
pool; the MoE capacity drop order; the sliding-window ring wrapping.
The one-token ring decode's kernel route (``decode_attention``, its
plain version here) against the JAX package's draft steps and rollback,
and against the plain masked ring attention."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.core import spec_decode as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.core.spec_decode import rollback_draft  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
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


# (dtype, head dim): the smallest head dims the kernel takes in each (16:
# the serving example's draft)
RING_DTYPES = {"f32-d16": (torch.float32, 16),
               "f32-d32": (torch.float32, 32),
               "bf16-d64": (torch.bfloat16, 64)}
# (window, max_len): a ring of as many slots as the window, and a shorter
# one; 8 slots either way
RING_SLOTS = {"slots-eq-window": (8, 32), "slots-lt-window": (16, 8)}


def _ring_run(cfg, params, cache, kernel, monkeypatch,
              da=TA._da.decode_attention):
    """Five one-token steps at fixed tokens (a draft's feeds), a
    ``rollback_draft`` keeping 0-5 of them per row, one step over the
    restored rows and a 3-token verify, on the kernel route (``on_card``
    forced true: ``decode_attention``'s plain version on the CPU) or the
    plain path; returns (logits of each call, the caches, the kernel
    calls' query lengths)."""
    m = []

    def spy(q, *a, **k):
        m.append(q.shape[2])
        return da(q, *a, **k)
    monkeypatch.setattr(TA, "on_card", lambda x: kernel)
    monkeypatch.setattr(TA._da, "decode_attention", spy)
    toks = torch.arange(5 * 4).reshape(4, 5) % cfg.vocab_size
    out, pends = [], []
    for i in range(5):
        lg, cache, pend = TM.decode(params, cfg, cache, toks[:, i:i + 1])
        cache = {"layers": cache["layers"], "pos": cache["pos"] + 1}
        out.append(lg)
        pends.append(pend)
    cache = rollback_draft(cfg, cache, pends, torch.tensor([0, 2, 5, 3]))
    lg, cache, _ = TM.decode(params, cfg, cache, toks[:, :1])
    cache = {"layers": cache["layers"], "pos": cache["pos"] + 1}
    out.append(lg)
    n_one = len(m)
    lg, cache, _ = TM.decode(params, cfg, cache, toks[:, 1:4])
    out.append(lg)
    assert len(m) == n_one, "a 3-token verify on a ring took the kernel"
    return out, cache, m


@pytest.mark.parametrize("slots", RING_SLOTS)
@pytest.mark.parametrize("dtype", RING_DTYPES)
def test_ring_decode_kernel_route_equals_plain(dtype, slots, monkeypatch):
    """Rows before the ring wraps (pos 2), at its edge (7), just past it
    (8) and well past it (13) in one batch, every slot holding rows (the
    stale ones past a row's length too): the kernel route's logits equal
    the plain path's at each step, after a rollback restored rows, and in
    a multi-token verify (plain on both); the caches end equal.  The
    route engages at every one-token step of every layer, never at 3
    tokens."""
    dt, hd = RING_DTYPES[dtype]
    window, max_len = RING_SLOTS[slots]
    cfg = dataclasses.replace(MISTRAL_7B.reduced(d_model=4 * hd),
                              sliding_window=window, dtype=str(dt)[6:])
    assert cfg.head_dim == hd
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    gen = torch.Generator().manual_seed(1)
    base = TT.init_cache(cfg, 4, max_len, CPU)
    assert base["layers"][0]["k"].shape[1] == 8
    for layer in base["layers"]:
        for key in ("k", "v"):
            layer[key].copy_(torch.randn(layer[key].shape, generator=gen))
    base["pos"] = torch.tensor([2, 7, 8, 13])
    runs = {}
    for kernel in (False, True):
        cache = {"layers": [{k: v.clone() for k, v in layer.items()}
                            for layer in base["layers"]],
                 "pos": base["pos"].clone()}
        runs[kernel] = _ring_run(cfg, params, cache, kernel, monkeypatch)
    (plain, pcache, pm), (got, kcache, km) = runs[False], runs[True]
    assert pm == []
    assert km == [1] * cfg.n_layers * 6
    # f32: the two differ in summation order alone; bf16: the plain path
    # rounds P to bf16 and the model's activations are bf16
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for g, w in zip(got, plain):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=0, atol=tol * w.abs().max().item())
    assert torch.equal(kcache["pos"], pcache["pos"])
    for kl, pl in zip(kcache["layers"], pcache["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(kl[key].float().numpy(),
                                       pl[key].float().numpy(), rtol=0,
                                       atol=tol * pl[key].abs().max().item())


@pytest.mark.parametrize("route", ["plain", "kernel"])
def test_ring_draft_steps_and_rollback_logits(route, monkeypatch):
    """The draft's steps over its 8-slot ring against the JAX package's
    on the same weights: a 4-token prefill, five one-token steps (the
    ring wraps at the fifth), ``rollback_draft`` keeping 1 and 5 of
    them, and five more steps from the restored rows (one row before
    the ring wraps, one past it).  The port on the kernel route
    (``on_card`` forced true: ``decode_attention``'s plain version on
    the CPU, at a head dim the kernel takes) and on the plain path."""
    jcfg, tcfg = (dataclasses.replace(c.reduced(d_model=128),
                                      sliding_window=8)
                  for c in (J_MISTRAL, MISTRAL_7B))
    assert tcfg.head_dim == 32
    jp, tp = _weights(jcfg, tcfg)
    calls, da = [], TA._da.decode_attention

    def spy(q, *a, **k):
        calls.append(q.shape[2])
        return da(q, *a, **k)
    monkeypatch.setattr(TA, "on_card", lambda x: route == "kernel")
    monkeypatch.setattr(TA._da, "decode_attention", spy)
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 14)).astype(np.int32)
    jc = JT.init_cache(jcfg, 2, 32)
    tc = TT.init_cache(tcfg, 2, 32, CPU)
    jl, jc = _jit("prefill")(jp, jcfg, jnp.asarray(toks[:, :4]), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks[:, :4]).long(), tc)
    _close(tl, jl)

    def steps(jc, tc, feed):
        jpends, tpends = [], []
        for i in range(feed.shape[1]):
            jl, jc, jpend = _jit("decode")(jp, jcfg, jc,
                                           jnp.asarray(feed[:, i:i + 1]))
            tl, tc, tpend = TM.decode(tp, tcfg, tc,
                                      torch.from_numpy(feed[:, i:i + 1]).long())
            _close(tl, jl)
            jc = {"layers": jc["layers"], "pos": jc["pos"] + 1}
            tc = {"layers": tc["layers"], "pos": tc["pos"] + 1}
            jpends.append(jpend)
            tpends.append(tpend)
        return jc, tc, jpends, tpends

    jc, tc, jpends, tpends = steps(jc, tc, toks[:, 4:9])
    keep = np.array([1, 5], np.int32)
    jc = JS.rollback_draft(jcfg, jc, jpends, jnp.asarray(keep))
    tc = rollback_draft(tcfg, tc, tpends, torch.from_numpy(keep))
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [5, 9]
    steps(jc, tc, toks[:, 9:14])
    assert calls == ([1] * tcfg.n_layers * 10 if route == "kernel" else [])
