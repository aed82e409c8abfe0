"""Tree speculation in the port against the JAX package, on the smoke
models of the JAX tree tests (a ``MIXTRAL_8X7B.reduced(d_model=64)``
target and a two-layer all-attention ``MISTRAL_7B.reduced(d_model=32)``
draft, f32, one set of JAX weights converted): the layout and its
descriptors, greedy and sampled tree acceptance (the JAX noise injected
as tensors), accepted-path compaction of contiguous and paged caches,
tree drafting, the masked decode at a full buffer and at a level feed,
whole rounds, the tree pipeline and the tree-mode serving engine.
Logits to atol 1e-4; tokens, counts, ``path_idx``, cache rows and
``pos`` exact."""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.configs.recurrentgemma_2b import CONFIG as J_RG  # noqa: E402
from repro.core import interleave as JI  # noqa: E402
from repro.core import spec_decode as JS  # noqa: E402
from repro.core.pipeline import SpecOffloadEngine as JEngine  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro.serving.trace import poisson_requests as j_poisson  # noqa: E402
from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B  # noqa: E402
from repro_torch.configs import RECURRENTGEMMA_2B  # noqa: E402
from repro_torch.core import interleave as TI  # noqa: E402
from repro_torch.core import spec_decode as TS  # noqa: E402
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402
from repro_torch.serving.trace import poisson_requests  # noqa: E402

CPU = "cpu"
ATOL = 1e-4
BRANCHINGS = [(1,), (2,), (3, 2), (2, 2, 1), (2, 2, 2, 2)]
IDS = ["-".join(map(str, br)) for br in BRANCHINGS]


@pytest.fixture(scope="module")
def models():
    jt = J_MIXTRAL.reduced(d_model=64)
    jd = dataclasses.replace(J_MISTRAL.reduced(d_model=32,
                                               vocab=jt.vocab_size),
                             layer_pattern=("attn",) * 2, n_layers=2)
    tt = MIXTRAL_8X7B.reduced(d_model=64)
    td = dataclasses.replace(MISTRAL_7B.reduced(d_model=32,
                                                vocab=tt.vocab_size),
                             layer_pattern=("attn",) * 2, n_layers=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtp, jdp = JM.init_params(jt, k1), JM.init_params(jd, k2)
    conv = lambda p, c: from_jax(jax.tree.map(np.asarray, p), c, CPU)
    return (jt, jd, jtp, jdp), (tt, td, conv(jtp, tt), conv(jdp, td))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=msg)


# ---------------------------------------------------------------------------
# layout and descriptors


@pytest.mark.parametrize("branching", BRANCHINGS, ids=IDS)
def test_tree_layout_and_spec_match_jax(branching):
    got, want = TS.tree_layout(branching), JS.tree_layout(branching)
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k], k)
    assert TS.tree_n_nodes(branching) == JS.tree_n_nodes(branching)
    for level in [None] + list(range(len(branching) + 1)):
        gs = TS.tree_spec(branching, level, device=CPU)
        ws = JS.tree_spec(branching, level)
        assert set(gs) == set(ws) | {"tensors"}
        for k in ws:
            _eq(gs[k], ws[k], f"level {level} {k}")
        depths, mask, anc = gs["tensors"]
        _eq(depths, ws["depths"], f"level {level} depths tensor")
        _eq(mask, ws["mask"], f"level {level} mask tensor")
        if ws["prev"] == 0:     # a feed from the buffer's start
            want = (np.asarray(ws["mask"]).astype(np.int64)
                    << np.arange(ws["mask"].shape[1])).sum(1)
            _eq(anc, want.astype(np.int32), f"level {level} anc_bits")
        else:
            assert anc is None


def test_tree_node_cap():
    assert TS.tree_n_nodes((2, 2, 2, 2)) == 31 == TS.MAX_TREE_NODES
    for bad in ((2,) * 5, (6, 5), (0,), ()):
        with pytest.raises(ValueError):
            JS.tree_layout(bad)
        with pytest.raises(ValueError):
            TS.tree_layout(bad)
    with pytest.raises(ValueError, match="128 query rows"):
        TS.tree_layout((2,) * 5)


def test_tree_supported_matches_jax():
    for jc, tc in ((J_MIXTRAL, MIXTRAL_8X7B), (J_MISTRAL, MISTRAL_7B),
                   (J_RG, RECURRENTGEMMA_2B),
                   (dataclasses.replace(J_MISTRAL, layer_pattern=("attn",)),
                    dataclasses.replace(MISTRAL_7B, layer_pattern=("attn",)))):
        assert TS.tree_supported(tc) == JS.tree_supported(jc)
    assert TS.tree_supported(MIXTRAL_8X7B)
    assert not TS.tree_supported(MISTRAL_7B)


# ---------------------------------------------------------------------------
# acceptance


def _tree_tokens(rng, b, branching, vocab):
    """A (B, N) BFS buffer whose siblings are distinct (as top-k children
    are)."""
    lay = TS.tree_layout(branching)
    toks = np.zeros((b, lay["n_nodes"]), np.int32)
    toks[:, 0] = rng.integers(0, vocab, b)
    for i in range(lay["n_nodes"]):
        fc = int(lay["first_child"][i])
        if fc < 0:
            continue
        k = branching[int(lay["depth"][i])]
        for r in range(b):
            toks[r, fc:fc + k] = rng.permutation(vocab)[:k]
    return toks


@pytest.mark.parametrize("branching", BRANCHINGS, ids=IDS)
def test_tree_greedy_acceptance_matches_jax(branching):
    """Random logits over a 4-token vocabulary, so paths of every depth
    get accepted."""
    rng = np.random.default_rng(0)
    b, v = 64, 4
    toks = _tree_tokens(rng, b, branching, v)
    logits = rng.standard_normal((b, toks.shape[1], v)).astype(np.float32)
    want = JS.tree_greedy_acceptance(jnp.asarray(toks), jnp.asarray(logits),
                                     branching)
    got = TS.tree_greedy_acceptance(torch.from_numpy(toks).long(),
                                    torch.from_numpy(logits), branching)
    for g, w, name in zip(got, want, ("a", "next", "out", "path_idx")):
        _eq(g, w, name)
    a = got[0].numpy()
    assert (a == 0).any() and (a == len(branching)).any()


@pytest.mark.parametrize("branching", [(2,), (3, 2), (2, 2, 1),
                                       (2, 2, 2, 2)], ids=lambda b: str(b))
def test_tree_greedy_acceptance_through_a_later_child(branching):
    """Logits built so that the target's greedy path runs through the
    last child of every node with siblings: the accepted path and its
    buffer indices must follow it."""
    lay = TS.tree_layout(branching)
    n, v = lay["n_nodes"], 64
    toks = np.arange(n, dtype=np.int32)[None, :] % v          # distinct
    logits = np.zeros((1, n, v), np.float32)
    cur, want_path = 0, [0]
    for d, k in enumerate(branching):
        child = int(lay["first_child"][cur]) + k - 1
        logits[0, cur, toks[0, child]] = 5.0
        cur = child
        want_path.append(child)
    logits[0, cur, 7] = 5.0                                   # the bonus
    want = JS.tree_greedy_acceptance(jnp.asarray(toks), jnp.asarray(logits),
                                     branching)
    got = TS.tree_greedy_acceptance(torch.from_numpy(toks).long(),
                                    torch.from_numpy(logits), branching)
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[0][0]) == len(branching) and int(got[1][0]) == 7
    assert got[3][0].tolist() == want_path
    assert got[2][0].tolist() == [int(toks[0, i]) for i in want_path[1:]] \
        + [7]


def jax_tree_noise(key, b, branching, vocab):
    """The draws ``tree_sampled_acceptance`` makes from ``key``
    (``repro/core/spec_decode.py:505-555``): per level one uniform per
    child, then one categorical; a last categorical for the bonus."""
    keys = jax.random.split(key, sum(branching) + len(branching) + 1)
    us, gs, ki = [], [], 0
    for k_d in branching:
        for _ in range(k_d):
            us.append(jax.random.uniform(keys[ki], (b,)))
            ki += 1
        gs.append(jax.random.gumbel(keys[ki], (b, vocab), jnp.float32))
        ki += 1
    gs.append(jax.random.gumbel(keys[ki], (b, vocab), jnp.float32))
    return (torch.from_numpy(np.stack([np.asarray(u) for u in us], 1)),
            torch.from_numpy(np.stack([np.asarray(g) for g in gs], 1)))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("branching", BRANCHINGS, ids=IDS)
def test_tree_sampled_acceptance_matches_jax(branching, temperature):
    rng = np.random.default_rng(1)
    b, v = 64, 6
    toks = _tree_tokens(rng, b, branching, v)
    n = toks.shape[1]
    dl = rng.standard_normal((b, n, v)).astype(np.float32)
    tl = (dl + 0.7 * rng.standard_normal((b, n, v))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = JS.tree_sampled_acceptance(jnp.asarray(toks), jnp.asarray(dl),
                                      jnp.asarray(tl), branching, key,
                                      temperature=temperature)
    got = TS.tree_sampled_acceptance(
        torch.from_numpy(toks).long(), torch.from_numpy(dl),
        torch.from_numpy(tl), branching, *jax_tree_noise(key, b, branching,
                                                         v),
        temperature=temperature)
    for g, w, name in zip(got, want, ("a", "next", "out", "path_idx")):
        _eq(g, w, name)
    a = got[0].numpy()
    assert (a == 0).any() and (a > 0).any()


# ---------------------------------------------------------------------------
# accepted-path compaction


def _random_path(rng, b, branching):
    """(path_idx (B, D+1), a (B,)): a random accepted depth and path."""
    lay = TS.tree_layout(branching)
    path = np.zeros((b, len(branching) + 1), np.int32)
    a = rng.integers(0, len(branching) + 1, b).astype(np.int32)
    for r in range(b):
        cur = 0
        for d in range(int(a[r])):
            cur = int(lay["first_child"][cur]) + int(
                rng.integers(0, branching[d]))
            path[r, d + 1] = cur
    return path, a


def _layer_leaves(jcache, jcfg, l):
    """Layer ``l``'s leaves of a JAX cache (stacked over layer groups)."""
    pat = len(jcfg.layer_pattern)
    return {k: np.asarray(v[l // pat])
            for k, v in jcache["layers"][l % pat].items()}


def _fill_like(jcache, tcache, jcfg, rng):
    """Random values into both caches' layer leaves (the same numbers)."""
    new_layers = []
    for leaf in jcache["layers"]:
        new_layers.append({k: rng.standard_normal(v.shape).astype(v.dtype)
                           for k, v in leaf.items()})
    jcache = dict(jcache, layers=tuple({k: jnp.asarray(v)
                                        for k, v in leaf.items()}
                                       for leaf in new_layers))
    for l in range(jcfg.n_layers):
        for k, v in _layer_leaves(jcache, jcfg, l).items():
            tcache["layers"][l][k].copy_(torch.from_numpy(v.copy()))
    return jcache, tcache


@pytest.mark.parametrize("pos_offset", [0, "n_nodes"])
@pytest.mark.parametrize("branching", BRANCHINGS, ids=IDS)
def test_tree_commit_cache_contiguous_matches_jax(models, branching,
                                                  pos_offset):
    """Overlapping gather/scatter, with sources clipped and destinations
    dropped past the cache end (one row's buffer starts two slots before
    the end, another's past it)."""
    (_, jd, _, _), (_, td, _, _) = models
    rng = np.random.default_rng(2)
    n = TS.tree_n_nodes(branching)
    off = n if pos_offset == "n_nodes" else 0
    b, s = 4, 40
    base = np.array([5, 17, s - 2, s + 1], np.int64)
    jc, tc = _fill_like(JT.init_cache(jd, b, s),
                        TT.init_cache(td, b, s, CPU), jd, rng)
    jc["pos"] = jnp.asarray(base + off, jnp.int32)
    tc["pos"] = torch.from_numpy(base + off)
    path, a = _random_path(rng, b, branching)
    want = JS.tree_commit_cache(jd, jc, jnp.asarray(path), jnp.asarray(a),
                                branching, pos_offset=off)
    got = TS.tree_commit_cache(td, tc, torch.from_numpy(path).long(),
                               torch.from_numpy(a).long(), branching,
                               pos_offset=off)
    _eq(got["pos"], want["pos"], "pos")
    for l in range(jd.n_layers):
        for k, v in _layer_leaves(want, jd, l).items():
            _eq(got["layers"][l][k], v, f"layer {l} {k}")


@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8_pool"])
@pytest.mark.parametrize("branching", [(2,), (3, 2), (2, 2, 2, 2)],
                         ids=lambda b: str(b))
def test_tree_commit_cache_paged_matches_jax(models, branching, quant):
    """Through the block tables; slot 2 is dead (its table row null, so
    its rows aim at the scratch block 0, which is not compared)."""
    (jt, _, _, _), (tt, _, _, _) = models
    rng = np.random.default_rng(3)
    b, bs, mbs, nb = 3, 4, 12, 32
    jc = JT.init_paged_cache(jt, b, nb, bs, mbs, kv_quant=quant)
    tc = TT.init_paged_cache(tt, b, nb, bs, mbs, kv_quant=quant, device=CPU)
    if quant:      # int8 rows and f32 scales, the same bits on both sides
        layers = []
        for leaf in jc["layers"]:
            layers.append({k: jnp.asarray(
                rng.integers(-127, 128, v.shape).astype(np.int8)
                if v.dtype == jnp.int8 else
                rng.random(v.shape).astype(np.float32))
                for k, v in leaf.items()})
        jc = dict(jc, layers=tuple(layers))
        for l in range(jt.n_layers):
            for k, v in _layer_leaves(jc, jt, l).items():
                tc["layers"][l][k].copy_(torch.from_numpy(v.copy()))
    else:
        jc, tc = _fill_like(jc, tc, jt, rng)
    tables = np.zeros((b, mbs), np.int32)
    perm = rng.permutation(nb - 1) + 1
    tables[0], tables[1] = perm[:mbs], perm[mbs:2 * mbs]
    base = np.array([9, 30, 13], np.int64)
    jc = dict(jc, block_tables=jnp.asarray(tables),
              pos=jnp.asarray(base, jnp.int32))
    tc["block_tables"] = torch.from_numpy(tables)
    tc["pos"] = torch.from_numpy(base)
    path, a = _random_path(rng, b, branching)
    want = JS.tree_commit_cache(jt, jc, jnp.asarray(path), jnp.asarray(a),
                                branching)
    got = TS.tree_commit_cache(tt, tc, torch.from_numpy(path).long(),
                               torch.from_numpy(a).long(), branching)
    _eq(got["pos"], want["pos"], "pos")
    for l in range(jt.n_layers):
        for k, v in _layer_leaves(want, jt, l).items():
            _eq(got["layers"][l][k][1:], v[1:], f"layer {l} {k}")


# ---------------------------------------------------------------------------
# drafting and the masked decode


def _prefill_both(j, t, prompts, max_len, paged=False):
    """Prefill a contiguous cache in both packages; with ``paged`` the
    target's rows go into a block pool (slot i's blocks 1 + i*mbs..)."""
    jcfg, jp, tcfg, tp = j + t
    b = prompts.shape[0]
    jc = JT.init_cache(jcfg, b, max_len)
    tc = TT.init_cache(tcfg, b, max_len, CPU)
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(prompts), jc)
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(prompts).long(), tc)
    if not paged:
        return jl, jc, tl, tc
    bs = 4
    mbs = max_len // bs
    jpc = JT.init_paged_cache(jcfg, b, 1 + b * mbs, bs, mbs)
    tpc = TT.init_paged_cache(tcfg, b, 1 + b * mbs, bs, mbs, device=CPU)
    for i in range(b):
        row = np.arange(1 + i * mbs, 1 + (i + 1) * mbs, dtype=np.int32)
        one_j = {"layers": jax.tree.map(lambda x: x[:, i:i + 1], jc["layers"]),
                 "pos": jc["pos"][i:i + 1]}
        one_t = {"layers": [{k: v[i:i + 1] for k, v in leaf.items()}
                            for leaf in tc["layers"]],
                 "pos": tc["pos"][i:i + 1]}
        jpc = JT.admit_sequence_paged(jcfg, jpc, one_j, i, jnp.asarray(row),
                                      prompts.shape[1], 0)
        TT.admit_sequence_paged(tcfg, tpc, one_t, i, row, prompts.shape[1],
                                0)
    return jl, jpc, tl, tpc


@pytest.mark.parametrize("branching", BRANCHINGS, ids=IDS)
def test_draft_tree_generate_matches_jax(models, branching):
    (_, jd, _, jdp), (_, td, _, tdp) = models
    prompts = np.random.default_rng(4).integers(
        0, td.vocab_size, (3, 7)).astype(np.int32)
    jl, jc, tl, tc = _prefill_both((jd, jdp), (td, tdp), prompts, 48)
    want = JS.draft_tree_generate(jdp, jd, jc, jnp.argmax(jl, -1),
                                  branching, collect_logits=True)
    got = TS.draft_tree_generate(tdp, td, tc, torch.argmax(tl, -1),
                                 branching, collect_logits=True)
    _eq(got[0], want[0], "tree buffer")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=ATOL)
    _eq(got[2]["pos"], want[2]["pos"], "pos")
    end = int(want[2]["pos"][0])
    np.testing.assert_allclose(got[2]["layers"][1]["k"][:, :end].numpy(),
                               _layer_leaves(want[2], jd, 1)["k"][:, :end],
                               atol=ATOL)


def test_top_k_orders_ties_by_index():
    logits = torch.tensor([[0.5, 2.0, 1.0, 2.0, 1.0, 2.0]])
    assert TS.top_k_indices(logits, 4).tolist() == [[1, 3, 5, 2]]
    _, want = jax.lax.top_k(jnp.asarray(logits.numpy()), 4)
    assert np.asarray(want).tolist() == [[1, 3, 5, 2]]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("branching", [(3, 2), (2, 2, 2, 2)],
                         ids=lambda b: str(b))
def test_decode_with_spec_tree_matches_jax(models, branching, paged):
    """``M.decode`` on the target with a whole tree buffer (``prev == 0``,
    the verify kernels' route on a card) and level by level (the draft's
    feeds, ``prev > 0``): logits at every node and the written rows."""
    (jt, _, jtp, _), (tt, _, ttp, _) = models
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, tt.vocab_size, (2, 9)).astype(np.int32)
    buf = _tree_tokens(rng, 2, branching, tt.vocab_size)
    for level_feed in (False, True):
        _, jc, _, tc = _prefill_both((jt, jtp), (tt, ttp), prompts, 48,
                                     paged)
        if not level_feed:
            feeds = [(buf, None)]
        else:
            lay = TS.tree_layout(branching)
            feeds = [(buf[:, o:o + c], d) for d, (o, c) in enumerate(
                zip(lay["level_offsets"], lay["level_sizes"]))]
        for toks, level in feeds:
            jl, jc, _ = JM.decode(jtp, jt, jc, jnp.asarray(toks),
                                  spec_tree=JS.tree_spec(branching, level))
            tl, tc, _ = TM.decode(ttp, tt, tc, torch.from_numpy(toks).long(),
                                  spec_tree=TS.tree_spec(branching, level,
                                                         device=CPU))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                       err_msg=f"level {level}")
            if level is not None:
                jc = dict(jc, pos=jc["pos"] + toks.shape[1])
                tc = dict(tc, pos=tc["pos"] + toks.shape[1])
        np.testing.assert_allclose(tc["layers"][0]["k"].numpy(),
                                   np.asarray(jc["layers"][0]["k"][0]),
                                   atol=ATOL)


def test_swa_layers_refuse_a_tree(models):
    """A sliding-window layer cannot hold a branched buffer (JAX raises
    the same)."""
    cfg = dataclasses.replace(MISTRAL_7B.reduced(d_model=32), n_layers=1)
    jcfg = dataclasses.replace(J_MISTRAL.reduced(d_model=32), n_layers=1)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(1))
    tp = from_jax(jax.tree.map(np.asarray, jp), cfg, CPU)
    toks = np.zeros((1, 3), np.int32)
    with pytest.raises(ValueError, match="full attention"):
        JM.decode(jp, jcfg, JT.init_cache(jcfg, 1, 16), jnp.asarray(toks),
                  spec_tree=JS.tree_spec((2,)))
    with pytest.raises(ValueError, match="full attention"):
        TM.decode(tp, cfg, TT.init_cache(cfg, 1, 16, CPU),
                  torch.from_numpy(toks).long(),
                  spec_tree=TS.tree_spec((2,), device=CPU))


# ---------------------------------------------------------------------------
# whole rounds, the pipeline and the engine


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("branching", [(1,), (3, 2), (2, 2, 2, 2)],
                         ids=lambda b: str(b))
def test_spec_round_tree_matches_jax(models, branching, sample):
    """Four rounds; the greedy case also runs the target as its own draft
    (every round accepted to full depth, the compaction moving real
    rows)."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    drafts = [((jd, jdp), (td, tdp))]
    if not sample:
        drafts.append(((jt, jtp), (tt, ttp)))
    prompts = np.random.default_rng(6).integers(
        0, tt.vocab_size, (3, 8)).astype(np.int32)
    round_fn = jax.jit(partial(JS.spec_round_tree, sample=sample),
                       static_argnames=("target_cfg", "draft_cfg",
                                        "branching", "mesh"))
    for (jdc_cfg, jdc_p), (tdc_cfg, tdc_p) in drafts:
        jl, jtc, tl, ttc = _prefill_both((jt, jtp), (tt, ttp), prompts, 96)
        _, jdc, _, tdc = _prefill_both((jdc_cfg, jdc_p), (tdc_cfg, tdc_p),
                                       prompts, 96)
        jn, tn = jnp.argmax(jl, -1), torch.argmax(tl, -1)
        key = jax.random.PRNGKey(8)
        for _ in range(4):
            key, sub = jax.random.split(key)
            want = round_fn(jtp, jt, jtc, jdc_p, jdc_cfg, jdc, jn, branching,
                            key=sub)
            noise = (jax_tree_noise(sub, 3, branching, tt.vocab_size)
                     if sample else None)
            got = TS.spec_round_tree(ttp, tt, ttc, tdc_p, tdc_cfg, tdc, tn,
                                     branching, noise=noise, sample=sample)
            for k in ("tokens", "n_emitted", "n_accept", "t_next"):
                _eq(got[k], want[k], k)
            jtc, jdc, jn = (want["target_cache"], want["draft_cache"],
                            want["t_next"])
            ttc, tdc, tn = (got["target_cache"], got["draft_cache"],
                            got["t_next"])
            for jc, tc in ((jtc, ttc), (jdc, tdc)):
                _eq(tc["pos"], jc["pos"], "pos")
                end = int(np.asarray(jc["pos"]).min())
                np.testing.assert_allclose(
                    tc["layers"][0]["k"][:, :end].numpy(),
                    np.asarray(jc["layers"][0]["k"][0, :, :end]), atol=ATOL)
        if tdc_cfg is tt:
            assert (got["n_accept"].numpy() == len(branching)).all()


def _greedy(params, cfg, prompt, steps):
    cache = TT.init_cache(cfg, 1, len(prompt) + steps + 1, CPU)
    lg, cache = TM.prefill(params, cfg, torch.as_tensor(prompt[None]).long(),
                           cache)
    out = []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        out.append(int(tok[0]))
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None])
    return np.asarray(out)


def test_tree_pipeline_matches_jax(models):
    """The tree-mode rotation at one shape signature, with no rollback
    entry, lossless and equal to the JAX pipeline's tokens."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    prompts = np.random.default_rng(7).integers(
        0, tt.vocab_size, (4, 6)).astype(np.int32)
    gen = 10
    je = JEngine(jt, jd)
    je.load(jtp, jdp)
    js = [je.prefill_batch(jnp.asarray(p), 96) for p in (prompts[:2],
                                                         prompts[2:])]
    jpipe = je.pipeline(0, tree=(3, 2))
    s0, s1, jrounds = jpipe.run(js, gen)
    want, _ = je.finalize([s0, s1], gen)
    te = SpecOffloadEngine(tt, td, device=CPU)
    te.load(ttp, tdp)
    ts = [te.prefill_batch(p, 96) for p in (prompts[:2], prompts[2:])]
    pipe = te.pipeline(0, tree=(3, 2))
    s0, s1, rounds = pipe.run(ts, gen)
    got, _ = te.finalize([s0, s1], gen)
    _eq(got, want)
    assert rounds == jrounds
    assert pipe.trace_counts == {"fused": 1, "draft": 1, "rollback": 0}
    for r in range(4):
        _eq(got[r], _greedy(ttp, tt, prompts[r], gen), f"row {r} vs greedy")


def test_tree_pipeline_and_engine_reject_an_swa_draft(models):
    (jt, _, _, _), (tt, _, _, _) = models
    jbad = J_MISTRAL.reduced(d_model=32, vocab=jt.vocab_size)
    tbad = MISTRAL_7B.reduced(d_model=32, vocab=tt.vocab_size)
    with pytest.raises(ValueError, match="all-attention"):
        JI.InterleavedPipeline(None, jt, None, jbad, 0, tree=(2,))
    with pytest.raises(ValueError, match="all-attention"):
        TI.InterleavedPipeline(None, tt, None, tbad, 0, tree=(2,))
    with pytest.raises(ValueError, match="spec_tree requires"):
        jserve.ServingEngine(jt, jbad,
                             config=jserve.SchedulerConfig(spec_tree=(2,)))
    with pytest.raises(ValueError, match="spec_tree requires"):
        tserve.ServingEngine(tt, tbad, device=CPU,
                             config=tserve.SchedulerConfig(spec_tree=(2,)))
    with pytest.raises(ValueError, match="31"):
        tserve.ServingEngine(tt, tt, device=CPU,
                             config=tserve.SchedulerConfig(spec_tree=(2,) * 5))


@pytest.mark.parametrize("group,head_dim,branching,n_groups", [
    (2, 16, (2, 2, 2, 2), 1),         # 62 rows
    (8, 16, (3, 2), 1),               # 80 rows
    (8, 16, (2, 2, 2, 2), 2),         # 248 rows > 128: 2 groups of 124
    (4, 256, (3, 2), 1),              # 40 rows
    (4, 256, (2, 2, 2, 2), 2),        # 124 rows > 76 at head dim 256
])
def test_engine_checks_the_verify_kernels_row_limit(models, group, head_dim,
                                                    branching, n_groups):
    """The target verifies the whole tree buffer in one verify-kernel
    call, (Hq / Hkv) * n_nodes query rows.  Past one CTA's capacity the
    kernels deal the rows out to row groups, so the engine takes every
    tree the node cap allows, as the JAX engine does."""
    from repro_torch.kernels.decode_attention import max_rows, row_groups
    (_, _, _, _), (tt, td, _, _) = models
    tgt = dataclasses.replace(tt, n_heads=8, n_kv_heads=8 // group,
                              head_dim=head_dim)
    tserve.ServingEngine(tgt, td, device=CPU,
                         config=tserve.SchedulerConfig(max_batch=1,
                                                       spec_tree=branching))
    rows = group * TS.tree_n_nodes(branching)
    groups, per = row_groups(rows, head_dim)
    assert groups == n_groups and per <= max_rows(head_dim)


def _trace(vocab, mod, rate_rps):
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, 8).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, vocab, n)])
               .astype(np.int32) for n in (5, 2, 5, 2, 5, 2, 5)]
    gens = rng.integers(3, 10, len(prompts)).tolist()
    return mod(prompts, gens, rate_rps=rate_rps, seed=7)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_serving_tree_matches_jax(models, paged):
    """``ServingEngine(spec_tree=(3, 2))`` against the JAX engine: the
    streams, the admission order, ``kv_stats()`` and the ``stats()``
    counters; every stream equal to the greedy decode, one fused shape
    signature.  All requests arrive at once, so the admission order does
    not depend on either engine's wall clock."""
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = models
    cfg = dict(max_batch=2, n_cand=2, spec_tree=(3, 2), block_size=4,
               paged=paged)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    te = tserve.ServingEngine(tt, td, config=tserve.SchedulerConfig(**cfg),
                              device=CPU)
    te.load(ttp, tdp)
    jreqs = _trace(jt.vocab_size, j_poisson, 1e6)
    treqs = _trace(tt.vocab_size, poisson_requests, 1e6)
    for eng, reqs in ((je, jreqs), (te, treqs)):
        for r in reqs:
            assert eng.submit(r)
        eng.run()
    order = lambda reqs: [r.rid for r in sorted(reqs,
                                                key=lambda r: r.admitted_s)]
    assert order(treqs) == order(jreqs)
    for jr, tr in zip(jreqs, treqs):
        _eq(tr.result, jr.result, f"rid {tr.rid} vs JAX")
        _eq(tr.result, _greedy(ttp, tt, tr.prompt, tr.max_new_tokens),
            f"rid {tr.rid} vs greedy")
    assert te.kv_stats() == je.kv_stats()
    ts, js = te.stats(), je.stats()
    for k in ("rounds", "tokens_out", "fused_compiles", "rejected",
              "spec_mode", "spec_tree"):
        assert ts[k] == js[k], k
    assert ts["spec_mode"] == "tree" and ts["fused_compiles"] == 1
    assert te.engine._pipe.trace_counts["rollback"] == 0


def test_verify_kernels_count_tree_launches_apart(monkeypatch):
    """With the build stubbed out, a verify call with ``anc_bits`` counts
    as a ``tree`` launch of its wrapper and one without as ``causal``
    (or ``window``): the serve run reads them apart."""
    from repro_torch.kernels import _build, launch_counts, reset_launches
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_decode_attention as pd
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "bind", lambda *a: lambda *args: 0)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    reset_launches()
    bits = torch.as_tensor(TS.tree_layout((3, 2))["anc_bits"])
    q = torch.zeros(1, 4, 10, 64)
    lengths = torch.tensor([30], dtype=torch.int32)
    pool = torch.zeros(5, 8, 2, 64)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    kv = torch.zeros(1, 2, 32, 64)
    for anc in (bits, None):
        pd.paged_decode_attention(q, pool, pool, table, lengths, anc_bits=anc)
        da.decode_attention(q, kv, kv, lengths, anc_bits=anc)
    da.decode_attention(q, kv, kv, lengths, window=16)
    counts = {k: n for k, n in launch_counts().items() if n}
    reset_launches()
    assert counts == {"paged_decode_attention": 2,
                      "paged_decode_attention causal": 1,
                      "paged_decode_attention tree": 1,
                      "decode_attention": 3, "decode_attention causal": 1,
                      "decode_attention window": 1,
                      "decode_attention tree": 1}
