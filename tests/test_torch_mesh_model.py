"""The whole model on a (2, 4) mesh of eight gloo ranks on the CPU against
the JAX package's single device, on ``from_jax`` weights.

One spawn (``tests/test_torch_distributed.py``'s harness: a file store in
the test's temporary directory, never a fixed port; the ranks joined
within ``JOIN_S``) shared by every test here runs, on each rank:

* the layout: every family's parameters laid out by ``param_specs``
  (``shard_model``) and gathered back bit for bit, no rank holding a
  whole copy of a leaf its spec splits;
* prefill and 4 greedy decode steps of a dense config at JAX's test
  widths (4 heads, 2 kv heads: they do not split over 4 ranks, so the
  ranks gather q/k/v), a dense config with 8 and 4 heads (split: each
  rank attends over its own heads, its caches hold its kv heads; a tied
  512-token vocabulary, split too), a reduced RG-LRU hybrid, RWKV-6 and a
  dropless MoE with 8 experts (``ep`` prefill, ``ep_psum`` decode) and
  with 6 (``tp`` prefill, ``tp_psum`` decode), and a reduced Whisper
  (the encoder gathered whole, the cross K/V in the cache): logits within
  1e-4 of JAX's, every rank's logits the same bits, greedy tokens equal;
* the bytes every collective of one decode step moves, at B 2 and B 4:
  exactly twice as many at twice the batch (they scale with B x m: a
  weight moved would add a term the batch does not scale);
* ``SpecOffloadEngine(mesh=)`` on the serving benchmark's smoke configs,
  chain (``generate``) and tree (3, 2): streams token-identical to JAX's
  engine, one fused shape signature on every rank;
* one ``make_train_step(cfg, mesh, 1e-3, accum_steps=2)`` of a dense
  config (remat), a dropless MoE and an Adafactor config: the loss within
  relative 1e-5 of JAX's single-device step, every parameter, gathered,
  under ``tests/test_torch_train.py``'s first-step rule (Adafactor's step
  is proportional to the bf16-accumulated gradient, so there within two
  bf16 ulps of JAX's step, and at ``accum_steps=1`` under the rule); the
  dense and MoE gradients of every leaf, gathered, against one
  process's port;
* the dense MLP's gradient over the mesh (row-parallel down projection)
  against one process's: a gradient ``m`` times too large fails it.

The ranks import neither JAX nor the JAX package; the JAX references are
computed here while the ranks run."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

from test_torch_distributed import JOIN_S, SRC, _rank_main  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import apply_mlp, mlp_specs  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

SHAPE = (2, 4)
B, L, STEPS = 4, 8, 4
GEN, N_CAND, TREE = 8, 2, (3, 2)
TRAIN_B, TRAIN_S, LR = 8, 32, 1e-3
DENSE = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
             dtype="float32", remat=False)
MOE = dict(DENSE, arch_type="moe", d_ff=96, n_experts=8, top_k=2,
           moe_dropless=True)


def _cfg(key: str, C):
    """The case's config from configs module ``C`` (the port's or JAX's:
    the two are field for field the same)."""
    if key == "dense":
        return C.ModelConfig(**DENSE)
    if key == "dense_split":
        return C.ModelConfig(**dict(DENSE, n_heads=8, n_kv_heads=4,
                                    vocab_size=512, tie_embeddings=True))
    if key == "moe":
        return C.ModelConfig(**MOE)
    if key == "moe_tp":             # 6 experts do not split over 4 ranks
        return C.ModelConfig(**dict(MOE, n_experts=6))
    if key == "rglru":
        return C.RECURRENTGEMMA_2B.reduced(d_model=64, n_layers=3)
    if key == "rwkv":
        return C.RWKV6_7B.reduced(d_model=64)
    if key == "whisper":
        return C.WHISPER_BASE.reduced(d_model=64)
    if key == "train_dense":
        return dataclasses.replace(_cfg("dense", C), remat=True)
    if key == "train_moe":
        return _cfg("moe", C)
    if key in ("train_adafactor", "train_adafactor_1"):
        return C.LLAMA3_405B.reduced(d_model=64)
    if key in ("target", "draft", "tree_draft"):
        t = C.MIXTRAL_8X7B.reduced(d_model=64)
        if key == "target":
            return t
        d = C.MISTRAL_7B.reduced(d_model=32, vocab=t.vocab_size)
        if key == "tree_draft":
            d = dataclasses.replace(d, layer_pattern=("attn",) * 2,
                                    n_layers=2)
        return d
    raise KeyError(key)


MODELS = ("dense", "dense_split", "rglru", "rwkv", "moe", "moe_tp",
          "whisper")
TRAINS = ("train_dense", "train_moe", "train_adafactor",
          "train_adafactor_1")


def _accum(key: str) -> int:
    return 1 if key.endswith("_1") else 2
ENGINE = ("target", "draft", "tree_draft")


# ---------------------------------------------------------------------------
# ranks (spawned: this module is imported in each, without JAX)


def _model_run(params, cfg, mesh, tokens, frames):
    """Prefill, then ``STEPS`` greedy decode steps: (logits, tokens)."""
    cache = init_cache(cfg, B, L + STEPS + 1, "cpu", mesh)
    lg, cache = TM.prefill(params, cfg, tokens, cache, mesh,
                           frames if cfg.encoder_decoder else None)
    logits, toks = [lg], []
    for _ in range(STEPS):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None], mesh)
        logits.append(lg)
    return (torch.stack(logits, 1).numpy(), torch.stack(toks, 1).numpy())


def _layout(whole, params, cfg, mesh) -> dict:
    specs = TM.mesh_specs(cfg, mesh)
    back = tree_flatten(tmesh.gather_params(params, specs, mesh))
    flat = tree_flatten(specs, is_leaf=tmesh.is_spec)
    mine = tree_flatten(params)
    return {path: (torch.equal(back[path], leaf), tuple(mine[path].shape),
                   tuple(leaf.shape), flat[path])
            for path, leaf in tree_flatten(whole).items()}


def _decode_bytes(params, cfg, mesh, tokens, b) -> int:
    """The bytes this rank hands the collectives of one decode step."""
    cache = init_cache(cfg, b, L + 2, "cpu", mesh)
    lg, cache = TM.prefill(params, cfg, tokens[:b], cache, mesh)
    tmesh.reset_collective_bytes()
    TM.decode_step(params, cfg, cache, torch.argmax(lg, -1)[:, None], mesh)
    return sum(tmesh.collective_bytes().values())


def _engine_run(w, mesh):
    tcfg = _cfg("target", TC)
    out = {}
    for mode, dkey in (("chain", "draft"), ("tree", "tree_draft")):
        dcfg = _cfg(dkey, TC)
        eng = SpecOffloadEngine(tcfg, dcfg, device="cpu", mesh=mesh)
        eng.load(from_jax(w["target"], tcfg, "cpu"),
                 from_jax(w[dkey], dcfg, "cpu"))
        prompts = w["prompts"]
        if mode == "chain":
            res = eng.generate(prompts, GEN, n_cand=N_CAND)
            toks, rounds = res.tokens, res.rounds
        else:
            states = [eng.prefill_batch(p, 64)
                      for p in (prompts[:2], prompts[2:])]
            pipe = eng.pipeline(0, tree=TREE)
            s0, s1, rounds = pipe.run(states, GEN)
            toks, _ = eng.finalize([s0, s1], GEN)
        out[mode] = (np.asarray(toks), rounds, dict(eng._pipe.trace_counts))
    return out


def _train_run(key, w, mesh):
    cfg = _cfg(key, TC)
    params = TM.shard_model(from_jax(w[key], cfg, "cpu"), cfg, mesh)
    specs = TM.mesh_specs(cfg, mesh)
    batch = {"tokens": w["train_tokens"]}
    out = {}
    if not key.startswith("train_adafactor"):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        _, grads = loss_and_grads(
            params, cfg, {"tokens": torch.from_numpy(w["train_tokens"])
                          .long()}, mesh)
        out["grads"] = tree_map(
            lambda t: t.numpy(),
            tmesh.gather_params(tree_unflatten(params, grads), specs, mesh))
    state = make_optimizer(cfg.optimizer)[0](params, cfg)
    step = make_train_step(cfg, mesh, LR, accum_steps=_accum(key))
    params, state, loss = step(params, state, batch)
    out["loss"] = float(loss)
    out["grad_norm"] = float(step.grad_norm)
    out["params"] = tree_map(lambda t: t.detach().numpy(),
                             tmesh.gather_params(params, specs, mesh))
    return out


def _mlp_case(mesh):
    """The dense MLP over the rank's rows (training's layout), its loss
    summed over ``data``: (loss, dx, weight gradients), gathered whole.
    ``mesh`` None: the same on one process."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 64, generator=g)
    r = torch.randn(4, 8, 64, generator=g)
    whole = {"w_gate": torch.randn(64, 96, generator=g) * 0.1,
             "w_up": torch.randn(64, 96, generator=g) * 0.1,
             "w_down": torch.randn(96, 64, generator=g) * 0.1}
    specs = mlp_specs("swiglu")
    p = whole if mesh is None else tmesh.shard_params(whole, specs, mesh)
    if mesh is not None:
        x, r = (tmesh.block(t, mesh, "data", 0) for t in (x, r))
    x = x.clone().requires_grad_(True)
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    loss = (apply_mlp(p, x, "swiglu", mesh) * r).sum()
    if mesh is not None:
        loss = tmesh.all_reduce(loss, mesh, "data")
    dx, *dw = torch.autograd.grad(loss, [x, *p.values()])
    dw = dict(zip(p, dw))
    if mesh is not None:
        with torch.no_grad():
            dx = tmesh.all_gather(dx, mesh, "data", 0)
            dw = tmesh.gather_params(dw, specs, mesh)
    return (float(loss.detach()), dx.numpy(),
            {k: v.numpy() for k, v in dw.items()})


def _mesh_ranks(rank, weights):
    with open(weights, "rb") as f:
        w = pickle.load(f)
    mesh = tmesh.make_mesh(SHAPE, device_type="cpu")
    tokens = torch.from_numpy(w["tokens"]).long()
    out = {"layout": {}, "model": {}, "bytes": {}}
    for key in MODELS:
        cfg = _cfg(key, TC)
        whole = from_jax(w[key], cfg, "cpu")
        params = TM.shard_model(whole, cfg, mesh)
        out["layout"][key] = _layout(whole, params, cfg, mesh)
        out["model"][key] = _model_run(params, cfg, mesh, tokens,
                                       torch.from_numpy(w["frames"]))
        if key in ("dense", "dense_split", "moe", "moe_tp"):
            out["bytes"][key] = (
                {b: _decode_bytes(params, cfg, mesh, tokens, b)
                 for b in (2, 4)},
                sum(t.numel() * t.element_size()
                    for path, t in tree_flatten(params).items()
                    if "/attn/" in path or "/ffn/" in path))
    out["engine"] = _engine_run(w, mesh)
    out["train"] = {key: _train_run(key, w, mesh) for key in TRAINS}
    out["mlp"] = _mlp_case(mesh)
    return out


# ---------------------------------------------------------------------------
# the JAX side


def _jax_refs(w) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.core.pipeline import SpecOffloadEngine as JEngine
    from repro.models import model as JM
    from repro.models.transformer import init_cache as j_init_cache
    from repro.training.optimizer import make_optimizer as j_make_opt
    from repro.training.train_loop import make_train_step as j_make_step

    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    ref = {"model": {}, "engine": {}, "train": {}}
    for key in MODELS:
        cfg, p = _cfg(key, JC), to_j(w[key])
        cache = j_init_cache(cfg, B, L + STEPS + 1)
        lg, cache = JM.prefill(p, cfg, jnp.asarray(w["tokens"]), cache,
                               encoder_frames=(jnp.asarray(w["frames"])
                                               if cfg.encoder_decoder
                                               else None))
        logits, toks = [lg], []
        for _ in range(STEPS):
            tok = jnp.argmax(lg, -1)
            toks.append(tok)
            lg, cache = JM.decode_step(p, cfg, cache, tok[:, None])
            logits.append(lg)
        ref["model"][key] = (np.stack([np.asarray(a) for a in logits], 1),
                             np.stack([np.asarray(a) for a in toks], 1))
    tcfg = _cfg("target", JC)
    prompts = jnp.asarray(w["prompts"])
    for mode, dkey in (("chain", "draft"), ("tree", "tree_draft")):
        je = JEngine(tcfg, _cfg(dkey, JC))
        je.load(to_j(w["target"]), to_j(w[dkey]))
        if mode == "chain":
            res = je.generate(prompts, GEN, n_cand=N_CAND)
            ref["engine"][mode] = (np.asarray(res.tokens), res.rounds)
        else:
            states = [je.prefill_batch(p, 64)
                      for p in (prompts[:2], prompts[2:])]
            s0, s1, rounds = je.pipeline(0, tree=TREE).run(states, GEN)
            toks, _ = je.finalize([s0, s1], GEN)
            ref["engine"][mode] = (np.asarray(toks), rounds)
    batch = {"tokens": jnp.asarray(w["train_tokens"])}
    for key in TRAINS:
        cfg, p = _cfg(key, JC), to_j(w[key])
        step = jax.jit(j_make_step(cfg, None, LR, accum_steps=_accum(key)))
        p1, _, loss = step(p, j_make_opt(cfg.optimizer)[0](p), batch)
        ref["train"][key] = (float(loss), jax.tree.map(np.asarray, p1))
    return ref


def _weights() -> dict:
    import jax

    from repro import configs as JC
    from repro.models import model as JM
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    w = {key: to_np(JM.init_params(_cfg(key, JC), jax.random.PRNGKey(i)))
         for i, key in enumerate(MODELS + TRAINS + ENGINE)}
    rng = np.random.default_rng(0)
    w["tokens"] = rng.integers(0, 97, (B, L)).astype(np.int32)
    w["frames"] = rng.standard_normal((B, 32, 64)).astype(np.float32)
    w["prompts"] = rng.integers(0, 512, (4, L)).astype(np.int32)
    w["train_tokens"] = rng.integers(0, 97, (TRAIN_B, TRAIN_S)).astype(
        np.int32)
    return w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh-model")
    w = _weights()
    weights = tmp / "weights.pkl"
    with open(weights, "wb") as f:
        pickle.dump(w, f)
    out_dir = tmp / "ranks"
    out_dir.mkdir()
    world = int(np.prod(SHAPE))
    ctx = mp.start_processes(
        _rank_main, args=(_mesh_ranks, world, str(tmp / "store"),
                          str(out_dir), (str(weights),)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        ref = _jax_refs(w)
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(world):
        with open(out_dir / f"{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "jax": ref, "weights": w}


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("key", MODELS)
def test_layout_round_trips_and_splits_every_split_leaf(runs, key):
    sizes = dict(zip(("data", "model"), SHAPE))
    for rank, res in enumerate(runs["ranks"]):
        for path, (same, mine, whole, spec) in res["layout"][key].items():
            assert same, (rank, path)
            assert mine == tuple(n // (sizes[a] if a else 1)
                                 for n, a in zip(whole, spec)), (rank, path)
            if any(a and sizes[a] > 1 for a in spec):
                assert np.prod(mine) < np.prod(whole), (rank, path)


@pytest.mark.parametrize("key", MODELS)
def test_prefill_and_decode_match_jax_single_device(runs, key):
    want_lg, want_tok = runs["jax"]["model"][key]
    first = runs["ranks"][0]["model"][key][0]
    for rank, res in enumerate(runs["ranks"]):
        lg, tok = res["model"][key]
        assert lg.shape == want_lg.shape
        err = float(np.abs(lg - want_lg).max())
        assert err < 1e-4, (key, rank, err)
        np.testing.assert_array_equal(tok, want_tok)
        np.testing.assert_array_equal(lg, first)   # the same bits


def test_the_head_routes_are_the_ones_named():
    from repro_torch.models.attention import heads_split, local_kv_heads
    mesh = dataclasses.make_dataclass("M", ["mesh_dim_names", "shape"])(
        ("data", "model"), SHAPE)
    dense, split = _cfg("dense", TC), _cfg("dense_split", TC)
    assert not heads_split(dense.n_heads, dense.n_kv_heads, mesh)
    assert local_kv_heads(dense.n_heads, dense.n_kv_heads, mesh) == 2
    assert heads_split(split.n_heads, split.n_kv_heads, mesh)
    assert local_kv_heads(split.n_heads, split.n_kv_heads, mesh) == 1


@pytest.mark.parametrize("key", ["dense", "dense_split", "moe", "moe_tp"])
def test_decode_moves_activations_not_weights(runs, key):
    for rank, res in enumerate(runs["ranks"]):
        by_b, weight_bytes = res["bytes"][key]
        # exactly linear in B: a weight's bytes would add a term that the
        # batch does not scale
        assert by_b[4] == 2 * by_b[2] > 0, (rank, by_b)
        assert by_b[2] < weight_bytes, (rank, by_b, weight_bytes)


@pytest.mark.parametrize("mode", ["chain", "tree"])
def test_engine_on_the_mesh_streams_equal_jax(runs, mode):
    want, want_rounds = runs["jax"]["engine"][mode]
    for rank, res in enumerate(runs["ranks"]):
        toks, rounds, counts = res["engine"][mode]
        np.testing.assert_array_equal(toks, want)
        assert rounds == want_rounds, (rank, rounds)
        assert counts["fused"] == 1, (rank, counts)


def _bf16_step_close(got, want, before, micro):
    """Adafactor's step is proportional to the gradient, which
    ``accum_steps=2`` sums in bf16 as JAX's does: ``bf16(bf16(g1) + g2)``
    (``micro``: the two microbatches' gradients, one process).  Where the
    mesh's f32 gradients and JAX's round apart, each of the two roundings
    moves by one bf16 ulp, at most 2^-7 of its value: the sum by up to
    2^-7 (|g1| + |g1 + g2|) + 2^-7 |g1|, so an entry's step |w - p0| by
    up to 2^-7 (2 |g1| + |g2|) / |g1 + g2| of itself.  Every entry within
    1e-6 plus that; at ``accum_steps=1`` the case takes the first-step
    rule."""
    got, want, before = (tree_flatten(t) for t in (got, want, before))
    g1, g2 = (tree_flatten(g) for g in micro)
    for path, b in before.items():
        a, w0, p0 = (t.detach().numpy() for t in (got[path], want[path], b))
        m1, m2 = np.abs(g1[path].numpy()), np.abs(g2[path].numpy())
        ratio = (2 * m1 + m2) / np.maximum(
            np.abs(g1[path].numpy() + g2[path].numpy()), 1e-30)
        np.testing.assert_array_less(
            np.abs(a - w0), 1e-6 + 2 ** -7 * np.abs(w0 - p0) * ratio,
            err_msg=path)


@pytest.mark.parametrize("key", TRAINS)
def test_train_step_on_the_mesh_matches_jax(runs, key):
    from test_torch_train import _first_step_close
    w = runs["weights"]
    cfg = _cfg(key, TC)
    want_loss, want_params = runs["jax"]["train"][key]
    _, grads = loss_and_grads(
        tree_map(lambda t: t.requires_grad_(True),
                 from_jax(w[key], cfg, "cpu")), cfg,
        {"tokens": torch.from_numpy(w["train_tokens"]).long()})
    whole = from_jax(w[key], cfg, "cpu")
    grads = tree_unflatten(whole, grads)
    micro = []
    for rows in (slice(0, TRAIN_B // 2), slice(TRAIN_B // 2, TRAIN_B)):
        p = tree_map(lambda t: t.requires_grad_(True),
                     from_jax(w[key], cfg, "cpu"))
        _, g = loss_and_grads(p, cfg, {"tokens": torch.from_numpy(
            w["train_tokens"][rows]).long()})
        micro.append(tree_unflatten(p, g))
    want = from_jax(want_params, cfg, "cpu")
    losses = set()
    for rank, res in enumerate(runs["ranks"]):
        got = res["train"][key]
        losses.add(got["loss"])
        assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss), \
            (rank, got["loss"], want_loss)
        assert np.isfinite(got["grad_norm"]) and got["grad_norm"] > 0
        got_params = tree_map(torch.from_numpy, got["params"])
        if key == "train_adafactor":
            _bf16_step_close(got_params, want, whole, micro)
        else:
            _first_step_close(got_params, want, grads, LR)
    assert len(losses) == 1, losses
    norms = {res["train"][key]["grad_norm"] for res in runs["ranks"]}
    assert len(norms) == 1, norms


@pytest.mark.parametrize("key", ["train_dense", "train_moe"])
def test_mesh_gradients_match_one_process(runs, key):
    w = runs["weights"]
    cfg = _cfg(key, TC)
    params = tree_map(lambda t: t.requires_grad_(True),
                      from_jax(w[key], cfg, "cpu"))
    _, grads = loss_and_grads(
        params, cfg, {"tokens": torch.from_numpy(w["train_tokens"]).long()})
    want = tree_flatten(tree_unflatten(params, grads))
    for rank, res in enumerate(runs["ranks"]):
        got = tree_flatten(res["train"][key]["grads"])
        assert sorted(got) == sorted(want)
        for path, g in want.items():
            np.testing.assert_allclose(got[path], g.numpy(), atol=1e-5,
                                       rtol=5e-5, err_msg=f"{rank} {path}")


def test_row_parallel_gradient_is_not_scaled_by_the_mesh(runs):
    """Megatron's two operators: a summing backward before the column
    products, an identity one after the row product's all-reduce; a sum
    too many (``torch.distributed.nn``'s all-reduce) makes the gradients
    4 (= model) times too large."""
    loss, dx, dw = _mlp_case(None)
    for rank, res in enumerate(runs["ranks"]):
        got_loss, got_dx, got_dw = res["mlp"]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        np.testing.assert_allclose(got_dx, dx, atol=1e-5, rtol=1e-5)
        for k in dw:
            np.testing.assert_allclose(got_dw[k], dw[k], atol=1e-5,
                                       rtol=1e-5, err_msg=k)


def test_ranks_import_no_jax():
    """The ranks import this module; it must not pull JAX in."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import test_torch_mesh_model
        bad = sorted(k for k in sys.modules if k.split('.')[0] in
                     ('jax', 'repro'))
        assert not bad, bad
    """ % str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-2000:]
