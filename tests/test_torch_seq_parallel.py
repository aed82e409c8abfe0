"""Sequence parallelism on a (2, 4) mesh of eight gloo ranks on the CPU
against the JAX package's single device, on ``from_jax`` weights, and
the flash functions' query offset.

One spawn (``tests/test_torch_distributed.py``'s harness: a file store in
the test's temporary directory, never a fixed port) runs, on each rank,
under the default profile (``sequence_sharding("model")``):

* a dense config whose 6 heads and 2 kv heads do not split over 4 ranks
  (context-parallel attention), a reduced RecurrentGemma (its single kv
  head never splits; its RG-LRU runs channel-parallel) and a reduced
  RWKV-6 at 4 heads (channel-parallel): prefill and greedy decode steps
  (logits within 1e-4 of JAX's, greedy tokens equal), the gradients of
  one batch (the loss and every leaf, gathered, within atol 1e-5 + rtol
  5e-5 of ``jax.value_and_grad``) and one AdamW step (the first-step
  rule of ``tests/test_torch_train.py``);
* the bytes a recurrent decode step hands the collectives at B 2 and 4:
  exactly twice as many at twice the batch (no weight moves);
* under ``sequence_sharding(None)``: the dense configs' prefill and
  gradient bytes, by collective, equal what the layout before sequence
  parallelism moved (``PR26_BYTES``, counted on the same shapes with the
  same rank code), with results still equal to JAX's;
* the group carries remat keeps on a rank (the checkpoints' inputs):
  under the profile a quarter of those under ``sequence_sharding(None)``;
* ``launch/specs.build_step``'s training step of ``DRY`` on real
  tensors, whose ``collective_bytes()`` on rank 0 the dry run's (a fake
  group of the same (2, 4) mesh, run in a subprocess) must equal.

The ranks import neither JAX nor the JAX package; the JAX references
are computed here while the ranks run."""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

from test_torch_distributed import JOIN_S, SRC, _rank_main  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.layers import sequence_sharding  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.training import make_train_step  # noqa: E402
from repro_torch.training.optimizer import make_optimizer  # noqa: E402
from repro_torch.training.train_loop import loss_and_grads  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

SHAPE = (2, 4)
B, L, STEPS = 4, 8, 4
TRAIN_B, TRAIN_S, LR = 8, 32, 1e-3
DENSE = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
             dtype="float32", remat=False)
MODELS = ("dense6", "rglru", "rwkv")
# the collective bytes of a prefill (B 4 x 8) and of loss_and_grads (B 8
# x 32) on this mesh before sequence parallelism, counted by rank 0 with
# this file's rank code (the layout sequence_sharding(None) must keep)
PR26_BYTES = {
    "dense": ({"all_gather": 74760, "all_reduce": 16384},
              {"all_gather": 106880, "all_reduce": 517892}),
    "dense6": ({"all_gather": 112776, "all_reduce": 24576},
               {"all_gather": 260672, "all_reduce": 854660})}
DRY = ("dense6", "t", TRAIN_S, TRAIN_B, "train")    # a dry-run combination


def _cfg(key: str, C):
    """The case's config from configs module ``C`` (the port's or JAX's)."""
    if key == "dense":
        return C.ModelConfig(**DENSE)
    if key == "dense6":             # 6 / 2 heads: no split over 4 ranks
        return C.ModelConfig(**dict(DENSE, name="t6", d_model=96, n_heads=6,
                                    remat=True))
    if key == "rglru":
        return dataclasses.replace(
            C.RECURRENTGEMMA_2B.reduced(d_model=64, n_layers=3), remat=True)
    if key == "rwkv":               # 4 heads of 32: one a rank
        return C.RWKV6_7B.reduced(d_model=128)
    raise KeyError(key)


# ---------------------------------------------------------------------------
# the query offset (no spawn)


OFFSETS = [(sq, off, skv, causal, window)
           for sq, off, skv in ((16, 16, 64), (16, 48, 64), (24, 8, 40))
           for causal, window in ((True, None), (True, 12), (False, None))]


@pytest.mark.parametrize("case", OFFSETS, ids=str)
def test_flash_with_q_offset_is_the_whole_rows_slice(case):
    sq, off, skv, causal, window = case
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, skv, 32, generator=g, dtype=torch.float64)
    k, v = (torch.randn(2, 2, skv, 32, generator=g, dtype=torch.float64)
            for _ in range(2))
    dout = torch.randn(2, 4, skv, 32, generator=g, dtype=torch.float64)
    kw = dict(causal=causal, window=window)
    out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    rows = slice(off, off + sq)
    got, got_lse = ref.flash_attention_ref(q[:, :, rows], k, v,
                                           return_lse=True, q_offset=off, **kw)
    torch.testing.assert_close(got, out[:, :, rows], rtol=0, atol=1e-12)
    torch.testing.assert_close(got_lse, lse[:, :, rows], rtol=0, atol=1e-12)
    # the backward of the rows' slice: dq the slice of the whole dq under
    # a gradient on those rows alone, dk / dv their part
    mask = torch.zeros_like(dout)
    mask[:, :, rows] = 1
    dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout * mask,
                                             **kw)
    gq, gk, gv = ref.flash_attention_bwd_ref(
        q[:, :, rows], k, v, got, got_lse, dout[:, :, rows], q_offset=off,
        **kw)
    torch.testing.assert_close(gq, dq[:, :, rows], rtol=0, atol=1e-12)
    torch.testing.assert_close(gk, dk, rtol=0, atol=1e-12)
    torch.testing.assert_close(gv, dv, rtol=0, atol=1e-12)


def test_flash_attention_fn_carries_the_offset_to_the_backward():
    from repro_torch.models.attention import FlashAttentionFn
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 2, 8, 16, generator=g, requires_grad=True)
    k, v = (torch.randn(1, 1, 24, 16, generator=g, requires_grad=True)
            for _ in range(2))
    dout = torch.randn(1, 2, 8, 16, generator=g)
    got = torch.autograd.grad(FlashAttentionFn.apply(q, k, v, 0.25, True, 6,
                                                     12), (q, k, v), dout)
    # autograd through the plain forward itself, at the same offset
    want = torch.autograd.grad(ref.flash_attention_ref(
        q, k, v, scale=0.25, window=6, q_offset=12), (q, k, v), dout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_visible_pairs_counts_the_masks():
    for sq, off, skv, causal, window in OFFSETS:
        s = ref._flash_scores(torch.zeros(1, 1, sq, 1), torch.zeros(
            1, 1, skv, 1), 1.0, causal, window, off)
        assert ref.visible_pairs(sq, skv, causal, window, off) == int(
            (s > ref.NEG_INF).sum())


# ---------------------------------------------------------------------------
# ranks (spawned: this module is imported in each, without JAX)


def _model_run(params, cfg, mesh, tokens):
    """Prefill, then ``STEPS`` greedy decode steps: (logits, tokens)."""
    cache = init_cache(cfg, B, L + STEPS + 1, "cpu", mesh)
    lg, cache = TM.prefill(params, cfg, tokens, cache, mesh)
    logits, toks = [lg], []
    for _ in range(STEPS):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None], mesh)
        logits.append(lg)
    return (torch.stack(logits, 1).numpy(), torch.stack(toks, 1).numpy())


def _grads(params, cfg, mesh, tokens):
    """(loss, every gradient gathered whole) of one batch."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, grads = loss_and_grads(params, cfg, {"tokens": tokens}, mesh)
    with torch.no_grad():
        whole = tmesh.gather_params(tree_unflatten(params, grads),
                                    TM.mesh_specs(cfg, mesh), mesh)
    return float(loss), tree_map(lambda t: t.numpy(), whole)


def _step(params, cfg, mesh, tokens):
    """One AdamW step: (loss, the parameters after it, gathered)."""
    state = make_optimizer(cfg.optimizer)[0](params, cfg)
    params, state, loss = make_train_step(cfg, mesh, LR)(
        params, state, {"tokens": tokens.numpy()})
    return float(loss), tree_map(
        lambda t: t.detach().numpy(),
        tmesh.gather_params(params, TM.mesh_specs(cfg, mesh), mesh))


def _decode_bytes(params, cfg, mesh, tokens, b) -> int:
    """The bytes this rank hands the collectives of one decode step."""
    cache = init_cache(cfg, b, L + 2, "cpu", mesh)
    lg, cache = TM.prefill(params, cfg, tokens[:b], cache, mesh)
    tmesh.reset_collective_bytes()
    TM.decode_step(params, cfg, cache, torch.argmax(lg, -1)[:, None], mesh)
    return sum(tmesh.collective_bytes().values())


def _phase_bytes(params, cfg, mesh, tokens, train_tokens) -> tuple:
    """(prefill bytes, gradient bytes) by collective."""
    cache = init_cache(cfg, B, L + 1, "cpu", mesh)
    tmesh.reset_collective_bytes()
    TM.prefill(params, cfg, tokens, cache, mesh)
    pre = tmesh.collective_bytes()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tmesh.reset_collective_bytes()
    loss_and_grads(params, cfg, {"tokens": train_tokens}, mesh)
    return pre, tmesh.collective_bytes()


def _carry_bytes(params, cfg, mesh, tokens) -> list:
    """The bytes of each group carry a remat checkpoint keeps (its
    input), in one gradient of the batch."""
    seen = []
    real = TT.checkpoint

    def spy(fn, z, **kw):
        seen.append(z.numel() * z.element_size())
        return real(fn, z, **kw)

    TT.checkpoint = spy
    try:
        _grads(params, cfg, mesh, tokens)
    finally:
        TT.checkpoint = real
    return seen


def _seq_ranks(rank, weights):
    from repro_torch.launch.specs import build_step
    with open(weights, "rb") as f:
        w = pickle.load(f)
    mesh = tmesh.make_mesh(SHAPE, device_type="cpu")
    tokens = torch.from_numpy(w["tokens"]).long()
    train_tokens = torch.from_numpy(w["train_tokens"]).long()
    shard = lambda key: TM.shard_model(  # noqa: E731
        from_jax(w[key], _cfg(key, TC), "cpu"), _cfg(key, TC), mesh)
    out = {"model": {}, "grads": {}, "step": {}, "bytes": {}}
    for key in MODELS:
        cfg = _cfg(key, TC)
        out["model"][key] = _model_run(shard(key), cfg, mesh, tokens)
        out["grads"][key] = _grads(shard(key), cfg, mesh, train_tokens)
        out["step"][key] = _step(shard(key), cfg, mesh, train_tokens)
        if key != "dense6":
            params = shard(key)
            out["bytes"][key] = (
                {b: _decode_bytes(params, cfg, mesh, tokens, b)
                 for b in (2, 4)},
                sum(t.numel() * t.element_size() for t in
                    tree_leaves(params)))
    out["none"] = {}
    with sequence_sharding(None):
        for key in ("dense", "dense6"):
            cfg = _cfg(key, TC)
            out["none"][key] = {
                "bytes": _phase_bytes(shard(key), cfg, mesh, tokens,
                                      train_tokens),
                "model": _model_run(shard(key), cfg, mesh, tokens),
                "grads": _grads(shard(key), cfg, mesh, train_tokens)}
        out["carries_none"] = _carry_bytes(shard("dense6"), _cfg(
            "dense6", TC), mesh, train_tokens)
    out["carries"] = _carry_bytes(shard("dense6"), _cfg("dense6", TC), mesh,
                                  train_tokens)
    key, name, s, b, phase = DRY
    cfg = _cfg(key, TC)
    fn, _, _ = build_step(cfg, TC.InputShape(name, s, b, phase), mesh)
    params = shard(key)
    state = make_optimizer(cfg.optimizer)[0](params, cfg)
    tmesh.reset_collective_bytes()
    fn(params, state, {"tokens": train_tokens})
    out["build_step"] = tmesh.collective_bytes()
    return out


# ---------------------------------------------------------------------------
# the JAX side


def _jax_refs(w) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.models import model as JM
    from repro.models.transformer import init_cache as j_init_cache
    from repro.training.optimizer import make_optimizer as j_make_opt
    from repro.training.train_loop import make_train_step as j_make_step

    to_j = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    batch = {"tokens": jnp.asarray(w["train_tokens"])}
    ref_ = {"model": {}, "grads": {}, "step": {}}
    for key in MODELS + ("dense",):
        cfg, p = _cfg(key, JC), to_j(w[key])
        cache = j_init_cache(cfg, B, L + STEPS + 1)
        lg, cache = JM.prefill(p, cfg, jnp.asarray(w["tokens"]), cache)
        logits, toks = [lg], []
        for _ in range(STEPS):
            tok = jnp.argmax(lg, -1)
            toks.append(tok)
            lg, cache = JM.decode_step(p, cfg, cache, tok[:, None])
            logits.append(lg)
        ref_["model"][key] = (np.stack([np.asarray(a) for a in logits], 1),
                              np.stack([np.asarray(a) for a in toks], 1))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda q: JM.loss_fn(q, cfg, batch)))(p)
        ref_["grads"][key] = (float(loss), jax.tree.map(np.asarray, grads))
        step = jax.jit(j_make_step(cfg, None, LR))
        p1, _, loss = step(p, j_make_opt(cfg.optimizer)[0](p), batch)
        ref_["step"][key] = (float(loss), jax.tree.map(np.asarray, p1))
    return ref_


def _weights() -> dict:
    import jax

    from repro import configs as JC
    from repro.models import model as JM
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    w = {key: to_np(JM.init_params(_cfg(key, JC), jax.random.PRNGKey(i)))
         for i, key in enumerate(MODELS + ("dense",))}
    rng = np.random.default_rng(0)
    w["tokens"] = rng.integers(0, 97, (B, L)).astype(np.int32)
    w["train_tokens"] = rng.integers(0, 97, (TRAIN_B, TRAIN_S)).astype(
        np.int32)
    return w


DRY_CODE = """
import json, sys
from repro_torch import configs as C
from repro_torch.launch.dryrun import run_one
cfg = C.ModelConfig(**json.loads(sys.argv[1]))
print(json.dumps(run_one(cfg, C.InputShape(*json.loads(sys.argv[2])),
                         tuple(json.loads(sys.argv[3])))))
"""


def dry_run(cfg, shape, mesh_shape=SHAPE):
    """``launch/dryrun.run_one`` of ``cfg`` at ``shape`` (InputShape's
    fields) in a subprocess: its Popen (:func:`dry_result` reads it)."""
    return subprocess.Popen(
        [sys.executable, "-c", DRY_CODE, json.dumps(dataclasses.asdict(cfg)),
         json.dumps(list(shape)), json.dumps(list(mesh_shape))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC))


def dry_result(proc) -> dict:
    out, err = proc.communicate(timeout=JOIN_S)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq-parallel")
    w = _weights()
    weights = tmp / "weights.pkl"
    with open(weights, "wb") as f:
        pickle.dump(w, f)
    out_dir = tmp / "ranks"
    out_dir.mkdir()
    world = int(np.prod(SHAPE))
    key, name, s, b, phase = DRY
    proc = dry_run(_cfg(key, TC), (name, s, b, phase))
    ctx = mp.start_processes(
        _rank_main, args=(_seq_ranks, world, str(tmp / "store"),
                          str(out_dir), (str(weights),)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        ref_ = _jax_refs(w)
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the ranks did not finish in {JOIN_S} s")
        dry = dry_result(proc)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    ranks = []
    for r in range(world):
        with open(out_dir / f"{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return {"ranks": ranks, "jax": ref_, "weights": w, "dry": dry}


# ---------------------------------------------------------------------------
# tests


def _model_close(got, want, key):
    lg, tok = got
    want_lg, want_tok = want
    assert lg.shape == want_lg.shape
    err = float(np.abs(lg - want_lg).max())
    assert err < 1e-4, (key, err)
    np.testing.assert_array_equal(tok, want_tok)


def _grads_close(got, want, cfg, key):
    loss, grads = got
    want_loss, want_grads = want
    assert abs(loss - want_loss) <= 1e-5 + 5e-5 * abs(want_loss), \
        (key, loss, want_loss)
    want = tree_flatten(from_jax(want_grads, cfg, "cpu"))
    got = tree_flatten(grads)
    assert sorted(got) == sorted(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path], g.numpy(), atol=1e-5,
                                   rtol=5e-5, err_msg=f"{key} {path}")


@pytest.mark.parametrize("key", MODELS)
def test_prefill_and_decode_match_jax_single_device(runs, key):
    first = runs["ranks"][0]["model"][key][0]
    for rank, res in enumerate(runs["ranks"]):
        _model_close(res["model"][key], runs["jax"]["model"][key],
                     (key, rank))
        np.testing.assert_array_equal(res["model"][key][0], first)


@pytest.mark.parametrize("key", MODELS)
def test_loss_and_every_gradient_match_jax(runs, key):
    cfg = _cfg(key, TC)
    for rank, res in enumerate(runs["ranks"]):
        _grads_close(res["grads"][key], runs["jax"]["grads"][key], cfg,
                     (key, rank))


@pytest.mark.parametrize("key", MODELS)
def test_adamw_step_matches_jax(runs, key):
    from test_torch_train import _first_step_close
    cfg = _cfg(key, TC)
    want_loss, want_params = runs["jax"]["step"][key]
    grads = from_jax(runs["jax"]["grads"][key][1], cfg, "cpu")
    want = from_jax(want_params, cfg, "cpu")
    for rank, res in enumerate(runs["ranks"]):
        loss, params = res["step"][key]
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (rank, loss)
        _first_step_close(tree_map(torch.from_numpy, params), want, grads,
                          LR)


@pytest.mark.parametrize("key", ["rglru", "rwkv"])
def test_recurrent_decode_moves_activations_not_weights(runs, key):
    for rank, res in enumerate(runs["ranks"]):
        by_b, weight_bytes = res["bytes"][key]
        assert by_b[4] == 2 * by_b[2] > 0, (rank, by_b)
        assert by_b[2] < weight_bytes, (rank, by_b, weight_bytes)


@pytest.mark.parametrize("key", ["dense", "dense6"])
def test_no_sequence_sharding_keeps_the_earlier_layout(runs, key):
    cfg = _cfg(key, TC)
    for rank, res in enumerate(runs["ranks"]):
        got = res["none"][key]
        if rank == 0:
            assert got["bytes"] == PR26_BYTES[key], got["bytes"]
        _model_close(got["model"], runs["jax"]["model"][key], (key, rank))
        _grads_close(got["grads"], runs["jax"]["grads"][key], cfg,
                     (key, rank))


def test_remat_keeps_a_quarter_of_each_group_carry(runs):
    for rank, res in enumerate(runs["ranks"]):
        seq, none = res["carries"], res["carries_none"]
        assert len(seq) == len(none) == _cfg("dense6", TC).n_groups
        assert [4 * n for n in seq] == none, (rank, seq, none)


def test_dry_run_counts_the_collectives_rank_0_ran(runs):
    dry = runs["dry"]
    assert dry["status"] == "ok"
    assert dry["collectives"] == runs["ranks"][0]["build_step"]


def test_a_sequence_that_does_not_split_over_model_raises():
    """The carry's split names the dim, as a batch that does not split
    over ``data`` raises (rank 0 of a stand-in (2, 4) mesh: the check
    comes before any collective)."""
    from repro_torch.models.layers import active_seq_axis, seq_split
    mesh = dataclasses.make_dataclass(
        "M", ["mesh_dim_names", "shape", "get_local_rank"])(
            ("data", "model"), SHAPE, lambda axis: 0)
    assert active_seq_axis(mesh) == "model"
    with sequence_sharding(None):
        assert active_seq_axis(mesh) is None
    with pytest.raises(ValueError, match="does not split over the 4 ranks"):
        seq_split(torch.zeros(2, 30, 8), mesh, "model")
    assert seq_split(torch.zeros(2, 32, 8), mesh, "model").shape == (2, 8, 8)
    with pytest.raises(ValueError, match="'model' or nothing"):
        sequence_sharding("data")
