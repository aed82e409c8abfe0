"""The port's training path against the JAX package on the same weights
(``params.from_jax``, which converts gradient trees too):
``forward_train`` and ``loss_fn`` with every gradient leaf against
``jax.value_and_grad(M.loss_fn)`` for reduced Gemma-3 (SWA + ATTN),
Mixtral, Phi-3.5-MoE and Llama-4 Maverick (MoE), RecurrentGemma, RWKV-6
and Whisper configs (loss rtol
1e-5, logits atol 1e-5, gradients atol 1e-5 plus rtol 5e-5: the f32
rounding of the RWKV-6 recurrence's backward, in either package, reaches
1.8e-5 relative on O(1) embedding gradients); remat, sqrt-remat and
``offload_carries`` against the plain backward; AdamW and Adafactor
(stacked factoring, the (n_groups, D) norm leaves included) over 3 steps
against JAX's; five ``train_loop`` steps against JAX's (losses rtol
1e-4), ``accum_steps=2`` and ``host_optimizer``; the checkpoint round
trip; the data pipeline; and the launcher.  The MoE families train
through the train phase's grouped products, the recurrent ones through
``WKV6Fn`` / ``RGLRUScanFn`` (their written-out backwards on the CPU).
Inputs and gradients are drawn with numpy from a seed."""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_loop import make_train_step as j_make_step  # noqa
from repro.training.train_loop import train_loop as j_train_loop  # noqa
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax, init_params  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves, tree_map  # noqa
from repro_torch.training.train_loop import (  # noqa: E402
    make_train_step as t_make_step, train_loop as t_train_loop)

CPU = "cpu"
TOL = 1e-5
GRAD_RTOL = 5e-5
FAMILIES = ("gemma3-12b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
            "llama4-maverick-400b-a17b", "recurrentgemma-2b", "rwkv6-7b",
            "whisper-base")


def _configs(arch, **kw):
    j = dataclasses.replace(j_get_config(arch).reduced(d_model=64), **kw)
    t = dataclasses.replace(get_config(arch).reduced(d_model=64), **kw)
    return j, t


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.encoder_decoder:
        batch["encoder_frames"] = rng.standard_normal(
            (b, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    out = {"tokens": torch.as_tensor(batch["tokens"]).long()}
    if "encoder_frames" in batch:
        out["encoder_frames"] = torch.as_tensor(batch["encoder_frames"])
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, atol=TOL, rtol=TOL):
    got, want = tree_flatten(got), tree_flatten(want)
    assert list(got) == list(want)
    for path in got:
        np.testing.assert_allclose(got[path].detach().float().numpy(),
                                   want[path].float().numpy(), atol=atol,
                                   rtol=rtol, err_msg=path)


def _port_grads(params, cfg, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = TM.loss_fn(params, cfg, _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss, tree_map(lambda _: next(it), params)


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_logits_and_every_gradient_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    batch = _batch(jcfg)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jbatch = jax.tree.map(jnp.asarray, batch)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch)))(jp)
    jlogits = jax.jit(lambda p: JM.forward_train(p, jcfg, jbatch))(jp)
    params = from_jax(_np(jp), tcfg, CPU)
    with torch.no_grad():
        logits = TM.forward_train(params, tcfg, _torch_batch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=TOL, rtol=TOL)
    loss, grads = _port_grads(params, tcfg, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
    _assert_trees_close(grads, from_jax(_np(jgrads), tcfg, CPU),
                        rtol=GRAD_RTOL)


def test_loss_chunks_are_checkpointed_divisors(monkeypatch):
    """S - 1 = 39 positions: the largest divisor up to the chunk (13),
    each chunk a checkpoint."""
    jcfg, tcfg = _configs("gemma3-12b")
    params = init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    calls = []
    real = TM.checkpoint
    monkeypatch.setattr(TM, "checkpoint",
                        lambda fn, h, t, **k: calls.append(h.shape[1])
                        or real(fn, h, t, **k))
    TM.loss_fn(params, tcfg, _torch_batch(_batch(jcfg, s=40)),
               logits_chunk=16)
    assert calls == [13, 13, 13]


def _grads_with(tcfg, params, batch, **kw):
    cfg = dataclasses.replace(tcfg, **kw)
    p = tree_map(lambda t: t.detach().clone(), params)
    return _port_grads(p, cfg, batch)


@pytest.mark.parametrize("n_groups", [4, 9])
def test_remat_sqrt_remat_and_offloaded_carries_give_equal_grads(
        n_groups, monkeypatch):
    """4 groups of (SWA, ATTN): a checkpoint a group; 9 single-layer
    groups: sqrt-remat, 3 superblocks of 3 (past the 8-group threshold);
    ``offload_carries``: group checkpoints whose inputs are saved through
    ``save_on_cpu``.  Every variant's loss and gradients equal the
    unrematerialised ones."""
    pattern = ("swa", "attn") if n_groups == 4 else ("attn",)
    _, tcfg = _configs("gemma3-12b", layer_pattern=pattern,
                       n_layers=n_groups * len(pattern))
    assert tcfg.n_groups == n_groups
    params = init_params(tcfg, torch.Generator().manual_seed(1), CPU)
    batch = _batch(tcfg, s=20, seed=1)
    want_loss, want = _grads_with(tcfg, params, batch, remat=False)
    calls = []
    real = TT.checkpoint
    monkeypatch.setattr(TT, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for kw in (dict(remat=True), dict(remat=True, offload_carries=True)):
        calls.clear()
        loss, grads = _grads_with(tcfg, params, batch, **kw)
        outer = (TT._sqrt_factor(n_groups)
                 if not kw.get("offload_carries") else 1)
        # forward calls: one a group, plus one a superblock
        assert len(calls) >= n_groups + (outer if outer > 1 else 0)
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
        _assert_trees_close(grads, want, atol=1e-6, rtol=0)
    assert TT._sqrt_factor(9) == 3 and TT._sqrt_factor(4) == 1


def _stacked_grads(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)),
        jp)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizers_match_jax_on_stacked_leaves(kind):
    """3 updates with random gradients of a 2-group (SWA, ATTN) config:
    the port's per-layer tensors updated as JAX updates its group-stacked
    leaves; for Adafactor the norm scales' (n_groups, D) leaves are
    factored (row over the groups, column over D) and their factors
    equal JAX's."""
    jcfg, tcfg = _configs("gemma3-12b", layer_pattern=("swa", "attn"),
                          n_layers=4)
    assert jcfg.n_groups == 2
    jp = JM.init_params(jcfg, jax.random.PRNGKey(2))
    j_init, j_update = jopt.make_optimizer(kind)
    t_init, t_update = topt.make_optimizer(kind)
    js = j_init(jp)
    params = from_jax(_np(jp), tcfg, CPU)
    ts = t_init(params, tcfg)
    for step in range(3):
        jg = _stacked_grads(jp, 10 + step)
        jp, js = j_update(jg, js, jp, 1e-2)
        t_update(from_jax(_np(jg), tcfg, CPU), ts, params, 1e-2)
    _assert_trees_close(params, from_jax(_np(jp), tcfg, CPU), atol=1e-6,
                        rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3
    if kind == "adafactor":
        for i in range(2):
            jv = js["v"]["layers"][i]["ln1"]["scale"]
            tv = ts["v"][f"layers/[{i}]/ln1/scale"]
            assert tv["row"].shape == (2,) and tv["col"].shape == (64,)
            for key in ("row", "col"):
                np.testing.assert_allclose(tv[key].numpy(),
                                           np.asarray(jv[key]), rtol=1e-5)
        np.testing.assert_allclose(ts["v"]["final_norm/scale"]["v"].numpy(),
                                   np.asarray(js["v"]["final_norm"]["scale"]
                                              ["v"]), rtol=1e-5)
    else:
        _assert_trees_close(ts["mu"], from_jax(_np(js["mu"]), tcfg, CPU),
                            atol=1e-7, rtol=1e-5)


def _data(cfg, seed=0):
    return tdata.make_lm_batches(4, 16, cfg.vocab_size, seed=seed)


def _first_step_close(got, want, grads, lr):
    """AdamW's first update is about lr * sign(g): where |g| is clear of
    zero the parameters agree tightly, elsewhere within 2 lr."""
    got, want = tree_flatten(got), tree_flatten(want)
    for path, g in tree_flatten(grads).items():
        a, b = got[path].detach().numpy(), want[path].numpy()
        clear = np.abs(g.numpy()) > 1e-4
        np.testing.assert_allclose(a[clear], b[clear], atol=1e-6,
                                   err_msg=path)
        np.testing.assert_allclose(a, b, atol=2 * lr, err_msg=path)


def test_train_loop_five_steps_match_jax():
    jcfg, tcfg = _configs("gemma3-12b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(3))
    params = from_jax(_np(jp), tcfg, CPU)      # JAX's loop donates jp
    j_init, _ = jopt.make_optimizer(jcfg.optimizer)
    _, _, jlog = j_train_loop(jcfg, jp, j_init(jp), _data(jcfg), 5,
                              lr=1e-3, log_every=1)
    t_init, _ = topt.make_optimizer(tcfg.optimizer)
    _, _, log = t_train_loop(tcfg, params, t_init(params, tcfg),
                                 _data(tcfg), 5, lr=1e-3, log_every=1)
    assert [r["step"] for r in log] == [r["step"] for r in jlog]
    np.testing.assert_allclose([r["loss"] for r in log],
                               [r["loss"] for r in jlog], rtol=1e-4)
    assert all(np.isfinite(r["grad_norm"]) and r["grad_norm"] > 0
               for r in log)


@pytest.mark.parametrize("mode", ["plain", "accum2", "host"])
def test_train_step_matches_jax(mode):
    """One step of ``make_train_step``: with ``accum_steps=2`` (bf16
    accumulation, as JAX's) against JAX's accumulating step; with
    ``host_optimizer`` (the state and the update on the host) against
    JAX's plain step."""
    lr = 1e-3
    accum = 2 if mode == "accum2" else 1
    jcfg, tcfg = _configs("mixtral-8x7b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(4))
    j_init, _ = jopt.make_optimizer(jcfg.optimizer)
    batch = next(_data(jcfg, seed=4))
    jstep = jax.jit(j_make_step(jcfg, lr=lr, accum_steps=accum))
    jp1, js1, jl = jstep(jp, j_init(jp), jax.tree.map(jnp.asarray, batch))
    params = from_jax(_np(jp), tcfg, CPU)
    step = t_make_step(tcfg, lr=lr, accum_steps=accum,
                                 host_optimizer=mode == "host")
    state = topt.make_optimizer(tcfg.optimizer)[0](params, tcfg)
    _, grads = _port_grads(tree_map(lambda t: t.detach().clone(),
                                         params), tcfg, batch)
    params, state, loss = step(params, state, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert int(state["step"]) == 1
    _first_step_close(params, from_jax(_np(jp1), tcfg, CPU), grads, lr)


def test_checkpoint_round_trips_exactly(tmp_path):
    _, tcfg = _configs("gemma3-12b")
    params = init_params(dataclasses.replace(tcfg, dtype="bfloat16"),
                         torch.Generator().manual_seed(5), CPU)
    params["extra_f32"] = torch.randn(3, 5)
    state = topt.adafactor_init(params, tcfg)
    state["step"] += 7
    tree = {"params": params, "opt": state}
    path = tmp_path / "ckpt" / "step7.bin"
    tckpt.save_checkpoint(path, tree, step=7)
    like = tree_map(torch.zeros_like, tree)
    back, step = tckpt.restore_checkpoint(path, like)
    assert step == 7
    a, b = tree_flatten(tree), tree_flatten(back)
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key])
    assert any(t.dtype == torch.bfloat16 for t in a.values())


def test_data_pipeline_matches_jax():
    assert tdata.DATASET_STATS == jdata.DATASET_STATS
    for name in sorted(jdata.DATASET_STATS):
        t, j = (m.synthetic_dataset(name, n_prompts=6, vocab=500, seed=3)
                for m in (tdata, jdata))
        assert (t.name, t.s_avg, t.s_max, t.s_std, t.n) == \
            (j.name, j.s_avg, j.s_max, j.s_std, j.n)
        for a, b in zip(t.prompts, j.prompts):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tdata.pad_batch(t.prompts, pad_id=7),
                                      jdata.pad_batch(j.prompts, pad_id=7))
        wide = max(len(x) for x in t.prompts) + 5
        np.testing.assert_array_equal(tdata.pad_batch(t.prompts, pad_to=wide),
                                      jdata.pad_batch(j.prompts, pad_to=wide))
    for structured in (True, False):
        ti = tdata.make_lm_batches(3, 20, 97, seed=9, structured=structured)
        ji = jdata.make_lm_batches(3, 20, 97, seed=9, structured=structured)
        for _ in range(3):
            a, b = next(ti)["tokens"], next(ji)["tokens"]
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().splitlines()


def test_launcher_trains_on_the_cpu_and_plans_like_jax(monkeypatch):
    lines = _stdout(tlaunch.main, ["--device", "cpu", "--steps", "3"])
    assert [ln.split()[:2] for ln in lines[:3]] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[-1].startswith("loss ") and "->" in lines[-1]
    assert lines[-1].endswith("(LEARNED)") or \
        lines[-1].endswith("(check hyperparams)")
    plan = _stdout(tlaunch.main, ["--production-plan", "--arch",
                                  "llama3-405b"])
    monkeypatch.setattr("sys.argv", ["train", "--production-plan", "--arch",
                                     "llama3-405b"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main()
    assert plan[:3] == buf.getvalue().splitlines() and len(plan) == 5
    # then train_4k's layout and accumulation from the port's specs.py,
    # which equal the JAX package's (tests/test_torch_specs.py)
    assert plan[3] == ("single-pod: train_4k (batch, seq, seq-parallel "
                       "axis)=('data', None, 'model') accum=16")
    assert plan[4] == ("multi-pod : train_4k (batch, seq, seq-parallel "
                       "axis)=(('pod', 'data'), None, 'model') accum=8")
