"""The MoE layer's mesh modes on ``torch.distributed`` against the JAX
package's.  Eight ranks on a (2, 4) gloo mesh on the CPU (a file store in
``tmp_path``, never a fixed port; every spawn joined within ``JOIN_S``)
run ``apply_moe(..., mesh=)`` in ``ep`` (B 4, S 8: E / model = 2, so a
mislaid all-to-all block shows), ``ep_psum`` (B 6, S 1) and ``tp`` (E 6)
on JAX's ``init_moe`` weights: at ``capacity_factor=inf`` within 1e-5 of
JAX's ``_moe_local`` (the criterion of ``tests/test_distributed.py``),
at 2.0 within 1e-5 of JAX's own ``apply_moe`` under 8 host devices (its
capacity is per rank, so its drops differ from the local ones), which a
subprocess computes once.  A reduced MoE model (2 layers, d 64, E 8,
f32) prefills (``ep``) and decodes 4 steps (``ep_psum``) on the mesh,
each rank holding its ``shard_model`` blocks; its logits are held
within 1e-4 of JAX's single-device ``prefill`` / ``decode_step`` and its
greedy tokens equal.  The model is dropless (``moe_dropless``): at a
finite capacity the ``ep`` prefill drops by each rank's token count,
which no single-device run reproduces (the layer tests above hold that
case to JAX's mesh).  A (1, 1) mesh is bit for bit the ``mesh=None``
path.  The ranks import neither JAX nor the JAX package."""
import datetime
import os
import pickle
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
JOIN_S = 120                 # a hung group fails within this
D, F, TOPK = 64, 96, 2
# case: (experts, x shape, the mode a (2, 4) mesh selects)
CASES = {"ep": (8, (4, 8, D)), "ep_psum": (8, (6, 1, D)),
         "tp": (6, (4, 8, D))}
CFS = {"inf": float("inf"), "2.0": 2.0}
MODEL = dict(name="t", arch_type="moe", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=96, vocab_size=97, n_experts=8, top_k=2,
             moe_dropless=True, dtype="float32", remat=False)
B, L, STEPS = 4, 8, 4


# ---------------------------------------------------------------------------
# ranks (spawned: this module is imported in each, without JAX)


def _rank_main(rank, fn, world, store, out_dir, args):
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=JOIN_S))
    torch.set_num_threads(1)
    try:
        res = fn(rank, *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp, *args) -> list:
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; their results in
    rank order.  A rank that hangs or raises fails the test."""
    out_dir = tmp / f"ranks-{fn.__name__}"
    out_dir.mkdir()
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, str(tmp / f"store-{fn.__name__}"),
                          str(out_dir), args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
                p.join()
            pytest.fail(f"{fn.__name__}: ranks did not finish in {JOIN_S} s")
    res = []
    for r in range(world):
        with open(out_dir / f"{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def _moe_params(w, e):
    return {k: torch.from_numpy(np.array(v)) for k, v in w[f"moe{e}"].items()}


def _shard_moe(params, mesh):
    """The rank's at-rest shard of a whole MoE layer."""
    specs = tmoe.moe_storage_specs("swiglu", params["w_up"].shape[0],
                                   tmesh.axis_size(mesh, "model"))
    return tmesh.shard_params(params, specs, mesh)


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
    return (torch.stack(logits, 1).numpy(),
            torch.stack(toks, 1).numpy())


def _mesh_ranks(rank, weights):
    with open(weights, "rb") as f:
        w = pickle.load(f)
    mesh = tmesh.make_mesh((2, 4), device_type="cpu")
    out = {"modes": {}, "moe": {},
           "axes": (tmesh.batch_axes(mesh), tmesh.mesh_devices(mesh),
                    tmesh.axis_size(mesh, "data"),
                    tmesh.axis_size(mesh, "model"),
                    tmesh.axis_index(mesh, "data"),
                    tmesh.axis_index(mesh, "model"))}
    for case, (e, _) in CASES.items():
        x = torch.from_numpy(np.array(w[f"x_{case}"]))
        out["modes"][case] = tmoe.select_moe_mode(e, x.shape[1], mesh)
        shard = _shard_moe(_moe_params(w, e), mesh)
        if case == "ep":
            out["shard_shapes"] = {k: tuple(v.shape)
                                   for k, v in shard.items()}
        for cf_name, cf in CFS.items():
            y = tmoe.apply_moe(shard, x, n_experts=e, top_k=TOPK,
                               activation="swiglu", mesh=mesh,
                               capacity_factor=cf)
            out["moe"][case, cf_name] = y.numpy()
    cfg = ModelConfig(**MODEL)
    params = TM.shard_model(from_jax(w["model"], cfg, "cpu"), cfg, mesh)
    out["model"] = _model_run(params, cfg, mesh,
                              torch.from_numpy(w["tokens"]).long())
    return out


def _host_ranks(rank, weights):
    with open(weights, "rb") as f:
        w = pickle.load(f)
    mesh = tmesh.make_host_mesh("cpu")
    x = torch.from_numpy(np.array(w["x_ep"]))
    p = _shard_moe(_moe_params(w, 8), mesh)
    kw = dict(n_experts=8, top_k=TOPK, activation="swiglu",
              capacity_factor=2.0)
    cfg = ModelConfig(**MODEL)
    params = from_jax(w["model"], cfg, "cpu")
    tokens = torch.from_numpy(w["tokens"]).long()
    return {"moe": (tmoe.apply_moe(p, x, mesh=mesh, **kw).numpy(),
                    tmoe.apply_moe(_moe_params(w, 8), x, **kw).numpy()),
            "model": (_model_run(TM.shard_model(params, cfg, mesh),
                                 cfg, mesh, tokens),
                      _model_run(params, cfg, None, tokens))}


# ---------------------------------------------------------------------------
# the JAX side: weights here, its mesh and single-device runs in a
# subprocess with 8 host devices


JAX_SCRIPT = """
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import ModelConfig
from repro.launch.mesh import activate_mesh, make_mesh_compat
from repro.models import model as M
from repro.models.moe import _moe_local, apply_moe
from repro.models.transformer import init_cache

weights, out, cases, model, b, l, steps = sys.argv[1:]
w = pickle.load(open(weights, "rb"))
cases = eval(cases)
mesh = make_mesh_compat((2, 4), ("data", "model"))
res = {}
for case, (e, _) in cases.items():
    p = jax.tree.map(jnp.asarray, w[f"moe{e}"])
    x = jnp.asarray(w[f"x_{case}"])
    res[f"local_{case}"] = np.asarray(_moe_local(
        p, x.reshape(-1, x.shape[-1]), n_experts=e, top_k=2,
        capacity_factor=float("inf"), activation="swiglu").reshape(x.shape))
    with activate_mesh(mesh):
        res[f"mesh_{case}"] = np.asarray(jax.jit(lambda pp, xx: apply_moe(
            pp, xx, n_experts=e, top_k=2, activation="swiglu", mesh=mesh,
            capacity_factor=2.0))(p, x))
cfg = ModelConfig(**eval(model))
b, l, steps = int(b), int(l), int(steps)
p = jax.tree.map(jnp.asarray, w["model"])
cache = init_cache(cfg, b, l + steps + 1)
lg, cache = M.prefill(p, cfg, jnp.asarray(w["tokens"]), cache)
logits, toks = [lg], []
for _ in range(steps):
    tok = jnp.argmax(lg, -1)
    toks.append(tok)
    lg, cache = M.decode_step(p, cfg, cache, tok[:, None])
    logits.append(lg)
res["logits"] = np.stack([np.asarray(a) for a in logits], 1)
res["tokens"] = np.stack([np.asarray(a) for a in toks], 1)
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JConfig
    from repro.models import model as JM
    from repro.models.moe import init_moe

    tmp = tmp_path_factory.mktemp("mesh")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    w = {f"moe{e}": to_np(init_moe(jax.random.PRNGKey(0), D, F, e,
                                   "swiglu", jnp.float32))
         for e in {e for e, _ in CASES.values()}}
    for case, (_, shape) in CASES.items():
        w[f"x_{case}"] = np.asarray(jax.random.normal(
            jax.random.PRNGKey(1), shape))
    w["model"] = to_np(JM.init_params(JConfig(**MODEL),
                                      jax.random.PRNGKey(0)))
    w["tokens"] = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (B, L), 0, MODEL["vocab_size"]))
    weights = tmp / "weights.pkl"
    with open(weights, "wb") as f:
        pickle.dump(w, f)
    ref = tmp / "jax.npz"
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(weights), str(ref),
         repr(CASES), repr(MODEL), str(B), str(L), str(STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"))
    try:
        mesh = _spawn(_mesh_ranks, 8, tmp, str(weights))
        host = _spawn(_host_ranks, 1, tmp, str(weights))[0]
        _, err = jproc.communicate(timeout=JOIN_S)
    finally:
        jproc.kill()
    assert jproc.returncode == 0, err[-4000:]
    return {"mesh": mesh, "host": host, "jax": dict(np.load(ref))}


# ---------------------------------------------------------------------------
# tests


def _jax_mesh(shape, names=("data", "model")):
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def _torch_mesh(shape, names=("data", "model")):
    return types.SimpleNamespace(mesh_dim_names=names, shape=tuple(shape))


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 4), (4, 2),
                                   (1, 8), (8,), (2, 16)])
def test_select_moe_mode_matches_jax(shape):
    from repro.models.moe import select_moe_mode as j_select
    names = ("data",) if len(shape) == 1 else ("data", "model")
    for e in (1, 6, 8, 16, 128):
        for s in (1, 2, 3, 8, 12, 512):
            assert (tmoe.select_moe_mode(e, s, _torch_mesh(shape, names))
                    == j_select(e, s, _jax_mesh(shape, names))), (e, s)
    assert tmoe.select_moe_mode(8, 8, None) == "local"


@pytest.mark.parametrize("model_size", [1, 2, 4, 6, 16])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_storage_and_view_specs_match_jax(model_size, activation):
    from repro.models import moe as jmoe
    as_tuple = lambda d: {k: tuple(v) for k, v in d.items()}  # noqa: E731
    for e in (6, 8):
        assert tmoe.moe_storage_specs(activation, e, model_size) == \
            as_tuple(jmoe.moe_storage_specs(activation, e, model_size))
    for mode in ("ep", "ep_psum", "tp"):
        assert tmoe._view_specs(activation, mode) == \
            as_tuple(jmoe._view_specs(activation, mode))


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh((1, 1), device_type="cpu")


def test_ranks_select_jax_modes_and_hold_their_shards(runs):
    for rank, res in enumerate(runs["mesh"]):
        # rank r sits at row-major position r of the (data, model) grid
        assert res["axes"] == (("data",), 8, 2, 4, rank // 4, rank % 4)
        assert res["modes"] == {c: c for c in CASES}
        # E 8 over model 4, D 64 over data 2 (w_down: its D over data)
        assert res["shard_shapes"] == {"router": (D, 8), "w_up": (2, 32, F),
                                       "w_gate": (2, 32, F),
                                       "w_down": (2, F, 32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_mode_dropless_matches_jax_local(runs, case):
    want = runs["jax"][f"local_{case}"]
    for rank, res in enumerate(runs["mesh"]):
        got = res["moe"][case, "inf"]
        assert got.shape == want.shape
        err = float(np.abs(got - want).max())
        assert err < 1e-5, (case, rank, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_mode_at_capacity_matches_jax_mesh(runs, case):
    """Capacity 2.0: each ``ep`` rank's capacity comes from its own 4
    tokens, so the drops (and the output) are JAX's distributed ones,
    not its local ones; every rank returns the same whole output."""
    want = runs["jax"][f"mesh_{case}"]
    outs = [res["moe"][case, "2.0"] for res in runs["mesh"]]
    for rank, got in enumerate(outs):
        err = float(np.abs(got - want).max())
        assert err < 1e-5, (case, rank, err)
        np.testing.assert_array_equal(got, outs[0])
    if case == "ep":
        assert np.abs(want - runs["jax"]["local_ep"]).max() > 1e-3


def test_mesh_decode_matches_jax_single_device(runs):
    want_lg, want_tok = runs["jax"]["logits"], runs["jax"]["tokens"]
    for rank, res in enumerate(runs["mesh"]):
        lg, tok = res["model"]
        assert lg.shape == want_lg.shape == (B, STEPS + 1,
                                             MODEL["vocab_size"])
        err = float(np.abs(lg - want_lg).max())
        assert err < 1e-4, (rank, err)
        np.testing.assert_array_equal(tok, want_tok)


def test_host_mesh_is_the_local_path_bit_for_bit(runs):
    got, want = runs["host"]["moe"]
    np.testing.assert_array_equal(got, want)
    (lg, tok), (lg0, tok0) = runs["host"]["model"]
    np.testing.assert_array_equal(lg, lg0)
    np.testing.assert_array_equal(tok, tok0)


def test_ranks_import_no_jax():
    """The ranks above import this module; it must not pull JAX in."""
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import test_torch_distributed
        bad = sorted(k for k in sys.modules if k.split('.')[0] in
                     ('jax', 'repro'))
        assert not bad, bad
    """ % str(Path(__file__).parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=SRC))
    assert out.returncode == 0, out.stderr[-2000:]
