"""Decode caches in the JAX package's production layout: the batch over
the batch axes, the sequence over ``"model"`` (over every axis at
``long_500k``), every kv head whole, and the verify attention's partials
merged across ranks by log-sum-exp.

* the plain version of ``decode_attention`` over slices of a cache (1, 2
  and 4 slices, each at its ``kv_offset``, with its log-sum-exp) merged
  by ``lse_weights`` against one call over the whole cache: causal,
  window and tree bits, an empty slice, verify rows across a slice
  boundary (f32, atol 1e-6);
* every rank's cache block (``launch/specs.abstract_cache``) of every
  catalog config at ``prefill_32k``, ``decode_32k`` and ``long_500k`` on
  both production meshes against JAX's ``cache_specs(cfg,
  cache_batch_spec, kv_seq_spec)`` over the global shapes of JAX's
  ``init_cache`` (stand-in meshes, no JAX devices);
* one 8-rank gloo spawn on a (2, 4) mesh (``tests/test_torch_distributed.
  py``'s harness) shared by every test that needs ranks: prefill and 4
  greedy ``decode_step``s under the production layout against JAX's
  single device on the same weights, for a dense config with a
  sliding-window and a global layer (q/k/v gathered: 4 / 2 heads), the
  same with 8 / 4 heads (split), a dropless MoE, RecurrentGemma, RWKV-6,
  Whisper (the encoder on its blocks) and the dense config at batch 1
  with its slots over every axis (``long_500k``'s layout); then, for the
  dense configs, a 3-token verify with a partial commit and one more
  step.  The 14-token prompt leaves the third and fourth ``"model"``
  blocks of a 32-slot cache empty and the steps cross slot 16; the
  8-slot rings wrap.  Logits within 1e-4 of JAX's, greedy tokens equal.
  The encoder over the mesh gathers no parameter block whole.

The ranks import neither JAX nor the JAX package; the JAX references are
computed here while the ranks run."""
import dataclasses
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.multiprocessing as mp  # noqa: E402

from test_torch_distributed import JOIN_S, _rank_main  # noqa: E402
from test_torch_mesh_specs import _jax_specs_flat, _unstacked  # noqa: E402

from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels.ref import (anc_mask_from_bits,  # noqa: E402
                                     decode_attention_ref)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.attention import lse_weights  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

# ---------------------------------------------------------------------------
# (a) the plain version over slices, merged


SLICE_CASES = [  # (label, lengths, m, window, anc_bits)
    ("causal m1", [9, 40], 1, None, None),
    ("causal m5 straddles", [18, 35], 5, None, None),
    ("window 6 m3", [30, 47], 3, 6, None),
    ("tree m4", [21, 34], 4, None, [1, 3, 5, 11]),
    ("tree m4 in one slice", [5, 13], 4, None, [1, 3, 5, 9]),
]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", SLICE_CASES, ids=[c[0] for c in
                                                   SLICE_CASES])
def test_slices_merged_by_lse_are_the_whole_cache(case, n):
    """48 slots cut into ``n`` slices: the later slices of the short
    sequences hold no key at all (lse -inf, output 0)."""
    _, lengths, m, window, anc = case
    g = torch.Generator().manual_seed(0)
    b, hq, hkv, s, d = 2, 4, 2, 48, 16
    q = torch.randn(b, hq, m, d, generator=g)
    k, v = (torch.randn(b, hkv, s, d, generator=g) for _ in range(2))
    lengths = torch.tensor(lengths, dtype=torch.int32)
    amask = None if anc is None else anc_mask_from_bits(
        torch.tensor(anc, dtype=torch.int32), m)
    kw = dict(window=window, anc_mask=amask)
    want = decode_attention_ref(q, k, v, lengths, **kw)
    whole, whole_lse = decode_attention_ref(q, k, v, lengths, **kw,
                                            return_lse=True)
    assert torch.equal(whole, want)
    outs, lses = [], []
    step = s // n
    for i in range(n):
        sl = slice(i * step, (i + 1) * step)
        o, lse = decode_attention_ref(q, k[:, :, sl], v[:, :, sl], lengths,
                                      **kw, kv_offset=i * step,
                                      return_lse=True)
        empty = torch.isinf(lse)
        assert (o[empty] == 0).all()
        outs.append(o)
        lses.append(lse)
    if n > 1:
        assert any(bool(torch.isinf(x).any()) for x in lses)
    w = lse_weights(torch.stack(lses))
    got = (torch.stack(outs) * w[..., None]).sum(0)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    merged_lse = torch.logsumexp(torch.stack(lses), 0)
    torch.testing.assert_close(merged_lse, whole_lse, atol=1e-5, rtol=0)


def test_a_slice_with_no_visible_key_gives_zero_and_minus_inf():
    q = torch.randn(1, 2, 1, 16)
    k = v = torch.randn(1, 1, 8, 16)
    o, lse = decode_attention_ref(q, k, v, torch.tensor([5]), kv_offset=8,
                                  return_lse=True)
    assert (o == 0).all() and torch.isinf(lse).all() and (lse < 0).all()
    assert torch.isfinite(lse_weights(torch.stack([lse, lse]))).all()


# ---------------------------------------------------------------------------
# (b) every rank's cache block against JAX's specs


MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}
SHAPES = ("prefill_32k", "decode_32k", "long_500k")


@dataclasses.dataclass
class _JaxMesh:                     # what repro.launch.specs reads
    axis_names: tuple
    shape: dict


@dataclasses.dataclass
class _PortMesh:                    # the axes of a torch DeviceMesh
    mesh_dim_names: tuple
    shape: tuple


def _jax_blocks(jcfg, shape, jmesh) -> dict:
    """{port path: block shape} of JAX's cache under its production
    specs: the global shapes of ``init_cache`` (group axis dropped) cut by
    the sizes of each dim's axes."""
    import jax

    from repro.launch import specs as JS
    from repro.models.transformer import cache_specs, init_cache as j_init

    whole = jax.eval_shape(lambda: j_init(jcfg, shape.global_batch,
                                          shape.seq_len))
    specs = _unstacked(_jax_specs_flat(cache_specs(
        jcfg, JS.cache_batch_spec(shape, jmesh),
        JS.kv_seq_spec(shape, jmesh))), jcfg)
    shapes = {}
    for path, leaf in tree_flatten(whole).items():
        parts = path.split("/")
        if parts[0] == "layers":
            i = int(parts[1][1:-1])
            for l in range(i, jcfg.n_layers, len(jcfg.layer_pattern)):
                shapes["/".join(["layers", f"[{l}]"] + parts[2:])] = \
                    tuple(leaf.shape[1:])
        else:
            shapes[path] = tuple(leaf.shape)
    out = {}
    for path, spec in specs.items():
        dims = []
        for n, ax in zip(shapes[path], spec):
            names = () if ax is None else (ax,) if isinstance(ax, str) else ax
            size = int(np.prod([jmesh.shape[a] for a in names]))
            assert n % size == 0, (path, n, ax)
            dims.append(n // size)
        out[path] = tuple(dims)
    return out


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_cache_blocks_match_jax_specs(arch, kind):
    from repro import configs as J
    from repro.configs.base import INPUT_SHAPES as J_SHAPES
    names, sizes = MESHES[kind]
    jmesh = _JaxMesh(names, dict(zip(names, sizes)))
    pmesh = _PortMesh(names, sizes)
    for shape in SHAPES:
        want = _jax_blocks(J.get_config(arch), J_SHAPES[shape], jmesh)
        cache = TS.abstract_cache(TC.get_config(arch), TC.INPUT_SHAPES[shape],
                                  pmesh)
        got = {path: tuple(t.shape) for path, t in tree_flatten(
            {k: v for k, v in cache.items() if k != "layout"}).items()}
        assert got == want, (arch, kind, shape)
        lay = cache["layout"]
        assert (lay.rows, lay.slots) == TS.cache_layout(
            TC.INPUT_SHAPES[shape], pmesh), lay


# ---------------------------------------------------------------------------
# (c) the spawn


SHAPE = (2, 4)
B, L, STEPS, MAX_LEN, VERIFY = 4, 14, 4, 32, 3
N_COMMIT = (3, 1, 2, 0)
DENSE = dict(name="t", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97,
             dtype="float32", remat=False, layer_pattern=("swa", "attn"),
             sliding_window=8)
PROD = ("data", "model")                 # decode_32k's layout on (2, 4)
LONG = (None, ("data", "model"))         # long_500k's: batch 1
# key: (config key, batch, layout, verify round)
CASES = {"dense": ("dense", B, PROD, True),
         "dense_split": ("dense_split", B, PROD, True),
         "moe": ("moe", B, PROD, False),
         "rglru": ("rglru", B, PROD, True),
         "rwkv": ("rwkv", B, PROD, True),
         "whisper": ("whisper", B, PROD, False),
         "dense_long": ("dense", 1, LONG, True)}
CFGS = ("dense", "dense_split", "moe", "rglru", "rwkv", "whisper")


def _cfg(key: str, C):
    if key == "dense":
        return C.ModelConfig(**DENSE)
    if key == "dense_split":         # 8 / 4 heads: split over 4 ranks
        return C.ModelConfig(**dict(DENSE, name="t8", n_heads=8,
                                    n_kv_heads=4))
    if key == "moe":
        return C.ModelConfig(**dict(DENSE, name="tm", arch_type="moe",
                                    d_ff=96, n_experts=8, top_k=2,
                                    moe_dropless=True))
    if key == "rglru":
        return C.RECURRENTGEMMA_2B.reduced(d_model=64, n_layers=3)
    if key == "rwkv":
        return C.RWKV6_7B.reduced(d_model=128)
    if key == "whisper":
        return C.WHISPER_BASE.reduced(d_model=64)
    raise KeyError(key)


def _inputs(w, key, cfg, b):
    out = {"tokens": w["tokens"][:b]}
    if cfg.encoder_decoder:
        out["encoder_frames"] = w["frames"][:b]
    return out


def _layout_ranks(rank, weights):
    with open(weights, "rb") as f:
        w = pickle.load(f)
    mesh = tmesh.make_mesh(SHAPE, device_type="cpu")
    out = {}
    for name, (key, b, layout, verify) in CASES.items():
        cfg = _cfg(key, TC)
        params = TM.shard_model(from_jax(w[key], cfg, "cpu"), cfg, mesh)
        ins = {k: torch.from_numpy(v) for k, v in
               _inputs(w, key, cfg, b).items()}
        cache = init_cache(cfg, b, MAX_LEN, "cpu", mesh, layout=layout)
        shapes = {p: tuple(t.shape) for p, t in tree_flatten(
            cache["layers"]).items()}
        lg, cache = TM.prefill(params, cfg, ins["tokens"].long(), cache, mesh,
                               encoder_frames=ins.get("encoder_frames"))
        logits, toks = [lg], []
        for _ in range(STEPS):
            tok = torch.argmax(lg, -1)
            toks.append(tok)
            lg, cache = TM.decode_step(params, cfg, cache, tok[:, None], mesh)
            logits.append(lg)
        res = {"logits": torch.stack(logits, 1).numpy(),
               "tokens": torch.stack(toks, 1).numpy(), "shapes": shapes}
        if verify:
            vt = torch.from_numpy(w["verify"][:b]).long()
            vl, cache, pend = TM.decode(params, cfg, cache, vt, mesh)
            cache = TM.commit(cfg, cache, pend,
                              torch.tensor(N_COMMIT[:b]), VERIFY)
            after, cache = TM.decode_step(params, cfg, cache,
                                          torch.argmax(vl[:, -1], -1)[:, None],
                                          mesh)
            res["verify"] = vl.numpy()
            res["after"] = after.numpy()
        out[name] = res
    if "whisper" in CASES:
        out["encoder"] = _encoder_gathers(w, mesh)
    return out


def _encoder_gathers(w, mesh):
    """The shapes of every weight the encoder gathers over the mesh (its
    blocks' ``"data"`` parts), with ``gather_tree`` made to raise."""
    from repro_torch.models import encdec, layers
    cfg = _cfg("whisper", TC)
    params = TM.shard_model(from_jax(w["whisper"], cfg, "cpu"), cfg, mesh)
    seen = []
    real = layers.gather_param

    def spy(t, *a, **kw):
        out = real(t, *a, **kw)
        seen.append(tuple(out.shape))
        return out

    def refuse(*a, **kw):
        raise AssertionError("the encoder gathered a tree whole")

    layers.gather_param, tmesh.gather_tree = spy, refuse
    try:
        frames = torch.from_numpy(w["frames"])
        encdec.apply_encoder(params["encoder"], cfg,
                             tmesh.block(frames, mesh, "data", 0), mesh)
    finally:
        layers.gather_param = real
        tmesh.gather_tree = _GATHER_TREE
    return seen


_GATHER_TREE = tmesh.gather_tree


def _jax_refs(w) -> dict:
    import jax
    import jax.numpy as jnp

    from repro import configs as JC
    from repro.models import model as JM
    from repro.models.transformer import init_cache as j_init_cache

    out = {}
    for name, (key, b, _, verify) in CASES.items():
        cfg = _cfg(key, JC)
        p = jax.tree.map(jnp.asarray, w[key])
        ins = {k: jnp.asarray(v) for k, v in _inputs(w, key, cfg, b).items()}
        cache = j_init_cache(cfg, b, MAX_LEN)
        lg, cache = JM.prefill(p, cfg, ins["tokens"], cache,
                               encoder_frames=ins.get("encoder_frames"))
        logits, toks = [lg], []
        for _ in range(STEPS):
            tok = jnp.argmax(lg, -1)
            toks.append(tok)
            lg, cache = JM.decode_step(p, cfg, cache, tok[:, None])
            logits.append(lg)
        res = {"logits": np.stack([np.asarray(a) for a in logits], 1),
               "tokens": np.stack([np.asarray(a) for a in toks], 1)}
        if verify:
            vl, cache, pend = JM.decode(p, cfg, cache,
                                        jnp.asarray(w["verify"][:b]))
            cache = JM.commit(cfg, cache, pend,
                              jnp.asarray(N_COMMIT[:b], jnp.int32), VERIFY)
            after, _ = JM.decode_step(p, cfg, cache,
                                      jnp.argmax(vl[:, -1], -1)[:, None])
            res["verify"] = np.asarray(vl)
            res["after"] = np.asarray(after)
        out[name] = res
    return out


def _weights() -> dict:
    import jax

    from repro import configs as JC
    from repro.models import model as JM
    w = {key: jax.tree.map(np.asarray, JM.init_params(
        _cfg(key, JC), jax.random.PRNGKey(i))) for i, key in enumerate(CFGS)}
    rng = np.random.default_rng(0)
    w["tokens"] = rng.integers(0, 97, (B, L)).astype(np.int32)
    w["verify"] = rng.integers(0, 97, (B, VERIFY)).astype(np.int32)
    wcfg = _cfg("whisper", JC)
    w["frames"] = rng.standard_normal(
        (B, wcfg.encoder_len, wcfg.d_model)).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("decode-layout")
    w = _weights()
    weights = tmp / "weights.pkl"
    with open(weights, "wb") as f:
        pickle.dump(w, f)
    out_dir = tmp / "ranks"
    out_dir.mkdir()
    world = int(np.prod(SHAPE))
    ctx = mp.start_processes(
        _rank_main, args=(_layout_ranks, world, str(tmp / "store"),
                          str(out_dir), (str(weights),)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_S
    try:
        ref_ = _jax_refs(w)
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
    return {"ranks": ranks, "jax": ref_, "weights": w}


@pytest.mark.parametrize("name", CASES)
def test_production_layout_matches_jax_single_device(runs, name):
    want = runs["jax"][name]
    for rank, res in enumerate(runs["ranks"]):
        got = res[name]
        for k in ("logits", "verify", "after"):
            if k in want:
                assert got[k].shape == want[k].shape, (name, k)
                err = float(np.abs(got[k] - want[k]).max())
                assert err < 1e-4, (name, rank, k, err)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("name", CASES)
def test_each_rank_holds_its_block(runs, name):
    """The rank's rows and slots of every kv head; the recurrent states
    its rows and channels (as (b) checks on the catalog)."""
    key, b, (rows, slots), _ = CASES[name]
    cfg = _cfg(key, TC)
    n_rows = b // (SHAPE[0] if rows else 1)
    n_slot = int(np.prod(SHAPE)) if isinstance(slots, tuple) else SHAPE[1]
    for res in runs["ranks"]:
        for path, shape in res[name]["shapes"].items():
            assert shape[0] == n_rows, (path, shape)
            leaf = path.split("/")[-1]
            if leaf in ("k", "v"):
                l = int(path.split("/")[0][1:-1])
                n = MAX_LEN if cfg.layer_kind(l) == "attn" else min(
                    MAX_LEN, cfg.sliding_window)
                assert shape[1:3] == (n // n_slot, cfg.n_kv_heads), (path,
                                                                     shape)
            if leaf in ("ck", "cv"):
                assert shape[2] == cfg.n_kv_heads, (path, shape)


def test_encoder_gathers_no_block_whole(runs):
    """Every encoder weight the ranks gather keeps its ``"model"``
    block: its gathered shape is never the whole weight's."""
    cfg = _cfg("whisper", TC)
    whole = {tuple(np.shape(v)) for path, v in tree_flatten(
        from_jax(runs["weights"]["whisper"], cfg, "cpu")["encoder"]).items()
        if np.ndim(v) == 2}
    for res in runs["ranks"]:
        seen = res["encoder"]
        assert len(seen) >= 6 * cfg.n_encoder_layers, seen
        assert not whole & set(seen), (whole, seen)
