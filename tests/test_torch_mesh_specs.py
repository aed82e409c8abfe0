"""The port's layouts over a mesh against the JAX package's.

Every catalog config's ``param_specs``, ``cache_specs`` (batch over
``"data"``, sequence over ``"model"``) and ``opt_state_specs`` (AdamW and
Adafactor) at ``model_size`` 16 and 2, field for field against JAX's
``PartitionSpec``s with the group axis unstacked (JAX stacks a pattern
position's layers on a leading axis whose spec is None; the port keeps one
entry a layer).  Then ``shard_params`` on every rank of an emulated (2, 4)
mesh (a stand-in that answers ``get_local_rank``; no process group): the
blocks stitched back give the whole tree bit for bit, no rank holds a whole
copy of a leaf its spec splits, parameters or optimizer state, and a dim
that does not divide its axis raises, naming the leaf.  Pure functions of
the configs: nothing here spawns a process."""
import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as J  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import init_params  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

NAMES = sorted(J.ALL_CONFIGS)
SIZES = (16, 2)


def _jax_specs_flat(tree, prefix=""):
    """{path: spec tuple} of a JAX spec tree, the port's paths."""
    from jax.sharding import PartitionSpec as P
    if isinstance(tree, P):
        return {prefix: tuple(tree)}
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    else:
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    out = {}
    for k, v in items:
        out.update(_jax_specs_flat(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unstacked(jax_flat: dict, cfg) -> dict:
    """JAX's flat specs with each ``layers/[i]`` position's stacked spec
    handed to every layer of that position, group axis dropped (the
    encoder's stacked layers likewise)."""
    pat = len(cfg.layer_pattern)
    out = {}
    for path, spec in jax_flat.items():
        parts = path.split("/")
        if parts[0] == "layers":
            i = int(parts[1][1:-1])
            assert spec[0] is None, (path, spec)
            for l in range(i, cfg.n_layers, pat):
                out["/".join(["layers", f"[{l}]"] + parts[2:])] = spec[1:]
        elif parts[:2] == ["encoder", "layers"]:
            assert spec[0] is None, (path, spec)
            for l in range(cfg.n_encoder_layers):
                out["/".join(["encoder", "layers", f"[{l}]"] + parts[2:])] = \
                    spec[1:]
        else:
            out[path] = spec
    return out


def _port_flat(specs) -> dict:
    return tree_flatten(specs, is_leaf=tmesh.is_spec)


@pytest.mark.parametrize("model_size", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_jax(name, model_size):
    from repro.models import model as JM
    jcfg, tcfg = J.get_config(name), T.get_config(name)
    want = _unstacked(_jax_specs_flat(JM.param_specs(jcfg, model_size)),
                      jcfg)
    got = _port_flat(TM.param_specs(tcfg, model_size))
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_cover_the_port_tree(name):
    """One spec a leaf of the port's parameters, of the leaf's rank."""
    cfg = T.get_config(name).reduced(d_model=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = _port_flat(TM.param_specs(cfg, 2))
    leaves = tree_flatten(params)
    assert sorted(specs) == sorted(leaves)
    for path, leaf in leaves.items():
        assert len(specs[path]) == leaf.dim(), path


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_match_jax(name):
    from repro.models.transformer import cache_specs as j_cache_specs
    jcfg, tcfg = J.get_config(name), T.get_config(name)
    want = _unstacked(_jax_specs_flat(j_cache_specs(jcfg, "data", "model")),
                      jcfg)
    got = _port_flat(TT.cache_specs(tcfg, "data", "model"))
    assert got == want
    cache = TT.init_cache(tcfg.reduced(d_model=64), 2, 8, "cpu")
    leaves = tree_flatten(cache)
    assert sorted(leaves) == sorted(_port_flat(TT.cache_specs(
        tcfg.reduced(d_model=64), "data", "model")))


def _jax_factors_flat(v, prefix=""):
    """Adafactor's JAX state specs {stacked path: {row, col} | {v}}."""
    from jax.sharding import PartitionSpec as P
    if isinstance(v, dict) and ("row" in v or "v" in v) and all(
            isinstance(x, P) for x in v.values()):
        return {prefix: {k: tuple(s) for k, s in v.items()}}
    items = (((str(k), x) for k, x in v.items()) if isinstance(v, dict)
             else ((f"[{i}]", x) for i, x in enumerate(v)))
    out = {}
    for k, x in items:
        out.update(_jax_factors_flat(x, f"{prefix}/{k}" if prefix else k))
    return out


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("model_size", SIZES)
@pytest.mark.parametrize("name", NAMES)
def test_opt_state_specs_match_jax(name, model_size, kind):
    from repro.models import model as JM
    from repro.training.optimizer import opt_state_specs as j_opt_specs
    jcfg, tcfg = J.get_config(name), T.get_config(name)
    jspecs = j_opt_specs(kind, JM.param_specs(jcfg, model_size))
    tspecs = topt.opt_state_specs(kind, TM.param_specs(tcfg, model_size),
                                  tcfg)
    assert tspecs["step"] == tuple(jspecs["step"]) == ()
    if kind == "adamw":
        for key in ("mu", "nu"):
            assert _port_flat(tspecs[key]) == _unstacked(
                _jax_specs_flat(jspecs[key]), jcfg)
    else:
        # the port's Adafactor keeps JAX's stacked leaves (see its
        # module), the encoder's stack as a one-position pattern
        want = {p.replace("encoder/layers/", "encoder/layers/[0]/", 1): v
                for p, v in _jax_factors_flat(jspecs["v"]).items()}
        assert tspecs["v"] == want


# ---------------------------------------------------------------------------
# layout on an emulated mesh


@dataclasses.dataclass
class FakeMesh:
    """What ``block`` / ``shard_params`` read of a mesh: its names, shape
    and this rank's coordinates."""
    shape: tuple
    coords: tuple
    mesh_dim_names: tuple = ("data", "model")

    def get_local_rank(self, axis):
        return self.coords[self.mesh_dim_names.index(axis)]


def _ranks(shape):
    return [FakeMesh(shape, c) for c in
            itertools.product(*(range(n) for n in shape))]


def _stitch(blocks: dict, spec: tuple, shape: tuple):
    """The whole leaf from every rank's block ({coords: block})."""
    out = None
    for coords, blk in blocks.items():
        if out is None:
            out = torch.empty(tuple(
                n * (shape[("data", "model").index(a)] if a else 1)
                for n, a in zip(blk.shape, spec)), dtype=blk.dtype)
        idx = tuple(slice(c * n, (c + 1) * n) if a else slice(None)
                    for n, a, c in ((blk.shape[d], spec[d],
                                     coords[("data", "model").index(spec[d])]
                                     if spec[d] else 0)
                                    for d in range(blk.dim())))
        out[idx] = blk
    return out


LAYOUT_CONFIGS = ("mixtral-8x7b", "recurrentgemma-2b", "rwkv6-7b",
                  "whisper-base", "llama3-405b", "gemma3-12b")


@pytest.mark.parametrize("name", LAYOUT_CONFIGS)
def test_shard_params_round_trip_and_no_whole_split_leaf(name):
    cfg = T.get_config(name).reduced(d_model=64)
    shape = (2, 4)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = TM.param_specs(cfg, shape[1], shape[0])
    flat_specs = _port_flat(specs)
    whole = tree_flatten(params)
    per_rank = {m.coords: tree_flatten(tmesh.shard_params(params, specs, m))
                for m in _ranks(shape)}
    opt = {kind: {m.coords: tree_flatten(topt.make_optimizer(kind)[0](
        tmesh.shard_params(params, specs, m), cfg)) for m in _ranks(shape)}
        for kind in ("adamw", "adafactor")}
    for path, leaf in whole.items():
        spec = flat_specs[path]
        blocks = {c: r[path] for c, r in per_rank.items()}
        got = _stitch(blocks, spec, shape)
        assert torch.equal(got, leaf), path
        for blk in blocks.values():
            assert blk.shape == tuple(
                n // (shape[("data", "model").index(a)] if a else 1)
                for n, a in zip(leaf.shape, spec)), path
            if any(spec):
                assert blk.numel() < leaf.numel(), path
            assert blk.untyped_storage().data_ptr() != \
                leaf.untyped_storage().data_ptr(), path   # a copy
        for mu in ("mu", "nu"):
            assert all(opt["adamw"][c][f"{mu}/{path}"].shape == blk.shape
                       for c, blk in blocks.items()), path
    # Adafactor's factors are the blocks of its state specs
    sspecs = topt.opt_state_specs("adafactor", TM.param_specs(cfg, 4, 2),
                                  cfg)["v"]
    whole_state = tree_flatten(topt.adafactor_init(params, cfg)["v"])
    for path, spec in _port_flat(sspecs).items():
        full = whole_state[path].shape
        for c, st in opt["adafactor"].items():
            got = st[f"v/{path}"].shape
            assert got == tuple(n // (shape[("data", "model").index(a)]
                                      if a else 1)
                                for n, a in zip(full, spec)), (path, got)
            if any(spec):
                assert st[f"v/{path}"].numel() < np.prod(full), path


def test_a_dim_that_does_not_divide_raises_naming_the_leaf():
    cfg = dataclasses.replace(T.get_config("mistral-7b").reduced(d_model=64),
                              d_ff=100)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    specs = TM.param_specs(cfg, 8, 2)
    with pytest.raises(ValueError, match=r"layers/\[0\]/ffn/w_\w+: dim 1 "
                                         r"of \(64, 100\) does not split "
                                         r"over the 8 ranks of axis "
                                         r"'model'"):
        tmesh.shard_params(params, specs, FakeMesh((2, 8), (0, 0)))
    # the embedding falls back where the vocabulary does not divide
    cfg = T.get_config("whisper-base")
    assert TM.param_specs(cfg, 16)["embed"]["tok"] == (None, "data")


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 4), (1, 6)])
def test_decode_mode_is_weight_stationary(shape):
    """A decode step's MoE mode moves no expert weight: ``ep_psum`` where
    the experts split over ``model``, ``tp_psum`` on ``tp``'s storage,
    the local path on one device."""
    from repro_torch.models.moe import stationary_moe_mode
    mesh = FakeMesh(shape, (0, 0))
    for e in (6, 8):
        got = stationary_moe_mode(e, mesh)
        if shape == (1, 1):
            assert got == "local"
        else:
            assert got == ("ep_psum" if e % shape[1] == 0 else "tp_psum")
    assert stationary_moe_mode(8, None) == "local"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_products_keep_f32_results_without_an_f32_shard(dtype):
    """``ep_psum``'s up / gate products: f32 operands go to one ``bmm``
    (bit for bit what the body computed before); bf16 ones are cast one
    expert at a time into an f32 result."""
    from repro_torch.models import moe as tmoe
    g = torch.Generator().manual_seed(0)
    a = torch.randn(3, 5, 16, generator=g).to(dtype)
    w = torch.randn(3, 16, 24, generator=g).to(dtype)
    got = tmoe._f32_bmm(a, w)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 24)
    if dtype == torch.float32:
        assert torch.equal(got, torch.bmm(a, w))
    else:
        want = torch.stack([a[e].float() @ w[e].float() for e in range(3)])
        assert torch.equal(got, want)
        np.testing.assert_allclose(got.numpy(), torch.bmm(
            a.float(), w.float()).numpy(), rtol=1e-5, atol=1e-5)
