"""The port's production layouts (``repro_torch.launch.specs``) against
the JAX package's (``repro.launch.specs``) for every architecture x input
shape on both production meshes.

The functions that read only a mesh's axes (``batch_axes``,
``train_layout``, ``podify_specs``, ``model_param_specs``,
``kv_seq_spec``, ``cache_batch_spec``, ``pick_accum``, ``applicable``)
take a stand-in on each side: JAX's ``axis_names`` and a ``shape``
mapping, the port's ``mesh_dim_names`` and a ``shape`` tuple.  Then
every parameter leaf's per-rank block, as ``abstract_params`` lays it
out on meta tensors (rank 0 of a stand-in that answers
``get_local_rank``), against ``NamedSharding.shard_shape`` of JAX's
``abstract_params`` on the real (16, 16) and (2, 16, 16) meshes, from a
subprocess with 512 host devices that runs ``eval_shape`` only."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_mesh_specs import _jax_specs_flat, _port_flat, _unstacked  # noqa: E402

from repro import configs as J  # noqa: E402
from repro.configs.base import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro_torch import configs as T  # noqa: E402
from repro_torch.launch import specs as TS  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

SRC = str(Path(__file__).resolve().parents[1] / "src")
ARCHS = list(J.ARCHS)
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


@dataclasses.dataclass
class _JaxMesh:                     # what repro.launch.specs reads
    axis_names: tuple
    shape: dict


@dataclasses.dataclass
class _PortMesh:                    # rank 0 of a torch DeviceMesh
    mesh_dim_names: tuple
    shape: tuple

    def get_local_rank(self, axis):
        return 0


def _meshes(kind):
    names, sizes = MESHES[kind]
    return _JaxMesh(names, dict(zip(names, sizes))), _PortMesh(names, sizes)


def test_input_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in T.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_layouts_match_jax(arch, kind):
    from repro.launch import specs as JS
    jm, tm = _meshes(kind)
    jcfg, tcfg = J.get_config(arch), T.get_config(arch)
    assert TS.batch_axes(tm) == JS.batch_axes(jm)
    for name in J_SHAPES:
        js, ts = J_SHAPES[name], T.INPUT_SHAPES[name]
        assert TS.train_layout(tcfg, ts, tm) == JS.train_layout(jcfg, js, jm)
        assert TS.kv_seq_spec(ts, tm) == JS.kv_seq_spec(js, jm)
        assert TS.cache_batch_spec(ts, tm) == JS.cache_batch_spec(js, jm)
        assert TS.pick_accum(tcfg, ts, tm) == JS.pick_accum(jcfg, js, jm)
        assert TS.applicable(tcfg, ts) == JS.applicable(jcfg, js)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_param_specs_match_jax(arch, kind):
    from repro.launch import specs as JS
    jm, tm = _meshes(kind)
    jcfg = J.get_config(arch)
    want = _unstacked(_jax_specs_flat(JS.model_param_specs(jcfg, jm)), jcfg)
    assert _port_flat(TS.model_param_specs(T.get_config(arch), tm)) == want


def test_podify_specs_widens_data_only_on_the_pod_mesh():
    from repro.launch import specs as JS
    from jax.sharding import PartitionSpec as P
    tree = {"a": ("data", "model"), "b": [(None, "data"), ("model",)]}
    jtree = {"a": P("data", "model"), "b": [P(None, "data"), P("model")]}
    for kind in MESHES:
        jm, tm = _meshes(kind)
        got = TS.podify_specs(tree, tm)
        want = JS.podify_specs(jtree, jm)
        assert got == {"a": tuple(want["a"]),
                       "b": [tuple(s) for s in want["b"]]}


_JAX_BLOCKS = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro import configs as J
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import abstract_params
    out = {}
    for kind in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=kind == "multi")
        for arch in J.ARCHS:
            tree = abstract_params(J.get_config(arch), mesh)
            flat = jax.tree_util.tree_flatten_with_path(tree)[0]
            out[f"{kind}/{arch}"] = [
                [jax.tree_util.keystr(p), list(a.sharding.shard_shape(a.shape))]
                for p, a in flat]
    json.dump(out, sys.stdout)
""")


@pytest.fixture(scope="module")
def jax_blocks():
    out = subprocess.run([sys.executable, "-c", _JAX_BLOCKS],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout)


def _jax_path(keystr: str) -> str:
    """``['layers'][0]['attn']['wq']`` -> ``layers/[0]/attn/wq``."""
    parts = keystr.strip("[]").split("][")
    return "/".join(p.strip("'") if p.startswith("'") else f"[{p}]"
                    for p in parts)


@pytest.mark.parametrize("kind", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_blocks_match_jax_shard_shapes(jax_blocks, arch, kind):
    jcfg = J.get_config(arch)
    want = _unstack_shapes({_jax_path(k): tuple(shape) for k, shape in
                            jax_blocks[f"{kind}/{arch}"]}, jcfg)
    blocks = tree_flatten(TS.abstract_params(T.get_config(arch),
                                             _meshes(kind)[1]))
    assert all(t.is_meta for t in blocks.values())
    assert {p: tuple(t.shape) for p, t in blocks.items()} == want


def _unstack_shapes(flat: dict, cfg) -> dict:
    """JAX's block shapes with the stacked group (or encoder-layer) axis
    dropped and handed to every layer of its pattern position."""
    pat = len(cfg.layer_pattern)
    out = {}
    for path, shape in flat.items():
        parts = path.split("/")
        if parts[0] == "layers":
            i = int(parts[1][1:-1])
            for l in range(i, cfg.n_layers, pat):
                out["/".join(["layers", f"[{l}]"] + parts[2:])] = shape[1:]
        elif parts[:2] == ["encoder", "layers"]:
            for l in range(cfg.n_encoder_layers):
                out["/".join(["encoder", "layers", f"[{l}]"] + parts[2:])] = \
                    shape[1:]
        else:
            out[path] = shape
    return out
