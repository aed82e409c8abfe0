"""Layouts and abstract inputs for every (architecture x input shape x
mesh) combination, and the step each one runs.

Counterpart of ``repro/launch/specs.py`` (``:22-242``): the single
source of the production layouts that ``launch/dryrun.py`` and
``launch/train.py --production-plan`` read.  "Abstract" here means the
rank's blocks as meta tensors (``device="meta"``: shapes and dtypes, no
data), where the JAX package has ``ShapeDtypeStruct``s with shardings.

A mesh is a ``torch.distributed`` ``DeviceMesh`` (:mod:`.mesh`), or for
the functions that read only its axes any object with either
``mesh_dim_names`` and a ``shape`` tuple (torch's) or ``axis_names`` and
a ``shape`` mapping (JAX's).

Decode and prefill caches take the JAX package's layout
(:func:`abstract_cache`): :func:`cache_batch_spec` splits their batch
over the batch axes and :func:`kv_seq_spec` their sequence over
``"model"`` (over every axis at ``long_500k``), every kv head whole;
the cache records the layout, and ``prefill`` / ``decode_step`` read it
(:mod:`repro_torch.models.attention`: each rank attends its rows over
its slots and the partials merge by log-sum-exp).  The model inputs
stay whole on every rank, as the port's entry points take them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.launch.mesh import shard_params
from repro_torch.models import model as M
from repro_torch.models.layers import sequence_sharding
from repro_torch.models.transformer import init_cache
from repro_torch.params import init_params
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import make_train_step


def _axes(mesh) -> dict:
    """{axis name: size} of a torch or a JAX mesh, in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _axes(mesh))


def _bspec(mesh):
    ax = batch_axes(mesh)
    return ax if len(ax) > 1 else ax[0]


def train_layout(cfg: ModelConfig, shape: InputShape, mesh):
    """(tokens batch spec, tokens seq spec, sequence-parallel axis): the
    batch over the batch axes, the sequence whole at the input and split
    over ``"model"`` inside the step (the JAX package's own reasons:
    ``repro/launch/specs.py:26-39``)."""
    if "pod" in _axes(mesh):
        return ("pod", "data"), None, "model"
    return "data", None, "model"


def podify_specs(spec_tree, mesh):
    """On a mesh with ``"pod"``, every ``"data"`` entry of a spec widened
    to ``("pod", "data")``: the pod axis joins the FSDP product."""
    if "pod" not in _axes(mesh):
        return spec_tree

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return tuple(("pod", "data") if a == "data" else a for a in node)

    return conv(spec_tree)


def model_param_specs(cfg: ModelConfig, mesh):
    return podify_specs(M.param_specs(cfg, _axes(mesh).get("model", 1)),
                        mesh)


def abstract_params(cfg: ModelConfig, mesh):
    """The rank's parameter blocks under :func:`model_param_specs`, as
    meta tensors."""
    whole = init_params(cfg, None, "meta")
    return shard_params(whole, model_param_specs(cfg, mesh), mesh)


def abstract_opt_state(cfg: ModelConfig, mesh):
    """The optimizer's state of the rank's blocks, as meta tensors."""
    return make_optimizer(cfg.optimizer)[0](abstract_params(cfg, mesh), cfg)


def kv_seq_spec(shape: InputShape, mesh):
    """How the JAX package shards a decode cache's sequence axis."""
    if shape.name == "long_500k":
        return tuple(_axes(mesh))     # batch 1: every axis
    return "model"


def cache_batch_spec(shape: InputShape, mesh):
    """How the JAX package shards a cache's (and the inputs') batch."""
    sizes = _axes(mesh)
    ax = batch_axes(mesh)
    if shape.global_batch % math.prod(sizes[a] for a in ax) == 0:
        return _bspec(mesh)
    if shape.global_batch % sizes[ax[-1]] == 0:      # data axis only
        return ax[-1]
    return None


def cache_layout(shape: InputShape, mesh) -> tuple:
    """(batch spec, sequence spec) of a decode or prefill cache: the JAX
    package's ``cache_specs`` arguments (``repro/launch/specs.py:
    129-135``)."""
    return cache_batch_spec(shape, mesh), kv_seq_spec(shape, mesh)


def abstract_cache(cfg: ModelConfig, shape: InputShape, mesh):
    """The rank's block of the cache the port's prefill and decode read on
    ``mesh``, as meta tensors: JAX's ``cache_specs(cfg,
    cache_batch_spec, kv_seq_spec)`` (the rank's rows and slots, every kv
    head; the recurrent states the rank's rows and channels), the layout
    recorded in the cache (``init_cache(..., layout=)``)."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, "meta", mesh,
                      layout=cache_layout(shape, mesh))


# ---------------------------------------------------------------------------
# model inputs


def input_specs(cfg: ModelConfig, shape: InputShape, mesh) -> dict:
    """Meta model inputs for one (arch, input shape), whole on the rank
    as the port's entry points take them (they split the batch
    themselves):

    train   -> {'batch': {tokens[, encoder_frames]}}
    prefill -> {'tokens'[, 'encoder_frames'], 'cache'}
    decode  -> {'cache', 'tokens'} (one new token per sequence)
    """
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    tokens = lambda n: torch.empty((b, n), dtype=torch.int64, **meta)  # noqa: E731
    frames = lambda: torch.empty((b, cfg.encoder_len, cfg.d_model),  # noqa: E731
                                 dtype=cfg.torch_dtype, **meta)
    if shape.phase == "train":
        batch = {"tokens": tokens(s)}
        if cfg.encoder_decoder:
            batch["encoder_frames"] = frames()
        return {"batch": batch}
    out = {"cache": abstract_cache(cfg, shape, mesh)}
    if shape.phase == "prefill":
        out["tokens"] = tokens(s)
        if cfg.encoder_decoder:
            out["encoder_frames"] = frames()
    else:
        out["tokens"] = tokens(1)
    return out


# ---------------------------------------------------------------------------
# step builders


def build_step(cfg: ModelConfig, shape: InputShape, mesh, lr: float = 1e-4):
    """(fn, args, donated argument indices): ``fn(*args)`` runs the
    combination's step on ``mesh``, training and prefill under the
    sequence-parallel profile, decode without it, as the JAX package's
    ``build_step`` wraps them.  ``args`` are meta tensors; a caller may
    hand ``fn`` real ones of the same shapes."""
    ins = input_specs(cfg, shape, mesh)
    if shape.phase == "train":
        step = make_train_step(cfg, mesh, lr,
                               accum_steps=pick_accum(cfg, shape, mesh),
                               host_optimizer=cfg.param_count() > 1e11)
        seq_ax = train_layout(cfg, shape, mesh)[2]

        def train_fn(params, opt_state, batch):
            with sequence_sharding(seq_ax):
                return step(params, opt_state, batch)

        params = abstract_params(cfg, mesh)
        opt_state = make_optimizer(cfg.optimizer)[0](params, cfg)
        return train_fn, (params, opt_state, ins["batch"]), (0, 1)

    if shape.phase == "prefill":
        def prefill_fn(params, tokens, cache, frames=None):
            with sequence_sharding("model"):
                return M.prefill(params, cfg, tokens, cache, mesh,
                                 encoder_frames=frames)
        args = (abstract_params(cfg, mesh), ins["tokens"], ins["cache"])
        if cfg.encoder_decoder:
            args += (ins["encoder_frames"],)
        return prefill_fn, args, (2,)

    def serve_fn(params, cache, tokens):
        with sequence_sharding(None):
            return M.decode_step(params, cfg, cache, tokens, mesh)

    return serve_fn, (abstract_params(cfg, mesh), ins["cache"],
                      ins["tokens"]), (1,)


def pick_accum(cfg: ModelConfig, shape: InputShape, mesh) -> int:
    """Gradient-accumulation steps: keep per-rank microbatch activations
    (B_loc_micro * d_model) within budget for the big dense configs."""
    tb, _, _ = train_layout(cfg, shape, mesh)
    sizes = _axes(mesh)
    axes = tb if isinstance(tb, tuple) else (tb,)
    b_loc = max(1, shape.global_batch // math.prod(sizes[a] for a in axes))
    target = max(1, (b_loc * cfg.d_model) // 8192)
    accum = 1
    while accum < min(target, b_loc):
        accum *= 2
    return accum


def applicable(cfg: ModelConfig, shape: InputShape) -> tuple:
    """(runs?, reason): the ``long_500k`` skip policy."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("SKIP(long-context): pure full-attention architecture "
                       "— no sub-quadratic variant (DESIGN.md §5)")
    return True, ""
