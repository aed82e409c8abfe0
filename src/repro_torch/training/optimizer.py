"""Optimizers, with the JAX package's hyperparameters and arithmetic.

Counterpart of ``repro/training/optimizer.py``:

* ``adamw`` -- AdamW with f32 moments (the default): the update is
  formed in f32 and cast back to the parameter's dtype, and weight decay
  applies to every leaf, norms and embeddings included.
* ``adafactor`` -- factored second moment (Shazeer & Stern 2018), no
  first moment; the JAX package uses it for the >= 400B configs.

Parameters, gradients and states are the port's trees (nested dicts and
lists of tensors, :mod:`repro_torch.params`).  Updates happen **in
place**: the parameter tensors and the state tensors are overwritten,
the counterpart of the JAX train step donating them; each update still
returns (params, state) as JAX's does.  ``state["step"]`` is a 0-d
int32 tensor on the CPU, so reading it never waits for the card.

Adafactor factors the JAX package's leaves, and those are stacked over
layer groups: a layer's norm scale of width D is one row of an
(n_groups, D) leaf there, so it is factored (a row factor over the
groups, a column factor over D), and the update's RMS clip spans the
whole stack.  The port keeps one tensor a layer, so its Adafactor
stacks the tensors of each pattern position (and the encoder's layers,
which the JAX package stacks too) before it factors them, and writes the
result back to each layer: the init takes the config for the pattern.
AdamW is elementwise and needs no stacking.

Over a mesh the parameters, gradients and states are the rank's blocks
(:func:`opt_state_specs` lays the states out as the parameters are:
AdamW's moments mirror them, Adafactor's factors drop one dim each).
AdamW needs nothing more; Adafactor's means over a dim that is split,
and its RMS clip over the whole leaf, sum over the ranks that hold the
leaf's other blocks (``mesh`` and the parameters' ``specs``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.launch.mesh import all_reduce, axis_size, is_spec
from repro_torch.tree import tree_flatten, tree_leaves, tree_map


def _f32(x) -> float:
    """A float32 scalar (the JAX package's weakly typed f32 arithmetic)."""
    return np.float32(x)


def _next_step(state: dict) -> float:
    state["step"] += 1
    return _f32(int(state["step"]))


def _state_zeros(p: torch.Tensor, shape=None) -> torch.Tensor:
    """f32 zeros on ``p``'s device (``p``'s shape by default)."""
    return torch.zeros(p.shape if shape is None else shape,
                       dtype=torch.float32, device=p.device)


# ---------------------------------------------------------------------------
# AdamW


def adamw_init(params, cfg=None) -> dict:
    """f32 zero moments shaped like ``params`` (``cfg`` is unused: AdamW
    is elementwise)."""
    return {"mu": tree_map(_state_zeros, params),
            "nu": tree_map(_state_zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.01):
    t = _next_step(state)
    c1 = _f32(1) - _f32(b1) ** t
    c2 = _f32(1) - _f32(b2) ** t
    with torch.no_grad():
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                tree_leaves(state["nu"]),
                                tree_leaves(params)):
            g = g.float()
            mu.mul_(b1).add_(g * (1 - b1))
            nu.mul_(b2).add_(g.square() * (1 - b2))
            del g
            delta = (nu / float(c2)).sqrt_().add_(eps)
            delta = (mu / float(c1)).div_(delta)
            pf = p.float()
            delta.add_(weight_decay * pf)
            p.copy_(pf.sub_(lr * delta))
    return params, state


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no momentum)


def stacked_leaves(params, n_positions: int, is_leaf=None) -> dict:
    """{JAX leaf path: [the port's tensors it stacks, in group order] or
    a single tensor}.  Decoder layer ``l`` is group ``l // P``, position
    ``l % P`` (``P = n_positions``, the pattern's length); encoder layers
    stack all together.  ``is_leaf`` as in :func:`tree_flatten` (a spec
    tree)."""
    flat = lambda t: tree_flatten(t, is_leaf=is_leaf)  # noqa: E731
    out = {}
    for key, val in params.items():
        if key == "layers":
            layers = val
            for i in range(n_positions):
                group = layers[i::n_positions]
                for path in flat(group[0]):
                    out[f"layers/[{i}]/{path}"] = [flat(layer)[path]
                                                   for layer in group]
        elif key == "encoder":
            for path, leaf in stacked_leaves(val, 1, is_leaf).items():
                out[f"encoder/{path}"] = leaf
        else:
            for path, leaf in flat(val).items():
                out[f"{key}/{path}"] = leaf
    return out


def _stacked_spec(spec) -> tuple:
    """A stacked leaf's spec: the group axis whole."""
    return (None,) + spec[0] if isinstance(spec, list) else spec


def _shape(leaf) -> tuple:
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape)
    return tuple(leaf.shape)


def adafactor_init(params, cfg) -> dict:
    """Row and column factors (f32) of every stacked leaf of two or more
    dims, a full second moment of the others (the embedding's and the
    final norm's 1-D leaves)."""
    def factors(leaf):
        shape = _shape(leaf)
        p = leaf[0] if isinstance(leaf, list) else leaf
        if len(shape) >= 2:
            return {"row": _state_zeros(p, shape[:-1]),
                    "col": _state_zeros(p, shape[:-2] + shape[-1:])}
        return {"v": _state_zeros(p, shape)}

    return {"v": {path: factors(leaf) for path, leaf in
                  stacked_leaves(params, len(cfg.layer_pattern)).items()},
            "step": torch.zeros((), dtype=torch.int32)}


def adafactor_update(grads, state, params, lr, *, decay=0.8, eps=1e-30,
                     clip=1.0, mesh=None, specs=None):
    """``mesh`` and ``specs`` (the parameters' spec tree) when the trees
    hold the rank's blocks: each mean then sums over the axis its dim is
    split over."""
    t = _next_step(state)
    beta = float(_f32(1) - t ** _f32(-decay))
    n_pos = _n_positions(state)
    gl = stacked_leaves(grads, n_pos)
    sl = (stacked_leaves(specs, n_pos, is_spec) if mesh is not None
          else {})

    def mean(x, dim, axis, keepdim=False):
        """``x.mean(dim)`` over the whole dim, split over ``axis``."""
        if mesh is None or axis is None:
            return x.mean(dim, keepdim=keepdim)
        return all_reduce(x.sum(dim, keepdim=keepdim), mesh, axis) / (
            x.shape[dim] * axis_size(mesh, axis))

    with torch.no_grad():
        for path, p in stacked_leaves(params, n_pos).items():
            g, v = gl[path], state["v"][path]
            stacked = isinstance(p, list)
            spec = (_stacked_spec(sl[path]) if mesh is not None
                    else (None,) * 2)
            g = (torch.stack([x.float() for x in g]) if stacked
                 else g.float())
            g2 = g.square() + eps
            if g.dim() >= 2:
                v["row"].mul_(beta).add_((1 - beta) * mean(g2, -1, spec[-1]))
                v["col"].mul_(beta).add_((1 - beta) * mean(g2, -2, spec[-2]))
                denom = mean(v["row"], -1, spec[-2], keepdim=True)
                rfac = (v["row"] / torch.clamp_min(denom, eps))[..., None]
                update = g * torch.rsqrt(torch.clamp_min(
                    rfac * v["col"][..., None, :], eps))
            else:
                v["v"].mul_(beta).add_((1 - beta) * g2)
                update = g * torch.rsqrt(torch.clamp_min(v["v"], eps))
            del g, g2
            if mesh is None:
                norm = torch.sqrt(torch.mean(torch.square(update)))
            else:
                norm = _leaf_mean(torch.square(update), spec, mesh).sqrt()
            update = update / torch.clamp_min(norm / clip, 1.0)
            if stacked:
                for i, pi in enumerate(p):
                    pi.copy_(pi.float() - lr * update[i])
            else:
                p.copy_(p.float() - lr * update)
    return params, state


def _n_positions(state: dict) -> int:
    """The pattern length the state was made for: the number of
    ``layers/[i]/`` positions among its paths (1 with no layer leaves)."""
    pos = {path.split("/")[1] for path in state["v"]
           if path.startswith("layers/")}
    return max(len(pos), 1)


# ---------------------------------------------------------------------------


def _leaf_mean(x, spec: tuple, mesh):
    """The mean of a leaf whose rank holds block ``x`` under ``spec``."""
    axes = [a for a in dict.fromkeys(spec) if a is not None]
    total = x.sum()
    for axis in axes:
        total = all_reduce(total, mesh, axis)
    return total / (x.numel() * math.prod(axis_size(mesh, a) for a in axes))


def opt_state_specs(kind: str, param_specs, cfg=None) -> dict:
    """The state's specs, mirroring ``param_specs``
    (``repro/training/optimizer.py:142``): AdamW's moments take the
    parameters' specs; Adafactor's ``row`` drops the last dim's axis and
    ``col`` the second-to-last, keyed by its stacked leaves as
    :func:`adafactor_init` (hence ``cfg``, for the pattern) keys them.
    ``step`` is a scalar."""
    if kind == "adamw":
        return {"mu": param_specs, "nu": param_specs, "step": ()}
    if kind != "adafactor":
        raise ValueError(kind)

    def factors(spec):
        if len(spec) >= 2:
            return {"row": spec[:-1], "col": spec[:-2] + spec[-1:]}
        return {"v": spec}

    return {"v": {path: factors(_stacked_spec(spec)) for path, spec in
                  stacked_leaves(param_specs, len(cfg.layer_pattern),
                                 is_spec).items()},
            "step": ()}


def make_optimizer(kind: str):
    """(init, update): ``init(params, cfg)`` (the port's init also takes
    the config, whose pattern Adafactor stacks by) and ``update(grads,
    state, params, lr)``."""
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(kind)
