"""The train step and loop.

Counterpart of ``repro/training/train_loop.py``.  ``make_train_step``
builds the (params, opt_state, batch) -> (params, opt_state, loss)
function; PyTorch runs it eagerly, the parameters and the optimizer
state updated in place (the JAX loop donates them).  A batch is the data
pipeline's dict of numpy arrays (``tokens`` (B, S) int32 and, for an
encoder-decoder config, ``encoder_frames`` (B, T, D)); the step moves it
to the parameters' device.

Over a ``mesh`` the parameters and the optimizer state are the rank's
blocks (:func:`repro_torch.models.model.shard_model`, and the
optimizer's init on them) and every rank is handed the whole batch.
:func:`loss_and_grads` sums each gradient over exactly the ranks that
saw other tokens: a leaf split over ``"data"`` got its sum from its
gather's backward (a reduce-scatter), one replicated over ``"data"`` is
summed here; nothing is summed over ``"model"``, whose ranks computed
the same thing.
"""
from __future__ import annotations

import functools
import time

import torch

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import all_reduce, is_batch_axis, leaf_specs
from repro_torch.models import model as M
from repro_torch.training.optimizer import make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _to_device(batch: dict, cfg: ModelConfig, device) -> dict:
    out = {"tokens": torch.as_tensor(batch["tokens"], device=device).long()}
    if "encoder_frames" in batch:
        out["encoder_frames"] = torch.as_tensor(
            batch["encoder_frames"], device=device).to(cfg.torch_dtype)
    return out


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A host buffer for ``t`` (page-locked for a card's tensor; a meta
    tensor's stays meta, for the dry run)."""
    return torch.empty(t.shape, dtype=t.dtype,
                       device="meta" if t.is_meta else "cpu",
                       pin_memory=t.is_cuda)


def _sum_over_data(grads: list, specs: list, mesh) -> list:
    """Each gradient of a leaf not split over ``"data"`` summed over it
    (one all-reduce a dtype)."""
    grads = list(grads)
    todo = [i for i, s in enumerate(specs)
            if not any(a is not None and is_batch_axis(a) for a in s)]
    for dt in dict.fromkeys(grads[i].dtype for i in todo):
        sel = [i for i in todo if grads[i].dtype == dt]
        flat = all_reduce(torch.cat([grads[i].reshape(-1) for i in sel]),
                          mesh, "data")
        for i, part in zip(sel, flat.split([grads[i].numel() for i in sel])):
            grads[i] = part.view_as(grads[i])
    return grads


def loss_and_grads(params, cfg: ModelConfig, batch: dict, mesh=None):
    """(loss, gradients in ``tree_leaves`` order) of ``loss_fn`` on a
    batch of tensors; over a ``mesh`` the global loss on every rank and
    the gradient of each of the rank's blocks, summed as the module's
    docstring says."""
    leaves = tree_leaves(params)
    loss = M.loss_fn(params, cfg, batch, mesh)
    grads = torch.autograd.grad(loss, leaves)
    if mesh is not None:
        grads = _sum_over_data(grads, leaf_specs(params,
                                                 M.mesh_specs(cfg, mesh)),
                               mesh)
    return loss.detach(), list(grads)


def global_grad_norm(grads: list, specs: list | None, mesh):
    """The L2 norm of the whole gradient: each leaf's squares summed over
    the axes its spec splits it over (a replicated block counts once)."""
    if mesh is None:
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads]))
    by_axes: dict = {}
    for i, g in enumerate(grads):
        axes = tuple(a for a in dict.fromkeys(specs[i]) if a is not None)
        by_axes.setdefault(axes, []).append(
            torch.linalg.vector_norm(g, dtype=torch.float32).square())
    total = []
    for axes, sq in by_axes.items():
        sq = torch.stack(sq).sum()
        for axis in axes:
            sq = all_reduce(sq, mesh, axis)
        total.append(sq)
    return torch.stack(total).sum().sqrt()


def make_train_step(cfg: ModelConfig, mesh=None, lr: float = 3e-4,
                    accum_steps: int = 1, host_optimizer: bool = False):
    """Build the train step (the JAX package's parameters, in its order).

    ``mesh``: the parameters and the optimizer state are the rank's
    blocks and the batch is whole on every rank; microbatch ``i`` is
    rows ``[i B / a, (i + 1) B / a)`` of the global batch, whose rows
    the ranks then split, as the JAX step's.

    ``accum_steps > 1`` runs the batch as that many sequential
    microbatches (split along the batch) with gradient accumulation in
    bf16, as the JAX package accumulates whatever the parameters' dtype
    (the optimizer's arithmetic stays f32).

    ``host_optimizer`` keeps the optimizer state in page-locked host
    memory and runs the update on the host, the counterpart of the JAX
    step's ``compute_on('device_host')``: each step copies the gradients
    and the parameters to host buffers, updates there, and copies the
    parameters back into the card's tensors.  A state made on the card
    moves to the host at the first step.

    The step also leaves the global L2 norm of the gradient its update
    used in ``step.grad_norm`` (a 0-d f32 tensor on the parameters'
    device, summed over the ranks).
    """
    _, opt_update = make_optimizer(cfg.optimizer)
    specs = None
    if mesh is not None:
        specs = M.mesh_specs(cfg, mesh)
        if cfg.optimizer == "adafactor":
            opt_update = functools.partial(opt_update, mesh=mesh,
                                           specs=specs)
    host: dict = {}

    def grads_of(params, leaves, batch):
        return loss_and_grads(params, cfg, batch, mesh)

    def update(grads, opt_state, params, leaves):
        if not host_optimizer:
            return opt_update(tree_unflatten(params, grads), opt_state, params,
                              lr)
        if not host:
            host["p"] = [_pinned_like(p) for p in leaves]
            host["g"] = [_pinned_like(g) for g in grads]
            opt_state = tree_map(
                lambda t: t if not t.is_cuda else
                _pinned_like(t).copy_(t), opt_state)
        with torch.no_grad():
            for dst, src in zip(host["p"] + host["g"], list(leaves) +
                                list(grads)):
                dst.copy_(src, non_blocking=True)
            if leaves[0].is_cuda:
                torch.cuda.current_stream(leaves[0].device).synchronize()
            _, opt_state = opt_update(tree_unflatten(params, host["g"]),
                                      opt_state,
                                      tree_unflatten(params, host["p"]), lr)
            for p, hp in zip(leaves, host["p"]):
                p.copy_(hp, non_blocking=True)
            if leaves[0].is_cuda:      # the host buffers are reused
                torch.cuda.current_stream(leaves[0].device).synchronize()
        return params, opt_state

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _to_device(batch, cfg, leaves[0].device)
        if accum_steps == 1:
            loss, grads = grads_of(params, leaves, batch)
        else:
            b = batch["tokens"].shape[0]
            mb = b // accum_steps
            gsum = [torch.zeros_like(p, dtype=torch.bfloat16) for p in leaves]
            losses = []
            for i in range(accum_steps):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, g = grads_of(params, leaves, micro)
                losses.append(loss_i)
                for s, gg in zip(gsum, g):
                    s.add_(gg.to(s.dtype))
                del g
            grads = [s / accum_steps for s in gsum]
            loss = torch.stack(losses).mean()
        train_step.grad_norm = global_grad_norm(
            grads, specs and leaf_specs(params, specs), mesh)
        params, opt_state = update(grads, opt_state, params, leaves)
        return params, opt_state, loss

    train_step.grad_norm = None
    return train_step


def train_loop(cfg: ModelConfig, params, opt_state, data_iter, steps: int,
               mesh=None, lr: float = 3e-4, log_every: int = 10):
    """Simple synchronous training loop; returns (params, opt_state, log).

    ``log`` holds a row every ``log_every`` steps and at the last:
    ``step``, ``loss``, ``elapsed_s`` (reading the loss waits for the
    card, so ``elapsed_s`` covers the device's work) and ``grad_norm``.
    ``mesh`` as in :func:`make_train_step`."""
    step_fn = make_train_step(cfg, mesh, lr)
    log = []
    t0 = time.time()
    for i in range(steps):
        batch = next(data_iter)
        params, opt_state, loss = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            loss_v = float(loss)
            log.append({"step": i, "loss": loss_v,
                        "elapsed_s": time.time() - t0,
                        "grad_norm": float(step_fn.grad_norm)})
    return params, opt_state, log
