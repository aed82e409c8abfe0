"""The train step and loop.

Counterpart of ``repro/training/train_loop.py``.  ``make_train_step``
builds the (params, opt_state, batch) -> (params, opt_state, loss)
function; PyTorch runs it eagerly, the parameters and the optimizer
state updated in place (the JAX loop donates them).  A batch is the data
pipeline's dict of numpy arrays (``tokens`` (B, S) int32 and, for an
encoder-decoder config, ``encoder_frames`` (B, T, D)); the step moves it
to the parameters' device.
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import model as M
from repro_torch.training.optimizer import make_optimizer
from repro_torch.tree import tree_leaves, tree_map


def _to_device(batch: dict, cfg: ModelConfig, device) -> dict:
    out = {"tokens": torch.as_tensor(batch["tokens"], device=device).long()}
    if "encoder_frames" in batch:
        out["encoder_frames"] = torch.as_tensor(
            batch["encoder_frames"], device=device).to(cfg.torch_dtype)
    return out


def _unflatten(params, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), params)


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu",
                       pin_memory=t.is_cuda)


def make_train_step(cfg: ModelConfig, lr: float = 3e-4, accum_steps: int = 1,
                    host_optimizer: bool = False):
    """Build the train step.

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
    device).
    """
    _, opt_update = make_optimizer(cfg.optimizer)
    host: dict = {}

    def grads_of(params, leaves, batch):
        loss = M.loss_fn(params, cfg, batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def update(grads, opt_state, params, leaves):
        if not host_optimizer:
            return opt_update(_unflatten(params, grads), opt_state, params,
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
            _, opt_state = opt_update(_unflatten(params, host["g"]),
                                      opt_state,
                                      _unflatten(params, host["p"]), lr)
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
        train_step.grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in grads]))
        params, opt_state = update(grads, opt_state, params, leaves)
        return params, opt_state, loss

    train_step.grad_norm = None
    return train_step


def train_loop(cfg: ModelConfig, params, opt_state, data_iter, steps: int,
               lr: float = 3e-4, log_every: int = 10):
    """Simple synchronous training loop; returns (params, opt_state, log).

    ``log`` holds a row every ``log_every`` steps and at the last:
    ``step``, ``loss``, ``elapsed_s`` (reading the loss waits for the
    card, so ``elapsed_s`` covers the device's work) and ``grad_norm``."""
    step_fn = make_train_step(cfg, lr=lr)
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
