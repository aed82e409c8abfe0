"""Mixture-of-Experts FFN with capacity-based token dispatch (local mode).

Counterpart of ``repro/models/moe.py``'s ``local`` mode: softmax router,
top-k experts per token, per-expert capacity
``C = int(tokens * top_k * cf / E) + 1`` (or every token when
``cf * top_k >= E`` / ``cf = inf``), overflow dropped in token-major
order, gates renormalized over the top k.  The expert FFN is the
``moe_ffn`` kernel on CUDA tensors and its plain version on CPU tensors;
where a gradient is needed it goes through :class:`MoEFFNFn`, whose
backward is the ``moe_ffn_bwd`` kernel (the JAX package differentiates
its three ``einsum`` products, ``repro/models/moe.py:160-167``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import moe_ffn as _mf
from repro_torch.kernels.ref import ffn_act
from repro_torch.models.attention import needs_grad


def _route(router_w, x_flat, n_experts: int, top_k: int):
    """Top-k routing. Returns (expert_idx (N,k), gate (N,k) f32)."""
    logits = x_flat.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, top_k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return idx, gate


def _capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    """cf >= n_experts/top_k (or cf=inf) gives dropless dispatch."""
    if cf == float("inf") or cf * top_k >= n_experts:
        return n_tokens
    return max(int(n_tokens * top_k * cf / n_experts) + 1, 1)


def _dispatch(x_flat, idx, n_experts: int, capacity: int):
    """Scatter tokens into per-expert capacity buffers.  A token's rank in
    its expert is the cumulative count over the token-major (N*k) order.
    Returns (buf (E, C, D), slot (N, k) — slot < 0 means dropped)."""
    n, k = idx.shape
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, n_experts)
    slot = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    keep = slot < capacity
    slot = torch.where(keep, slot, -1)
    tok = torch.arange(n, device=x_flat.device).repeat_interleave(k)
    safe_e = torch.where(keep, flat_e, 0)
    safe_s = torch.where(keep, slot, 0)
    buf = torch.zeros((n_experts, capacity, x_flat.shape[-1]),
                      dtype=x_flat.dtype, device=x_flat.device)
    rows = torch.where(keep[:, None], x_flat[tok], 0).to(x_flat.dtype)
    buf.index_put_((safe_e, safe_s), rows, accumulate=True)
    return buf, slot.reshape(n, k)


def _combine(y_buf, idx, slot, gate):
    """Gather expert outputs back to token order, weighted by gates."""
    n, k = idx.shape
    keep = slot >= 0
    safe_s = torch.where(keep, slot, 0)
    picked = y_buf[idx.reshape(-1), safe_s.reshape(-1)].reshape(n, k, -1)
    picked = torch.where(keep[..., None], picked, 0)
    return torch.einsum("nkd,nk->nd", picked.float(), gate).to(y_buf.dtype)


class MoEFFNFn(torch.autograd.Function):
    """The gated expert FFN with a hand-written backward: the forward
    runs ``moe_ffn`` and saves its inputs; the backward runs
    ``moe_ffn_bwd``, which recomputes the forward's products.  Kernels on
    CUDA tensors, plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, buf, w_gate, w_up, w_down, activation):
        ctx.activation = activation
        ctx.save_for_backward(buf, w_gate, w_up, w_down)
        return _mf.moe_ffn(buf, w_gate, w_up, w_down, activation=activation)

    @staticmethod
    def backward(ctx, dy):
        return (*_mf.moe_ffn_bwd(*ctx.saved_tensors, dy.contiguous(),
                                 activation=ctx.activation), None)


def _expert_ffn(params, buf, activation: str):
    """(E, C, D) -> (E, C, D) grouped FFN: the ``moe_ffn`` kernel on CUDA
    tensors (through :class:`MoEFFNFn` where a gradient is needed), the
    products on CPU tensors."""
    if "w_gate" not in params:
        if buf.is_cuda:
            raise NotImplementedError("the moe_ffn kernel is gated only")
        h = ffn_act(torch.bmm(buf, params["w_up"]), activation)
        return torch.bmm(h, params["w_down"])
    ws = (params["w_gate"], params["w_up"], params["w_down"])
    if needs_grad(buf, *ws):
        return MoEFFNFn.apply(buf, *ws, activation)
    return _mf.moe_ffn(buf, *ws, activation=activation)


def _moe_local(params, x_flat, *, n_experts, top_k, capacity_factor,
               activation):
    n = x_flat.shape[0]
    cap = _capacity(n, top_k, n_experts, capacity_factor)
    idx, gate = _route(params["router"], x_flat, n_experts, top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)
    y = _expert_ffn(params, buf, activation)
    return _combine(y, idx, slot, gate)


def apply_moe(params: dict, x, *, n_experts: int, top_k: int,
              activation: str, capacity_factor: float = 2.0):
    """MoE FFN over x (B, S, D)."""
    b, s, d = x.shape
    return _moe_local(params, x.reshape(-1, d), n_experts=n_experts,
                      top_k=top_k, capacity_factor=capacity_factor,
                      activation=activation).reshape(b, s, d)
