"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free time mixing
with data-dependent per-channel decay.

Counterpart of ``repro/models/rwkv.py``.  Time mix, per head of size
``hd`` with state S (hd, hd)::

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(w0 + tanh(x_w A) B))

The projections, the token shift and the group norm are plain PyTorch;
the recurrence is the ``wkv6`` kernel on CUDA tensors (its plain version
on the CPU), in prefill and in verify.  The JAX prefill scans in
``jax.checkpoint`` segments only to bound training's backward pass;
serving has none, so the port runs the whole sequence in one call.
Where a gradient is needed the call goes through :class:`WKV6Fn`, whose
backward, the ``wkv6_bwd`` kernel, keeps that segment checkpointing
inside the kernel.

State per layer: ``{"S": (B,H,hd,hd) f32, "ts_a": (B,D), "ts_c": (B,D)}``
(the last inputs of the time-mix and channel-mix token shifts).  A
multi-token decode (S <= 16) also returns the per-step state stack that
``commit`` selects from, index 0 being the state before the first step.

Over a mesh the block runs channel-parallel (``repro/models/rwkv.py:
113-130``), on the rank's H/m heads: r/k/v/g are column products, ``w0``,
``u``, ``ln_x`` and ``w_lora_b`` are the rank's channel blocks, the
per-head group norm is local and ``w_o`` is a row product; the
``wkv6`` kernel runs on H/m heads.  The channel mix's ``w_k`` is a
column product and ``w_v`` a row product whose output's rank block
(a reduce-scatter over D) meets the ``w_r`` column product's, then is
gathered.  Decode moves no weight (the stationary products of
:mod:`repro_torch.models.layers`); ``S`` and its rollback stack hold the
rank's heads, the token-shift inputs are whole (:func:`rwkv_state_specs`).
With ``rows`` (a decode step on a cache in the production layout) ``S``
and its stack hold the rank's rows of the batch over that axis: r/k/v/w
are computed for every row (the stationary products need the whole
token block), the ``wkv6`` recurrence runs on the rank's rows from their
``S``, and its output rows are gathered for the group norm and ``w_o``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import wkv6 as _wk
from repro_torch.launch.mesh import (all_gather, all_reduce_grad, block,
                                     gather_param, reduce_scatter)
from repro_torch.models.attention import needs_grad, row_block
from repro_torch.models.layers import (ROW, col_product, model_input,
                                       row_product)


def tmix_specs() -> dict:
    """At rest over a mesh (``repro/models/rwkv.py:56``), as
    :func:`cmix_specs`."""
    col, row = ("data", "model"), ("model", "data")
    return {"mu_r": (None,), "mu_k": (None,), "mu_v": (None,),
            "mu_g": (None,), "mu_w": (None,),
            "w_r": col, "w_k": col, "w_v": col, "w_g": col, "w_o": row,
            "w0": ("model",), "w_lora_a": ("data", None),
            "w_lora_b": (None, "model"), "u": ("model",),
            "ln_x": ("model",)}


def cmix_specs() -> dict:
    return {"mu_k": (None,), "mu_r": (None,), "w_k": ("data", "model"),
            "w_v": ("model", "data"), "w_r": ("data", "model")}


def rwkv_state_specs(batch_spec) -> dict:
    return {"S": (batch_spec, "model", None, None),
            "ts_a": (batch_spec, None), "ts_c": (batch_spec, None)}


def init_rwkv_state(batch: int, d_model: int, head_size: int, dtype,
                    device, shards: int = 1) -> dict:
    """The zero state; ``S`` holds ``1 / shards`` of the heads (a rank's
    over a mesh)."""
    h = d_model // head_size // shards
    return {"S": torch.zeros((batch, h, head_size, head_size),
                             device=device),
            "ts_a": torch.zeros((batch, d_model), dtype=dtype, device=device),
            "ts_c": torch.zeros((batch, d_model), dtype=dtype, device=device)}


def _token_shift(x, prev):
    """The x_{t-1} stream: ``prev`` for t=0, x shifted right otherwise."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _lerp(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _mix_col(params, x, xp, mu: str, w: str, mesh, stationary: bool):
    """The token-shift mix ``params[mu]`` of x times the column-parallel
    ``params[w]`` (over a ``mesh``: the rank's block of its outputs)."""
    z = model_input(_lerp(x, xp, params[mu]), mesh, stationary)
    return col_product(z, params[w], mesh, stationary)


class WKV6Fn(torch.autograd.Function):
    """The WKV recurrence with a hand-written backward, the counterpart of
    the JAX package's autodiff through its checkpointed scan
    (``repro/models/rwkv.py:145-162``).  Takes r/k/v/w (B, H, S, hd) (the
    model's (B, S, H, hd) tensors as transposed views), u (H, hd) and s0;
    returns (y, s_final).  The forward runs ``wkv6`` (no stack) and saves
    its inputs; the backward runs ``wkv6_bwd``, which writes dr/dk/dv/dw
    through r's strides.  Kernels on CUDA tensors, plain versions on CPU
    tensors."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        y, s_fin = _wk.wkv6(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.set_materialize_grads(False)
        return y, s_fin

    @staticmethod
    def backward(ctx, dy, ds_fin):
        r, k, v, w, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        return _wk.wkv6_bwd(r, k, v, w, u, s0, dy, ds_fin)


def apply_rwkv_tmix(params: dict, x, state_S, ts_prev, head_size: int,
                    mesh=None, stationary: bool = False, rows=None):
    """Time mix over x (B,S,D).  Returns (out, S_stack, new ts (B,D)):
    ``S_stack`` is (B,S+1,H,hd,hd) — every state, index 0 = ``state_S`` —
    for S <= 16, else the final state as (B,1,H,hd,hd).  Over a ``mesh``
    the heads are the rank's; with ``rows`` ``state_S`` and the stack
    its rows (see the module's docstring)."""
    b, s, _ = x.shape
    xp = _token_shift(x, ts_prev)
    col = lambda mu, w: _mix_col(params, x, xp, mu, w, mesh,  # noqa: E731
                                 stationary)
    r, k, v = col("mu_r", "w_r"), col("mu_k", "w_k"), col("mu_v", "w_v")
    g = F.silu(col("mu_g", "w_g"))
    xw = _lerp(x, xp, params["mu_w"]).float()
    # the low-rank decay: its (B,S,R) middle is whole on every rank, and
    # its gradient there is summed over "model" (each rank's channels
    # give a part), not the gradient of xw a second time
    lora = torch.tanh(col_product(model_input(xw, mesh, True) if stationary
                                  else xw, params["w_lora_a"], mesh,
                                  stationary))
    if mesh is not None and not stationary:
        lora = all_reduce_grad(lora, mesh, "model")
    w_log = params["w0"] + lora @ params["w_lora_b"]
    w = torch.exp(-torch.exp(w_log))                  # (B,S,D) in (0, 1)
    d = r.shape[-1]                                   # the rank's channels
    h = d // head_size

    def heads(z):                                     # -> (B,H,S,hd) view
        return z.reshape(b, s, h, head_size).float().transpose(1, 2)

    u = params["u"].reshape(h, head_size)
    rh, kh, vh, wh = heads(r), heads(k), heads(v), heads(w)
    if rows is not None:
        rs = row_block(mesh, rows, b)
        rh, kh, vh, wh = (t[rs] for t in (rh, kh, vh, wh))
    if needs_grad(rh, kh, vh, wh, u, state_S):
        # training: no per-step states (verify runs without a gradient)
        y, s_last = WKV6Fn.apply(rh, kh, vh, wh, u, state_S)
        S_stack = s_last[:, None]
    elif s <= 16:   # decode/verify keeps every per-step state for rollback
        y, _, S_stack = _wk.wkv6(rh, kh, vh, wh, u, state_S, stack=True)
    else:
        y, s_last = _wk.wkv6(rh, kh, vh, wh, u, state_S)
        S_stack = s_last[:, None]
    y = y.transpose(1, 2)                             # (B,S,H,hd)
    if rows is not None:
        y = all_gather(y, mesh, rows, 0)

    # per-head RMS "group norm"
    var = y.square().mean(-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6)
    y = (y.reshape(b, s, d) * params["ln_x"]).to(x.dtype)
    out = row_product(y * g, params["w_o"], mesh, stationary)
    return out, S_stack, x[:, -1]


def apply_rwkv_cmix(params: dict, x, ts_prev, mesh=None,
                    stationary: bool = False):
    xp = _token_shift(x, ts_prev)
    col = lambda mu, w: _mix_col(params, x, xp, mu, w, mesh,  # noqa: E731
                                 stationary)
    hk = torch.square(torch.relu(col("mu_k", "w_k")))
    r = torch.sigmoid(col("mu_r", "w_r"))
    if mesh is None:
        return r * (hk @ params["w_v"]), x[:, -1]
    if stationary:     # whole on every rank, then the rank's channels
        kv = block(row_product(hk, params["w_v"], mesh, True), mesh, "model",
                   -1)
    else:
        kv = reduce_scatter(
            hk @ gather_param(params["w_v"], mesh, ROW, keep=("model", None)),
            mesh, "model", -1)
    return all_gather(r * kv, mesh, "model", -1), x[:, -1]


def apply_rwkv_block(tmix: dict, cmix: dict, ln1, ln2, x, state: dict,
                     head_size: int, norm_fn, mesh=None,
                     stationary: bool = False, rows=None):
    """Full RWKV layer (pre-norm residual twice).  Returns (out,
    new_state, state_stack|None); ``state_stack`` (S <= 16 only) holds
    the per-step S and token-shift inputs, index 0 the state before the
    first step; ``rows``: ``S`` and its stack the rank's rows."""
    s = x.shape[1]
    a_in = norm_fn(ln1, x)
    a_out, S_stack, ts_a = apply_rwkv_tmix(tmix, a_in, state["S"],
                                           state["ts_a"], head_size, mesh,
                                           stationary, rows)
    x = x + a_out
    c_in = norm_fn(ln2, x)
    c_out, ts_c = apply_rwkv_cmix(cmix, c_in, state["ts_c"], mesh,
                                  stationary)
    x = x + c_out
    new_state = {"S": S_stack[:, -1], "ts_a": ts_a, "ts_c": ts_c}
    stack = None
    if s <= 16:
        stack = {"S": S_stack,
                 "ts_a": torch.cat([state["ts_a"][:, None].to(a_in.dtype),
                                    a_in], dim=1),
                 "ts_c": torch.cat([state["ts_c"][:, None].to(c_in.dtype),
                                    c_in], dim=1)}
    return x, new_state, stack


def select_rwkv_state(stack: dict, index) -> dict:
    """Per-sequence state at step ``index`` (B,) of the stack."""
    bi = torch.arange(index.shape[0], device=index.device)
    return {key: stack[key][bi, index] for key in ("S", "ts_a", "ts_c")}
