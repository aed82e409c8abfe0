"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.  Block structure::

    x ──ln──┬── w_y ── gelu ─────────────────┐
            └── w_x ── causal conv1d ── RG-LRU ──*──  w_out ── (+residual)

The two gate products ``x @ w_a`` and ``x @ w_i`` are f32 products on
weights that :mod:`repro_torch.params` stores f32 (``.float()`` is then
the tensor itself); the gates (``r``, ``i``, ``log a``, ``a``, the
gated input) and the time recurrence ``h_t = a_t * h_{t-1} + g_t`` are
one ``rglru_gated_scan`` kernel on CUDA tensors (its plain version on
the CPU); where a gradient is needed, through :class:`RGLRUScanFn`,
whose backward is the ``rglru_gated_scan_bwd`` kernel.

State: ``{"h": (B, W) f32, "conv": (B, conv_width-1, W)}``.  A
multi-token decode (S <= 16) also returns the per-step state stack that
``commit`` selects from, index 0 being the state before the first step.

Over a mesh the block runs channel-parallel (``repro/models/rglru.py:
95-129``): ``w_y``, ``w_x``, ``w_a`` and ``w_i`` are column products
giving the rank's W/m channels, the conv, ``a_param``, the gates and the
scan are per channel (the kernel runs at width W/m), and ``w_out`` is a
row product.  The gate products read the conv output of every channel,
gathered over ``"model"`` (an activation).  Decode moves no weight
(:mod:`repro_torch.models.layers`' stationary products); the state and
its rollback stack hold the rank's channels (:func:`rglru_state_specs`).
With ``rows`` (a decode step on a cache in the production layout) the
state ``h`` holds the rank's rows of the batch over that axis: the gates
are computed for every row (the stationary products need the whole
token block), the scan runs on the rank's rows from their ``h``, and its
output rows are gathered for ``w_out``; ``conv`` comes whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import rglru_scan as _rg
from repro_torch.launch.mesh import all_gather
from repro_torch.models.attention import needs_grad, row_block
from repro_torch.models.layers import col_product, model_input, row_product


def rglru_specs() -> dict:
    """At rest over a mesh (``repro/models/rglru.py:52``)."""
    return {"w_y": ("data", "model"), "w_x": ("data", "model"),
            "w_out": ("model", "data"),
            "conv_w": (None, "model"), "conv_b": ("model",),
            "w_a": ("data", "model"), "b_a": ("model",),
            "w_i": ("data", "model"), "b_i": ("model",),
            "a_param": ("model",)}


def rglru_state_specs(batch_spec) -> dict:
    return {"h": (batch_spec, "model"), "conv": (batch_spec, None, "model")}


def init_rglru_state(batch: int, width: int, conv_width: int, dtype,
                     device) -> dict:
    return {"h": torch.zeros((batch, width), device=device),
            "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                                device=device)}


def _conv1d_causal(x, conv_state, w, b):
    """Depthwise causal conv over time; x (B,S,W), state (B,cw-1,W).
    Returns (y (B,S,W), new_state)."""
    cw = w.shape[0]
    full = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(cw):
        y = y + full[:, i:i + s] * w[cw - 1 - i]
    new_state = full[:, -(cw - 1):] if cw > 1 else conv_state
    return y + b, new_state


class RGLRUScanFn(torch.autograd.Function):
    """The gated RG-LRU with a hand-written backward: the forward runs
    ``rglru_gated_scan`` and saves its inputs and its output h_all (the
    states the backward reads as h_{t-1}); the backward runs
    ``rglru_gated_scan_bwd``.  Both are kernels on CUDA tensors and
    plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, xa, xi, x, b_a, b_i, a_param, h0):
        h_all = _rg.rglru_gated_scan(xa, xi, x, b_a, b_i, a_param, h0)
        ctx.save_for_backward(xa, xi, x, b_a, b_i, a_param, h0, h_all)
        return h_all

    @staticmethod
    def backward(ctx, dh):
        return _rg.rglru_gated_scan_bwd(*ctx.saved_tensors, dh.contiguous())


def _rglru_scan(params: dict, x, h0, mesh=None, stationary=False,
                rows=None):
    """The RG-LRU over x (B,S,W) from h0 (B,W) f32: the gate products in
    f32, then the gates and the recurrence in one kernel (through
    :class:`RGLRUScanFn` when a gradient is needed).  Returns h_all
    (B,S,W) f32 (the output is the state).  Over a ``mesh`` x and h0
    hold the rank's channels, and the gate products read x's channels
    gathered over ``"model"``; with ``rows`` h0 and the result hold the
    rank's rows of the batch over that axis."""
    xf = x.float()
    if mesh is not None:
        xf = model_input(all_gather(xf, mesh, "model", -1), mesh, stationary)
    gate = lambda w: col_product(xf, w.float(), mesh, stationary)  # noqa: E731
    xa, xi = gate(params["w_a"]), gate(params["w_i"])
    if rows is not None:
        rs = row_block(mesh, rows, x.shape[0])
        xa, xi, x = xa[rs], xi[rs], x[rs]
    args = (xa, xi, x, params["b_a"], params["b_i"], params["a_param"], h0)
    if needs_grad(*args):
        return RGLRUScanFn.apply(*args)
    return _rg.rglru_gated_scan(*args)


def apply_rglru_block(params: dict, x, state: dict, mesh=None,
                      stationary: bool = False, rows=None):
    """Full recurrent block over x (B,S,D).  Returns (out (B,S,D),
    new_state, state_stack); ``state_stack`` (S <= 16 only, else None)
    is ``{"h": (B,S+1,W), "conv": (B,S+1,cw-1,W)}``.  Over a ``mesh``
    the parameters and the state are the rank's blocks (W its W/m
    channels) and ``stationary`` picks the decode products (see the
    module's docstring; ``rows``: ``h`` and its stack the rank's rows)."""
    xin = model_input(x, mesh, stationary)
    y_branch = F.gelu(col_product(xin, params["w_y"], mesh, stationary),
                      approximate="tanh")
    xb = col_product(xin, params["w_x"], mesh, stationary)
    cw = params["conv_w"].shape[0]
    conv_out, conv_final = _conv1d_causal(xb, state["conv"], params["conv_w"],
                                          params["conv_b"])
    h_all = _rglru_scan(params, conv_out, state["h"], mesh, stationary, rows)
    h_rows = h_all if rows is None else all_gather(h_all, mesh, rows, 0)
    out = row_product(h_rows.to(x.dtype) * y_branch, params["w_out"], mesh,
                      stationary)
    new_state = {"h": h_all[:, -1], "conv": conv_final}

    s = x.shape[1]
    stack = None
    if s <= 16:
        full = torch.cat([state["conv"].to(xb.dtype), xb], dim=1)
        conv_stack = torch.stack([full[:, i + 1:i + cw] for i in range(s)],
                                 dim=1)                       # (B,S,cw-1,W)
        stack = {"h": torch.cat([state["h"][:, None], h_all], dim=1),
                 "conv": torch.cat([state["conv"][:, None].to(xb.dtype),
                                    conv_stack], dim=1)}
    return out, new_state, stack


def select_rglru_state(stack: dict, index) -> dict:
    """Per-sequence state at step ``index`` (B,) of the stack."""
    bi = torch.arange(index.shape[0], device=index.device)
    return {"h": stack["h"][bi, index], "conv": stack["conv"][bi, index]}
