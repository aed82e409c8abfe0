"""Mixture-of-Experts FFN with capacity-based token dispatch.

Counterpart of ``repro/models/moe.py``: softmax router,
top-k experts per token, per-expert capacity
``C = int(tokens * top_k * cf / E) + 1`` (or every token when
``cf * top_k >= E`` / ``cf = inf``), overflow dropped in token-major
order, gates renormalized over the top k.  The expert FFN is the
``moe_ffn`` kernel on CUDA tensors and its plain version on CPU tensors;
where a gradient is needed it goes through :class:`MoEFFNFn`, whose
backward is the ``moe_ffn_bwd`` kernel (the JAX package differentiates
its three ``einsum`` products, ``repro/models/moe.py:160-167``).

Distribution modes (:func:`select_moe_mode`, and for decode steps
:func:`stationary_moe_mode`), each over a :mod:`repro_torch.launch.mesh`
mesh with the axes ``("data", "model")`` and the JAX package's rules:

* ``local``: no mesh, or a ``model`` axis of size 1.
* ``ep``: expert parallel.  The experts are split over ``model``, the
  tokens over (data = batch, model = sequence); each rank dispatches its
  own tokens into an (E, C, D) buffer, and an all-to-all over ``model``
  brings every rank the rows of its resident experts, (E/m, C*m, D),
  for the expert FFN.  Needs ``E % m == 0`` and ``S % m == 0``.
* ``ep_psum``: weight-stationary decode (``S % m != 0``).  The token
  block is whole on every rank with its feature dim split over
  ``data``, as the experts' D rows are at rest; the partial up / gate
  products are summed over ``data`` before the activation, and the
  down projections of the ranks' experts over ``model``.
* ``tp``: tensor parallel (``E % m != 0``).  Every rank holds all the
  experts with F split over ``model``; the expert FFN's output is a
  partial sum that an all-reduce over ``model`` completes.
* ``tp_psum``: ``tp``'s storage in a decode step, weight-stationary as
  ``ep_psum`` is (the JAX package's decode gathers the ``data`` rows
  there; the port moves no expert weight in a decode step).

The parameters live on each rank as ``moe_storage_specs`` lays them out
(:func:`repro_torch.launch.mesh.shard_params`); each mode gathers the
view its body needs (``_view_specs``) with explicit collectives on
``mesh.get_group(axis)``, where the JAX package lets ``shard_map``
reshard.  ``x`` comes in the layout ``x_spec`` names (whole, or the
rank's rows of the batch in a prefill or training step) and the output
leaves in it.  Under a gradient the collectives are
:mod:`repro_torch.launch.mesh`'s autograd ones: ``ep``'s exchange runs
back in reverse, ``tp``'s all-reduce has an identity backward and its
input a summing one, and ``ep``'s router sums its gradient over
``model``, whose ranks route different tokens.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import moe_ffn as _mf
from repro_torch.kernels.ref import ffn_act
from repro_torch.launch.mesh import (all_reduce, all_reduce_grad, all_to_all,
                                     axis_index, axis_size, block,
                                     gather_param, mesh_devices, reshard)
from repro_torch.models.attention import needs_grad


def _route(router_w, x_flat, n_experts: int, top_k: int):
    """Top-k routing. Returns (expert_idx (N,k), gate (N,k) f32)."""
    return _top_k(x_flat.float() @ router_w, top_k)


def _top_k(logits, top_k: int):
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


# ---------------------------------------------------------------------------
# layouts over a mesh: a spec names the mesh axis each dim is split over


def moe_storage_specs(activation: str, n_experts: int,
                      model_size: int) -> dict:
    """At-rest sharding of the MoE parameters (what a rank holds)."""
    if model_size > 0 and n_experts % model_size == 0:
        w, wd = ("model", "data", None), ("model", None, "data")
    else:
        w, wd = (None, "data", "model"), (None, "model", "data")
    p = {"router": (None, None), "w_up": w, "w_down": wd}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = w
    return p


def _view_specs(activation: str, mode: str) -> dict:
    """The layout a mode's body computes on."""
    if mode == "ep_psum":            # the storage itself: nothing moves
        w, wd = ("model", "data", None), ("model", None, "data")
        router = ("data", None)
    elif mode == "tp_psum":          # tp's storage itself
        w, wd = (None, "data", "model"), (None, "model", "data")
        router = ("data", None)
    elif mode == "ep":
        w, wd = ("model", None, None), ("model", None, None)
        router = (None, None)
    else:
        w, wd = (None, None, "model"), (None, "model", None)
        router = (None, None)
    p = {"router": router, "w_up": w, "w_down": wd}
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = w
    return p


def _x_spec(mode: str) -> tuple:
    """Which block of x (B, S, D) a rank computes: ep splits the batch
    over ``data`` and the sequence over ``model``, the stationary modes
    the features over ``data``, tp the batch over ``data``."""
    return {"ep": ("data", "model", None), "ep_psum": (None, None, "data"),
            "tp_psum": (None, None, "data"), "tp": ("data", None, None)}[mode]


def _param_view(t, mesh, src: tuple, dst: tuple):
    """A parameter from its storage ``src`` to a body's view ``dst``:
    the axes ``dst`` drops gathered (:func:`gather_param`), those it
    adds taken as the rank's block (the router's D rows in the
    stationary modes)."""
    t = gather_param(t, mesh, src, keep=dst)
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a is None and b is not None:
            t = block(t, mesh, b, dim)
    return t


# ---------------------------------------------------------------------------
# mode bodies: x_flat is the rank's block of tokens, params its view


def _moe_ep_body(params, x_flat, mesh, *, n_experts, top_k,
                 capacity_factor, activation):
    """Tokens local, experts split over ``model``.  The capacity comes
    from the rank's own token count."""
    n, d = x_flat.shape
    m = axis_size(mesh, "model")
    e_loc = n_experts // m
    cap = _capacity(n, top_k, n_experts, capacity_factor)
    router = all_reduce_grad(params["router"], mesh, "model")
    idx, gate = _route(router, x_flat, n_experts, top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)      # (E, C, D)
    # the JAX package's tiled all_to_all (split E, concatenate C): rank
    # j's expert block goes to rank j, and rank i's rows land in C-block
    # i; all_to_all_single splits and concatenates dim 0, so permute
    recv = all_to_all(buf, mesh, "model")                   # (m, E/m, C, D)
    buf = recv.view(m, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, m * cap, d)
    y = _expert_ffn(params, buf, activation)                # (E/m, C*m, D)
    send = y.view(e_loc, m, cap, d).transpose(0, 1).contiguous()
    back = all_to_all(send, mesh, "model")
    return _combine(back.view(n_experts, cap, d), idx, slot, gate)


def _f32_bmm(a, w):
    """``a @ w`` per expert with an f32 result, as the JAX package's
    ``preferred_element_type``: f32 operands go to one ``bmm``; bf16 ones
    are cast one expert at a time, so no f32 copy of the rank's whole
    shard is ever made."""
    if a.dtype == w.dtype == torch.float32:
        return torch.bmm(a, w)
    return torch.stack([a[e].float() @ w[e].float()
                        for e in range(w.shape[0])])


def _moe_psum_body(params, x_flat, mesh, *, n_experts, top_k,
                   capacity_factor, activation):
    """Weight-stationary decode (``ep_psum``, ``tp_psum``): x_flat (N,
    D/d), the experts' D rows as at rest.  The partial up / gate
    products (f32) are summed over ``data`` before the activation,
    which makes the sum exact; each rank projects down to its D shard,
    and a sum over ``model`` joins the ranks' experts (``ep_psum``: E/m
    experts a rank) or F blocks (``tp_psum``: every expert, F/m)."""
    n = x_flat.shape[0]
    e_loc = params["w_up"].shape[0]
    cap = _capacity(n, top_k, n_experts, capacity_factor)
    idx, gate = _top_k(all_reduce(x_flat.float() @ params["router"],
                                  mesh, "data"), top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)      # (E, C, D/d)
    lo = axis_index(mesh, "model") * e_loc if e_loc < n_experts else 0
    buf_loc = buf[lo:lo + e_loc]

    def up(w):
        return all_reduce(_f32_bmm(buf_loc, w), mesh, "data")

    hu = up(params["w_up"])
    h = (ffn_act(up(params["w_gate"]), activation) * hu
         if "w_gate" in params else ffn_act(hu, activation))
    y = torch.bmm(h.to(x_flat.dtype), params["w_down"])     # (E_loc, C, D/d)
    if e_loc < n_experts:
        y_loc, y = y, torch.zeros((n_experts, cap, x_flat.shape[-1]),
                                  dtype=y.dtype, device=y.device)
        y[lo:lo + e_loc] = y_loc
    return _combine(all_reduce(y, mesh, "model"), idx, slot, gate)


def _moe_tp_body(params, x_flat, mesh, *, n_experts, top_k,
                 capacity_factor, activation):
    """All experts resident, F split over ``model``: the expert FFN's
    output on the F shard is a partial sum."""
    n = x_flat.shape[0]
    cap = _capacity(n, top_k, n_experts, capacity_factor)
    idx, gate = _route(params["router"], x_flat, n_experts, top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)
    buf = all_reduce_grad(buf, mesh, "model")
    y = all_reduce(_expert_ffn(params, buf, activation), mesh, "model")
    return _combine(y, idx, slot, gate)


_BODIES = {"ep": _moe_ep_body, "ep_psum": _moe_psum_body,
           "tp_psum": _moe_psum_body, "tp": _moe_tp_body}


# ---------------------------------------------------------------------------
# public entry


def select_moe_mode(n_experts: int, seq_len: int, mesh) -> str:
    if mesh is None or "model" not in tuple(mesh.mesh_dim_names or ()):
        return "local"
    msize = axis_size(mesh, "model")
    if msize == 1:
        return "local"
    if n_experts % msize == 0:
        # all-to-all EP when the sequence can spread over 'model';
        # expert-stationary psum EP for decode steps (S < msize)
        return "ep" if seq_len % msize == 0 else "ep_psum"
    return "tp"


def stationary_moe_mode(n_experts: int, mesh) -> str:
    """A decode step's mode: no expert weight moves, whatever S is."""
    if mesh is None or mesh_devices(mesh) == 1:
        return "local"
    return ("ep_psum" if n_experts % axis_size(mesh, "model") == 0
            else "tp_psum")


def apply_moe(params: dict, x, *, n_experts: int, top_k: int,
              activation: str, mesh=None, capacity_factor: float = 2.0,
              stationary: bool = False, x_spec: tuple = (None, None, None)):
    """MoE FFN over x (B, S, D).  With a ``mesh``, ``params`` is this
    rank's shard (``moe_storage_specs``) and ``x`` the rank's block
    under ``x_spec`` (default: whole, the same on every rank), as is
    the output; ``stationary`` (a decode step) picks the
    weight-stationary mode."""
    b, s, d = x.shape
    mode = (stationary_moe_mode(n_experts, mesh) if stationary
            else select_moe_mode(n_experts, s, mesh))
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, activation=activation)
    if mesh is not None:
        storage = moe_storage_specs(activation, n_experts,
                                    axis_size(mesh, "model"))
        view = (_view_specs(activation, mode) if mode != "local" else
                {k: (None,) * len(v) for k, v in storage.items()})
        params = {k: _param_view(v, mesh, storage[k], view[k])
                  for k, v in params.items()}
    if mode == "local":
        return _moe_local(params, x.reshape(-1, d), **kw).reshape(b, s, d)
    spec = _x_spec(mode)
    xx = reshard(x, mesh, x_spec, spec)
    out = _BODIES[mode](params, xx.reshape(-1, xx.shape[-1]), mesh, **kw)
    return reshard(out.reshape(xx.shape), mesh, spec, x_spec)
