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

Distribution modes (:func:`select_moe_mode`), each over a
:mod:`repro_torch.launch.mesh` mesh with the axes ``("data", "model")``
and the JAX package's rules:

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

The parameters live on each rank as :func:`shard_moe_params` lays them
out (``moe_storage_specs``); each mode gathers the view its body needs
(``_view_specs``) with explicit collectives on ``mesh.get_group(axis)``,
where the JAX package lets ``shard_map`` reshard.  Every rank holds the
whole ``x`` and gets the whole output.  Forward only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import moe_ffn as _mf
from repro_torch.kernels.ref import ffn_act
from repro_torch.launch.mesh import axis_index, axis_size
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
    over ``data`` and the sequence over ``model``, ep_psum the features
    over ``data``, tp the batch over ``data``."""
    return {"ep": ("data", "model", None), "ep_psum": (None, None, "data"),
            "tp": ("data", None, None)}[mode]


def _all_gather(t, mesh, axis: str, dim: int):
    size = axis_size(mesh, axis)
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def _all_reduce(t, mesh, axis: str):
    if axis_size(mesh, axis) > 1:
        t = t.contiguous()
        dist.all_reduce(t, group=mesh.get_group(axis))
    return t


def _block(t, mesh, axis: str, dim: int):
    """This rank's block of ``t`` along ``dim``, split over ``axis``."""
    size = axis_size(mesh, axis)
    if size == 1:
        return t
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over the {size} ranks of axis {axis!r}")
    n = t.shape[dim] // size
    return t.narrow(dim, axis_index(mesh, axis) * n, n)


def _reshard(t, mesh, src: tuple, dst: tuple):
    """From layout ``src`` to ``dst``: gather each dim split in ``src``
    but not in ``dst``, take this rank's block of each dim split in
    ``dst`` but not in ``src``."""
    for dim, (a, b) in enumerate(zip(src, dst)):
        if a == b:
            continue
        if a is not None:
            t = _all_gather(t, mesh, a, dim)
        if b is not None:
            t = _block(t, mesh, b, dim)
    return t


def shard_moe_params(params: dict, mesh) -> dict:
    """This rank's at-rest shard of whole MoE parameters
    (``moe_storage_specs``): with ``E % model == 0`` the experts split
    over ``model`` and their D rows over ``data``, else F over ``model``
    and D over ``data``; the router whole.  Each shard is a copy, so the
    whole tensors can be freed."""
    gated = "swiglu" if "w_gate" in params else "gelu"   # keys w_gate
    specs = moe_storage_specs(gated, params["w_up"].shape[0],
                              axis_size(mesh, "model"))
    return {k: _reshard(v, mesh, (None,) * v.ndim, specs[k]).clone()
            for k, v in params.items()}


def shard_moe_layers(params: dict, cfg, mesh) -> dict:
    """The model's parameters with each MoE layer's FFN replaced by this
    rank's :func:`shard_moe_params` shard (the rest shared, whole)."""
    layers = [dict(p, ffn=shard_moe_params(p["ffn"], mesh))
              if cfg.layer_is_moe(l) else p
              for l, p in enumerate(params["layers"])]
    return dict(params, layers=layers)


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
    idx, gate = _route(params["router"], x_flat, n_experts, top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)      # (E, C, D)
    # the JAX package's tiled all_to_all (split E, concatenate C): rank
    # j's expert block goes to rank j, and rank i's rows land in C-block
    # i; all_to_all_single splits and concatenates dim 0, so permute
    group = mesh.get_group("model")
    recv = torch.empty_like(buf)
    dist.all_to_all_single(recv, buf, group=group)          # (m, E/m, C, D)
    buf = recv.view(m, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, m * cap, d)
    y = _expert_ffn(params, buf, activation)                # (E/m, C*m, D)
    send = y.view(e_loc, m, cap, d).transpose(0, 1).contiguous()
    back = torch.empty_like(send)
    dist.all_to_all_single(back, send, group=group)
    return _combine(back.view(n_experts, cap, d), idx, slot, gate)


def _moe_ep_psum_body(params, x_flat, mesh, *, n_experts, top_k,
                      capacity_factor, activation):
    """Weight-stationary decode: x_flat (N, D/d), the experts' D rows
    as at rest.  The partial up / gate products (f32, as the JAX
    package's ``preferred_element_type``) are summed over ``data``
    before the activation, which makes the sum exact; each rank projects
    its experts down to its D shard, and a sum over ``model`` joins the
    experts."""
    n = x_flat.shape[0]
    e_loc = n_experts // axis_size(mesh, "model")
    cap = _capacity(n, top_k, n_experts, capacity_factor)
    idx, gate = _top_k(_all_reduce(x_flat.float() @ params["router"],
                                   mesh, "data"), top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)      # (E, C, D/d)
    lo = axis_index(mesh, "model") * e_loc
    buf_loc = buf[lo:lo + e_loc].float()

    def up(w):
        return _all_reduce(torch.bmm(buf_loc, w.float()), mesh, "data")

    hu = up(params["w_up"])
    h = (ffn_act(up(params["w_gate"]), activation) * hu
         if "w_gate" in params else ffn_act(hu, activation))
    y_loc = torch.bmm(h.to(x_flat.dtype), params["w_down"])  # (E/m, C, D/d)
    y = torch.zeros((n_experts, cap, x_flat.shape[-1]), dtype=y_loc.dtype,
                    device=y_loc.device)
    y[lo:lo + e_loc] = y_loc
    return _combine(_all_reduce(y, mesh, "model"), idx, slot, gate)


def _moe_tp_body(params, x_flat, mesh, *, n_experts, top_k,
                 capacity_factor, activation):
    """All experts resident, F split over ``model``: the expert FFN's
    output on the F shard is a partial sum."""
    n = x_flat.shape[0]
    cap = _capacity(n, top_k, n_experts, capacity_factor)
    idx, gate = _route(params["router"], x_flat, n_experts, top_k)
    buf, slot = _dispatch(x_flat, idx, n_experts, cap)
    y = _all_reduce(_expert_ffn(params, buf, activation), mesh, "model")
    return _combine(y, idx, slot, gate)


_BODIES = {"ep": _moe_ep_body, "ep_psum": _moe_ep_psum_body,
           "tp": _moe_tp_body}


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


def apply_moe(params: dict, x, *, n_experts: int, top_k: int,
              activation: str, mesh=None, capacity_factor: float = 2.0):
    """MoE FFN over x (B, S, D).  With a ``mesh``, ``params`` is this
    rank's :func:`shard_moe_params` shard and ``x`` the whole input,
    the same on every rank; every rank returns the whole output."""
    b, s, d = x.shape
    mode = select_moe_mode(n_experts, s, mesh)
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, activation=activation)
    if mesh is not None:
        storage = moe_storage_specs(activation, n_experts,
                                    axis_size(mesh, "model"))
        view = (_view_specs(activation, mode) if mode != "local" else
                {k: (None,) * len(v) for k, v in storage.items()})
        params = {k: _reshard(v, mesh, storage[k], view[k])
                  for k, v in params.items()}
    if mode == "local":
        return _moe_local(params, x.reshape(-1, d), **kw).reshape(b, s, d)
    spec = _x_spec(mode)
    xx = _reshard(x, mesh, (None,) * 3, spec)
    out = _BODIES[mode](params, xx.reshape(-1, xx.shape[-1]), mesh, **kw)
    return _reshard(out.reshape(xx.shape), mesh, spec, (None,) * 3)
