"""Basic building blocks: norms, RoPE, MLPs, embeddings, sinusoids, and
their specs and products over a mesh.

Counterpart of ``repro/models/layers.py``.  Weight matrices are stored
``(in_features, out_features)`` so the forward is ``x @ w``; norms and
RoPE compute in f32 and return the input's dtype.

Over a mesh (:mod:`repro_torch.launch.mesh`) a weight ``(D, N)`` rests
split ``("data", "model")`` (column-parallel: q/k/v, gate, up) and one
``(N, D)`` split ``("model", "data")`` (row-parallel: wo, down).  The
products take one of two routes (the JAX package lets GSPMD pick the
same ones from its hints):

* ``stationary`` (decode, verify and draft steps): the token block is
  whole on every rank; each rank multiplies its block of the features
  by its weight block at rest and the partial sums are added over
  ``"data"`` (column) or over ``"model"`` (row, then the output's
  feature blocks gathered over ``"data"``).  No weight moves.
* otherwise (prefill, training): the rank's rows of the batch meet the
  weight with its ``"data"`` blocks gathered for the call (backward: a
  reduce-scatter); a column product gives the rank's ``"model"`` block
  of N, a row product a partial sum that an all-reduce over ``"model"``
  completes (Megatron's two operators).

The sequence-parallel profile (``repro/models/layers.py:22-110``):
:class:`sequence_sharding` selects the mesh axis the sequence of
prefill and training activations splits over, ``"model"`` by default
(the JAX package's default), or None.  Torch has no ambient mesh, so the
profile is read only by code that is handed a mesh, once a call (the
model's entry points pass the value down, so a recomputation in the
backward sees the same one), and decode steps never read it.  The JAX
package's two hints become explicit reshards: ``seq_hint`` is
:func:`seq_split` (the rank's block of the sequence, dim 1) and
``gather_seq`` is :func:`seq_gather` (an all-gather along dim 1).
"""
from __future__ import annotations

import contextvars

import torch

from repro_torch.kernels.ref import ffn_act
from repro_torch.launch.mesh import (all_gather, all_reduce, all_reduce_grad,
                                     axis_index, axis_size, block,
                                     gather_param, split)

_SEQ_AXIS = contextvars.ContextVar("seq_axis", default="model")


class sequence_sharding:
    """Context manager selecting the sequence-parallel axis (``"model"``)
    or None (no sequence parallelism)."""

    def __init__(self, axis):
        if axis not in (None, "model"):
            raise ValueError(f"the sequence splits over 'model' or nothing, "
                             f"not {axis!r}")
        self.axis = axis

    def __enter__(self):
        self._tok = _SEQ_AXIS.set(self.axis)
        return self

    def __exit__(self, *exc):
        _SEQ_AXIS.reset(self._tok)
        return False


def seq_axis():
    """The profile's sequence axis (``"model"`` or None)."""
    return _SEQ_AXIS.get()


def active_seq_axis(mesh):
    """The profile's sequence axis where it splits anything on ``mesh``
    (None off a mesh, under ``sequence_sharding(None)``, or where the
    axis has one rank)."""
    ax = seq_axis()
    if mesh is None or ax is None or axis_size(mesh, ax) == 1:
        return None
    return ax


def seq_split(x, mesh, seq):
    """The rank's block of ``x``'s sequence (dim 1) over ``seq``; a
    sequence that does not split raises.  Backward: gather."""
    return x if seq is None else split(x, mesh, seq, 1)


def seq_gather(x, mesh, seq):
    """``x``'s sequence blocks over ``seq`` joined (dim 1); backward
    keeps the rank's block (the gathered tensor is read alike on every
    rank of ``seq``, whose gradients are then whole)."""
    return x if seq is None else all_gather(x, mesh, seq, 1)

COL = ("data", "model")           # a column-parallel weight at rest
ROW = ("model", "data")           # a row-parallel one


def norm_specs(kind: str) -> dict:
    p = {"scale": (None,)}
    if kind == "layernorm":
        p["bias"] = (None,)
    return p


def mlp_specs(activation: str) -> dict:
    if activation in ("swiglu", "geglu"):
        return {"w_gate": COL, "w_up": COL, "w_down": ROW}
    return {"w_up": COL, "w_down": ROW}


def embedding_specs(tie: bool, vocab: int = 0, d_model: int = 0,
                    model_size: int = 16, data_size: int = 16) -> dict:
    """Vocabulary over ``"model"`` and D over ``"data"``, each dropped
    where the size does not divide the axis (Whisper's 51865)."""
    def ax(size, name, n):
        return name if size == 0 or size % n == 0 else None

    v, d = ax(vocab, "model", model_size), ax(d_model, "data", data_size)
    p = {"tok": (v, d)}
    if not tie:
        p["head"] = (d, v)
    return p


# ---------------------------------------------------------------------------
# products over a mesh


def model_input(x, mesh, stationary: bool):
    """``x`` (..., D), whole on the rank, as its column products read
    it: its ``"data"`` block of features (stationary), else itself with
    a backward that sums the gradient over ``"model"``."""
    if mesh is None:
        return x
    if stationary:
        return block(x, mesh, "data", -1)
    return all_reduce_grad(x, mesh, "model")


def col_product(xin, w, mesh, stationary: bool):
    """``xin`` (from :func:`model_input`) times a column-parallel weight
    block: the rank's ``"model"`` block of the N outputs."""
    if mesh is None:
        return xin @ w
    if stationary:
        return all_reduce(xin @ w, mesh, "data")
    return xin @ gather_param(w, mesh, COL, keep=(None, "model"))


def row_product(h, w, mesh, stationary: bool):
    """The rank's ``"model"`` block of N, ``h`` (..., N/m), times a
    row-parallel weight block: the whole (..., D) on every rank."""
    if mesh is None:
        return h @ w
    if stationary:
        return all_gather(all_reduce(h @ w, mesh, "model"), mesh, "data", -1)
    return all_reduce(h @ gather_param(w, mesh, ROW, keep=("model", None)),
                      mesh, "model")


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    elif kind == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """sin/cos tables for integer ``positions`` (any shape), each of shape
    ``positions.shape + (head_dim // 2,)`` in f32.  The base is a host
    scalar, never a tensor copied to the card (a CUDA graph's capture
    cannot hold a copy from pageable memory)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(float(theta), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., S, n_heads, head_dim) by per-position tables of
    shape (..., S, head_dim // 2), broadcast over the heads axis."""
    half = x.shape[-1] // 2
    s, c = sin[..., None, :], cos[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params: dict, x: torch.Tensor, activation: str, mesh=None,
              stationary: bool = False) -> torch.Tensor:
    """The dense FFN; over a ``mesh`` the hidden dim is the rank's
    ``"model"`` block and ``params`` its blocks at rest."""
    xin = model_input(x, mesh, stationary)
    up = lambda w: col_product(xin, w, mesh, stationary)  # noqa: E731
    if "w_gate" in params:
        h = ffn_act(up(params["w_gate"]), activation) * up(params["w_up"])
    else:
        h = ffn_act(up(params["w_up"]), activation)
    return row_product(h, params["w_down"], mesh, stationary)


def embed_tokens(params: dict, tokens: torch.Tensor, mesh=None,
                 specs: dict | None = None,
                 stationary: bool = False) -> torch.Tensor:
    """Rows of ``tok`` (V, D).  Over a ``mesh``, ``tok`` is the rank's
    block under ``specs`` (:func:`embedding_specs`): each rank looks up
    the tokens of its vocabulary block (zeros elsewhere) and a sum over
    the vocabulary's axis joins them, exactly; stationary, on its block
    of D, which is then gathered, else with D gathered first."""
    tok = params["tok"]
    if mesh is None:
        return tok[tokens]
    v_ax, d_ax = specs["tok"]
    if not stationary:
        tok = gather_param(tok, mesh, specs["tok"], keep=(v_ax, None))
    if v_ax is None:
        x = tok[tokens]
    else:
        n = tok.shape[0]
        local = tokens - axis_index(mesh, v_ax) * n
        mine = (local >= 0) & (local < n)
        x = torch.where(mine[..., None], tok[local.clamp(0, n - 1)], 0)
        x = all_reduce(x, mesh, v_ax)
    if stationary and d_ax is not None:
        x = all_gather(x, mesh, d_ax, -1)
    return x


def unembed(params: dict, x: torch.Tensor, mesh=None,
            specs: dict | None = None,
            stationary: bool = False) -> torch.Tensor:
    """Logits (..., V) f32 of ``x`` (..., D): ``head``, else the tied
    ``tok`` transposed.  Over a ``mesh`` (``specs`` the embedding's
    :func:`embedding_specs`) the weight's vocabulary block gives the
    rank's block of the logits, gathered whole; its D block a partial
    sum over ``"data"`` (stationary) or gathered first."""
    w = params.get("head")
    if mesh is None:
        return (x @ (params["tok"].T if w is None else w)).float()
    if w is None:
        w, (d_ax, v_ax) = params["tok"].T, specs["tok"][::-1]
    else:
        d_ax, v_ax = specs["head"]
    if stationary:
        if d_ax is None:
            y = x @ w
        else:
            y = all_reduce(block(x, mesh, d_ax, -1) @ w, mesh, d_ax)
    else:
        w = gather_param(w, mesh, (d_ax, v_ax), keep=(None, v_ax))
        y = (x if v_ax is None else all_reduce_grad(x, mesh, v_ax)) @ w
    y = y.float()
    return y if v_ax is None else all_gather(y, mesh, v_ax, -1)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Classic sinusoid table (the Whisper encoder's positions), (n, d)
    f32: sin of the ``d // 2`` angles, then their cos."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
