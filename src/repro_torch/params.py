"""Model parameters: seeded initialization and conversion from JAX.

The port's parameters are plain dicts of tensors::

    {"embed": {"tok": (V, D), "head": (D, V)},
     "layers": [per-layer dict, one per layer],
     "final_norm": {"scale": (D,)}}

(a LayerNorm config adds ``"bias"`` beside each ``"scale"``; an
encoder-decoder config adds ``"encoder"`` and, in each attention layer,
the cross attention ``xattn`` and its norm ``ln_x``)

with each attention layer ``{"ln1": {"scale"}, "ln2": {"scale"},
"attn": {"wq", "wk", "wv", "wo"}, "ffn": {...}}``; a dense FFN holds
``w_gate``/``w_up`` (D, F) and ``w_down`` (F, D), an MoE FFN ``router``
(D, E) f32 and ``w_gate``/``w_up`` (E, D, F), ``w_down`` (E, F, D).  An
RG-LRU layer holds ``rec`` (:func:`_init_rglru`; its gate weights
``w_a``/``w_i`` are stored f32 whatever the model's dtype, cast once
here, since the gate products are f32 as in the JAX package) and a
dense ``ffn``; an RWKV-6 layer ``tmix`` and ``cmix``
(:mod:`repro_torch.models.rwkv`).  Matrices are ``(in, out)`` as in the
JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import RGLRU, RWKV, ModelConfig, resolve_device


def _trunc_normal(shape, std, generator, device, dtype):
    """Normal(0, std) truncated at +-3 std, drawn in f32 (the JAX
    package's ``dense_init`` / ``_expert_init``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, std=std, a=-3 * std, b=3 * std,
                                generator=generator)
    return t.to(dtype)


def _dense(d_in, d_out, generator, device, dtype):
    return _trunc_normal((d_in, d_out), d_in ** -0.5, generator, device,
                         dtype)


def _normal(shape, std, generator, device, dtype):
    return (torch.randn(shape, generator=generator, device=device)
            * std).to(dtype)


def _init_rglru(cfg: ModelConfig, generator, device) -> dict:
    """``repro/models/rglru.py::init_rglru``: ``a_param`` such that
    a = exp(-8 softplus(a_param)) is U(0.9, 0.999), conv N(0, 0.1), zero
    biases (the gate biases f32; the gate weights drawn in the model's
    dtype and stored f32, the type of their products, so that no call
    casts them)."""
    dt, d, w = cfg.torch_dtype, cfg.d_model, cfg.rnn_width
    u = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=device)
    return {"w_y": _dense(d, w, generator, device, dt),
            "w_x": _dense(d, w, generator, device, dt),
            "w_out": _dense(w, d, generator, device, dt),
            "conv_w": _normal((cfg.conv_width, w), 0.1, generator, device,
                              dt),
            "conv_b": torch.zeros((w,), dtype=dt, device=device),
            "w_a": _dense(w, w, generator, device, dt).float(),
            "b_a": torch.zeros((w,), device=device),
            "w_i": _dense(w, w, generator, device, dt).float(),
            "b_i": torch.zeros((w,), device=device),
            "a_param": torch.log(torch.expm1(-torch.log(u) / 8.0))}


def _init_rwkv(cfg: ModelConfig, generator, device) -> tuple:
    """``repro/models/rwkv.py::init_rwkv_tmix`` / ``init_rwkv_cmix``:
    token-shift mixes at 0.5, decay base linspace(-6, -2), an f32 LoRA
    (64 wide) for the data-dependent decay, bonus ``u`` N(0, 0.1)."""
    dt, d, f = cfg.torch_dtype, cfg.d_model, cfg.d_ff
    half = lambda: torch.full((d,), 0.5, dtype=dt, device=device)
    dense = lambda i, o: _dense(i, o, generator, device, dt)
    tmix = {"mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
            "mu_w": half(),
            "w_r": dense(d, d), "w_k": dense(d, d), "w_v": dense(d, d),
            "w_g": dense(d, d), "w_o": dense(d, d),
            "w0": torch.linspace(-6.0, -2.0, d, device=device),
            "w_lora_a": _dense(d, 64, generator, device, torch.float32),
            "w_lora_b": _normal((64, d), 0.01, generator, device,
                                torch.float32),
            "u": _normal((d,), 0.1, generator, device, torch.float32),
            "ln_x": torch.ones((d,), device=device)}
    cmix = {"mu_k": half(), "mu_r": half(), "w_k": dense(d, f),
            "w_v": dense(f, d), "w_r": dense(d, d)}
    return tmix, cmix


def _norm(cfg: ModelConfig, device) -> dict:
    """Unit scale, and a zero bias for LayerNorm (``init_norm``)."""
    p = {"scale": torch.ones((cfg.d_model,), dtype=cfg.torch_dtype,
                             device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=cfg.torch_dtype,
                                device=device)
    return p


def _attention(cfg: ModelConfig, generator, device) -> dict:
    dt, d, hd = cfg.torch_dtype, cfg.d_model, cfg.head_dim
    return {"wq": _dense(d, cfg.n_heads * hd, generator, device, dt),
            "wk": _dense(d, cfg.n_kv_heads * hd, generator, device, dt),
            "wv": _dense(d, cfg.n_kv_heads * hd, generator, device, dt),
            "wo": _dense(cfg.n_heads * hd, d, generator, device, dt)}


def _mlp(cfg: ModelConfig, generator, device) -> dict:
    dt, d, f = cfg.torch_dtype, cfg.d_model, cfg.d_ff
    p = {"w_up": _dense(d, f, generator, device, dt),
         "w_down": _dense(f, d, generator, device, dt)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = _dense(d, f, generator, device, dt)
    return p


def _init_layer(cfg: ModelConfig, kind: str, use_moe: bool, generator,
                device) -> dict:
    dt, d, f = cfg.torch_dtype, cfg.d_model, cfg.d_ff
    p = {"ln1": _norm(cfg, device), "ln2": _norm(cfg, device)}
    if kind == RWKV:
        p["tmix"], p["cmix"] = _init_rwkv(cfg, generator, device)
        return p
    if kind == RGLRU:
        p["rec"] = _init_rglru(cfg, generator, device)
    else:
        p["attn"] = _attention(cfg, generator, device)
        if cfg.encoder_decoder:
            p["xattn"] = _attention(cfg, generator, device)
            p["ln_x"] = _norm(cfg, device)
    if use_moe:
        gated = cfg.activation in ("swiglu", "geglu")
        e = cfg.n_experts
        ffn = {"router": _dense(d, e, generator, device, torch.float32),
               "w_up": _trunc_normal((e, d, f), d ** -0.5, generator, device,
                                     dt),
               "w_down": _trunc_normal((e, f, d), f ** -0.5, generator,
                                       device, dt)}
        if gated:
            ffn["w_gate"] = _trunc_normal((e, d, f), d ** -0.5, generator,
                                          device, dt)
    else:
        ffn = _mlp(cfg, generator, device)
    p["ffn"] = ffn
    return p


def init_layer(cfg: ModelConfig, layer: int, generator: torch.Generator,
               device) -> dict:
    """Layer ``layer``'s parameters, drawn as :func:`init_params` draws
    them (it draws every layer in order, then the embedding)."""
    return _init_layer(cfg, cfg.layer_kind(layer), cfg.layer_is_moe(layer),
                       generator, device)


def init_resident(cfg: ModelConfig, generator: torch.Generator,
                  device) -> dict:
    """The parameters outside the decoder's layer stack, ``embed``,
    ``final_norm`` and an encoder-decoder config's ``encoder``
    (``{"layers": [per layer {ln1, attn, ln2, mlp}], "final_norm"}``),
    drawn as :func:`init_params` draws them after the layers."""
    dt = cfg.torch_dtype
    embed = {"tok": (torch.randn((cfg.vocab_size, cfg.d_model),
                                 generator=generator, device=device)
                     * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        embed["head"] = _dense(cfg.d_model, cfg.vocab_size, generator,
                               device, dt)
    out = {"embed": embed, "final_norm": _norm(cfg, device)}
    if cfg.encoder_decoder:
        out["encoder"] = {
            "layers": [{"ln1": _norm(cfg, device),
                        "attn": _attention(cfg, generator, device),
                        "ln2": _norm(cfg, device),
                        "mlp": _mlp(cfg, generator, device)}
                       for _ in range(cfg.n_encoder_layers)],
            "final_norm": _norm(cfg, device)}
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters with the JAX package's distributions: truncated
    normal with std ``d_in**-0.5`` for every matrix (experts included),
    N(0, 0.02) embeddings, an f32 router, unit norm scales, and the
    recurrent layers' own (:func:`_init_rglru`, :func:`_init_rwkv`).  Every draw
    comes from ``generator``, which must live on ``device``: the layers
    in order (:func:`init_layer`), then the embedding
    (:func:`init_resident`).  (The draws differ from ``jax.random``'s;
    hold the two packages against each other with :func:`from_jax`.)"""
    device = resolve_device(device)
    layers = [init_layer(cfg, l, generator, device)
              for l in range(cfg.n_layers)]
    resident = init_resident(cfg, generator, device)
    return {"embed": resident.pop("embed"), "layers": layers, **resident}


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
                .to(device))
    return torch.from_numpy(a).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def from_jax(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """Convert the JAX package's parameter pytree, after
    ``jax.tree.map(np.asarray, params)``, into the port's structure.

    The JAX ``layers`` entry is a tuple with one dict per
    ``layer_pattern`` position whose leaves are stacked over layer groups
    on a leading axis; layer ``l`` is group ``l // P``, position
    ``l % P`` for a pattern of length P.  An encoder-decoder config's
    ``encoder["layers"]`` leaves are stacked over the encoder layers on
    a leading axis (``jax.vmap``); they become a list, one dict a layer.
    """
    device = resolve_device(device)
    pat = len(cfg.layer_pattern)
    layers = [_map(lambda a, g=l // pat: _to_torch(np.asarray(a)[g], device),
                   tree["layers"][l % pat])
              for l in range(cfg.n_layers)]
    for layer in layers:            # the gate weights f32, as _init_rglru
        if "rec" in layer:
            rec = layer["rec"]
            rec["w_a"], rec["w_i"] = rec["w_a"].float(), rec["w_i"].float()
    out = {"embed": _map(lambda a: _to_torch(a, device), tree["embed"]),
           "layers": layers,
           "final_norm": _map(lambda a: _to_torch(a, device),
                              tree["final_norm"])}
    if cfg.encoder_decoder:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_map(lambda a, i=i: _to_torch(np.asarray(a)[i],
                                                     device), enc["layers"])
                       for i in range(cfg.n_encoder_layers)],
            "final_norm": _map(lambda a: _to_torch(a, device),
                               enc["final_norm"])}
    return out
