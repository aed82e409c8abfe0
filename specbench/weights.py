"""Seeded random weights, made on the device in the serving layout.

The benchmark makes its own weights: the program receives them through
``ServingEngine.load`` and the reference reads the very same tensors.
Layout (the program's parameter tree, matrices stored ``(in, out)``)::

    {"embed": {"tok": (V, D), "head": (D, V)},
     "layers": [per layer dict], "final_norm": {"scale": (D,)}}

attention layers ``{"ln1", "ln2", "attn": {wq, wk, wv, wo}, "ffn"}``
with a dense ``ffn`` ``{w_gate, w_up (D, F), w_down (F, D)}`` or a
mixture of experts ``{router (D, E) f32, w_gate, w_up (E, D, F),
w_down (E, F, D)}``; RWKV-6 layers ``{"ln1", "ln2", "tmix", "cmix"}``.

Every random tensor is a view into one of two flat buffers (the model's
dtype, and float32) filled by a few large ``torch.randn`` calls from a
generator on the device; each view is then scaled in place.  Matrices
are N(0, 1/fan_in), embeddings N(0, 0.02^2); norms are ones; the RWKV
constants follow the published initialisation's shape (token-shift
mixes 0.5, decay base linspace(-6, -2), bonus N(0, 0.1^2)).
"""
from __future__ import annotations

import torch

ALIGN = 128            # elements: every view starts 256-byte aligned
CHUNK = 1 << 30        # elements per randn call


class _Plan:
    """Collects (shape, std) requests per buffer, then fills them."""

    def __init__(self):
        self.items = {"model": [], "f32": []}

    def add(self, kind: str, shape, std: float, holder: dict, key: str):
        self.items[kind].append((tuple(shape), std, holder, key))

    def fill(self, generator, device, dtype):
        for kind, items in self.items.items():
            if not items:
                continue
            dt = dtype if kind == "model" else torch.float32
            offs, n = [], 0
            for shape, _, _, _ in items:
                offs.append(n)
                size = 1
                for s in shape:
                    size *= s
                n += -(-size // ALIGN) * ALIGN
            buf = torch.empty(n, dtype=dt, device=device)
            for i in range(0, n, CHUNK):
                part = buf[i:i + CHUNK]
                torch.randn(part.shape, generator=generator, out=part)
            for off, (shape, std, holder, key) in zip(offs, items):
                size = 1
                for s in shape:
                    size *= s
                t = buf[off:off + size].view(shape)
                t.mul_(std)
                holder[key] = t


def _ones(n, dtype, device):
    return torch.ones((n,), dtype=dtype, device=device)


def _attention_layer(cfg: dict, plan: _Plan, moe: bool, dtype, device):
    d, hd = cfg["d_model"], cfg["head_dim"]
    hq, hkv, f = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, cfg["d_ff"]
    layer = {"ln1": {"scale": _ones(d, dtype, device)},
             "ln2": {"scale": _ones(d, dtype, device)},
             "attn": {}, "ffn": {}}
    for key, shape in (("wq", (d, hq)), ("wk", (d, hkv)), ("wv", (d, hkv)),
                       ("wo", (hq, d))):
        plan.add("model", shape, shape[0] ** -0.5, layer["attn"], key)
    ffn = layer["ffn"]
    if moe:
        e = cfg["n_experts"]
        plan.add("f32", (d, e), d ** -0.5, ffn, "router")
        plan.add("model", (e, d, f), d ** -0.5, ffn, "w_gate")
        plan.add("model", (e, d, f), d ** -0.5, ffn, "w_up")
        plan.add("model", (e, f, d), f ** -0.5, ffn, "w_down")
    else:
        plan.add("model", (d, f), d ** -0.5, ffn, "w_gate")
        plan.add("model", (d, f), d ** -0.5, ffn, "w_up")
        plan.add("model", (f, d), f ** -0.5, ffn, "w_down")
    return layer


def _rwkv_layer(cfg: dict, plan: _Plan, dtype, device):
    d, f = cfg["d_model"], cfg["d_ff"]
    half = lambda: torch.full((d,), 0.5, dtype=dtype, device=device)  # noqa
    tmix = {"mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_g": half(),
            "mu_w": half(),
            "w0": torch.linspace(-6.0, -2.0, d, device=device),
            "ln_x": torch.ones((d,), device=device)}
    for key in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        plan.add("model", (d, d), d ** -0.5, tmix, key)
    plan.add("f32", (d, 64), d ** -0.5, tmix, "w_lora_a")
    plan.add("f32", (64, d), 0.01, tmix, "w_lora_b")
    plan.add("f32", (d,), 0.1, tmix, "u")
    cmix = {"mu_k": half(), "mu_r": half()}
    plan.add("model", (d, f), d ** -0.5, cmix, "w_k")
    plan.add("model", (f, d), f ** -0.5, cmix, "w_v")
    plan.add("model", (d, d), d ** -0.5, cmix, "w_r")
    return {"ln1": {"scale": _ones(d, dtype, device)},
            "ln2": {"scale": _ones(d, dtype, device)},
            "tmix": tmix, "cmix": cmix}


def _plan_model(cfg: dict, plan: _Plan, dtype, device) -> dict:
    d, v = cfg["d_model"], cfg["vocab_size"]
    pat = cfg["layer_pattern"]
    moe_pat = cfg.get("moe_pattern") or [k in ("attn", "swa") for k in pat]
    layers = []
    for l in range(cfg["n_layers"]):
        kind = pat[l % len(pat)]
        if kind == "rwkv":
            layers.append(_rwkv_layer(cfg, plan, dtype, device))
        elif kind in ("attn", "swa"):
            moe = cfg.get("n_experts", 0) > 0 and moe_pat[l % len(pat)]
            layers.append(_attention_layer(cfg, plan, moe, dtype, device))
        else:
            raise ValueError(f"no weights for layer kind {kind!r}")
    embed = {}
    plan.add("model", (v, d), 0.02, embed, "tok")
    plan.add("model", (d, v), d ** -0.5, embed, "head")
    return {"embed": embed, "layers": layers,
            "final_norm": {"scale": _ones(d, dtype, device)}}


def make_weights(target: dict, draft: dict, seed: int, device) -> tuple:
    """(target params, draft params) for the two model configurations
    (the configuration file's ``target`` / ``draft`` dicts), drawn from
    ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = []
    for cfg in (target, draft):
        dtype = getattr(torch, cfg.get("dtype", "bfloat16"))
        plan = _Plan()
        params = _plan_model(cfg, plan, dtype, device)
        plan.fill(g, device, dtype)
        out.append(params)
    return tuple(out)
