"""RWKV-6 "Finch" (arXiv:2404.05892): token shift, the data-dependent
decay through a low-rank (tanh) path, the WKV recurrence with bonus u,
a per-head RMS group norm, the SiLU gate; the channel mix with squared
ReLU and a sigmoid receptance.  One sequence at a time from a zero
state; the recurrence runs in chunks (exactly the sequential sums, in
another order)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import head_logits, linear, rms_norm

CHUNK = 32


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, zero before the first token."""
    return torch.cat([torch.zeros_like(x[:1]), x[:-1]])


def _mix(x, xp, mu):
    return x + (xp - x) * mu.float()


def wkv(r, k, v, logw, u):
    """r/k/v/logw (H, L, d) f32 (logw = log of the decay, < 0), u (H, d):
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(w_t) S_{t-1} +
    k_t v_t^T from S_0 = 0.  Returns y (H, L, d)."""
    h, length, d = r.shape
    state = r.new_zeros((h, d, d))
    ys = []
    for c0 in range(0, length, CHUNK):
        rc, kc, vc = (t[:, c0:c0 + CHUNK] for t in (r, k, v))
        a = torch.cumsum(logw[:, c0:c0 + CHUNK], dim=1)     # (H, T, d)
        a_prev = a - logw[:, c0:c0 + CHUNK]                 # through t-1
        t = rc.shape[1]
        # intra-chunk: s < t, weight exp(A_{t-1} - A_s) per channel
        tri = torch.tril(torch.ones(t, t, dtype=torch.bool,
                                    device=r.device), -1)[None, :, :, None]
        dec = torch.exp((a_prev[:, :, None, :] - a[:, None, :, :])
                        .masked_fill(~tri, float("-inf")))
        scores = torch.einsum("htd,hsd,htsd->hts", rc, kc, dec)
        y = torch.einsum("hts,hsd->htd", scores, vc)
        y += (rc * u[:, None, :] * kc).sum(-1, keepdim=True) * vc
        y += torch.einsum("htd,hde->hte", rc * torch.exp(a_prev), state)
        ys.append(y)
        last = a[:, -1:, :]                                 # A_T
        state = (torch.exp(last[:, 0, :, None]) * state
                 + torch.einsum("hsd,hse->hde", kc * torch.exp(last - a), vc))
    return torch.cat(ys, dim=1)


def _tmix(p: dict, x: torch.Tensor, hs: int, quant):
    length, d = x.shape
    h = d // hs
    xp = _shift(x)
    r = linear(_mix(x, xp, p["mu_r"]), p["w_r"], quant)
    k = linear(_mix(x, xp, p["mu_k"]), p["w_k"], quant)
    v = linear(_mix(x, xp, p["mu_v"]), p["w_v"], quant)
    g = F.silu(linear(_mix(x, xp, p["mu_g"]), p["w_g"], quant))
    xw = _mix(x, xp, p["mu_w"])
    lora = torch.tanh(xw @ p["w_lora_a"].float()) @ p["w_lora_b"].float()
    logw = -torch.exp(p["w0"].float() + lora)               # log of the decay
    heads = lambda z: z.view(length, h, hs).transpose(0, 1)  # noqa: E731
    y = wkv(heads(r), heads(k), heads(v), heads(logw),
            p["u"].float().view(h, hs)).transpose(0, 1)     # (L, H, hs)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-6)
    y = y.reshape(length, d) * p["ln_x"].float()
    return linear(y * g, p["w_o"], quant)


def _cmix(p: dict, x: torch.Tensor, quant):
    xp = _shift(x)
    k = torch.relu(linear(_mix(x, xp, p["mu_k"]), p["w_k"], quant)).square()
    r = torch.sigmoid(linear(_mix(x, xp, p["mu_r"]), p["w_r"], quant))
    return r * linear(k, p["w_v"], quant)


def logits_at(params: dict, cfg: dict, seqs: list, positions: list,
              quant: str | None) -> list:
    hs = cfg["rwkv_head_size"]
    out = []
    for s, pos in zip(seqs, positions):
        x = params["embed"]["tok"][s].float()
        for p in params["layers"]:
            x = x + _tmix(p["tmix"], rms_norm(x, p["ln1"]["scale"]), hs,
                          quant)
            x = x + _cmix(p["cmix"], rms_norm(x, p["ln2"]["scale"]), quant)
        out.append(head_logits(params, x[pos], quant))
    return out
