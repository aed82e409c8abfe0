"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Each function computes what its CUDA kernel computes, in the JAX
package's layouts, materializing full score matrices (clarity over
speed).  A kernel wrapper takes these only for tensors on the CPU; the
tests hold them against the Pallas kernels, and ``chip_smoke.py`` holds
the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
RGLRU_C, RGLRU_EPS = 8.0, 1e-6       # repro/models/rglru.py's _C, _EPS


def _flash_scores(q, k, scale, causal, window, q_offset=0):
    """Masked f32 scores (B, Hkv, g, Sq, Skv) of the flash functions,
    masked entries at NEG_INF (as the JAX package adds its mask); query
    row i sits at position ``q_offset + i``, key j at j."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    qp = q_offset + torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(skv, device=q.device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def visible_pairs(sq: int, skv: int, causal: bool, window, q_offset=0) -> int:
    """How many (query, key) pairs the flash masks leave visible: the
    work of one (batch, head) that the flash kernels do."""
    i = q_offset + torch.arange(sq, dtype=torch.int64)
    hi = torch.clamp(i + 1, max=skv) if causal else torch.full_like(i, skv)
    lo = torch.clamp(i - window + 1, min=0) if window else torch.zeros_like(i)
    return int(torch.clamp(hi - lo, min=0).sum())


def flash_attention_ref(q, k, v, *, scale=None, causal=True, window=None,
                        return_lse=False, q_offset=0):
    """q (B,Hq,Sq,d), k/v (B,Hkv,Skv,d) -> (B,Hq,Sq,d); with
    ``return_lse`` also the rows' log-sum-exp (B,Hq,Sq) f32, ``m +
    log(max(l, 1e-30))`` as the JAX package's ``_flash_forward`` forms
    it.  Query row i sits at position ``q_offset + i``."""
    b, hq, sq, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    s = _flash_scores(q, k, scale, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = o.reshape(b, hq, sq, d).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    return out, lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, scale=None,
                            causal=True, window=None, q_offset=0):
    """The flash backward from the saved log-sum-exp, step for step the
    JAX package's ``_flash_bwd_rule`` (``repro/models/attention.py:231``):
    ``D = rowsum(dO * O)`` (O in its own dtype, cast to f32), ``P =
    exp(S - lse)``, ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)
    scale``, ``dQ = dS K``, ``dK = dS^T Q``, all in f32, dK and dV summed
    over the g query heads of each KV head.  q/out/dout (B,Hq,Sq,d), k/v
    (B,Hkv,Skv,d), lse (B,Hq,Sq) f32, masks as
    :func:`flash_attention_ref`'s.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    grp = lambda t: t.reshape(b, hkv, g, sq, d).float()
    qg, do, og = grp(q), grp(dout), grp(out)
    delta = (do * og).sum(-1)                                  # (b,h,g,q)
    s = _flash_scores(q, k, scale, causal, window, q_offset)
    p = torch.exp(s - lse.reshape(b, hkv, g, sq)[..., None].float())
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do, v.float())
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def anc_mask_from_bits(anc_bits, m: int):
    """(m,) int32 ancestor bitmasks -> (m, m) bool visibility, bit j of
    row i marking buffer row j (bits past 31 read bit 31, as the kernels'
    ``clip(col, 0, 31)`` does)."""
    j = torch.clamp(torch.arange(m, device=anc_bits.device), max=31)
    return ((anc_bits.long()[:, None] >> j[None, :]) & 1) > 0


def decode_attention_ref(q, k, v, lengths, *, scale=None, window=None,
                         anc_mask=None, kv_offset: int = 0,
                         return_lse: bool = False):
    """q (B,Hq,m,d); k/v (B,Hkv,S,d); lengths (B,).  Causal over the m new
    tokens at positions [len-m, len) — or, with ``anc_mask`` (m, m) bool,
    ancestor-or-self masking of the m-row speculation buffer.  Slot i of
    k/v holds position ``kv_offset + i`` (a slice of the sequence; the
    lengths and masks are global).  A row with no visible key gives 0
    (and, with ``return_lse``, a log-sum-exp of -inf).  With
    ``return_lse`` returns (out, lse (B,Hq,m) f32)."""
    b, hq, m, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    lengths = lengths.to(dev).long()
    qg = q.reshape(b, hkv, g, m, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    kpos = kv_offset + torch.arange(skv, device=dev)
    if anc_mask is not None:
        assert window is None, "tree masking requires full attention"
        col = kpos[None, :] - (lengths[:, None] - m)             # (B, S)
        allowed = anc_mask[:, col.clamp(0, m - 1)].permute(1, 0, 2)
        ok = ((col < 0)[:, None, :]
              | (((col >= 0) & (col < m))[:, None, :] & allowed))
    else:
        kp = kpos[None, None, :]
        qp = (lengths[:, None, None] - m
              + torch.arange(m, device=dev)[None, :, None])      # (B, m, 1)
        ok = (kp <= qp) & (kp < lengths[:, None, None])
        if window is not None:
            ok &= kp > qp - window
    s = torch.where(ok[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    seen = ok.any(-1)[:, None, None, :, None]                    # (B,1,1,m,1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    o = torch.where(seen, o, 0.0).reshape(b, hq, m, d).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(seen[..., 0], torch.logsumexp(s, -1), -math.inf)
    return o, lse.reshape(b, hq, m)


def gather_paged_kv_ref(k_pool, v_pool, block_tables, *, k_scale=None,
                        v_scale=None, dtype=torch.float32):
    """Materialize per-sequence contiguous KV from a block pool.

    k_pool/v_pool (NB, BS, H, d) [int8 when scales (NB, BS, H, 1) are
    given]; block_tables (B, MBS) -> k/v (B, MBS*BS, H, d) in ``dtype``.
    Table entries <= 0 resolve to block 0; rows past a sequence's length
    hold whatever the pool holds and must be masked by the caller.
    """
    nb, bs, h, d = k_pool.shape
    bt = block_tables.long().clamp_min(0)
    b, mbs = bt.shape
    idx = (bt[:, :, None] * bs
           + torch.arange(bs, device=bt.device)[None, None, :]).reshape(b, -1)
    k = k_pool.reshape(nb * bs, h, d)[idx]
    v = v_pool.reshape(nb * bs, h, d)[idx]
    if k_scale is not None:
        k = k.float() * k_scale.reshape(nb * bs, h, 1)[idx]
        v = v.float() * v_scale.reshape(nb * bs, h, 1)[idx]
    return k.to(dtype), v.to(dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               k_scale=None, v_scale=None, scale=None,
                               anc_bits=None):
    """Plain version of the paged kernel: gather, then contiguous decode."""
    k, v = gather_paged_kv_ref(k_pool, v_pool, block_tables,
                               k_scale=k_scale, v_scale=v_scale)
    anc = (None if anc_bits is None
           else anc_mask_from_bits(anc_bits, q.shape[2]))
    return decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                lengths, scale=scale,
                                anc_mask=anc).to(q.dtype)


def ffn_act(h, activation: str):
    """silu for swiglu; tanh-approximate gelu (``jax.nn.gelu``'s default)
    for gelu/geglu."""
    if activation == "swiglu":
        return F.silu(h)
    if activation in ("gelu", "geglu"):
        return F.gelu(h, approximate="tanh")
    raise ValueError(activation)


def _compute_dtype(t):
    """f64 stays f64 (the gradient checks); everything else computes in
    f32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def moe_ffn_ref(buf, w_gate, w_up, w_down, *, activation="swiglu"):
    """buf (E,C,D); w_gate/w_up (E,D,F); w_down (E,F,D) -> (E,C,D)."""
    ct = _compute_dtype(buf)
    buff = buf.to(ct)
    h = ffn_act(torch.bmm(buff, w_gate.to(ct)), activation)
    h = h * torch.bmm(buff, w_up.to(ct))
    return torch.bmm(h, w_down.to(ct)).to(buf.dtype)


def ffn_act_grad(h, activation: str):
    """(act(h), act'(h)) for :func:`ffn_act`, written out."""
    if activation == "swiglu":
        s = torch.sigmoid(h)
        return h * s, s * (1 + h * (1 - s))
    if activation in ("gelu", "geglu"):
        c, k = math.sqrt(2 / math.pi), 0.044715
        t = torch.tanh(c * (h + k * h ** 3))
        return (0.5 * h * (1 + t),
                0.5 * (1 + t) + 0.5 * h * (1 - t * t) * c * (1 + 3 * k * h * h))
    raise ValueError(activation)


def moe_ffn_bwd_ref(buf, w_gate, w_up, w_down, dy, *, activation="swiglu"):
    """The backward of :func:`moe_ffn_ref` from dy (E,C,D): (dbuf
    (E,C,D), dw_gate, dw_up (E,D,F), dw_down (E,F,D)) in buf's dtype,
    written out: dh = dy Wd^T, dg = dh u act'(g), du = dh act(g), dbuf =
    dg Wg^T + du Wu^T, dWg = buf^T dg, dWu = buf^T du, dWd = h^T dy."""
    ct = _compute_dtype(buf)
    x, wg, wu, wd, gy = (t.to(ct) for t in (buf, w_gate, w_up, w_down, dy))
    g, u = torch.bmm(x, wg), torch.bmm(x, wu)
    a, da = ffn_act_grad(g, activation)
    dh = torch.bmm(gy, wd.transpose(1, 2))
    dg, du = dh * u * da, dh * a
    xt = x.transpose(1, 2)
    out = (torch.bmm(dg, wg.transpose(1, 2))
           + torch.bmm(du, wu.transpose(1, 2)),
           torch.bmm(xt, dg), torch.bmm(xt, du),
           torch.bmm((a * u).transpose(1, 2), gy))
    return tuple(t.to(buf.dtype) for t in out)


def rglru_scan_ref(a, gated, h0):
    """a/gated (B,S,W) f32, h0 (B,W) f32 -> h_all (B,S,W): the state
    ``h_t = a_t * h_{t-1} + g_t`` after every step."""
    h, out = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gated[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_gates_ref(xa, xi, x, b_a, b_i, a_param):
    """The RG-LRU's decay and gated input from xa = x @ w_a, xi = x @ w_i
    (B,S,W) f32, the conv output x (B,S,W) and b_a, b_i, a_param (W,) f32
    (``repro/models/rglru.py:97-103``).  Returns (a, gated) (B,S,W) f32."""
    r = torch.sigmoid(xa + b_a)
    i = torch.sigmoid(xi + b_i)
    log_a = -RGLRU_C * F.softplus(a_param) * r
    a = torch.exp(log_a)
    gated = (torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), RGLRU_EPS,
                                    1.0))
             * (i * x.to(xa.dtype)))
    return a, gated


def rglru_gated_scan_ref(xa, xi, x, b_a, b_i, a_param, h0):
    """The gates, then the recurrence: h_all (B,S,W) f32."""
    return rglru_scan_ref(*rglru_gates_ref(xa, xi, x, b_a, b_i, a_param), h0)


def rglru_gated_scan_bwd_ref(xa, xi, x, b_a, b_i, a_param, h0, h_all, dh):
    """The backward of :func:`rglru_gated_scan_ref` from its output
    ``h_all`` and the output's gradient ``dh`` (B,S,W), written out: the
    gates recomputed as :func:`rglru_gates_ref` forms them, the reverse
    scan ``dH_t = dh_t + a_{t+1} dH_{t+1}`` (dH the gradient of the state
    h_t), then ``da_t = dH_t h_{t-1}``, ``dg_t = dH_t`` and the chain
    through ``log_a = -C softplus(a_param) r``, ``a = exp(log_a)`` and
    ``gated = sqrt(clip(1 - a^2, eps, 1)) i x``; the clip passes the
    gradient inside its range only (as ``torch.clamp``'s does).  Returns
    (dxa, dxi, dx in x's dtype, db_a, db_i, da_param, dh0)."""
    dt = xa.dtype
    xf = x.to(dt)
    r = torch.sigmoid(xa + b_a)
    i = torch.sigmoid(xi + b_i)
    c = -RGLRU_C * F.softplus(a_param)
    log_a = c * r
    a = torch.exp(log_a)
    a2 = torch.exp(2.0 * log_a)
    m = 1.0 - a2
    sq = torch.sqrt(torch.clamp(m, RGLRU_EPS, 1.0))
    d_h = torch.empty_like(dh, dtype=dt)
    carry = dh[:, -1].to(dt)
    d_h[:, -1] = carry
    for t in range(dh.shape[1] - 2, -1, -1):
        carry = dh[:, t] + a[:, t + 1] * carry
        d_h[:, t] = carry
    h_prev = torch.cat([h0[:, None].to(dt), h_all[:, :-1].to(dt)], dim=1)
    dx = d_h * sq * i
    dxi = d_h * sq * xf * i * (1.0 - i)
    inside = (m >= RGLRU_EPS) & (m <= 1.0)
    dm = torch.where(inside, d_h * i * xf / (2.0 * sq), torch.zeros_like(m))
    dlog_a = d_h * h_prev * a - 2.0 * a2 * dm
    dxa = dlog_a * c * r * (1.0 - r)
    da_param = ((dlog_a * r).sum((0, 1)) * -RGLRU_C
                * torch.sigmoid(a_param))
    return (dxa, dxi, dx.to(x.dtype), dxa.sum((0, 1)), dxi.sum((0, 1)),
            da_param, a[:, 0] * d_h[:, 0])


def wkv6_ref(r, k, v, w, u, s0, *, stack: bool = False):
    """r/k/v/w (B,H,S,hd) f32; u (H,hd); s0 (B,H,hd,hd) f32.  Per head
    ``y_t = r_t (S + u k_t v_t^T)``, then ``S <- diag(w_t) S + k_t v_t^T``.
    Returns (y (B,H,S,hd), s_final (B,H,hd,hd)); with ``stack`` also every
    state (B,S+1,H,hd,hd), index t being the state after t steps."""
    states, ys = [s0], []
    s = s0
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]          # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, :, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, :, t, :, None] * s + kv
        if stack:
            states.append(s)
    y = torch.stack(ys, dim=2)
    if stack:
        return y, s, torch.stack(states, dim=1)
    return y, s


def wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds_fin=None):
    """The backward of :func:`wkv6_ref` (no stack) as the explicit
    reverse recurrence.  With ``G_t`` the gradient of the state after
    step t (``G_S = ds_fin``, zero when None) and ``S_{t-1}`` the state
    before it (every state re-formed forward from s0; nothing divides by
    a decay)::

        G_{t-1} = diag(w_t) G_t + r_t dy_t^T
        dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
        dk_t = G_t v_t + u * r_t (v_t . dy_t)
        dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
        dw_t = rowsum(G_t * S_{t-1})
        du = sum_t r_t * k_t (v_t . dy_t)   (and over the batch)
        ds0 = G_0

    r/k/v/w/dy (B,H,S,hd); u (H,hd); s0/ds_fin (B,H,hd,hd).  Returns
    (dr, dk, dv, dw, du, ds0)."""
    b, h, s, hd = r.shape
    states = torch.empty((s + 1, b, h, hd, hd), dtype=r.dtype,
                         device=r.device)
    states[0] = s0
    for t in range(s):
        states[t + 1] = (w[:, :, t, :, None] * states[t]
                         + k[:, :, t, :, None] * v[:, :, t, None, :])
    g = (torch.zeros_like(s0) if ds_fin is None
         else ds_fin.to(r.dtype).clone())
    grads = [torch.empty_like(r, memory_format=torch.contiguous_format)
             for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((b, h, hd), dtype=r.dtype, device=r.device)
    for t in range(s - 1, -1, -1):
        rt, kt, vt, wt, dyt = (z[:, :, t] for z in (r, k, v, w, dy))
        vdy = (vt * dyt).sum(-1, keepdim=True)                   # (B,H,1)
        dr[:, :, t] = (torch.einsum("bhij,bhj->bhi", states[t], dyt)
                       + u * kt * vdy)
        dk[:, :, t] = torch.einsum("bhij,bhj->bhi", g, vt) + u * rt * vdy
        dv[:, :, t] = (torch.einsum("bhij,bhi->bhj", g, kt)
                       + (rt * u * kt).sum(-1, keepdim=True) * dyt)
        dw[:, :, t] = (g * states[t]).sum(-1)
        du += rt * kt * vdy
        g = wt[..., :, None] * g + rt[..., :, None] * dyt[..., None, :]
    return dr, dk, dv, dw, du.sum(0), g
