"""Speculative decoding, chain mode: greedy acceptance, draft generation,
draft rollback.

Counterpart of ``repro/core/spec_decode.py`` (``:131``, ``:186``,
``:209-255``); the round protocol is the same.  Both caches hold
positions [0, P) and ``t_next`` (B,) is the last committed token, not yet
fed.  The draft feeds ``n_cand + 1`` tokens one at a time
(``t_next, d_1..d_m``) producing drafts ``d_1..d_m``; the target
verifies ``[t_next, d_1..d_m]`` in one forward; ``a`` = the longest
prefix with ``d_{i+1} == g_i`` is accepted and ``a + 1`` tokens are
emitted (``d_1..d_a`` plus the target's ``g_a``).  With greedy
acceptance the stream equals the target's own greedy decode.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ATTN, SWA, ModelConfig
from repro_torch.models import model as M
from repro_torch.models.attention import restore_rejected_rows


def greedy_acceptance(drafts, target_logits):
    """drafts (B, m); target_logits (B, m+1, V) for inputs
    [t_next, d_1..d_m].  Returns (n_accept (B,) in [0, m], next_token
    (B,), n_commit (B,) = a + 1)."""
    g = torch.argmax(target_logits, dim=-1)                  # (B, m+1)
    m = drafts.shape[1]
    match = drafts == g[:, :m]
    a = torch.cumprod(match.long(), dim=1).sum(dim=1)
    next_token = torch.gather(g, 1, a[:, None])[:, 0]
    return a, next_token, a + 1


def draft_generate(params, cfg: ModelConfig, cache, t_next, n_cand: int):
    """Generate ``n_cand`` greedy drafts, feeding n_cand+1 inputs.

    Returns (drafts (B, m), draft_logits (B, m, V), cache, step_pendings);
    the cache holds all n_cand+1 inputs (pos advanced) — roll it back
    with :func:`rollback_draft`.
    """
    tok = t_next[:, None]
    drafts, dlogits, step_pendings = [], [], []
    for i in range(n_cand + 1):
        logits, cache, pend = M.decode(params, cfg, cache, tok)
        cache = {"layers": cache["layers"], "pos": cache["pos"] + 1}
        step_pendings.append(pend)
        if i < n_cand:
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
            drafts.append(tok[:, 0])
            dlogits.append(logits[:, 0])
    return (torch.stack(drafts, dim=1), torch.stack(dlogits, dim=1), cache,
            step_pendings)


def rollback_draft(cfg: ModelConfig, cache, step_pendings, n_keep):
    """Rewind the draft cache to keep only the first ``n_keep`` (B,) of the
    ``len(step_pendings)`` single-token steps of :func:`draft_generate`
    (ring rows restored in place, step by step in feed order)."""
    m = len(step_pendings)
    nk = n_keep.long()
    pos0 = cache["pos"] - m
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == ATTN:
            continue            # full cache: stale rows beyond pos are hidden
        if kind != SWA:
            raise NotImplementedError(f"rollback of {kind!r} layers is not "
                                      "ported yet")
        for i, pend in enumerate(step_pendings):
            saved = pend[l]["saved"]
            if not saved:
                continue
            keep_i = (i < nk).long()
            restore_rejected_rows(cache["layers"][l], saved, pos0 + i, keep_i)
    return {"layers": cache["layers"], "pos": pos0 + nk}
