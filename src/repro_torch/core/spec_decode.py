"""Speculative decoding: draft-then-verify with batched per-sequence
acceptance (greedy and sampled), the paper's acceptance model (Appendix
A.1), and speculation trees.

Counterpart of ``repro/core/spec_decode.py``; the round protocol is the
same.  Both caches hold positions [0, P) and ``t_next`` (B,) is the last
committed token, not yet fed.  The draft feeds ``n_cand + 1`` tokens one
at a time (``t_next, d_1..d_m``) producing drafts ``d_1..d_m``; the
target verifies ``[t_next, d_1..d_m]`` in one forward; ``a`` = the
longest accepted prefix and ``a + 1`` tokens are emitted (``d_1..d_a``
plus the target's next token).  With greedy acceptance the stream equals
the target's own greedy decode.

Sampled acceptance takes its randomness as tensors drawn before the
round (:func:`acceptance_noise`, :func:`tree_acceptance_noise`): uniforms
where the JAX package draws ``jax.random.uniform`` and standard Gumbel
noise where it draws ``jax.random.categorical``, which is
``argmax(gumbel + logits)``.  Nothing inside a round draws or reads the
host.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.configs import ATTN, RGLRU, SWA, ModelConfig
from repro_torch.models import model as M
from repro_torch.models.attention import (paged_row_indices,
                                          restore_rejected_rows)
from repro_torch.models.rglru import select_rglru_state
from repro_torch.models.rwkv import select_rwkv_state
from repro_torch.obs.metrics import acceptance_buckets

# ---------------------------------------------------------------------------
# the paper's acceptance model (Appendix A.1, Eqs. 10-12)


def acceptance_pmf(p: float, n_cand: int) -> np.ndarray:
    """P[n_generated = k] for k = 1..n_cand+1 under i.i.d. acceptance p."""
    ks = np.arange(1, n_cand + 2)
    pmf = p ** (ks - 1) * (1 - p)
    pmf[-1] = p ** n_cand
    return pmf


def expected_generated(p: float, n_cand: int) -> float:
    """E[n_generated] under the paper's acceptance pmf (Eqs. 10-11).

    ERRATUM: the paper's closed form (Eq. 12) is algebraically inconsistent
    with its own pmf — summing k * P[k] over Eqs. (10)-(11) gives the
    truncated-geometric mean ``(1 - p^{n+1}) / (1 - p)`` (this also matches
    Leviathan et al. 2023 Eq. 1).  We implement the correct sum.
    """
    if p >= 1.0:
        return float(n_cand + 1)
    return float((1.0 - p ** (n_cand + 1)) / (1.0 - p))


def expected_generated_paper_eq12(p: float, n_cand: int) -> float:
    """The paper's Eq. (12) as printed — kept for the erratum comparison."""
    if p >= 1.0:
        return float(n_cand + 1)
    return float((n_cand * p ** (n_cand + 2)
                  - (n_cand + 1) * p ** (n_cand + 1) + 1) / (1 - p))


def record_acceptance(metrics, n_accept, n_cand: int, live_mask=None,
                      n_draft: int | None = None, mode: str = "chain"):
    """Observe one verified round's per-sequence accepted-draft counts
    into the registry (host-side: call with the host copy
    ``RoundOutput.n_accept``, never with a device tensor).

    ``live_mask`` drops slots holding retired or parked sequences.  The
    histogram's integer buckets 0..n_cand make ``sum / (count * n_cand)``
    the measured per-round acceptance (for trees ``n_cand`` is the tree
    depth).  ``n_draft`` is the number of candidates verified per
    sequence per round (chain: n_cand; tree: n_nodes - 1) and feeds
    ``spec_tokens_accepted_total`` / ``spec_tokens_wasted_total``,
    ``spec_verify_rounds_total`` and ``spec_accept_depth_total{depth=d}``
    (rounds whose accepted path reached at least depth d).
    """
    if not metrics.enabled:
        return
    hist = metrics.histogram(
        "spec_accepted_tokens",
        "accepted draft tokens per sequence per verified round",
        buckets=acceptance_buckets(n_cand))
    arr = np.asarray(n_accept)
    if live_mask is not None:
        arr = arr[np.asarray(live_mask)]
    for v in arr.tolist():
        hist.observe(float(v))

    n_draft = n_cand if n_draft is None else n_draft
    accepted = metrics.counter(
        "spec_tokens_accepted_total",
        "draft candidate tokens accepted by target verification")
    wasted = metrics.counter(
        "spec_tokens_wasted_total",
        "draft candidate tokens verified by the target but rejected")
    rounds = metrics.counter(
        "spec_verify_rounds_total",
        "per-sequence verified speculation rounds")
    depth_c = metrics.counter(
        "spec_accept_depth_total",
        "rounds whose accepted path reached at least this depth")
    accepted.inc(float(arr.sum()), mode=mode)
    wasted.inc(float((n_draft - arr).sum()), mode=mode)
    rounds.inc(float(arr.size), mode=mode)
    for d in range(1, n_cand + 1):
        depth_c.inc(float((arr >= d).sum()), mode=mode, depth=str(d))


# ---------------------------------------------------------------------------
# acceptance rules


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


def gumbel_noise(generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` with u uniform in
    [tiny, 1), as ``jax.random.gumbel`` forms it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def acceptance_noise(generator, b: int, m: int, vocab: int,
                     device) -> tuple:
    """The randomness of one :func:`sampled_acceptance` call, drawn from
    an explicit ``torch.Generator`` outside the round: ``u_accept``
    (B, m) uniform in [0, 1), ``g_resample`` and ``g_bonus`` (B, V)
    standard Gumbel."""
    u = torch.rand((b, m), generator=generator, device=device)
    return (u, gumbel_noise(generator, (b, vocab), device),
            gumbel_noise(generator, (b, vocab), device))


def sampled_acceptance(drafts, draft_logits, target_logits, u_accept,
                       g_resample, g_bonus, temperature: float = 1.0):
    """Leviathan et al. (2023) lossless *sampling* acceptance.

    Accept d_i with prob min(1, p_t(d_i)/p_d(d_i)) (``u_accept`` (B, m)
    the uniforms); on the first rejection resample from max(0, p_t - p_d)
    normalized (Gumbel-max with ``g_resample`` (B, V)); a fully accepted
    row samples its bonus token from the target (``g_bonus`` (B, V)).
    Returns (n_accept, next_token, n_commit).
    """
    b, m = drafts.shape
    pt = torch.softmax(target_logits[:, :m].float() / temperature, dim=-1)
    pd = torch.softmax(draft_logits.float() / temperature, dim=-1)
    di = drafts.long()[..., None]
    pt_d = torch.gather(pt, -1, di)[..., 0]
    pd_d = torch.gather(pd, -1, di)[..., 0]
    ratio = torch.clamp(pt_d / torch.clamp_min(pd_d, 1e-20), max=1.0)
    accept = u_accept < ratio
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)

    # residual distribution at the first rejected position
    rows = torch.arange(b, device=drafts.device)
    idx = torch.clamp(a, max=m - 1)
    residual = torch.clamp_min(pt[rows, idx] - pd[rows, idx], 0.0)
    residual = residual / torch.clamp_min(residual.sum(-1, keepdim=True),
                                          1e-20)
    resampled = torch.argmax(g_resample + torch.log(residual + 1e-20), -1)
    # fully-accepted rows sample the bonus position from the target
    bonus = torch.argmax(
        g_bonus + target_logits[:, m].float() / temperature, -1)
    next_token = torch.where(a == m, bonus, resampled)
    return a, next_token, a + 1


# ---------------------------------------------------------------------------
# chain draft generation with rollback support


def draft_generate(params, cfg: ModelConfig, cache, t_next, n_cand: int,
                   mesh=None):
    """Generate ``n_cand`` greedy drafts, feeding n_cand+1 inputs (over
    ``mesh``, :func:`repro_torch.models.model.decode`'s).

    Returns (drafts (B, m), draft_logits (B, m, V), cache, step_pendings);
    the cache holds all n_cand+1 inputs (pos advanced) — roll it back
    with :func:`rollback_draft`.
    """
    tok = t_next[:, None]
    drafts, dlogits, step_pendings = [], [], []
    for i in range(n_cand + 1):
        logits, cache, pend = M.decode(params, cfg, cache, tok, mesh)
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
    (ring rows restored in place, step by step in feed order; a
    recurrent layer set in place to its state after ``n_keep`` steps)."""
    m = len(step_pendings)
    nk = n_keep.long()
    pos0 = cache["pos"] - m
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == ATTN:
            continue            # full cache: stale rows beyond pos are hidden
        if kind == SWA:
            for i, pend in enumerate(step_pendings):
                saved = pend[l]["saved"]
                if not saved:
                    continue
                keep_i = (i < nk).long()
                restore_rejected_rows(cache["layers"][l], saved, pos0 + i,
                                      keep_i)
            continue
        # recurrent: step i's stack holds [state before i, state after i];
        # the sequence [before step 0, after step 0, ..., after step m-1]
        # is (B, m+1, ...) per state leaf, read per row at n_keep
        stacks = [pend[l]["stack"] for pend in step_pendings]
        seq = {key: torch.cat([stacks[0][key][:, :1]]
                              + [st[key][:, 1:2] for st in stacks], dim=1)
               for key in stacks[0]}
        sel = (select_rglru_state if kind == RGLRU else select_rwkv_state)
        for key, val in sel(seq, nk).items():
            cache["layers"][l][key].copy_(val)
    return {"layers": cache["layers"], "pos": pos0 + nk}


# ---------------------------------------------------------------------------
# one full chain round


def spec_round(target_params, target_cfg: ModelConfig, target_cache,
               draft_params, draft_cfg: ModelConfig, draft_cache, t_next,
               n_cand: int, mesh=None, noise=None, sample: bool = False):
    """One draft-then-verify round for one batch.

    ``sample=True`` accepts by :func:`sampled_acceptance` with ``noise``,
    the tuple :func:`acceptance_noise` returns.  Returns a dict with:
    tokens (B, m+1) — the m+1 candidate output slots (d_1..d_m, bonus);
    n_emitted (B,) in [1, m+1] — how many of them are valid; t_next (B,);
    n_accept; the caches (updated in place).
    """
    drafts, dlogits, draft_cache, pendings = draft_generate(
        draft_params, draft_cfg, draft_cache, t_next, n_cand, mesh)
    verify_in = torch.cat([t_next[:, None], drafts], dim=1)
    tlogits, target_cache, tpend = M.decode(target_params, target_cfg,
                                            target_cache, verify_in, mesh)
    if sample:
        a, nxt, n_commit = sampled_acceptance(drafts, dlogits, tlogits,
                                              *noise)
    else:
        a, nxt, n_commit = greedy_acceptance(drafts, tlogits)
    target_cache = M.commit(target_cfg, target_cache, tpend, n_commit,
                            n_cand + 1)
    draft_cache = rollback_draft(draft_cfg, draft_cache, pendings, n_commit)
    return {"tokens": emit_slots(drafts, a, nxt), "n_emitted": a + 1,
            "t_next": nxt, "target_cache": target_cache,
            "draft_cache": draft_cache, "n_accept": a}


def emit_slots(accepted, a, nxt):
    """Output slots (B, m+1): the first ``a`` columns of ``accepted``
    (B, m), then ``nxt`` at slot ``a``, zeros after."""
    m = accepted.shape[1]
    keep = torch.arange(m, device=a.device)[None, :] < a[:, None]
    out = torch.cat([torch.where(keep, accepted, 0),
                     torch.zeros_like(a[:, None])], dim=1)
    return out.scatter_(1, a[:, None], nxt[:, None])


# ---------------------------------------------------------------------------
# speculation trees (SpecExec-style): top-k branching per depth, verified
# in one masked target pass
#
# The tree is flattened breadth-first into a buffer of ``n_nodes`` tokens.
# Node 0 is the root — the last committed token ``t_next`` (depth 0).
# Level d holds prod(branching[:d]) nodes: every level-(d-1) node gets the
# draft's top-``branching[d-1]`` continuations as children.  Cache rows of
# the buffer are written at slots ``[pos, pos + n_nodes)`` in BFS order,
# while each node's RoPE position is the logical ``pos + depth``.
# Attention inside the buffer follows the ancestor-or-self mask; committed
# rows ``< pos`` stay fully visible.  After verification the accepted
# root-to-leaf path is compacted back to contiguous slots
# (:func:`tree_commit_cache`).

#: ancestor sets are packed into int32 bitmasks for the verify kernels
MAX_TREE_NODES = 31


@lru_cache(maxsize=None)
def tree_layout(branching: tuple) -> dict:
    """Static BFS layout for a ``branching`` = (k_1, .., k_D) tree.

    Returns numpy constants: ``n_nodes``, ``depth`` (n,), ``parent`` (n,)
    with parent[0] = 0, ``level_sizes`` / ``level_offsets`` (D+1,),
    ``first_child`` (n,) (-1 for leaves), ``anc_mask`` (n, n) bool
    ancestor-or-self, and ``anc_bits`` (n,) int32 with bit j set iff node
    j is an ancestor-or-self of node i.  The verify kernels hold
    (Hq / Hkv) * n_nodes query rows in one CTA, at most 128 at head dim
    128 (4 * 31 = 124 for Mixtral's GQA group of 4).
    """
    branching = tuple(int(k) for k in branching)
    if not branching or any(k < 1 for k in branching):
        raise ValueError(f"branching factors must be >= 1: {branching}")
    level_sizes = [1]
    for k in branching:
        level_sizes.append(level_sizes[-1] * k)
    n = sum(level_sizes)
    if n > MAX_TREE_NODES:
        raise ValueError(f"tree {branching} has {n} nodes; int32 ancestor "
                         f"bitmasks cap the buffer at {MAX_TREE_NODES} (and "
                         "the verify kernels hold (Hq / Hkv) * n_nodes <= "
                         "128 query rows at head dim 128)")
    offsets = np.concatenate([[0], np.cumsum(level_sizes)[:-1]])
    depth = np.zeros(n, np.int32)
    parent = np.zeros(n, np.int32)
    for d in range(1, len(level_sizes)):
        off, cnt = offsets[d], level_sizes[d]
        depth[off:off + cnt] = d
        parent[off:off + cnt] = offsets[d - 1] + (np.arange(cnt)
                                                  // branching[d - 1])
    first_child = np.full(n, -1, np.int32)
    for d in range(len(branching)):
        off, cnt = offsets[d], level_sizes[d]
        first_child[off:off + cnt] = offsets[d + 1] + (np.arange(cnt)
                                                       * branching[d])
    anc = np.eye(n, dtype=bool)
    for i in range(1, n):
        anc[i] |= anc[parent[i]]
    bits = (anc.astype(np.int64) << np.arange(n)[None, :]).sum(1)
    return {"n_nodes": n, "branching": branching,
            "depth": depth, "parent": parent,
            "level_sizes": np.asarray(level_sizes, np.int32),
            "level_offsets": np.asarray(offsets, np.int32),
            "first_child": first_child,
            "anc_mask": anc, "anc_bits": bits.astype(np.int32)}


def tree_n_nodes(branching) -> int:
    """Buffer size (root + all candidates) of a ``branching`` tree."""
    return int(tree_layout(tuple(branching))["n_nodes"])


def tree_supported(cfg: ModelConfig) -> bool:
    """Tree speculation needs every layer to see the full prefix (the
    ancestor mask subsets full causal attention): all-ATTN decoder-only
    configs.  SWA rings and recurrent state carry order-dependent state
    that a branched buffer cannot share."""
    return (not cfg.encoder_decoder
            and all(kind == ATTN for kind in cfg.layer_pattern))


def _spec_arrays(lay: dict, level: int | None) -> dict:
    """The JAX package's ``spec_tree`` descriptor (numpy constants)."""
    if level is None:
        return {"depths": lay["depth"], "prev": 0, "mask": lay["anc_mask"],
                "anc_bits": lay["anc_bits"]}
    off = int(lay["level_offsets"][level])
    cnt = int(lay["level_sizes"][level])
    return {"depths": lay["depth"][off:off + cnt], "prev": off,
            "mask": lay["anc_mask"][off:off + cnt, :off + cnt]}


def tree_spec(branching: tuple, level: int | None = None, *,
              device) -> dict:
    """The ``spec_tree`` attention descriptor.

    ``level=None``: verify the whole buffer at once (``prev=0``).
    ``level=d``: the draft's feed of level ``d``'s nodes after ``prev``
    buffer rows are already written.  Keys: ``depths`` (Sq,) node depths,
    ``prev`` rows of the buffer already in cache, ``mask`` (Sq, prev+Sq)
    ancestor-or-self visibility over the buffer written so far, and (full
    buffer only) ``anc_bits`` for the verify kernels — numpy constants,
    as in the JAX package — and ``tensors``, the same on ``device``:
    (depths int64, mask bool, ancestor bitmasks int32 for a feed from
    the buffer's start, else None), made once per layout and device.
    """
    lay = tree_layout(tuple(branching))
    spec = _spec_arrays(lay, level)
    spec["tensors"] = _tree_consts(lay["branching"],
                                   torch.device(device))["specs"][level]
    return spec


@lru_cache(maxsize=None)
def _tree_consts(branching: tuple, device: torch.device) -> dict:
    """The layout's constants as tensors on ``device``, made once: a
    host-to-device copy inside a round would wait for the card.
    ``levels`` holds, per depth d >= 1, (offset, count, parent, parent
    within level d-1, buffer indices); ``specs`` maps each
    :func:`tree_spec` level to its ``tensors``."""
    lay = tree_layout(branching)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=device).long()
    levels = []
    for d in range(1, len(lay["level_sizes"])):
        off = int(lay["level_offsets"][d])
        cnt = int(lay["level_sizes"][d])
        par = lay["parent"][off:off + cnt]
        levels.append((off, cnt, as_t(par),
                       as_t(par - int(lay["level_offsets"][d - 1])),
                       as_t(np.arange(off, off + cnt))))
    specs = {}
    for level in [None] + list(range(len(lay["level_sizes"]))):
        s = _spec_arrays(lay, level)
        n = len(s["depths"])
        # a feed from the buffer's start masks by the layout's bitmasks
        anc = (torch.as_tensor(lay["anc_bits"][:n], device=device)
               if s["prev"] == 0 else None)
        specs[level] = (as_t(s["depths"]),
                        torch.as_tensor(s["mask"], device=device), anc)
    return {"levels": levels, "first_child": as_t(lay["first_child"]),
            "specs": specs}


# ---------------------------------------------------------------------------
# tree-shaped acceptance model


def acceptance_pmf_tree(p: float, branching: tuple) -> np.ndarray:
    """P[n_generated = d+1] for d = 0..D on a ``branching`` tree.

    Per-level coverage under i.i.d. acceptance p: the accepted node at
    depth d-1 has k_d children, each independently acceptable with prob
    p, so the path extends with ``q_d = 1 - (1-p)^{k_d}`` (any child
    matches).  The emitted count is path length + 1 (bonus token).
    """
    qs = [1.0 - (1.0 - p) ** k for k in tuple(branching)]
    pmf, run = [], 1.0
    for q in qs:
        pmf.append(run * (1.0 - q))
        run *= q
    pmf.append(run)
    return np.asarray(pmf)


def expected_generated_tree(p: float, branching: tuple) -> float:
    """E[n_generated] for a tree: ``1 + sum_d prod_{j<=d} q_j`` — the tree
    analogue of :func:`expected_generated` (chain = all k_j = 1)."""
    if p >= 1.0:
        return float(len(tuple(branching)) + 1)
    e, run = 1.0, 1.0
    for k in tuple(branching):
        run *= 1.0 - (1.0 - p) ** k
        e += run
    return float(e)


# ---------------------------------------------------------------------------
# tree acceptance rules


def tree_greedy_acceptance(tokens, target_logits, branching: tuple):
    """Greedy (lossless) acceptance over a verified tree buffer.

    ``tokens`` (B, N) is the BFS buffer (root = committed ``t_next`` at
    column 0); ``target_logits`` (B, N, V) are the target's logits at
    every node.  A node is accepted iff its token equals the target's
    greedy prediction at its parent and its parent is accepted — the
    target's own greedy path through the tree (top-k children are
    distinct, so at most one child per level matches).

    Returns ``(n_accept (B,), next_token (B,), out_tokens (B, D+1),
    path_idx (B, D+1))`` where ``path_idx[:, d]`` is the buffer index of
    the accepted depth-d node (0 = root beyond the path) for
    :func:`tree_commit_cache`.
    """
    levels = _tree_consts(tuple(branching), tokens.device)["levels"]
    b = tokens.shape[0]
    g = torch.argmax(target_logits, dim=-1)                      # (B, N)

    acc_levels = [torch.ones((b, 1), dtype=torch.bool, device=g.device)]
    path_cols = [torch.zeros((b,), dtype=torch.int64, device=g.device)]
    out_cols = []
    for off, cnt, par, par_local, idx in levels:
        match = tokens[:, off:off + cnt] == g[:, par]
        lvl = match & acc_levels[-1][:, par_local]
        acc_levels.append(lvl)
        hot = lvl.long()                                         # <=1 hot
        path_cols.append((hot * idx[None, :]).sum(dim=1))
        out_cols.append((hot * tokens[:, off:off + cnt]).sum(dim=1))
    n_accept = sum(lvl.any(dim=1).long() for lvl in acc_levels[1:])
    path_idx = torch.stack(path_cols, dim=1)                     # (B, D+1)
    best = torch.gather(path_idx, 1, n_accept[:, None])
    nxt = torch.gather(g, 1, best)[:, 0]
    out = torch.stack(out_cols + [torch.zeros_like(nxt)], dim=1)
    out.scatter_(1, n_accept[:, None], nxt[:, None])
    return n_accept, nxt, out, path_idx


def tree_acceptance_noise(generator, b: int, branching: tuple, vocab: int,
                          device) -> tuple:
    """The randomness of one :func:`tree_sampled_acceptance` call, drawn
    from an explicit ``torch.Generator`` outside the round: ``u_accept``
    (B, sum(branching)) uniform in [0, 1), one per child tried in draw
    order, and ``g_sample`` (B, D+1, V) standard Gumbel, one row per
    level's residual draw and the last for the deepest node's bonus."""
    u = torch.rand((b, sum(branching)), generator=generator, device=device)
    return u, gumbel_noise(generator, (b, len(branching) + 1, vocab), device)


def tree_sampled_acceptance(tokens, draft_logits, target_logits,
                            branching: tuple, u_accept, g_sample,
                            temperature: float = 1.0):
    """SpecInfer-style multi-candidate rejection sampling down the tree.

    At the current accepted node, try its k children in draft-rank order:
    accept child c with prob ``min(1, res(c) / p_d(c))`` where ``res``
    starts as the target distribution; on rejection subtract the draft
    proposal mass and renormalize both (sampling-without-replacement
    correction), and if every child is rejected emit a token from the
    residual.  The noise is :func:`tree_acceptance_noise`'s: the JAX
    package splits its key into sum(branching) + D + 1 keys and draws, per
    level, one uniform per child and then one categorical, and a last
    categorical for the bonus — ``u_accept`` holds the uniforms in that
    order and ``g_sample`` the categoricals' Gumbel noise.

    Same return signature as :func:`tree_greedy_acceptance`.
    """
    lay = tree_layout(tuple(branching))
    branching = lay["branching"]
    b, _, v = target_logits.shape
    dev = tokens.device
    rows = torch.arange(b, device=dev)
    pt_all = torch.softmax(target_logits.float() / temperature, dim=-1)
    pd_all = torch.softmax(draft_logits.float() / temperature, dim=-1)
    fc_arr = _tree_consts(branching, dev)["first_child"]

    cur = torch.zeros((b,), dtype=torch.int64, device=dev)  # deepest accepted
    alive = torch.ones((b,), dtype=torch.bool, device=dev)
    n_accept = torch.zeros((b,), dtype=torch.int64, device=dev)
    nxt = torch.zeros((b,), dtype=tokens.dtype, device=dev)
    path_cols = [cur]
    out_cols = []
    ui = 0
    for d, k_d in enumerate(branching):
        fc = fc_arr[cur]
        res = pt_all[rows, cur]
        pdm = pd_all[rows, cur]
        accepted = torch.zeros((b,), dtype=torch.bool, device=dev)
        child_tok = torch.zeros((b,), dtype=tokens.dtype, device=dev)
        child_idx = cur
        for j in range(k_d):
            cidx = fc + j
            ctok = torch.gather(tokens, 1, cidx[:, None])[:, 0]
            ci = ctok.long()[:, None]
            p_res = torch.gather(res, 1, ci)[:, 0]
            p_d = torch.gather(pdm, 1, ci)[:, 0]
            u = u_accept[:, ui]
            ui += 1
            ratio = torch.clamp(p_res / torch.clamp_min(p_d, 1e-20), max=1.0)
            acc_j = alive & ~accepted & (u < ratio)
            child_tok = torch.where(acc_j, ctok, child_tok)
            child_idx = torch.where(acc_j, cidx, child_idx)
            accepted = accepted | acc_j
            rej = (alive & ~accepted)[:, None]
            res_new = torch.clamp_min(res - pdm, 0.0)
            res_new = res_new / torch.clamp_min(
                res_new.sum(-1, keepdim=True), 1e-20)
            res = torch.where(rej, res_new, res)
            pdm_new = pdm.scatter(1, ci, 0.0)
            pdm_new = pdm_new / torch.clamp_min(
                pdm_new.sum(-1, keepdim=True), 1e-20)
            pdm = torch.where(rej, pdm_new, pdm)
        failed = alive & ~accepted
        bonus = torch.argmax(g_sample[:, d] + torch.log(res + 1e-20), -1)
        nxt = torch.where(failed, bonus.to(tokens.dtype), nxt)
        n_accept = n_accept + accepted.long()
        alive = alive & accepted
        out_cols.append(torch.where(accepted, child_tok, 0))
        cur = torch.where(accepted, child_idx, cur)
        path_cols.append(torch.where(accepted, child_idx, 0))
    pt_deep = pt_all[rows, cur]
    bonus = torch.argmax(g_sample[:, len(branching)]
                         + torch.log(pt_deep + 1e-20), -1)
    nxt = torch.where(alive, bonus.to(tokens.dtype), nxt)
    out = torch.stack(out_cols + [torch.zeros_like(nxt)], dim=1)
    out.scatter_(1, n_accept[:, None], nxt[:, None])
    return n_accept, nxt, out, torch.stack(path_cols, dim=1)


# ---------------------------------------------------------------------------
# tree draft generation + accepted-path commit


def top_k_indices(logits, k: int):
    """Indices of the ``k`` largest entries of the last axis, largest
    first and ties by lower index — the order of JAX's ``lax.top_k``
    (``torch.topk`` promises no order among ties, and bf16 logits tie)."""
    return torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def draft_tree_generate(params, cfg: ModelConfig, cache, t_next,
                        branching: tuple, mesh=None,
                        collect_logits: bool = False):
    """Expand the draft's top-k speculation tree level by level.

    Feeds the root (``t_next``) then each level's nodes in one masked
    decode step per depth; every level-(d-1) node contributes its
    top-``branching[d-1]`` continuations (:func:`top_k_indices`).  All
    ``n_nodes`` buffer rows end up written to the cache (slots ``[pos,
    pos + n_nodes)``), so a fully-accepted round needs no catch-up feed.
    Returns ``(tok_buf (B, N), draft_logits (B, N, V) | None, cache)``
    with ``pos`` advanced by ``n_nodes``.
    """
    branching = tree_layout(tuple(branching))["branching"]
    b = t_next.shape[0]
    feed = t_next[:, None].long()
    toks, dlogits = [feed], []
    for d in range(len(branching) + 1):
        logits, cache, _ = M.decode(params, cfg, cache, feed, mesh,
                                    spec_tree=tree_spec(branching, d,
                                                      device=feed.device))
        cache = dict(cache, pos=cache["pos"] + feed.shape[1])
        if collect_logits:
            dlogits.append(logits)
        if d < len(branching):
            feed = top_k_indices(logits, branching[d]).reshape(b, -1)
            toks.append(feed)
    tok_buf = torch.cat(toks, dim=1)
    logits_buf = torch.cat(dlogits, dim=1) if collect_logits else None
    return tok_buf, logits_buf, cache


def tree_commit_cache(cfg: ModelConfig, cache, path_idx, n_keep,
                      branching: tuple, pos_offset: int = 0):
    """Commit a verified tree's accepted root path by compaction, in
    place: the accepted buffer rows (root + path) are read from their
    scattered BFS slots and written back contiguously at the frontier,
    then ``pos`` advances past the kept rows.  Rows beyond the new ``pos``
    are stale but invisible and get overwritten by the next buffer.

    ``path_idx`` (B, D+1) comes from the acceptance rule; ``n_keep`` (B,)
    is the accepted path length ``a`` (``a + 1`` rows kept).
    ``pos_offset`` is how far ``cache['pos']`` already advanced past the
    buffer start (0 for the target, whose decode does not move ``pos``;
    ``n_nodes`` for the draft after :func:`draft_tree_generate`).

    Every source row is read before any destination row is written (the
    two ranges overlap).  Paged pools go through the block table (dead
    slots aim at the scratch block 0, where several rows may land).  On a
    contiguous cache sources past the end clip to the last slot and
    destinations past the end are dropped, as the JAX package's
    ``mode="clip"`` / ``mode="drop"``: a dropped column rewrites the value
    the row's last kept column writes (or, with none kept, the last
    slot's own value) to the last slot, so the one scatter stays free of
    conflicting duplicates and of host reads.
    """
    dplus = path_idx.shape[1]
    base = cache["pos"] - pos_offset                             # (B,)
    src = base[:, None] + path_idx.long()                        # (B, D+1)
    dst = base[:, None] + torch.arange(dplus, device=base.device)[None, :]
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind != ATTN:
            raise ValueError("tree_commit_cache requires an all-attention "
                             f"layer pattern (layer {l} is {kind!r})")
    leaves = [t for layer in cache["layers"] for t in layer.values()]
    if "block_tables" in cache:
        bs = leaves[0].shape[1]
        srows = paged_row_indices(cache["block_tables"], src, bs).reshape(-1)
        drows = paged_row_indices(cache["block_tables"], dst, bs).reshape(-1)
        for t in leaves:
            flat = t.view((t.shape[0] * bs,) + t.shape[2:])
            flat[drows] = flat[srows]            # gathered copy, then set
    else:
        n_slots = leaves[0].shape[1]
        last_kept = torch.gather(
            src, 1, (n_slots - 1 - base).clamp(0, dplus - 1)[:, None])
        fallback = torch.where(base[:, None] <= n_slots - 1, last_kept,
                               n_slots - 1)
        src_eff = torch.where(dst < n_slots, src, fallback).clamp(
            0, n_slots - 1)
        dst_eff = dst.clamp(max=n_slots - 1)
        rows = torch.arange(dst.shape[0], device=dst.device)[:, None]
        for t in leaves:
            t[rows, dst_eff] = t[rows, src_eff]
    return dict(cache, pos=base + n_keep.long() + 1)


# ---------------------------------------------------------------------------
# one full tree-speculation round (mirrors spec_round)


def spec_round_tree(target_params, target_cfg: ModelConfig, target_cache,
                    draft_params, draft_cfg: ModelConfig, draft_cache,
                    t_next, branching: tuple, mesh=None, noise=None,
                    sample: bool = False):
    """One draft-tree-then-verify round for one batch.

    Same contract as :func:`spec_round` with ``tokens`` (B, D+1): the
    accepted path's tokens then the bonus token at slot ``a``;
    ``sample=True`` takes ``noise`` from :func:`tree_acceptance_noise`.
    """
    branching = tuple(branching)
    n_nodes = tree_n_nodes(branching)
    tok_buf, dlogits, draft_cache = draft_tree_generate(
        draft_params, draft_cfg, draft_cache, t_next, branching, mesh,
        collect_logits=sample)
    tlogits, target_cache, _ = M.decode(target_params, target_cfg,
                                        target_cache, tok_buf, mesh,
                                        spec_tree=tree_spec(
                                            branching, device=tok_buf.device))
    if sample:
        a, nxt, out, path_idx = tree_sampled_acceptance(
            tok_buf, dlogits, tlogits, branching, *noise)
    else:
        a, nxt, out, path_idx = tree_greedy_acceptance(tok_buf, tlogits,
                                                       branching)
    target_cache = tree_commit_cache(target_cfg, target_cache, path_idx, a,
                                     branching)
    draft_cache = tree_commit_cache(draft_cfg, draft_cache, path_idx, a,
                                    branching, pos_offset=n_nodes)
    return {"tokens": out, "n_emitted": a + 1, "t_next": nxt,
            "target_cache": target_cache, "draft_cache": draft_cache,
            "n_accept": a}
