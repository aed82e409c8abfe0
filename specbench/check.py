"""The comparison that decides ``correct``: what the timed path served and
drafted, against the plain reference.

A sample of the requests served (drawn from the seed and spread over the
engine's slots, the one with the most served tokens always in it) is run
through the reference once each, after the window.

* Target: prompt and served tokens together.  At the position before
  each served token the reference target's logits are read, and the
  numbers compared are the gaps by which the served tokens' logits lie
  below the reference's best there.  Greedy decoding serves the argmax,
  so a sound program reads gaps at the size of its rounding, where
  near-ties flip.
* Draft: every chain of drafts that a round verified for a sampled
  request, recorded as the round left it (``n_before`` tokens served
  before it, the chain ``d_1..d_m``).  The draft proposes ``d_1`` after
  the prompt and those tokens, and each ``d_j`` after ``d_1..d_{j-1}``
  as well; the reference draft reads the whole served stream and every
  chain as a branch off it in one pass (a tree mask), and the gaps of
  the drafted tokens below its best are compared the same way.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference


def pick_sample(served: dict, n: int, seed: int,
                slot_of: dict | None = None) -> list:
    """``served``: rid -> list of served tokens.  The rid with the most
    tokens, then up to n - 1 more from the seed: ordered by the slot that
    served them (``slot_of``: rid -> slot) and taken at even steps from
    an offset the seed draws, so both halves and their slots are
    covered; drawn at random where no slot is known."""
    rids = sorted(r for r, toks in served.items() if toks)
    if not rids:
        return []
    longest = max(rids, key=lambda r: (len(served[r]), -r))
    rest = [r for r in rids if r != longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0xC4EC])
    k = min(len(rest), max(0, n - 1))
    if not k:
        return [longest]
    if slot_of is not None:
        rest.sort(key=lambda r: (slot_of.get(r, -1), r))
        step = len(rest) / k
        off = rng.random() * step
        extra = [rest[int(off + i * step)] for i in range(k)]
    else:
        extra = [rest[int(i)] for i in rng.choice(len(rest), size=k,
                                                  replace=False)]
    return [longest] + sorted(extra)


def _stats(g: torch.Tensor) -> dict:
    """Gaps of the picked tokens below the reference's best: the widest,
    the 99th percentile, the mean, and the share of picks that are not
    the reference's argmax."""
    return {"max": float(g.max()), "p99": float(torch.quantile(g, 0.99)),
            "mean": float(g.mean()), "mismatch": float((g > 0).float().mean())}


def _compare(params: dict, cfg: dict, items: list, others) -> dict:
    """``items``: (tokens, layout or None, read positions, picks), one
    sequence each.  The gap statistics of the picks, and for each name in
    ``others`` those of the tokens that the reference computed that way
    puts first at the same positions."""
    got = {None: []} | {q: [] for q in others}
    for seq, layout, reads, picks in items:
        ref = reference.logits_at(params, cfg, [seq], [reads],
                                  layouts=[layout])[0]
        best = ref.max(-1).values
        got[None].append(best - ref.gather(-1, picks[:, None])[:, 0])
        for q in others:
            alt = reference.logits_at(params, cfg, [seq], [reads], quant=q,
                                      layouts=[layout])[0].argmax(-1)
            got[q].append(best - ref.gather(-1, alt[:, None])[:, 0])
        del ref
    out = {"tokens": int(sum(len(g) for g in got[None])),
           "stats": _stats(torch.cat(got[None]))}
    for q in others:
        out[f"stats_{q}"] = _stats(torch.cat(got[q]))
    return out


def gaps(params: dict, cfg: dict, prompts: dict, served: dict, rids: list,
         others=()) -> dict:
    """The target: ``{"tokens": tokens compared, "stats": {...}}``; for
    each name in ``others`` (``"fp8"``, the control; ``"bf16"``, a
    witness), ``"stats_<name>"``."""
    device = params["embed"]["tok"].device
    items = []
    for r in rids:
        p = np.asarray(prompts[r], np.int64)
        t = np.asarray(served[r], np.int64)
        seq = torch.as_tensor(np.concatenate([p, t[:-1]]), device=device)
        reads = torch.arange(len(p) - 1, len(p) - 1 + len(t), device=device)
        items.append((seq, None, reads, torch.as_tensor(t, device=device)))
    return _compare(params, cfg, items, others)


def draft_inputs(prompt, served, rounds) -> tuple:
    """One sampled request's draft chains as one tree: the served stream
    (main branch, positions 0..L-1) and each chain's first m-1 tokens as
    a branch at positions c..c+m-2 (c = prompt + tokens served before
    it) that sees the main branch below c and its own earlier tokens.
    Returns (tokens, (pos, lim, branch), read positions, picks) as numpy
    arrays; a token sees main tokens at positions <= its ``lim`` and the
    tokens of its own ``branch`` (-1: the main branch) up to its own."""
    p = np.asarray(prompt, np.int64)
    main = np.concatenate([p, np.asarray(served, np.int64)])
    n = len(main)
    toks, pos, lim, br = [main], [np.arange(n)], [np.arange(n)], \
        [np.full(n, -1)]
    reads, picks = [], []
    for b, (n_before, chain) in enumerate(rounds):
        chain = np.asarray(chain, np.int64)
        m = len(chain)
        c = len(p) + int(n_before)
        if not 1 <= n_before <= len(served):
            raise ValueError(f"a chain after {n_before} of {len(served)} "
                             "served tokens")
        base = sum(len(t) for t in toks)
        toks.append(chain[:m - 1])
        pos.append(c + np.arange(m - 1))
        lim.append(np.full(m - 1, c - 1))
        br.append(np.full(m - 1, b))
        reads += [c - 1] + [base + j for j in range(m - 1)]
        picks += chain.tolist()
    cat = np.concatenate
    return (cat(toks), (cat(pos), cat(lim), cat(br)), np.asarray(reads),
            np.asarray(picks))


def draft_gaps(params: dict, cfg: dict, prompts: dict, served: dict,
               rounds: dict, rids: list, others=()) -> dict:
    """The draft, as :func:`gaps`: ``rounds``: rid -> [(n_before,
    chain)], every chain a round verified for that request."""
    device = params["embed"]["tok"].device
    items = []
    for r in rids:
        if not rounds.get(r):
            continue
        seq, layout, reads, picks = draft_inputs(prompts[r], served[r],
                                                 rounds[r])
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        items.append((t(seq), tuple(t(a) for a in layout), t(reads),
                      t(picks)))
    if not items:
        return {"tokens": 0, "stats": None}
    return _compare(params, cfg, items, others)
