"""Interleaved Batch Pipeline (paper §4.1): dual-batch rotation, chain or
tree mode.

Counterpart of ``repro/core/interleave.py``.  In slot t_n the target
verifies batch V's drafts while the draft model generates candidates for
batch D; the roles swap in t_{n+1}.  The JAX package fuses both halves
into one jit program; here the fused round runs eagerly on one CUDA
stream (overlapping draft and verify on two streams is later work).

All shapes inside a round are fixed by ``(batch, n_cand)``, or by
``(batch, tree)`` in tree mode, where the staged drafts are the (B, N)
BFS token buffer of a speculation tree and both caches of batch V are
compacted to the accepted path inside the fused round (no separate
rollback).
``trace_counts["fused"]`` counts the distinct input shape signatures the
fused round has seen — the eager stand-in for the JAX package's compile
count, so a shape-stable server keeps it at 1 (and a later CUDA-graph
capture of the round stays possible).  Each round reads its tokens to
the host once, and that is its only synchronisation; a tracer that
fences (``obs``, off by default) adds one at the end of each device
span.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.spec_decode import (draft_generate,
                                          draft_tree_generate, emit_slots,
                                          greedy_acceptance, rollback_draft,
                                          tree_commit_cache,
                                          tree_greedy_acceptance,
                                          tree_n_nodes, tree_spec,
                                          tree_supported)
from repro_torch.models import model as M
from repro_torch.obs import NULL_OBS


@dataclass
class BatchState:
    """Per-interleaved-batch decoding state."""
    target_cache: dict
    draft_cache: dict
    t_next: torch.Tensor         # (B,) last committed token (not yet fed)
    drafts: torch.Tensor | None  # (B, m) candidates awaiting verification
                                 # ((B, N) tree buffer in tree mode)
    draft_pendings: list | None  # rollback info for the draft steps
    emitted: list                # host-side: list of (tokens, n_emitted)


@dataclass
class RoundOutput:
    """Host-side result of one verified rotation round (one batch)."""
    tokens: np.ndarray           # (B, m+1) output slots (d_1..d_a, bonus, 0s)
    n_emitted: np.ndarray        # (B,) in [1, m+1]: valid prefix of tokens
    n_accept: np.ndarray         # (B,) accepted draft tokens this round
    t0: float = 0.0              # wall interval of the round (perf_counter)
    t1: float = 0.0


def fused_verify_and_draft(target_params, target_cfg: ModelConfig,
                           draft_params, draft_cfg: ModelConfig,
                           verify_state: dict, draft_state: dict,
                           n_cand: int, mesh=None):
    """The fused round: the target verifies batch V's drafts while the
    draft model generates candidates for batch D.

    verify_state: {target_cache, t_next, drafts}
    draft_state:  {draft_cache, t_next}
    Returns (verify_out, draft_out).
    """
    drafts = verify_state["drafts"]
    v_in = torch.cat([verify_state["t_next"][:, None], drafts], dim=1)
    tlogits, tcache, tpend = M.decode(target_params, target_cfg,
                                      verify_state["target_cache"], v_in,
                                      mesh)
    a, nxt, n_commit = greedy_acceptance(drafts, tlogits)
    tcache = M.commit(target_cfg, tcache, tpend, n_commit, n_cand + 1)

    new_drafts, _, dcache, dpend = draft_generate(
        draft_params, draft_cfg, draft_state["draft_cache"],
        draft_state["t_next"], n_cand, mesh)

    verify_out = {"target_cache": tcache,
                  "tokens": emit_slots(drafts, a, nxt), "n_emitted": a + 1,
                  "t_next": nxt, "n_accept": a}
    draft_out = {"drafts": new_drafts, "draft_cache": dcache,
                 "pendings": dpend}
    return verify_out, draft_out


def fused_tree_verify_and_draft(target_params, target_cfg: ModelConfig,
                                draft_params, draft_cfg: ModelConfig,
                                verify_state: dict, draft_state: dict,
                                branching: tuple, mesh=None):
    """Tree-mode fused round: the target verifies batch V's speculation
    tree (ancestor-masked, one forward over all ``n_nodes`` buffer rows)
    while the draft expands a fresh tree for batch D.

    verify_state: {target_cache, draft_cache, t_next, drafts} where
    ``drafts`` is the (B, N) BFS token buffer (column 0 == t_next).  Both
    of batch V's caches are committed by accepted-path compaction here
    (:func:`tree_commit_cache`), so the round needs no rollback call.
    """
    branching = tuple(branching)
    n_nodes = tree_n_nodes(branching)
    tlogits, tcache, _ = M.decode(target_params, target_cfg,
                                  verify_state["target_cache"],
                                  verify_state["drafts"], mesh,
                                  spec_tree=tree_spec(
                                      branching,
                                      device=verify_state["drafts"].device))
    a, nxt, out, path_idx = tree_greedy_acceptance(verify_state["drafts"],
                                                   tlogits, branching)
    tcache = tree_commit_cache(target_cfg, tcache, path_idx, a, branching)
    vdcache = tree_commit_cache(draft_cfg, verify_state["draft_cache"],
                                path_idx, a, branching, pos_offset=n_nodes)

    drafts, _, dcache = draft_tree_generate(
        draft_params, draft_cfg, draft_state["draft_cache"],
        draft_state["t_next"], branching, mesh)
    verify_out = {"target_cache": tcache, "draft_cache": vdcache,
                  "tokens": out, "n_emitted": a + 1, "t_next": nxt,
                  "n_accept": a}
    draft_out = {"drafts": drafts, "draft_cache": dcache, "pendings": None}
    return verify_out, draft_out


def _signature(*trees) -> tuple:
    """Shapes and dtypes of every tensor in nested dicts/lists."""
    sig = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), x.dtype))
        elif isinstance(x, dict):
            for k in sorted(x):
                sig.append(k)
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            sig.append(len(x))
            for y in x:
                walk(y)
    for t in trees:
        walk(t)
    return tuple(sig)


class InterleavedPipeline:
    """Dual-batch rotation, drivable one round at a time.

    ``trace_counts`` records, per entry point, how many distinct input
    shape signatures it has run with; a scheduler that keeps shapes
    stable sees ``trace_counts['fused'] == 1`` for its whole lifetime.
    ``tree`` (a branching tuple) selects tree mode, which needs
    all-attention decoder-only target and draft models; its rounds never
    call the rollback entry.  ``obs`` receives the warmup, verify, draft
    and rollback spans.  Over a ``mesh`` (the parameters and caches the
    rank's, :class:`repro_torch.core.pipeline.SpecOffloadEngine` with a
    mesh) every rank runs the same rounds on the same tokens.
    """

    def __init__(self, target_params, target_cfg, draft_params, draft_cfg,
                 n_cand: int, tree=None, obs=None, mesh=None):
        self.tp, self.tcfg = target_params, target_cfg
        self.dp, self.dcfg = draft_params, draft_cfg
        self.n_cand = n_cand
        self.mesh = mesh
        self.obs = obs if obs is not None else NULL_OBS
        self.tree = tuple(tree) if tree is not None else None
        if self.tree is not None:
            for name, cfg in (("target", target_cfg), ("draft", draft_cfg)):
                if not tree_supported(cfg):
                    raise ValueError(
                        f"tree speculation requires an all-attention "
                        f"decoder-only {name} model (layer_pattern="
                        f"{cfg.layer_pattern!r})")
            tree_n_nodes(self.tree)          # validates shape and node cap
        self.trace_counts = {"fused": 0, "draft": 0, "rollback": 0}
        self._seen = {k: set() for k in self.trace_counts}
        self._exported_traces = {k: 0 for k in self.trace_counts}

    def _count(self, entry: str, *trees) -> None:
        sig = _signature(*trees)
        if sig not in self._seen[entry]:
            self._seen[entry].add(sig)
            self.trace_counts[entry] += 1

    def export_trace_counts(self, registry) -> None:
        """Sync ``trace_counts`` into ``pipeline_traces_total{entry=...}``
        counters (delta-based: safe to call repeatedly); a shape-stable
        serving run reports ``entry="fused"`` == 1 through this path."""
        ctr = registry.counter(
            "pipeline_traces_total",
            "jit (re)traces per pipeline entry point; fused must stay 1")
        for entry, n in self.trace_counts.items():
            delta = n - self._exported_traces[entry]
            if delta:
                ctr.inc(delta, entry=entry)
                self._exported_traces[entry] = n
            elif n == 0:
                ctr.inc(0, entry=entry)   # materialize the zero series

    # ------------------------------------------------------------------
    def warmup(self, state: BatchState) -> None:
        """Slot t_0 (paper Fig. 4): draft candidates for ``state`` so the
        next :meth:`step` can verify it.  No-op if drafts are staged."""
        if state.drafts is not None:
            return
        self._count("draft", state.draft_cache, state.t_next)
        with self.obs.tracer.span("draft_generate", "warmup",
                                  cat="device") as sp:
            if self.tree is not None:
                d, _, dc = draft_tree_generate(self.dp, self.dcfg,
                                               state.draft_cache,
                                               state.t_next, self.tree,
                                               self.mesh)
                pend = None
            else:
                d, _, dc, pend = draft_generate(self.dp, self.dcfg,
                                                state.draft_cache,
                                                state.t_next, self.n_cand,
                                                self.mesh)
            sp.fence(d)
        state.drafts, state.draft_cache, state.draft_pendings = d, dc, pend

    def step(self, verify: BatchState, gen: BatchState,
             record: bool = True) -> RoundOutput:
        """One rotation round: verify ``verify``'s staged drafts while
        drafting fresh candidates for ``gen``.

        Mutates both states; on return ``verify.drafts is None`` (the safe
        window for slot surgery) and ``gen`` holds new drafts.
        ``record=False`` skips appending to ``verify.emitted``.
        """
        assert verify.drafts is not None, "verify batch has no staged drafts"
        assert gen.drafts is None, "gen batch already holds drafts"
        t0 = time.perf_counter()
        vstate = {"target_cache": verify.target_cache,
                  "t_next": verify.t_next, "drafts": verify.drafts}
        dstate = {"draft_cache": gen.draft_cache, "t_next": gen.t_next}
        if self.tree is not None:
            vstate["draft_cache"] = verify.draft_cache
        self._count("fused", vstate, dstate)
        tr = self.obs.tracer
        # the fused round does both phases: record it as anti-phase twins,
        # a verify span plus a draft span mirrored over the same interval
        # (bubble accounting unions the overlap)
        with tr.span("target_verify", "verify(fused)", cat="device") as sp:
            if self.tree is not None:
                vout, dout = fused_tree_verify_and_draft(
                    self.tp, self.tcfg, self.dp, self.dcfg, vstate, dstate,
                    self.tree, self.mesh)
            else:
                vout, dout = fused_verify_and_draft(
                    self.tp, self.tcfg, self.dp, self.dcfg, vstate, dstate,
                    self.n_cand, self.mesh)
            sp.fence((vout, dout))
        if tr.enabled:
            tr.complete("draft_generate", "draft(fused)", sp.t0, sp.t1,
                        cat="device")
        if self.tree is not None:
            # batch V's draft cache was compacted inside the fused round
            verify.draft_cache = vout["draft_cache"]
        else:
            # batch V: roll its draft cache back to the accepted prefix
            self._count("rollback", verify.draft_cache,
                        verify.draft_pendings)
            with tr.span("rollback", "rollback", cat="device") as rb:
                verify.draft_cache = rb.fence(rollback_draft(
                    self.dcfg, verify.draft_cache, verify.draft_pendings,
                    vout["n_emitted"]))
        verify.target_cache = vout["target_cache"]
        verify.t_next = vout["t_next"]
        verify.drafts, verify.draft_pendings = None, None
        gen.drafts = dout["drafts"]
        gen.draft_cache = dout["draft_cache"]
        gen.draft_pendings = dout["pendings"]
        # the round's one host synchronisation
        host = torch.cat([vout["tokens"], vout["n_emitted"][:, None],
                          vout["n_accept"][:, None]], dim=1).cpu().numpy()
        m1 = vout["tokens"].shape[1]
        out = RoundOutput(tokens=host[:, :m1], n_emitted=host[:, m1],
                          n_accept=host[:, m1 + 1], t0=t0,
                          t1=time.perf_counter())
        if record:
            verify.emitted.append((out.tokens, out.n_emitted))
        return out

    def run(self, states: list, gen_len: int, max_rounds: int = 10_000):
        """Blocking loop: rotate until every sequence has ``gen_len``
        tokens.  states: two prefilled BatchStates, mutated and returned
        with ``emitted`` filled."""
        s0, s1 = states
        self.warmup(s0)

        def total(st):
            """Guaranteed tokens so far = sum of per-round minima."""
            return int(sum(np.min(np.asarray(n)) for _, n in st.emitted))

        verify, gen = s0, s1
        rounds = 0
        while rounds < max_rounds:
            if total(s0) >= gen_len and total(s1) >= gen_len:
                break
            self.step(verify, gen)
            verify, gen = gen, verify
            rounds += 1
        return s0, s1, rounds
