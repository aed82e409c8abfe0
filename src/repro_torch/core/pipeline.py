"""SpecOffloadEngine — the paper's full system (§3): offline placement
(:func:`repro_torch.core.placement.plan_placement`), the ParaSpec
planner (:meth:`SpecOffloadEngine.plan`), zig-zag microbatched prefill
(§4.1.1) and the dual-batch rotation (§4.1.2).  Counterpart of
``repro/core/pipeline.py``; placement and policy are decisions for the
configured :class:`HardwareSpec`, the weights here stay resident (the
streamed target is :class:`repro_torch.core.offload.OffloadedModel`).

* :meth:`SpecOffloadEngine.prefill_batch` — prefill a prompt batch into
  a fresh :class:`BatchState` (first greedy token staged in ``t_next``).
* :meth:`SpecOffloadEngine.resume` — the state of a sequence resumed
  after a preemption (its prompt prefilled, its emitted tokens decoded).
* :meth:`SpecOffloadEngine.decode_round` — one rotation round.
* :meth:`SpecOffloadEngine.finalize` — assemble the emission logs of the
  two interleaved batches into a dense ``(B, gen_len)`` array.
* :meth:`SpecOffloadEngine.generate` — the three above in one call.

``obs`` (:func:`repro_torch.obs.make_obs`) receives the prefill span
and reaches the pipeline and the planner, as in the JAX package.
``graphs`` reaches the pipeline (:class:`repro_torch.core.interleave.
InterleavedPipeline`: by default the rounds run as CUDA graphs on a card
without a mesh); a pipeline rebuilt for another ``n_cand`` or tree drops
the old one's graphs and their memory pool.  Prefill stays eager.

``mesh`` (:mod:`repro_torch.launch.mesh`): :meth:`SpecOffloadEngine.load`
lays the target and the draft out over it
(:func:`repro_torch.models.model.shard_model`) and every prefill, round
and resume runs on it; each rank runs the same host loop on the same
tokens (the logits every rank reads are the same bits).  The JAX engine
prefills without its mesh, whose parameters are replicated; the port's
are sharded, so its prefill takes the mesh too.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import ModelConfig, resolve_device
from repro_torch.core.interleave import (BatchState, InterleavedPipeline,
                                         RoundOutput)
from repro_torch.core.placement import PlacementPlan, plan_placement
from repro_torch.core.planner import ParaSpecPlanner, Policy, Workload
from repro_torch.models import model as M
from repro_torch.models.model import shard_model
from repro_torch.models.transformer import init_cache
from repro_torch.obs import NULL_OBS
from repro_torch.params import init_params
from repro_torch.sim.hardware import ENV1, HardwareSpec


def required_cache_len(prompt_len: int, gen_len: int, n_cand: int) -> int:
    """Per-sequence KV capacity for a decode of ``gen_len`` tokens: the last
    speculative round can overshoot, and the draft cache briefly holds
    ``n_cand + 1`` uncommitted positions before rollback."""
    return prompt_len + gen_len + 3 * (n_cand + 1) + 4


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, gen_len)
    rounds: int
    accept_counts: list
    policy: Policy
    placement: PlacementPlan


class SpecOffloadEngine:
    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 hw: HardwareSpec = ENV1, policy: Policy | None = None,
                 device="cuda", obs=None, mesh=None, graphs=None):
        self.tcfg = target_cfg
        self.dcfg = draft_cfg
        self.hw = hw
        self.obs = obs if obs is not None else NULL_OBS
        self.policy = policy
        self.placement = plan_placement(target_cfg, draft_cfg, hw)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.graphs = graphs
        self.tp = None
        self.dp = None
        self._pipe: InterleavedPipeline | None = None

    # ------------------------------------------------------------------
    def load(self, target_params, draft_params):
        """Whole parameters; over the mesh each rank keeps its blocks."""
        if self.mesh is not None:
            target_params = shard_model(target_params, self.tcfg, self.mesh)
            draft_params = shard_model(draft_params, self.dcfg, self.mesh)
        self.tp = target_params
        self.dp = draft_params
        self._pipe = None

    def init_from_seed(self, seed: int = 0):
        g = torch.Generator(device=self.device).manual_seed(seed)
        self.load(init_params(self.tcfg, g, self.device),
                  init_params(self.dcfg, g, self.device))

    def plan(self, prompt_len: int, gen_len: int,
             accept_prob: float = 0.7, occupancy: float = 1.0) -> Policy:
        """The ParaSpec policy for this workload on ``hw`` (kept once
        found; a policy given to the constructor wins)."""
        if self.policy is not None:
            return self.policy
        planner = ParaSpecPlanner(self.tcfg, self.dcfg, self.hw,
                                  obs=self.obs)
        rep = planner.search(Workload(prompt_len, gen_len, accept_prob,
                                      occupancy))
        self.policy = rep.policy
        return self.policy

    # ------------------------------------------------------------------
    def _prefill_zigzag(self, params, cfg, tokens, bs_prefill: int,
                        max_len: int):
        """Microbatched prefill (zig-zag §4.1.1): ``bs_prefill`` prompts at
        a time; the chunk caches are then concatenated."""
        b = tokens.shape[0]
        last_logits, caches = [], []
        for i in range(0, b, bs_prefill):
            chunk = tokens[i:i + bs_prefill]
            c = init_cache(cfg, chunk.shape[0], max_len, self.device,
                           self.mesh)
            lg, c = M.prefill(params, cfg, chunk, c, self.mesh)
            last_logits.append(lg)
            caches.append(c)
        if len(caches) == 1:
            return last_logits[0], caches[0]
        return torch.cat(last_logits, 0), _concat_caches(caches)

    # ------------------------------------------------------------------
    def prefill_batch(self, prompts, max_len: int,
                      bs_prefill: int | None = None) -> BatchState:
        """Zig-zag prefill of a ``(B, L)`` prompt batch into a fresh
        :class:`BatchState` with KV capacity ``max_len`` per sequence; the
        first greedy token is staged in ``t_next`` and recorded as the
        first emission."""
        assert self.tp is not None, "call load()/init_from_seed() first"
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                  device=self.device)
        bs_prefill = bs_prefill or max(1, prompts.shape[0])
        with self.obs.tracer.span("prefill", "zigzag_prefill",
                                  cat="device", stream=True) as sp:
            lg, tc = self._prefill_zigzag(self.tp, self.tcfg, prompts,
                                          bs_prefill, max_len)
            _, dc = self._prefill_zigzag(self.dp, self.dcfg, prompts,
                                         bs_prefill, max_len)
            sp.set("batch", int(prompts.shape[0]))
            sp.set("prompt_len", int(prompts.shape[1]))
        return self._first_token(tc, dc, lg)

    def _first_token(self, tc, dc, last_logits) -> BatchState:
        """The state whose first greedy token is read to the host: the
        synchronisation that resolves the tracer's device spans."""
        t0 = torch.argmax(last_logits, dim=-1)
        first = _host(t0)
        self.obs.tracer.resolve(time.perf_counter())
        return BatchState(target_cache=tc, draft_cache=dc, t_next=t0,
                          drafts=None, draft_pendings=None,
                          emitted=[(first[:, None], 1)])

    def resume(self, prompt, progress, max_len: int,
               chunk: int) -> BatchState:
        """B=1 state of a sequence resumed after a preemption: ``prompt``
        prefilled exactly as at its first admission, then the tokens it
        had emitted (``progress``) fed back through decode steps of at
        most ``chunk`` tokens (the verify width), each committed whole;
        ``t_next`` is the target's greedy token after the last of them.

        The JAX engine prefills prompt + progress in one pass instead.
        Where the target's MoE prefill is capacity-bound (Mixtral's
        capacity factor 2 over 8 experts), that pass routes other tokens
        to their experts than the first admission's prefill and the
        decode rounds did, and the resumed stream leaves the greedy one;
        here the prompt keeps its own routing and the emitted tokens go
        through the dropless decode path, as the rounds that emitted
        them did."""
        st = self.prefill_batch(np.asarray(prompt)[None, :], max_len)
        toks = torch.as_tensor(np.asarray(progress)[None], dtype=torch.int64,
                               device=self.device)
        with self.obs.tracer.span("prefill", "resume_decode",
                                  cat="device", stream=True) as sp:
            caches = []
            for params, cfg, cache in ((self.tp, self.tcfg, st.target_cache),
                                       (self.dp, self.dcfg, st.draft_cache)):
                for i in range(0, toks.shape[1], chunk):
                    part = toks[:, i:i + chunk]
                    lg, cache, pend = M.decode(params, cfg, cache, part,
                                               self.mesh)
                    n = part.shape[1]
                    cache = M.commit(cfg, cache, pend, torch.full(
                        (1,), n, dtype=torch.int64, device=self.device), n)
                caches.append((cache, lg[:, -1]))
            sp.set("progress", int(toks.shape[1]))
        (tc, tlast), (dc, _) = caches
        return self._first_token(tc, dc, tlast)

    def pipeline(self, n_cand: int, tree=None) -> InterleavedPipeline:
        """The (cached) dual-batch rotation pipeline for ``n_cand`` — or,
        when ``tree`` (a branching tuple) is given, the tree-mode pipeline
        with that speculation-tree shape."""
        assert self.tp is not None, "call load()/init_from_seed() first"
        tree = tuple(tree) if tree is not None else None
        if (self._pipe is None or self._pipe.n_cand != n_cand
                or self._pipe.tree != tree):
            self._pipe = InterleavedPipeline(self.tp, self.tcfg, self.dp,
                                             self.dcfg, n_cand, tree=tree,
                                             obs=self.obs, mesh=self.mesh,
                                             graphs=self.graphs)
        return self._pipe

    def decode_round(self, verify: BatchState, gen: BatchState,
                     n_cand: int, record: bool = True,
                     tree=None) -> RoundOutput:
        """One rotation round: verify ``verify``, draft for ``gen``."""
        pipe = self.pipeline(n_cand, tree=tree)
        pipe.warmup(verify)
        return pipe.step(verify, gen, record=record)

    def finalize(self, states: list, gen_len: int) -> tuple:
        """Dense ``(B_total, gen_len)`` tokens from the two batches'
        emission logs (+ per-round accept counts)."""
        widths = [int(np.asarray(st.emitted[0][0]).shape[0]) for st in states]
        out = np.zeros((sum(widths), gen_len), np.int32)
        accepts = []
        row0 = 0
        for st, width in zip(states, widths):
            fills = [list() for _ in range(width)]
            for toks, n in st.emitted:
                toks = np.asarray(toks)
                n = np.asarray(n) + np.zeros(toks.shape[0], np.int64)
                for r in range(toks.shape[0]):
                    fills[r].extend(toks[r, :int(n[r])].tolist())
                if toks.shape[1] > 1:
                    accepts.append(n - 1)
            for r, f in enumerate(fills):
                out[row0 + r] = (f + [0] * gen_len)[:gen_len]
            row0 += width
        return out, accepts

    # ------------------------------------------------------------------
    def generate(self, prompts, gen_len: int, n_cand: int = 4,
                 max_len: int | None = None) -> GenerationResult:
        """prompts (B, L) int, split into the two interleaved batches;
        rotate rounds until every sequence has ``gen_len`` tokens.  The
        policy (``self.policy``, else half the batch everywhere and
        ``n_cand``) sets the prefill microbatch and the candidates."""
        assert self.tp is not None, "call load()/init_from_seed() first"
        prompts = np.asarray(prompts)
        b, length = prompts.shape
        pol = self.policy or Policy(bs_prefill=max(1, b // 2),
                                    bs_decode=max(1, b // 2),
                                    bs_draft=max(1, b // 2), n_cand=n_cand)
        m = pol.n_cand
        max_len = max_len or required_cache_len(length, gen_len, m)
        half = b // 2
        states = [self.prefill_batch(bt, max_len, pol.bs_prefill)
                  for bt in (prompts[:half], prompts[half:])]
        s0, s1, rounds = self.pipeline(m).run(states, gen_len)
        out, accepts = self.finalize([s0, s1], gen_len)
        return GenerationResult(out, rounds, accepts, pol, self.placement)


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a CPU tensor's ``numpy()`` shares its
    memory, which the rounds write in place)."""
    return t.cpu().numpy().copy()


def _concat_caches(caches):
    """Concat per-chunk caches over the batch axis."""
    layers = [{k: torch.cat([c["layers"][l][k] for c in caches], 0)
               for k in caches[0]["layers"][l]}
              for l in range(len(caches[0]["layers"]))]
    pos = torch.cat([c["pos"] for c in caches], 0)
    return {"layers": layers, "pos": pos}
