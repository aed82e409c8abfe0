"""ParaSpec Planner (paper §4.3, Appendix A.1).

Maximizes throughput = N_generated / T_generation over the policy
``(bs_prefill, bs_decode, bs_draft, n_cand)`` subject to peak-accelerator-
memory constraints, using the paper's latency/memory model:

  T_generation = T_prefill + T_decoding                      (13)
  T_prefill    = ceil(bs / bs_prefill) * T_prefill_step      (14)  I/O-bound:
  T_prefill_step ~ T_para_C2G (+ compute)                    (15)
  T_decoding   = n_iter * max(T_target_decode, T_draft)      (16)
  T_draft      = ceil(bs/bs_draft) * [T_dprefill + (n_cand-1) T_ddecode] (17)
  T_target     = n_layer * [max(T_attn_host, T_ffn_stream) + T_ffn_gpu] (18)
  T_attn_host  = n_cand_tokens * bs * t_attn_per_token       (19)
  E[n_generated] per Eq. (12) with per-token acceptance p.

Memory (20)-(22): prefill = target params resident + bs_prefill KV slice;
decode = streamed FFN slab + draft params + draft KV.

The planner is pure Python so it can run in the launcher before any
device work, exactly as the paper's offline phase does.  It is the
port's copy of ``repro/core/planner.py`` and gives the same floats; with
``obs`` it records the ``policy_search`` span, the ``replan`` /
``replan_tree`` instants and ``planner_searches_total`` as JAX's does.

Beyond the paper, :class:`Workload` carries an *effective occupancy* term
(fraction of in-flight batch slots holding live requests).  Prefill and
host-attention KV traffic are modelled per live sequence while the
streamed-FFN decode round is paid per slot, so the optimal policy shifts
with occupancy — the continuous-batching scheduler re-runs :meth:`search`
online when its measured occupancy drifts (the JAX package's
``ServingEngine`` does; the port's does not replan yet).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.configs import ModelConfig
from repro_torch.core.spec_decode import (expected_generated,
                                          expected_generated_tree,
                                          tree_layout, tree_n_nodes)
from repro_torch.obs import NULL_OBS
from repro_torch.sim.hardware import HardwareSpec

@dataclass(frozen=True)
class Policy:
    """The gray tuple of the paper's tables (+ optional tree shape)."""
    bs_prefill: int
    bs_decode: int          # per interleaved batch (total = 2x)
    bs_draft: int
    n_cand: int             # draft max new tokens (chain mode)
    tree: tuple | None = None  # speculation-tree branching per depth;
                               # None = linear chain of n_cand drafts

    def astuple(self):
        base = (self.bs_prefill, self.bs_decode, self.bs_draft, self.n_cand)
        return base if self.tree is None else base + (self.tree,)


@dataclass
class Workload:
    prompt_len: int          # S_avg of the dataset
    gen_len: int             # tokens to generate per sequence
    accept_prob: float = 0.7 # per-token draft acceptance probability p
    occupancy: float = 1.0   # effective batch-slot occupancy in (0, 1]:
                             # fraction of in-flight slots holding live
                             # requests (continuous batching keeps this
                             # near 1; padded-wave draining does not)
    kv_bytes_per_seq: float | None = None
                             # measured resident target-KV bytes per live
                             # sequence (the serving engine feeds its
                             # paged-allocator average here); None falls
                             # back to the analytic ctx * bytes/token
                             # model, which over-states int8/paged caches


# ---------------------------------------------------------------------------
# model byte/flop accounting helpers


def layer_ffn_bytes(cfg: ModelConfig, bytes_per: int = 2) -> float:
    """Streamed-per-layer FFN bytes (all experts for MoE — the stream unit)."""
    return cfg._ffn_params() * bytes_per


def layer_attn_bytes(cfg: ModelConfig, bytes_per: int = 2) -> float:
    hd = cfg.head_dim
    n = (cfg.d_model * cfg.n_heads * hd + 2 * cfg.d_model * cfg.n_kv_heads * hd
         + cfg.n_heads * hd * cfg.d_model)
    return n * bytes_per


def kv_bytes_per_token(cfg: ModelConfig, bytes_per: int = 2) -> float:
    return 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * bytes_per


def stored_kv_bytes_per_seq(cfg: ModelConfig, context: int, *,
                            block_size: int | None = None,
                            quant: bool = False,
                            bytes_per: int = 2) -> float:
    """Resident full-attention KV bytes one sequence holds at ``context``
    tokens in the *serving* cache, as actually stored:

    * ``quant`` — int8 values (1 byte/elem) plus a 4-byte f32 absmax
      scale per (token, kv-head) for each of K and V;
    * ``block_size`` — paged storage rounds the context up to the block
      grid (internal fragmentation of the last block).
    """
    tokens = context if block_size is None \
        else -(-context // block_size) * block_size
    elems = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
    if quant:
        per_tok = elems + 2 * cfg.n_layers * cfg.n_kv_heads * 4
    else:
        per_tok = elems * bytes_per
    return float(tokens * per_tok)


def attn_flops_per_token(cfg: ModelConfig, context: int) -> float:
    """Decode attention FLOPs for one query token against `context` KV."""
    return 4 * cfg.n_layers * cfg.n_heads * cfg.head_dim * context


def dense_flops_per_token(cfg: ModelConfig) -> float:
    """Matmul FLOPs per token (active params only for MoE)."""
    return 2 * cfg.active_param_count()


# ---------------------------------------------------------------------------


@dataclass
class PlanReport:
    policy: Policy
    throughput: float
    t_prefill: float
    t_decode: float
    t_target: float
    t_draft: float
    expected_tokens: float
    peak_mem_prefill: float
    peak_mem_decode: float
    feasible: bool
    detail: dict = field(default_factory=dict)


class ParaSpecPlanner:
    """Offline profiling model + online policy search."""

    def __init__(self, target: ModelConfig, draft: ModelConfig,
                 hw: HardwareSpec, bytes_per_param: int = 2, obs=None):
        self.target = target
        self.draft = draft
        self.hw = hw
        self.bp = bytes_per_param
        self.obs = obs if obs is not None else NULL_OBS

    # -- latency model -----------------------------------------------------

    def evaluate(self, pol: Policy, wl: Workload) -> PlanReport:
        cfg, dcfg, hw = self.target, self.draft, self.hw
        bs = pol.bs_decode * 2          # dual-batch rotation: total in flight
        m = pol.n_cand
        # tokens the target forwards per verify pass: the whole flattened
        # tree buffer in tree mode, the chain's n_cand+1 otherwise
        n_verify = tree_n_nodes(pol.tree) if pol.tree else m + 1
        # Effective occupancy: fraction of in-flight slots holding live
        # requests.  Prefill and host-attention KV traffic are paid per
        # *live* sequence; the streamed-FFN decode round is paid per
        # *slot* (dead slots still ride the fused step).  This makes the
        # best policy occupancy-dependent, so the serving engine re-runs
        # the search online when measured occupancy drifts.
        occ = min(max(wl.occupancy, 1e-6), 1.0)
        n_live = bs * occ

        # ---- prefill (Eqs. 14-15): stream whole model once per microbatch
        stream_bytes = cfg.param_bytes(self.bp)
        t_prefill_step = stream_bytes / hw.h2d_bw + (
            wl.prompt_len * pol.bs_prefill * dense_flops_per_token(cfg)
            / hw.accel_flops)
        # KV cache written on accelerator then shipped to host (Table 3 P row)
        kv_ship = (wl.prompt_len * kv_bytes_per_token(cfg, self.bp)
                   / hw.d2h_bw)
        t_prefill = math.ceil(n_live / pol.bs_prefill) * t_prefill_step \
            + n_live * kv_ship

        # ---- decode round (Eqs. 16-19)
        ctx = wl.prompt_len + wl.gen_len / 2
        # host attention (Eq. 19): CPU attention is DRAM-bandwidth bound —
        # each round streams the whole KV working set once (plus compute)
        attn_flops = (n_verify * pol.bs_decode * occ
                      * attn_flops_per_token(cfg, int(ctx)))
        # KV traffic per live sequence: prefer the *measured* resident
        # bytes (the serving engine's paged allocator reports its block-
        # granular average, which reflects int8 storage and block
        # fragmentation) over the analytic bf16-contiguous model
        kv_seq = (wl.kv_bytes_per_seq if wl.kv_bytes_per_seq
                  else ctx * kv_bytes_per_token(cfg, self.bp))
        kv_read = pol.bs_decode * occ * kv_seq
        t_attn_host = max(attn_flops / hw.host_flops,
                          kv_read / (hw.host_mem_bw * hw.host_attn_eff))
        # per-layer FFN stream vs host attention overlap (Eq. 18)
        ffn_per_layer = layer_ffn_bytes(cfg, self.bp)
        t_ffn_stream = cfg.n_layers * ffn_per_layer / hw.h2d_bw
        t_ffn_gpu = (n_verify * pol.bs_decode * dense_flops_per_token(cfg)
                     / hw.accel_flops)
        t_target = max(t_attn_host, t_ffn_stream) + t_ffn_gpu

        # draft generation for the other batch (Eq. 17).  The paper's draft
        # runs *full-sequence* autoregressive inference each round (App.
        # A.2: no persistent draft KV across rounds), so each sub-batch
        # pays a ctx-long prefill plus (m-1) decode steps.  (Our JAX engine
        # keeps a rollback-able draft cache — recorded as a beyond-paper
        # optimization.)
        d_flops = dense_flops_per_token(dcfg)
        d_attn = attn_flops_per_token(dcfg, int(ctx))
        d_bytes = dcfg.param_bytes(self.bp)
        pf = hw.accel_flops_prefill or hw.accel_flops * 1.33
        t_dprefill = max(pol.bs_draft * ctx * d_flops / pf,
                         d_bytes / hw.accel_mem_bw)
        t_ddecode = max(pol.bs_draft * (d_flops + d_attn) / hw.accel_flops,
                        d_bytes / hw.accel_mem_bw)
        if pol.tree:
            # one masked decode pass per tree level; level d feeds
            # prod(branching[:d]) tokens, each either compute- or
            # weight-bandwidth-bound like the chain's decode step
            widths = tree_layout(tuple(pol.tree))["level_sizes"][1:]
            t_levels = sum(
                max(pol.bs_draft * int(w) * (d_flops + d_attn)
                    / hw.accel_flops, d_bytes / hw.accel_mem_bw)
                for w in widths)
            t_draft = math.ceil(pol.bs_decode / pol.bs_draft) * (
                t_dprefill + t_levels)
        else:
            t_draft = math.ceil(pol.bs_decode / pol.bs_draft) * (
                t_dprefill + (m - 1) * t_ddecode)

        t_round = max(t_target, t_draft)
        e_n = (expected_generated_tree(wl.accept_prob, tuple(pol.tree))
               if pol.tree else expected_generated(wl.accept_prob, m))
        n_iter = math.ceil(wl.gen_len / e_n)
        # dual-batch rotation: the target pipeline serves the two
        # interleaved batches in alternating slots -> 2x n_iter slots
        t_decode = 2 * n_iter * t_round

        n_generated = n_live * wl.gen_len
        thr = n_generated / (t_prefill + t_decode)

        # ---- memory (Eqs. 20-22)
        v_prefill = cfg.param_bytes(self.bp) * min(
            1.0, hw.accel_mem_bytes / cfg.param_bytes(self.bp)) * 0 \
            + self._prefill_resident() \
            + pol.bs_prefill * wl.prompt_len * kv_bytes_per_token(cfg, self.bp)
        v_decode = (2 * ffn_per_layer          # current + prefetched layer
                    + dcfg.param_bytes(self.bp)
                    + pol.bs_draft * (wl.prompt_len + wl.gen_len)
                    * kv_bytes_per_token(dcfg, self.bp)
                    + self._act_bytes(pol, n_verify))
        feasible = (v_prefill <= hw.accel_mem_bytes
                    and v_decode <= hw.accel_mem_bytes
                    and cfg.param_bytes(self.bp) <= hw.host_mem_bytes
                    + hw.accel_mem_bytes)

        return PlanReport(
            policy=pol, throughput=thr, t_prefill=t_prefill,
            t_decode=t_decode, t_target=t_target, t_draft=t_draft,
            expected_tokens=e_n, peak_mem_prefill=v_prefill,
            peak_mem_decode=v_decode, feasible=feasible,
            detail={"t_attn_host": t_attn_host, "t_ffn_stream": t_ffn_stream,
                    "t_ffn_gpu": t_ffn_gpu, "n_iter": n_iter,
                    "t_round": t_round})

    def _prefill_resident(self) -> float:
        """Layer slab resident during zig-zag prefill: 2 layers of params."""
        per_layer = (layer_attn_bytes(self.target, self.bp)
                     + layer_ffn_bytes(self.target, self.bp))
        return 2 * per_layer

    def _act_bytes(self, pol: Policy, n_verify: int) -> float:
        cfg = self.target
        return 4 * n_verify * pol.bs_decode * cfg.d_model * 4

    # -- search ------------------------------------------------------------

    def search(self, wl: Workload,
               bs_prefill_grid=(16, 32, 50, 64, 80, 96, 128),
               bs_decode_grid=(32, 64, 128, 160, 192, 256, 320),
               bs_draft_grid=(4, 5, 6, 8, 10, 16),
               n_cand_grid=(1, 2, 4, 6, 8)) -> PlanReport:
        """Exhaustive grid search (the paper's space is small)."""
        best = None
        with self.obs.tracer.span("planner", "policy_search") as sp:
            for bp_ in bs_prefill_grid:
                for bd in bs_decode_grid:
                    for bdr in bs_draft_grid:
                        if bdr > bd:
                            continue
                        for m in n_cand_grid:
                            rep = self.evaluate(Policy(bp_, bd, bdr, m), wl)
                            if not rep.feasible:
                                continue
                            if (best is None
                                    or rep.throughput > best.throughput):
                                best = rep
            if best is not None:
                sp.set("policy", str(best.policy.astuple()))
                sp.set("occupancy", wl.occupancy)
        if best is None:
            raise ValueError("no feasible policy — model too large for host+"
                             "accelerator memory")
        if self.obs.enabled:
            self.obs.tracer.instant(
                "planner", "replan",
                {"bs_prefill": best.policy.bs_prefill,
                 "bs_decode": best.policy.bs_decode,
                 "bs_draft": best.policy.bs_draft,
                 "n_cand": best.policy.n_cand,
                 "occupancy": wl.occupancy,
                 "modeled_throughput": best.throughput})
            self.obs.metrics.counter(
                "planner_searches_total",
                "ParaSpec policy searches (offline + online replans)"
            ).inc(1)
        return best

    def search_spec(self, wl: Workload, tree_grid=None,
                    node_budget: int = 16,
                    bs_draft_grid=(4, 5, 6, 8, 10, 16),
                    **search_kw) -> PlanReport:
        """Joint chain-vs-tree speculation search.

        Runs the chain :meth:`search` first, then re-evaluates the best
        chain policy's batch dimensions with every tree shape in
        ``tree_grid`` (sweeping ``bs_draft`` — tree levels shift the
        draft's compute/bandwidth balance).  ``node_budget`` caps the
        flattened buffer so a wide tree can't blow up the verify pass.
        At low acceptance rates extra siblings raise the chance *some*
        path survives each depth, so trees win; at high acceptance a deep
        chain is optimal and the chain policy comes back unchanged.
        """
        if tree_grid is None:
            tree_grid = TREE_GRID
        best = self.search(wl, **search_kw)
        base = best.policy
        for tree in tree_grid:
            tree = tuple(tree)
            if tree_n_nodes(tree) > node_budget:
                continue
            for bdr in bs_draft_grid:
                if bdr > base.bs_decode:
                    continue
                rep = self.evaluate(
                    Policy(base.bs_prefill, base.bs_decode, bdr,
                           len(tree), tree=tree), wl)
                if rep.feasible and rep.throughput > best.throughput:
                    best = rep
        if self.obs.enabled and best.policy.tree is not None:
            self.obs.tracer.instant(
                "planner", "replan_tree",
                {"tree": str(best.policy.tree),
                 "bs_draft": best.policy.bs_draft,
                 "modeled_throughput": best.throughput})
        return best


#: Tree shapes the online replanner considers (depth-major; every shape
#: stays under the 31-node ancestor-bitmask cap with plenty of margin).
TREE_GRID = ((2,), (3,), (4,), (2, 2), (3, 2), (4, 2), (2, 2, 2), (3, 3))
