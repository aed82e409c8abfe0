"""Continuous-batching request scheduler on top of the SpecOffload engine.

Counterpart of the core of ``repro/serving/engine.py``: paged or
contiguous target KV, chain or tree speculation, FIFO/SJF admission on a
virtual clock.

* Each of the two interleaved half-batches is a fixed-shape
  :class:`BatchState` of ``max_batch`` slots, so the fused round runs at
  one input shape signature for the whole serving lifetime
  (``trace_counts["fused"] == 1``).
* Per-slot sequence state lives on the host.  A sequence retires the
  moment it emits EOS or reaches its own ``max_new_tokens``.
* Freed slots are refilled mid-flight at round boundaries: a queued
  request is prefilled (B=1) on admission and its target KV is scattered
  into blocks granted from the half's pool (full prompt blocks shared
  through the prefix cache), its draft ring copied into the slot.  With
  ``paged=False`` every slot holds a contiguous ``(max_len)`` cache (or
  a recurrent state), bootstrapped with a parked one-token dummy, and
  admission copies the whole B=1 prefill cache into the slot: the
  substrate of targets without full-attention layers (RecurrentGemma,
  RWKV-6).
  Admission happens only while the half's drafts are un-staged, so every
  stream stays token-identical to a target-only greedy decode.
* Requests carry ``arrival_s``; the scheduler admits only arrived
  requests and fast-forwards its virtual clock over idle gaps, so
  Poisson traces replay deterministically.

Round structure (one :meth:`ServingEngine.run_step`)::

      admit -> [fused verify(half V) + draft(half W)] -> retire -> swap
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import ATTN, ModelConfig, resolve_device
from repro_torch.core.interleave import BatchState
from repro_torch.core.pipeline import SpecOffloadEngine, required_cache_len
from repro_torch.core.spec_decode import tree_n_nodes, tree_supported
from repro_torch.kernels.decode_attention import max_rows
from repro_torch.models.transformer import (admit_sequence_paged, init_cache,
                                            init_paged_cache,
                                            release_slot_paged)
from repro_torch.serving.paged_kv import BlockAllocator, prefix_block_keys


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    arrival_s: float = 0.0        # relative to run() start (trace replay)
    result: np.ndarray | None = None
    latency_s: float = 0.0        # end-to-end: arrival -> finished
    # scheduler-stamped metrics (virtual clock, seconds from run() start)
    admitted_s: float = float("nan")
    first_token_s: float = float("nan")
    finished_s: float = float("nan")
    admitted_prompt: np.ndarray | None = None  # bucket-padded prompt
    rejected: str | None = None   # submit()-time rejection reason
    admitted_run: int = -1        # run-window indices for throughput
    finished_run: int = -1

    @property
    def queue_s(self) -> float:
        return self.admitted_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s


@dataclass
class SchedulerConfig:
    """Continuous-batching knobs the port supports (paged or contiguous
    KV, chain or tree speculation, virtual clock)."""
    max_batch: int = 8            # slots per interleaved half (total 2x)
    n_cand: int = 4               # draft candidates per round (chain mode)
    spec_tree: tuple | None = None  # speculation-tree branching per depth
                                  # (e.g. (3, 2)); None keeps the linear
                                  # chain of n_cand drafts.  Requires all-
                                  # attention target AND draft models.
    eos_id: int = -1              # -1: never stop early
    admission: str = "fifo"       # "fifo" | "sjf" (shortest job first)
    length_bucket: int | None = None   # left-pad admitted prompts up to a
                                  # multiple of this; outputs condition on
                                  # the padded prompt
    pad_id: int = 0
    max_len: int | None = None    # per-slot KV capacity; derived from the
                                  # queue at first run() when None
    paged: bool = True            # block-table pool instead of per-slot
                                  # contiguous target KV
    block_size: int = 16          # tokens per KV block
    num_blocks: int | None = None # per-half pool size (incl. the scratch
                                  # block 0); None -> every slot can reach
                                  # max_len
    kv_quant_cold: bool = False   # int8-quantize the pool on write (paged)


@dataclass
class _Slot:
    """Host-side state of one cache slot in one interleaved half."""
    req: ServeRequest | None = None
    emitted: list = field(default_factory=list)
    done: bool = True             # True: free (or holding a retired seq)
    blocks: list = field(default_factory=list)  # granted KV blocks


def latency_percentiles(done: list, attr: str = "latency_s",
                        ps=(50, 95, 99)) -> dict:
    """p50/p95/p99 (seconds) of a per-request metric over completed reqs."""
    vals = np.asarray([getattr(r, attr) for r in done], np.float64)
    if vals.size == 0:
        return {f"p{p}": float("nan") for p in ps}
    return {f"p{p}": float(np.percentile(vals, p)) for p in ps}


@dataclass
class ServingEngine:
    """Continuous-batching front door; see the module docstring.  Runs
    on ``device`` (default ``"cuda"``; pass ``"cpu"`` for the plain
    path)."""
    target_cfg: ModelConfig
    draft_cfg: ModelConfig
    config: SchedulerConfig = field(default_factory=SchedulerConfig)
    device: str = "cuda"
    engine: SpecOffloadEngine = field(init=False)
    _queue: list = field(default_factory=list)

    def __post_init__(self):
        if self.config.admission not in ("fifo", "sjf"):
            raise ValueError(f"admission must be 'fifo' or 'sjf', got "
                             f"{self.config.admission!r}")
        if self.config.spec_tree is not None:
            self.config.spec_tree = tuple(self.config.spec_tree)
            for name, cfg in (("target", self.target_cfg),
                              ("draft", self.draft_cfg)):
                if not tree_supported(cfg):
                    raise ValueError(
                        f"spec_tree requires an all-attention decoder-only "
                        f"{name} model (layer_pattern="
                        f"{cfg.layer_pattern!r})")
            n_nodes = tree_n_nodes(self.config.spec_tree)  # the node cap
            # the target verifies the whole buffer in one verify-kernel
            # call (the draft feeds it a level at a time, the root alone)
            tc = self.target_cfg
            rows = (tc.n_heads // tc.n_kv_heads) * n_nodes
            if rows > max_rows(tc.head_dim):
                raise ValueError(
                    f"spec_tree {self.config.spec_tree} has {n_nodes} "
                    f"nodes: the verify kernels hold (Hq / Hkv) * n_nodes "
                    f"= {rows} query rows, at most {max_rows(tc.head_dim)} "
                    f"at head dim {tc.head_dim}")
        self.device = resolve_device(self.device)
        self.engine = SpecOffloadEngine(self.target_cfg, self.draft_cfg,
                                        device=self.device)
        self._halves = None           # two BatchState of max_batch slots
        self._slots = None            # parallel host-side _Slot lists
        self._allocs = None           # per-half BlockAllocator
        self._num_blocks = self.config.num_blocks
        self._v = 0                   # index of the next verify half
        self._max_len = self.config.max_len
        self._now = 0.0               # virtual clock (s since run() start)
        self._wall_s = 0.0            # accumulated real wall time in run()
        self._rounds = 0
        self._tokens_out = 0
        self._occ_sum = 0.0
        # live slot-rounds verified, by accepted drafts (0..depth cap)
        self._accept_hist = np.zeros(self._depth_cap() + 1, np.int64)
        self.round_s = []             # wall seconds of each fused round
        self._windows = []            # wall seconds of each sealed run()
        self._open_window_s = 0.0
        self.rejected_total = 0

    # ------------------------------------------------------------------
    def load(self, target_params, draft_params):
        self.engine.load(target_params, draft_params)

    def init_from_seed(self, seed: int = 0):
        self.engine.init_from_seed(seed)

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request.  A request that could never fit (KV capacity /
        block pool) is rejected: ``req.rejected`` records why and False is
        returned."""
        if ((self._max_len is not None
                and self._required_len(req) > self._max_len)
                or (self.config.paged and self.config.num_blocks is not None
                    and self._required_blocks(req)
                    > self.config.num_blocks - 1)):
            req.rejected = "never_fits"
            self.rejected_total += 1
            return False
        self._queue.append(req)
        return True

    def pending(self) -> int:
        return len(self._queue)

    def has_live(self) -> bool:
        return (self._slots is not None
                and any(not s.done for half in self._slots for s in half))

    def has_work(self) -> bool:
        return self.has_live() or bool(self._queue)

    def _cand_equiv(self) -> int:
        """Per-round uncommitted-token budget for cache sizing: tree mode
        stages the whole flattened buffer (n_nodes rows, root included),
        chain mode n_cand drafts + the root."""
        if self.config.spec_tree is not None:
            return tree_n_nodes(self.config.spec_tree) - 1
        return self.config.n_cand

    def _depth_cap(self) -> int:
        """Max accepted draft tokens per verify round (the deepest
        root-to-leaf path in tree mode, n_cand in chain mode)."""
        if self.config.spec_tree is not None:
            return len(self.config.spec_tree)
        return self.config.n_cand

    def _required_len(self, req: ServeRequest) -> int:
        l = len(req.prompt)
        if self.config.length_bucket:
            b = self.config.length_bucket
            l = -(-l // b) * b
        return required_cache_len(l, req.max_new_tokens, self._cand_equiv())

    def _required_blocks(self, req: ServeRequest) -> int:
        return -(-self._required_len(req) // self.config.block_size)

    # ------------------------------------------------------------------
    # slot bootstrap / admission

    def _ensure_halves(self):
        if self._halves is not None:
            return
        cfg = self.config
        if self._max_len is None:
            if not self._queue:
                raise ValueError("run() with an empty queue and no "
                                 "SchedulerConfig.max_len to size caches")
            self._max_len = max(self._required_len(r) for r in self._queue)
        if not cfg.paged:
            # park a 1-token dummy sequence in every slot: shapes are fixed
            # for the serving lifetime, requests are spliced in by _admit
            dummy = np.zeros((cfg.max_batch, 1), np.int32)
            self._halves = [self.engine.prefill_batch(dummy, self._max_len,
                                                      cfg.max_batch)
                            for _ in range(2)]
            self._slots = [[_Slot() for _ in range(cfg.max_batch)]
                           for _ in range(2)]
            return
        # a block multiple, so the (B=1, max_len) prefill caches and the
        # paged serving caches agree on every non-ATTN leaf shape
        bs = cfg.block_size
        self._max_len = -(-self._max_len // bs) * bs
        mbs = self._max_len // bs
        if self._num_blocks is None:
            self._num_blocks = 1 + cfg.max_batch * mbs
        nb = self._num_blocks
        self._halves = []
        for _ in range(2):
            tc = init_paged_cache(self.target_cfg, cfg.max_batch, nb, bs, mbs,
                                  kv_quant=True if cfg.kv_quant_cold
                                  else None, device=self.device)
            dc = init_cache(self.draft_cfg, cfg.max_batch, self._max_len,
                            self.device)
            self._halves.append(BatchState(
                target_cache=tc, draft_cache=dc,
                t_next=torch.zeros((cfg.max_batch,), dtype=torch.int64,
                                   device=self.device),
                drafts=None, draft_pendings=None, emitted=[]))
        self._allocs = [BlockAllocator(nb, name=f"h{h}") for h in range(2)]
        self._slots = [[_Slot() for _ in range(cfg.max_batch)]
                       for _ in range(2)]

    def _admission_order(self, arrived: list) -> list:
        if self.config.admission == "sjf":
            return sorted(arrived, key=lambda r: (r.max_new_tokens,
                                                  len(r.prompt)))
        return arrived

    def _try_grant(self, h: int, prompt: np.ndarray,
                   req: ServeRequest) -> tuple | None:
        """Reserve the request's full block budget from half ``h``,
        reusing prefix-cached full-prompt blocks.  Returns
        ``(block_ids, n_shared)``, or None while the pool is short (the
        request stays queued)."""
        cfg = self.config
        alloc = self._allocs[h]
        need = required_cache_len(len(prompt), req.max_new_tokens,
                                  self._cand_equiv())
        n_need = -(-need // cfg.block_size)
        keys = prefix_block_keys(prompt, cfg.block_size)
        shared = []
        for key in keys:
            bid = alloc.lookup(key)
            if bid is None:
                break
            shared.append(bid)
        if not alloc.can_alloc(n_need - len(shared)):
            for bid in shared:
                alloc.decref(bid)
            return None
        block_ids = shared + alloc.alloc(n_need - len(shared))
        for j in range(len(shared), len(keys)):
            alloc.register(block_ids[j], keys[j])
        return block_ids, len(shared)

    def _admit_tokens(self, req: ServeRequest) -> np.ndarray:
        """Prefill tokens of a request: its prompt, bucket-padded once."""
        if req.admitted_prompt is None:
            toks = np.asarray(req.prompt, np.int32)
            if self.config.length_bucket:
                b = self.config.length_bucket
                tgt = -(-len(toks) // b) * b
                toks = np.concatenate(
                    [np.full(tgt - len(toks), self.config.pad_id, np.int32),
                     toks])
            req.admitted_prompt = toks
        return req.admitted_prompt

    def _admit(self, h: int) -> list:
        """Admit arrived requests into free slots of half ``h``.  Only legal
        while the half's drafts are un-staged."""
        half, slots = self._halves[h], self._slots[h]
        assert half.drafts is None, "admission while drafts staged"
        cfg = self.config
        finished = []
        free = [i for i, s in enumerate(slots) if s.done]
        while free and self._queue:
            arrived = [r for r in self._queue if r.arrival_s <= self._now]
            picked = None
            for req in self._admission_order(arrived):
                prompt = self._admit_tokens(req)
                grant = None
                if cfg.paged:
                    grant = self._try_grant(h, prompt, req)
                    if grant is None:    # block pressure: stays queued
                        continue
                picked = (req, prompt, grant)
                break
            if picked is None:
                break
            req, prompt, grant = picked
            slot_idx = free.pop(0)
            self._queue.remove(req)
            req.admitted_s = self._now
            req.admitted_run = len(self._windows)
            t_wall = time.time()
            st = self.engine.prefill_batch(prompt[None, :], self._max_len)
            if cfg.paged:
                block_ids, n_shared = grant
                row = np.zeros(self._max_len // cfg.block_size, np.int32)
                row[:len(block_ids)] = block_ids
                admit_sequence_paged(self.target_cfg, half.target_cache,
                                     st.target_cache, slot_idx, row,
                                     len(prompt), n_shared)
            else:
                _splice_slot(half.target_cache, st.target_cache, slot_idx)
            _splice_slot(half.draft_cache, st.draft_cache, slot_idx)
            t0 = int(st.emitted[0][0][0, 0])
            half.t_next[slot_idx] = t0
            self._now += time.time() - t_wall
            req.first_token_s = self._now
            slot = slots[slot_idx]
            slot.req, slot.emitted, slot.done = req, [t0], False
            slot.blocks = list(grant[0]) if grant else []
            # a 1-token request (or instant EOS) finishes at admission
            if ((cfg.eos_id >= 0 and t0 == cfg.eos_id)
                    or len(slot.emitted) >= req.max_new_tokens):
                self._finish(h, slot_idx)
                finished.append(req)
        return finished

    def _finish(self, h: int, idx: int):
        slot = self._slots[h][idx]
        req = slot.req
        req.result = np.asarray(slot.emitted, np.int32)
        req.finished_s = self._now
        req.finished_run = len(self._windows)
        req.latency_s = self._now - req.arrival_s
        self._tokens_out += len(req.result)
        self._release_slot(h, idx)

    def _release_slot(self, h: int, idx: int):
        """Clear a slot and return its KV blocks to the pool.  The table
        row and pos are nulled before the blocks can be re-granted: the
        vacated slot keeps riding the fused round, and its dead writes
        must land in the scratch block."""
        slot = self._slots[h][idx]
        slot.req, slot.emitted, slot.done = None, [], True
        if slot.blocks:
            release_slot_paged(self._halves[h].target_cache, idx)
            for bid in slot.blocks:
                self._allocs[h].decref(bid)
            slot.blocks = []

    def _process_emissions(self, h: int, out) -> list:
        """Append this round's verified tokens to each live slot, stopping
        per sequence at EOS or its own length."""
        cfg = self.config
        finished = []
        for idx, slot in enumerate(self._slots[h]):
            if slot.done:
                continue
            req = slot.req
            self._accept_hist[int(out.n_accept[idx])] += 1
            for t in out.tokens[idx, :int(out.n_emitted[idx])]:
                tok = int(t)
                slot.emitted.append(tok)
                if ((cfg.eos_id >= 0 and tok == cfg.eos_id)
                        or len(slot.emitted) >= req.max_new_tokens):
                    self._finish(h, idx)
                    finished.append(req)
                    break
        return finished

    # ------------------------------------------------------------------
    def run_step(self) -> list:
        """One scheduler iteration: admit on whichever half has un-staged
        drafts, one fused verify+draft round, retire.  Returns the
        requests retired by this step."""
        if self._halves is None and not self._queue:
            return []
        self._ensure_halves()
        t_step0 = time.time()
        completed = []
        v = self._v
        for h in (v, 1 - v):
            if self._halves[h].drafts is None:
                completed += self._admit(h)
        if not self.has_live():
            if self._queue:      # fast-forward to the next arrival
                self._now = max(self._now,
                                min(r.arrival_s for r in self._queue))
        else:
            t_wall = time.time()
            out = self.engine.decode_round(self._halves[v],
                                           self._halves[1 - v],
                                           self.config.n_cand, record=False,
                                           tree=self.config.spec_tree)
            self._now += time.time() - t_wall
            self.round_s.append(out.t1 - out.t0)
            self._rounds += 1
            self._occ_sum += (sum(1 for half in self._slots for s in half
                                  if not s.done)
                              / (2 * self.config.max_batch))
            completed += self._process_emissions(v, out)
            self._v = 1 - v
        dt = time.time() - t_step0
        self._wall_s += dt
        self._open_window_s += dt
        return completed

    def run(self, max_rounds: int = 100_000) -> list:
        """Serve until the queue and all in-flight sequences drain.
        Returns the requests completed by this call (retirement order)."""
        if self._halves is None and not self._queue:
            return []
        self._ensure_halves()
        completed = []
        for _ in range(max_rounds):
            completed += self.run_step()
            if not self.has_work():
                break
        if self._open_window_s > 0.0:
            self._windows.append(self._open_window_s)
            self._open_window_s = 0.0
        # rebase the virtual clock only once fully drained, so stamps of
        # queued or in-flight requests stay on one clock
        if not self.has_work():
            self._now = 0.0
        return completed

    # ------------------------------------------------------------------
    def _window_wall(self, i: int) -> float:
        return (self._windows[i] if i < len(self._windows)
                else self._open_window_s)

    def throughput(self, done: list | None = None) -> float:
        """Tokens/s over the engine's wall time, or, for a subset of
        completed requests, over the run windows those requests spanned."""
        if done is None:
            return self._tokens_out / max(self._wall_s, 1e-9)
        toks = sum(len(r.result) for r in done if r.result is not None)
        wins: set = set()
        for r in done:
            if r.finished_run >= 0:
                wins.update(range(max(r.admitted_run, 0),
                                  r.finished_run + 1))
        return toks / max(sum(self._window_wall(w) for w in wins), 1e-9)

    def _attn_cache_bytes(self, cache: dict) -> int:
        return sum(t.numel() * t.element_size()
                   for l, layer in enumerate(cache["layers"])
                   if self.target_cfg.layer_kind(l) == ATTN
                   for t in layer.values())

    def kv_stats(self) -> dict:
        """KV accounting for the target's full-attention layers: the
        serving-lifetime high-water mark of granted blocks when paged, the
        whole (B, max_len) caches when contiguous (every slot is always
        materialized there)."""
        if self._halves is None:
            return {}
        if not self.config.paged:
            full = float(sum(self._attn_cache_bytes(hf.target_cache)
                             for hf in self._halves))
            return {"paged": False, "pool_bytes_total": full,
                    "peak_kv_bytes": full}
        pool_bytes = self._attn_cache_bytes(self._halves[0].target_cache)
        per_block = pool_bytes / self._num_blocks
        peak = sum(a.peak_used for a in self._allocs)
        return {"paged": True, "block_size": self.config.block_size,
                "num_blocks_per_half": self._num_blocks,
                "bytes_per_block": per_block,
                "pool_bytes_total": 2.0 * pool_bytes,
                "peak_blocks_in_use": peak,
                "peak_kv_bytes": peak * per_block,
                "prefix_hits": sum(a.prefix_hits for a in self._allocs),
                "prefix_evictions": sum(a.evictions for a in self._allocs),
                "allocators": [a.stats() for a in self._allocs]}

    def stats(self) -> dict:
        """Engine-level serving metrics."""
        pipe = self.engine._pipe
        rs = np.asarray(self.round_s, np.float64)
        hist = self._accept_hist
        return {
            "rounds": self._rounds,
            "tokens_out": self._tokens_out,
            "wall_s": self._wall_s,
            "mean_occupancy": self._occ_sum / max(1, self._rounds),
            "tok_per_s": self._tokens_out / max(self._wall_s, 1e-9),
            "round_s_p50": float(np.percentile(rs, 50)) if rs.size
            else float("nan"),
            "round_s_p95": float(np.percentile(rs, 95)) if rs.size
            else float("nan"),
            "acceptance": (float(hist @ np.arange(hist.size))
                           / max(1, hist.sum() * self._depth_cap())),
            "accept_hist": hist.tolist(),
            "fused_compiles": 0 if pipe is None
            else pipe.trace_counts["fused"],
            "rejected": self.rejected_total,
            "spec_mode": ("tree" if self.config.spec_tree is not None
                          else "chain"),
            "spec_tree": self.config.spec_tree,
            "kv": self.kv_stats(),
        }


def _splice_slot(big: dict, small: dict, slot: int) -> None:
    """In place: copy sequence 0 of a (B=1) prefill cache into batch slot
    ``slot`` of a serving cache, for every layer leaf and ``pos``."""
    for big_l, small_l in zip(big["layers"], small["layers"]):
        for key in big_l:
            big_l[key][slot] = small_l[key][0]
    big["pos"][slot] = small["pos"][0]
