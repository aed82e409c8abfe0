"""Continuous-batching request scheduler on top of the SpecOffload engine.

Counterpart of ``repro/serving/engine.py``: paged or contiguous target
KV, chain or tree speculation, FIFO/SJF admission, multi-tenant QoS with
lossless preemption, a virtual or a real clock, online replanning and
request-level observability.

* Each of the two interleaved half-batches is a fixed-shape
  :class:`BatchState` of ``max_batch`` slots, so the fused round runs at
  one input shape signature for the whole serving lifetime
  (``trace_counts["fused"] == 1``); its tensors keep their addresses
  (admission and retirement write them in place), so on a card the
  round runs as CUDA graphs (``SchedulerConfig.graphs``).
* Per-slot sequence state lives on the host.  A sequence retires the
  moment it emits EOS or reaches its own ``max_new_tokens``.
* Freed slots are refilled mid-flight at round boundaries: a queued
  request is prefilled (B=1) on admission and its target KV is scattered
  into blocks granted from the half's pool (full prompt blocks shared
  through the prefix cache), its draft cache copied into the slot.  With
  ``paged=False`` every slot holds a contiguous ``(max_len)`` cache (or
  a recurrent state), bootstrapped with a parked one-token dummy, and
  admission copies the whole B=1 prefill cache into the slot: the
  substrate of targets without full-attention layers (RecurrentGemma,
  RWKV-6).
  Admission happens only while the half's drafts are un-staged, so every
  stream stays token-identical to a target-only greedy decode.
* Requests carry ``arrival_s``; the scheduler admits only arrived
  requests.  On the virtual clock (the default) it fast-forwards over
  idle gaps, so Poisson traces replay deterministically; the real clock
  (``SchedulerConfig(clock="real")``) is wall seconds since the engine
  was built, the asyncio front door's mode
  (:mod:`repro_torch.serving.server`).
* QoS (``qos=True``) orders arrivals by priority class, then by weighted
  per-tenant service time; ``preempt=True`` evicts a long-tail decode
  when a strictly more urgent request waits: its emitted tokens are
  saved as progress, and re-admission prefills the prompt and decodes
  the progress (:meth:`SpecOffloadEngine.resume`), so the resumed greedy
  stream continues exactly where it stopped.
* ``obs`` (:func:`repro_torch.obs.make_obs`): a metrics registry (on by
  default, host-side only: the round's host copy is all it reads), a
  span tracer (off by default; on a card its device spans are timed by
  marks, one-thread kernels that stamp the GPU's clock, read after the
  synchronisations the round makes anyway, and the round's graphs carry
  marks at the verify / draft / rollback boundaries), per-request
  timelines, SLOs and the flight recorder.

Round structure (one :meth:`ServingEngine.run_step`)::

      admit -> [fused verify(half V) + draft(half W)] -> retire -> swap
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.configs import ATTN, ModelConfig, resolve_device
from repro_torch.core.interleave import BatchState
from repro_torch.core.offload import record_transfer
from repro_torch.core.pipeline import SpecOffloadEngine, required_cache_len
from repro_torch.core.planner import (ParaSpecPlanner, Policy, Workload,
                                      kv_bytes_per_token)
from repro_torch.core.spec_decode import (record_acceptance, tree_n_nodes,
                                          tree_supported)
from repro_torch.models.transformer import (admit_sequence_paged, init_cache,
                                            init_paged_cache,
                                            release_slot_paged)
from repro_torch.obs import (NULL_REQUEST_TRACKER, FlightRecorder,
                             RequestTracker, SLOMonitor, as_slos,
                             bubble_report, make_obs)
from repro_torch.obs.metrics import LATENCY_BUCKETS
from repro_torch.serving.paged_kv import BlockAllocator, prefix_block_keys
from repro_torch.sim.hardware import ENV1, HardwareSpec


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int = 32
    arrival_s: float = 0.0        # relative to run() start (trace replay)
    result: np.ndarray | None = None
    latency_s: float = 0.0        # end-to-end: arrival -> finished
    # scheduler-stamped metrics (scheduler clock, seconds)
    admitted_s: float = float("nan")
    first_token_s: float = float("nan")
    finished_s: float = float("nan")
    # QoS (the defaults keep single-tenant runs as they were)
    tenant: str = "default"
    priority: int = 1             # lower value = more urgent class
    progress: list = field(default_factory=list)  # tokens emitted before
                                  # a preemption; re-admission rebuilds
                                  # prompt + progress and resumes exactly
    admitted_prompt: np.ndarray | None = None  # bucket-padded prompt,
                                  # frozen at first admission
    preemptions: int = 0
    rejected: str | None = None   # submit()-time rejection reason
    admitted_run: int = -1        # run-window indices for throughput
    finished_run: int = -1

    @property
    def queue_s(self) -> float:
        """Time spent queued before a slot freed up."""
        return self.admitted_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        """Time to first token (arrival -> prefill argmax available)."""
        return self.first_token_s - self.arrival_s

    @property
    def decode_s(self) -> float:
        """First token -> last token."""
        return self.finished_s - self.first_token_s

    @property
    def tok_per_s(self) -> float:
        n = 0 if self.result is None else len(self.result)
        return n / max(self.latency_s, 1e-9)


@dataclass
class SchedulerConfig:
    """Continuous-batching knobs (see the module docstring)."""
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
    prefill_chunk: int = 8        # zig-zag microbatch size on admission
    replan_threshold: float | None = None  # occupancy drift that triggers
                                  # an online ParaSpec re-search (None: off)
    replan_accept_drift: float | None = None  # measured-acceptance drift
                                  # (EMA over live slots) that triggers a
                                  # chain-vs-tree re-search (None: off)
    replan_interval: int = 32     # rounds between drift checks
    # ---- clock + admission bounds (async front door) ----
    clock: str = "virtual"        # "virtual": trace replay, advances by
                                  # measured wall time and fast-forwards
                                  # idle gaps; "real": wall seconds since
                                  # the engine was built
    max_queue: int | None = None  # bounded admission queue: submit() past
                                  # this depth is a graceful rejection
    # ---- multi-tenant QoS (layered on `admission`) ----
    qos: bool = False             # order arrivals by (priority class,
                                  # weighted per-tenant service time)
    tenant_weights: dict = field(default_factory=dict)  # tenant ->
                                  # fair-share weight (default 1.0)
    preempt: bool = False         # evict long-tail decodes when a strictly
                                  # more urgent request is starved
    preempt_min_remaining: int = 4  # never evict a decode with fewer
                                  # tokens left than this
    # ---- paged KV substrate (target full-attention layers only) ----
    paged: bool = True            # block-table pool instead of per-slot
                                  # contiguous target KV
    block_size: int = 16          # tokens per KV block
    num_blocks: int | None = None # per-half pool size (incl. the scratch
                                  # block 0); None -> every slot can reach
                                  # max_len
    kv_quant_cold: bool = False   # int8-quantize the pool on write (paged)
    prefix_cache: bool = True     # hash-chain dedup of full prompt blocks
    graphs: bool | None = None    # the round as CUDA graphs: None on a
                                  # card, False eager (InterleavedPipeline)
    # ---- observability (repro_torch.obs) ----
    metrics: bool = True          # counter/gauge/histogram registry; reads
                                  # only the round's host copy
    trace: bool = False           # span tracer -> Chrome trace + bubble
                                  # accounting
    trace_annotations: bool = False  # torch.profiler.record_function per span
    request_timeline: bool = False  # per-request phase timelines +
                                  # req:{rid} Chrome tracks (host-side)
    slos: tuple = ()              # declarative objectives (SLO instances or
                                  # plain dicts)
    flight_recorder: bool = True  # always-on ring of round records; dumps
                                  # a postmortem bundle on SLO violations /
                                  # anomaly signals (inactive when all obs
                                  # is off)
    flight_capacity: int = 256    # ring capacity, rounds
    postmortem_dir: str | None = None  # bundle directory (None: triggers
                                  # are counted, nothing touches the disk)
    postmortem_cooldown_s: float = 30.0  # min seconds between bundles
    postmortem_max_bundles: int = 4      # lifetime bundle cap


@dataclass
class _Slot:
    """Host-side state of one cache slot in one interleaved half."""
    req: ServeRequest | None = None
    emitted: list = field(default_factory=list)
    done: bool = True             # True: free (or holding a retired seq)
    blocks: list = field(default_factory=list)  # granted KV blocks
    accept_ema: float = 0.7       # EMA of this sequence's per-round
                                  # acceptance fraction; feeds replanning


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
    path); ``hw`` is the hardware spec the planner and the placement
    plan for."""
    target_cfg: ModelConfig
    draft_cfg: ModelConfig
    hw: HardwareSpec = ENV1
    config: SchedulerConfig = field(default_factory=SchedulerConfig)
    device: str = "cuda"
    engine: SpecOffloadEngine = field(init=False)
    _queue: list = field(default_factory=list)

    def __post_init__(self):
        cfg = self.config
        if cfg.admission not in ("fifo", "sjf"):
            raise ValueError(f"admission must be 'fifo' or 'sjf', got "
                             f"{cfg.admission!r}")
        if cfg.clock not in ("virtual", "real"):
            raise ValueError(f"SchedulerConfig.clock must be 'virtual' or "
                             f"'real', got {cfg.clock!r}")
        if cfg.spec_tree is not None:
            cfg.spec_tree = tuple(cfg.spec_tree)
            for name, mcfg in (("target", self.target_cfg),
                               ("draft", self.draft_cfg)):
                if not tree_supported(mcfg):
                    raise ValueError(
                        f"spec_tree requires an all-attention decoder-only "
                        f"{name} model (layer_pattern="
                        f"{mcfg.layer_pattern!r})")
            tree_n_nodes(cfg.spec_tree)            # validates the node cap
        self.device = resolve_device(self.device)
        self.obs = make_obs(trace=cfg.trace, metrics=cfg.metrics,
                            annotations=cfg.trace_annotations,
                            virtual_clock=lambda: self._now,
                            device=self.device)
        # request-scoped observability: timelines, SLO monitor, flight
        # recorder (host-side; the NULL tracker when off)
        self.requests = (RequestTracker(tracer=self.obs.tracer,
                                        clock=lambda: self._now)
                         if cfg.request_timeline else NULL_REQUEST_TRACKER)
        self._slos = as_slos(cfg.slos)
        self.recorder = None
        if cfg.flight_recorder and (self.obs.enabled or self._slos
                                    or cfg.postmortem_dir
                                    or cfg.request_timeline):
            self.recorder = FlightRecorder(
                capacity=cfg.flight_capacity,
                out_dir=cfg.postmortem_dir,
                cooldown_s=cfg.postmortem_cooldown_s,
                max_bundles=cfg.postmortem_max_bundles)
        self.slo_monitor = (SLOMonitor(self._slos,
                                       metrics=self.obs.metrics,
                                       tracer=self.obs.tracer,
                                       on_violation=self._on_slo_violation)
                            if self._slos else None)
        self.engine = SpecOffloadEngine(self.target_cfg, self.draft_cfg,
                                        self.hw, device=self.device,
                                        obs=self.obs, graphs=cfg.graphs)
        self._halves = None           # two BatchState of max_batch slots
        self._slots = None            # parallel host-side _Slot lists
        self._allocs = None           # per-half BlockAllocator
        self._num_blocks = cfg.num_blocks
        self._blocks_granted_seqs = 0  # paged admissions (avg-blocks metric)
        self._v = 0                   # index of the next verify half
        self._max_len = cfg.max_len
        self._now = 0.0               # scheduler clock (s)
        self._wall_s = 0.0            # accumulated real wall time in run()
        self._rounds = 0
        self._tokens_out = 0
        self._occ_sum = 0.0
        self._occ_window = []
        self._planned_occ = 1.0
        self._accept_window = []
        self._accept_last = None      # latest live-slot acceptance mean
        self._planned_accept = 0.7    # planner's accept_prob default
        self._len_sum, self._gen_sum, self._req_seen = 0, 0, 0
        self.replan_events = []
        self.suggested_policy: Policy | None = None
        self.suggested_tree: tuple | None = None
        # live slot-rounds verified, by accepted drafts (0..depth cap)
        self._accept_hist = np.zeros(self._depth_cap() + 1, np.int64)
        self.round_s = []             # wall seconds of each fused round
        self._real_clock = cfg.clock == "real"
        self._epoch = time.monotonic()   # real-clock zero point
        self._windows = []            # wall seconds of each sealed run()
        self._open_window_s = 0.0     # wall accumulated since last seal
        self._tenant_vtime = {}       # tenant -> weighted service time
        self._tenants_seen = set()
        self.rejected_total = 0
        self.preempted_total = 0
        self.idle_step = False        # last run_step() only ticked clock
        # per-emission hooks for the async front door, called with
        # (request, token) / (request,) as tokens retire
        self.emit_hook = None
        self.finish_hook = None

    # ------------------------------------------------------------------
    def load(self, target_params, draft_params):
        self.engine.load(target_params, draft_params)

    def init_from_seed(self, seed: int = 0):
        self.engine.init_from_seed(seed)

    def submit(self, req: ServeRequest) -> bool:
        """Queue a request.  Never raises: a request that could never fit
        (KV capacity / block pool) or that finds the bounded admission
        queue full is rejected: ``req.rejected`` records why,
        ``serve_requests_rejected_total`` counts it, and False is
        returned."""
        reason = None
        if (self._max_len is not None
                and self._required_len(req) > self._max_len):
            reason = "never_fits"
        elif (self.config.paged and self.config.num_blocks is not None
                and self._required_blocks(req)
                > self.config.num_blocks - 1):
            reason = "never_fits"
        elif (self.config.max_queue is not None
                and len(self._queue) >= self.config.max_queue):
            reason = "queue_full"
        if reason is not None:
            req.rejected = reason
            self.rejected_total += 1
            if self.obs.enabled:
                self.obs.metrics.counter(
                    "serve_requests_rejected_total",
                    "requests rejected at submit (never fits / bounded "
                    "queue full)").inc(1, reason=reason, tenant=req.tenant)
            self.requests.on_reject(req, reason)
            if self.recorder is not None:
                self.recorder.record_instant(
                    "rejected", {"rid": req.rid, "reason": reason,
                                 "tenant": req.tenant})
            return False
        self._tenants_seen.add(req.tenant)
        self.requests.on_submit(req)
        self._queue.append(req)
        return True

    def pending(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------
    # scheduler clock

    def now(self) -> float:
        """Scheduler clock (s): the virtual trace clock, or wall seconds
        since engine construction on the real clock."""
        if self._real_clock:
            self._refresh_now()
        return self._now

    def _refresh_now(self):
        self._now = time.monotonic() - self._epoch

    def _tick(self, dt: float):
        """Advance the clock past a step that took ``dt`` wall seconds
        (the virtual clock adds it; the real clock advances on its own)."""
        if self._real_clock:
            self._refresh_now()
        else:
            self._now += dt

    def has_live(self) -> bool:
        """True while any slot holds an unfinished sequence."""
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
        # the bucket applies to the prompt alone; a preempted request
        # re-prefills prompt + progress with only its remaining tokens
        # left, so the total never exceeds the first reservation
        l = len(req.prompt)
        if self.config.length_bucket:
            b = self.config.length_bucket
            l = -(-l // b) * b
        l += len(req.progress)
        return required_cache_len(l, req.max_new_tokens - len(req.progress),
                                  self._cand_equiv())

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
        self._allocs = [BlockAllocator(nb, obs=self.obs, name=f"h{h}")
                        for h in range(2)]
        self._slots = [[_Slot() for _ in range(cfg.max_batch)]
                       for _ in range(2)]

    def _admission_order(self, arrived: list) -> list:
        if self.config.admission == "sjf":
            arrived = sorted(arrived, key=lambda r: (r.max_new_tokens,
                                                     len(r.prompt)))
        if self.config.qos:
            # priority class first, then weighted fair sharing: tenants
            # are ordered by accumulated service time (charged at
            # admission as (prompt + remaining) / weight); the sort is
            # stable, so the FIFO/SJF key breaks ties
            arrived = sorted(
                arrived,
                key=lambda r: (r.priority,
                               self._tenant_vtime.get(r.tenant, 0.0)))
        return arrived

    def _charge_tenant(self, req: ServeRequest, prompt_len: int):
        w = float(self.config.tenant_weights.get(req.tenant, 1.0))
        cost = (prompt_len + req.max_new_tokens - len(req.progress))
        self._tenant_vtime[req.tenant] = (
            self._tenant_vtime.get(req.tenant, 0.0) + cost / max(w, 1e-9))

    def _try_grant(self, h: int, prompt: np.ndarray,
                   req: ServeRequest) -> tuple | None:
        """Reserve the request's block budget (its remaining tokens) from
        half ``h``, reusing prefix-cached full-prompt blocks.  Returns
        ``(block_ids, n_shared)``, or None while the pool is short (the
        request stays queued)."""
        cfg = self.config
        alloc = self._allocs[h]
        need = required_cache_len(len(prompt),
                                  req.max_new_tokens - len(req.progress),
                                  self._cand_equiv())
        n_need = -(-need // cfg.block_size)
        keys = (prefix_block_keys(prompt, cfg.block_size)
                if cfg.prefix_cache else [])
        shared = []
        for key in keys:
            bid = alloc.lookup(key)
            if bid is None:
                break
            shared.append(bid)
        if not alloc.can_alloc(n_need - len(shared)):
            for bid in shared:           # roll back the prefix refs
                alloc.decref(bid)
            return None
        block_ids = shared + alloc.alloc(n_need - len(shared))
        for j in range(len(shared), len(keys)):
            alloc.register(block_ids[j], keys[j])
        return block_ids, len(shared)

    def _admit_tokens(self, req: ServeRequest) -> np.ndarray:
        """Prefill tokens of a request: its prompt (bucket-padded once,
        then frozen, so a resume re-prefills the identical context)
        extended by any progress saved at preemption."""
        if req.admitted_prompt is None:
            toks = np.asarray(req.prompt, np.int32)
            if self.config.length_bucket:
                b = self.config.length_bucket
                tgt = -(-len(toks) // b) * b
                toks = np.concatenate(
                    [np.full(tgt - len(toks), self.config.pad_id, np.int32),
                     toks])
            req.admitted_prompt = toks
        toks = req.admitted_prompt
        if req.progress:
            toks = np.concatenate([toks, np.asarray(req.progress, np.int32)])
        return toks

    def _admit(self, h: int) -> list:
        """Admit arrived requests into free slots of half ``h``.  Only legal
        while the half's drafts are un-staged.  One request is picked per
        free slot, so the QoS keys (updated by each admission's charge)
        stay fresh."""
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
            if req.admitted_run < 0:
                req.admitted_run = len(self._windows)
            if cfg.qos:
                self._charge_tenant(req, len(prompt))
            t_wall = time.time()
            pt0 = time.perf_counter()
            with self.obs.tracer.span("admit", "admit", stream=True) as asp:
                if req.progress:
                    st = self.engine.resume(req.admitted_prompt,
                                            req.progress, self._max_len,
                                            self._cand_equiv() + 1)
                else:
                    st = self.engine.prefill_batch(prompt[None, :],
                                                   self._max_len,
                                                   cfg.prefill_chunk)
                if cfg.paged:
                    block_ids, n_shared = grant
                    row = np.zeros(self._max_len // cfg.block_size, np.int32)
                    row[:len(block_ids)] = block_ids
                    admit_sequence_paged(self.target_cfg, half.target_cache,
                                         st.target_cache, slot_idx, row,
                                         len(prompt), n_shared)
                    self._blocks_granted_seqs += 1
                else:
                    _splice_slot(half.target_cache, st.target_cache,
                                 slot_idx)
                _splice_slot(half.draft_cache, st.draft_cache, slot_idx)
                asp.set("rid", req.rid)
                asp.set("half", h)
                asp.set("slot", slot_idx)
            t0 = int(st.emitted[0][0][0, 0])
            half.t_next[slot_idx] = t0
            pt1 = time.perf_counter()
            dt = time.time() - t_wall
            self._tick(dt)
            # resumed iff its first token came before (re-admission after
            # a preemption): closes the park interval as queue or
            # preempted time on the request's timeline
            self.requests.on_admit(req, pt0, pt1, half=h, slot=slot_idx,
                                   resumed=not np.isnan(req.first_token_s))
            if self.obs.enabled:
                # the prefilled KV handed to the serving cache
                kv_bytes = len(prompt) * (
                    kv_bytes_per_token(self.target_cfg)
                    + kv_bytes_per_token(self.draft_cfg))
                record_transfer(self.obs, "h2d", kv_bytes, dt,
                                what="kv_splice")
                self.obs.metrics.histogram(
                    "admit_seconds",
                    "wall seconds per admission (prefill + splice)"
                ).observe(dt)
                self.obs.tracer.instant(
                    "admit", "admitted",
                    {"rid": req.rid, "half": h, "slot": slot_idx,
                     "prompt_len": len(prompt)})
            if np.isnan(req.first_token_s):   # not set on re-admission
                req.first_token_s = self._now
                if self.obs.enabled:
                    self.obs.metrics.histogram(
                        "serve_ttft_seconds",
                        "arrival -> first token, labeled per tenant",
                        buckets=LATENCY_BUCKETS).observe(
                            req.ttft_s, tenant=req.tenant)
                if self.slo_monitor is not None:
                    self.slo_monitor.observe_ttft(req)
            slot = slots[slot_idx]
            slot.req = req
            slot.emitted = list(req.progress) + [t0]
            slot.done = False
            slot.blocks = list(grant[0]) if grant else []
            if self.emit_hook is not None:
                self.emit_hook(req, t0)
            self._len_sum += len(prompt)
            self._gen_sum += req.max_new_tokens
            self._req_seen += 1
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
        if self.obs.enabled:
            self.obs.metrics.counter(
                "serve_requests_total",
                "requests completed by the scheduler").inc(1)
            self.obs.tracer.instant(
                "admit", "retired",
                {"rid": req.rid, "half": h, "slot": idx,
                 "tokens": len(req.result)})
        self.requests.on_finish(req)
        if self.slo_monitor is not None:
            self.slo_monitor.observe_finish(
                req, self.requests.timeline(req.rid))
        self._release_slot(h, idx)
        if self.finish_hook is not None:
            self.finish_hook(req)

    def _release_slot(self, h: int, idx: int):
        """Clear a slot and return its KV blocks to the pool (retirement
        and preemption).  The table row and pos are nulled before the
        blocks can be re-granted: the vacated slot keeps riding the fused
        round, and its dead writes must land in the scratch block."""
        slot = self._slots[h][idx]
        slot.req, slot.emitted, slot.done = None, [], True
        if slot.blocks:
            release_slot_paged(self._halves[h].target_cache, idx)
            for bid in slot.blocks:
                self._allocs[h].decref(bid)
            slot.blocks = []

    def preempt(self, h: int, idx: int) -> ServeRequest:
        """Evict the live sequence in slot ``idx`` of half ``h``: its
        emitted tokens are saved as ``req.progress``, its KV blocks return
        to the pool, and the request rejoins the queue (original arrival
        stamp).  Re-admission rebuilds prompt + progress
        (:meth:`SpecOffloadEngine.resume`), so the resumed greedy stream
        continues exactly where it stopped.  Only legal while the half's
        drafts are un-staged."""
        half = self._halves[h]
        assert half.drafts is None, "preemption while drafts staged"
        slot = self._slots[h][idx]
        req = slot.req
        req.progress = list(slot.emitted)
        req.preemptions += 1
        self.preempted_total += 1
        self.requests.on_preempt(req)
        if self.recorder is not None:
            self.recorder.record_instant(
                "preempted", {"rid": req.rid, "tenant": req.tenant,
                              "progress": len(req.progress)})
        self._release_slot(h, idx)
        self._queue.append(req)
        if self.obs.enabled:
            self.obs.metrics.counter(
                "serve_requests_preempted_total",
                "live decodes evicted for higher-priority arrivals "
                "(progress saved, requeued)").inc(1, tenant=req.tenant)
            self.obs.tracer.instant(
                "admit", "preempted",
                {"rid": req.rid, "half": h, "slot": idx,
                 "progress": len(req.progress)})
        return req

    def _maybe_preempt(self, h: int):
        """When a strictly more urgent request waits and half ``h`` has no
        free slot, evict the least urgent live decode with the most
        tokens left, provided it has ``preempt_min_remaining`` to go."""
        slots = self._slots[h]
        if any(s.done for s in slots):
            return                    # a free slot: plain admission wins
        arrived = [r for r in self._queue if r.arrival_s <= self._now]
        if not arrived:
            return
        best = min(r.priority for r in arrived)
        victims = [(s.req.priority,
                    s.req.max_new_tokens - len(s.emitted), i)
                   for i, s in enumerate(slots)
                   if not s.done and s.req.priority > best
                   and (s.req.max_new_tokens - len(s.emitted))
                   >= self.config.preempt_min_remaining]
        if victims:
            _, _, idx = max(victims)
            self.preempt(h, idx)

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
                if self.emit_hook is not None:
                    self.emit_hook(req, tok)
                if ((cfg.eos_id >= 0 and tok == cfg.eos_id)
                        or len(slot.emitted) >= req.max_new_tokens):
                    self._finish(h, idx)
                    finished.append(req)
                    break
        return finished

    # ------------------------------------------------------------------
    # occupancy + online replanning (the planner's effective occupancy)

    def _record_occupancy(self):
        n_active = sum(1 for half in self._slots for s in half if not s.done)
        occ = n_active / (2 * self.config.max_batch)
        self._occ_sum += occ
        self._occ_window.append(occ)

    def _record_acceptance_ema(self, v: int, out):
        """Fold this round's per-slot acceptance fraction into each live
        sequence's EMA and log the live-slot mean for drift checks."""
        cap = self._depth_cap()
        fracs = []
        for idx, slot in enumerate(self._slots[v]):
            if slot.done:
                continue
            frac = float(out.n_accept[idx]) / max(cap, 1)
            slot.accept_ema = 0.8 * slot.accept_ema + 0.2 * frac
            fracs.append(slot.accept_ema)
        if fracs:
            self._accept_last = float(np.mean(fracs))
            self._accept_window.append(self._accept_last)

    def _maybe_replan(self):
        cfg = self.config
        if ((cfg.replan_threshold is None
                and cfg.replan_accept_drift is None)
                or self._rounds % cfg.replan_interval):
            return
        occ, occ_drifted = self._planned_occ, False
        if cfg.replan_threshold is not None and self._occ_window:
            occ = float(np.mean(self._occ_window))
            self._occ_window = []
            occ_drifted = abs(occ - self._planned_occ) > cfg.replan_threshold
        acc, acc_drifted = self._planned_accept, False
        if cfg.replan_accept_drift is not None and self._accept_window:
            acc = float(np.mean(self._accept_window))
            self._accept_window = []
            acc_drifted = (abs(acc - self._planned_accept)
                           > cfg.replan_accept_drift)
        if not (occ_drifted or acc_drifted):
            return
        wl = Workload(prompt_len=max(1, self._len_sum
                                     // max(1, self._req_seen)),
                      gen_len=max(1, self._gen_sum
                                  // max(1, self._req_seen)),
                      accept_prob=min(max(acc, 0.01), 0.99),
                      occupancy=max(occ, 1e-3),
                      kv_bytes_per_seq=self._kv_bytes_per_seq())
        planner = ParaSpecPlanner(self.target_cfg, self.draft_cfg,
                                  self.hw, obs=self.obs)
        # acceptance-aware replans search the joint chain-vs-tree space;
        # occupancy-only replans keep the paper's chain search
        if cfg.spec_tree is not None or cfg.replan_accept_drift is not None:
            rep = planner.search_spec(wl)
        else:
            rep = planner.search(wl)
        self.suggested_policy = rep.policy
        self.suggested_tree = rep.policy.tree
        self._planned_occ, self._planned_accept = occ, acc
        self.replan_events.append({"round": self._rounds, "occupancy": occ,
                                   "accept_rate": acc,
                                   "policy": rep.policy,
                                   "tree": rep.policy.tree,
                                   "throughput": rep.throughput})

    # ------------------------------------------------------------------
    # wall-time windows (throughput attribution)

    def _close_window(self):
        """Seal the open per-run wall window.  run() seals at exit; a
        direct run_step() driver (the async server) seals at drain."""
        if self._open_window_s > 0.0:
            self._windows.append(self._open_window_s)
            self._open_window_s = 0.0

    def _window_wall(self, i: int) -> float:
        return (self._windows[i] if i < len(self._windows)
                else self._open_window_s)

    # ------------------------------------------------------------------
    def run_step(self) -> list:
        """One scheduler iteration: preempt/admit on whichever half has
        un-staged drafts, one fused verify+draft round, retire.

        Reentrant: ``run()`` is a loop over this, and the asyncio front
        door drives it directly (in a worker thread).  Returns the
        requests retired by this step (``emit_hook``/``finish_hook`` fire
        inside).  ``self.idle_step`` is left True when nothing was in
        flight: on the virtual clock the clock fast-forwarded to the next
        arrival; on the real clock the caller should wait for arrivals.
        """
        cfg = self.config
        self.idle_step = False
        if self._halves is None and not self._queue:
            self.idle_step = True
            return []                 # nothing submitted yet: no-op
        self._ensure_halves()
        if self._real_clock:
            self._refresh_now()
        t_step0 = time.time()
        completed = []
        v = self._v
        # one "round" span per iteration, renamed "idle" when the engine
        # is empty, so bubble accounting never counts waiting as stall
        with self.obs.tracer.span("round", "round") as rs:
            for h in (v, 1 - v):
                if self._halves[h].drafts is None:
                    if cfg.preempt:
                        self._maybe_preempt(h)
                    completed += self._admit(h)
            if not self.has_live():
                rs.rename("idle")
                self.idle_step = True
                if self._queue and not self._real_clock:
                    # fast-forward the virtual clock to the next arrival
                    self._now = max(self._now,
                                    min(r.arrival_s for r in self._queue))
                dt = time.time() - t_step0
                self._wall_s += dt
                self._open_window_s += dt
                return completed
            live_v = ([not s.done for s in self._slots[v]]
                      if self.obs.metrics.enabled else None)
            t_wall = time.time()
            out = self.engine.decode_round(self._halves[v],
                                           self._halves[1 - v],
                                           cfg.n_cand, record=False,
                                           tree=cfg.spec_tree)
            self._tick(time.time() - t_wall)
            self.round_s.append(out.t1 - out.t0)
            self._rounds += 1
            self._record_occupancy()
            self._record_acceptance_ema(v, out)
            if self.obs.metrics.enabled:
                self._round_metrics(out, live_v)
            if self.requests.enabled:
                # attribute the fused round to every live request before
                # retirement pops slots: the verified half may have
                # emitted tokens, the anti-phase half got fresh drafts
                rd = self._rounds - 1
                for idx, slot in enumerate(self._slots[v]):
                    if not slot.done:
                        self.requests.on_round(
                            slot.req, rd, out.t0, out.t1,
                            accepted=int(out.n_accept[idx]),
                            emitted=int(out.n_emitted[idx]), role="verify")
                for slot in self._slots[1 - v]:
                    if not slot.done:
                        self.requests.on_round(slot.req, rd, out.t0,
                                               out.t1, role="draft")
            completed += self._process_emissions(v, out)
            self._maybe_replan()
            self._v = 1 - v
        dt = time.time() - t_step0
        self._wall_s += dt
        self._open_window_s += dt
        if self.recorder is not None:
            # black box: one small record per round + anomaly detectors
            # (busy fraction = the fused interval over the round's wall)
            busy_frac = max(0.0, out.t1 - out.t0) / max(dt, 1e-9)
            self.recorder.record_round(
                {"round": self._rounds - 1, "t0": out.t0, "t1": out.t1,
                 "dur_s": dt, "busy_frac": busy_frac,
                 "queue_depth": len(self._queue),
                 "accept_mean": self._accept_last,
                 "tokens_out": self._tokens_out})
            hit = self.recorder.check(accept_mean=self._accept_last,
                                      busy_frac=busy_frac,
                                      queue_depth=len(self._queue))
            if hit is not None:
                self._postmortem(*hit)
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
            if self.idle_step and self._real_clock and self._queue:
                # the real clock cannot fast-forward: sleep toward the
                # next arrival instead of spinning
                gap = min(r.arrival_s for r in self._queue) - self.now()
                if gap > 0:
                    time.sleep(min(gap, 0.05))
        self._close_window()
        # rebase the virtual clock only once fully drained, so stamps of
        # queued or in-flight requests stay on one clock
        if not self._real_clock and not self.has_work():
            self._now = 0.0
        return completed

    # ------------------------------------------------------------------
    # observability: per-round samples + snapshot export

    def _round_metrics(self, out, live_v: list):
        """Per-round registry updates (metrics mode) from the round's host
        copy: no device work."""
        reg = self.obs.metrics
        reg.gauge("serve_queue_depth",
                  "requests waiting for a free slot").set(len(self._queue))
        if self._tenants_seen:
            g = reg.gauge("serve_tenant_queue_depth",
                          "queued requests, labeled per tenant")
            depth: dict = {}
            for r in self._queue:
                depth[r.tenant] = depth.get(r.tenant, 0) + 1
            for t in self._tenants_seen:
                g.set(depth.get(t, 0), tenant=t)
        reg.gauge("serve_occupancy",
                  "fraction of batch slots holding live sequences").set(
                      self._occ_window[-1] if self._occ_window
                      else self._occ_sum / max(1, self._rounds))
        record_acceptance(reg, out.n_accept, self._depth_cap(),
                          live_mask=live_v, n_draft=self._cand_equiv(),
                          mode="tree" if self.config.spec_tree is not None
                          else "chain")

    def _sync_metrics(self):
        """Bring scrape-time gauges/counters up to date: pipeline trace
        counts, allocator block states, lifetime totals."""
        reg = self.obs.metrics
        pipe = self.engine._pipe
        if pipe is not None:
            pipe.export_trace_counts(reg)
        if self._allocs is not None:
            for a in self._allocs:
                a.export_gauges(reg)
        reg.gauge("serve_rounds_total", "decode rounds executed").set(
            self._rounds)
        reg.gauge("serve_tokens_out_total",
                  "tokens emitted to completed requests").set(
                      self._tokens_out)
        reg.gauge("serve_replans_total",
                  "online ParaSpec replans triggered").set(
                      len(self.replan_events))

    def metrics(self) -> dict:
        """``{"metrics": <registry snapshot>}`` plus, when tracing is on,
        ``"utilization"``: the bubble report derived from the spans."""
        self._sync_metrics()
        rep = {"metrics": self.obs.metrics.snapshot()}
        if self.obs.tracer.enabled:
            rep["utilization"] = bubble_report(self.obs.tracer)
        return rep

    def prometheus(self) -> str:
        """Prometheus text exposition of the metrics registry."""
        self._sync_metrics()
        return self.obs.metrics.prometheus_text()

    def chrome_trace(self) -> dict:
        """The recorded spans as Chrome trace-event JSON (Perfetto)."""
        return self.obs.tracer.to_chrome_trace()

    # ------------------------------------------------------------------
    # request timelines, SLOs, flight recorder

    def request_timelines(self) -> list:
        """Final timeline digests of every retired request
        (``SchedulerConfig(request_timeline=True)``; [] otherwise)."""
        return self.requests.timelines()

    def request_timeline(self, rid: int) -> dict | None:
        """One request's timeline digest (provisional while live)."""
        return self.requests.timeline(rid)

    def slo_report(self) -> dict | None:
        """Per-(slo, tenant) compliance + violation log, or None when no
        SLOs are configured."""
        return None if self.slo_monitor is None else self.slo_monitor.report()

    def _on_slo_violation(self, slo, event: dict):
        """SLOMonitor callback: log the violation into the black box and
        dump a postmortem bundle (cooldown/cap limited)."""
        if self.recorder is not None:
            self.recorder.record_instant("slo_violation", dict(event))
            self._postmortem(f"slo_{slo.name}", dict(event))

    def _postmortem(self, reason: str, args: dict | None = None):
        """Dump a flight-recorder bundle; sections are callables so a
        cooldown-suppressed trigger costs nothing."""
        if self.recorder is None:
            return None
        path = self.recorder.trigger(
            reason, args,
            metrics=self.metrics,
            engine=self._engine_digest,
            config=self._config_digest)
        if path is not None and self.obs.enabled:
            self.obs.metrics.counter(
                "postmortem_bundles_total",
                "flight-recorder postmortem bundles dumped").inc(
                    1, reason=reason)
            self.obs.tracer.instant("slo", "postmortem",
                                    {"reason": reason, "path": path})
        return path

    def _engine_digest(self) -> dict:
        """Small JSON engine-state summary for postmortem bundles."""
        live = (sum(1 for half in self._slots for s in half if not s.done)
                if self._slots is not None else 0)
        return {"rounds": self._rounds, "tokens_out": self._tokens_out,
                "queue_depth": len(self._queue), "live": live,
                "wall_s": self._wall_s, "now_s": self._now,
                "rejected": self.rejected_total,
                "preempted": self.preempted_total,
                "mean_occupancy": self._occ_sum / max(1, self._rounds),
                "accept_mean": self._accept_last,
                "spec_mode": ("tree" if self.config.spec_tree is not None
                              else "chain")}

    def _config_digest(self) -> dict:
        """Scheduler config as plain JSON."""
        d = asdict(self.config)
        d["slos"] = [s.to_dict() for s in self._slos]
        return d

    # ------------------------------------------------------------------
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

    def _kv_bytes_per_seq(self) -> float | None:
        """Average resident target-KV bytes per admitted sequence (block
        granularity; None before any paged admission)."""
        if (not self.config.paged or self._allocs is None
                or not self._blocks_granted_seqs):
            return None
        ks = self.kv_stats()
        granted = sum(a.granted_total for a in self._allocs)
        return ks["bytes_per_block"] * granted / self._blocks_granted_seqs

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
            "graph_captures": ({} if pipe is None
                               else dict(pipe.graph_captures)),
            "capture_s": 0.0 if pipe is None else pipe.capture_s,
            "graph_nodes": ({} if pipe is None
                            else dict(pipe.graph_nodes)),
            "rejected": self.rejected_total,
            "preempted": self.preempted_total,
            "replans": len(self.replan_events),
            "slo_violations": (len(self.slo_monitor.violations)
                               if self.slo_monitor is not None else 0),
            "postmortems": (len(self.recorder.bundles)
                            if self.recorder is not None else 0),
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
