"""Interleaved Batch Pipeline (paper §4.1): dual-batch rotation, chain or
tree mode.

Counterpart of ``repro/core/interleave.py``.  In slot t_n the target
verifies batch V's drafts while the draft model generates candidates for
batch D; the roles swap in t_{n+1}.  The JAX package jits each of its
three entry points once (the fused round, the draft warmup, the
rollback); here each runs as a CUDA graph on the card, one stream, the
counterpart of that one program (overlapping draft and verify on two
streams is later work).

All shapes inside a round are fixed by ``(batch, n_cand)``, or by
``(batch, tree)`` in tree mode, where the staged drafts are the (B, N)
BFS token buffer of a speculation tree and both caches of batch V are
compacted to the accepted path inside the fused round (no separate
rollback).
``trace_counts["fused"]`` counts the distinct input shape signatures the
fused round has seen, the JAX package's compile count: a shape-stable
server keeps it at 1.

Graphs (``InterleavedPipeline(graphs=...)``).  A graph replays the
addresses it captured, so a round reads and writes its
:class:`BatchState` in place: the caches (``pos`` included), ``t_next``,
and buffers the state's first round makes for what outlives a round
(the staged drafts, the draft steps' rollback pendings, the round's
output row).  Nothing a later round reads stays in the graphs' memory
pool, which every graph of a pipeline shares and overwrites.  An entry
point runs eagerly the first time it meets a key (its input shapes and
the addresses of every tensor it touches): real work, and the warmup
that builds the kernels outside any capture; the second time the key is
captured and replayed at once, later times replayed.  The rotation swaps
the halves, so each entry sees two keys.  A round over a mesh stays
eager (gloo's collectives run on the host and cannot be captured).
Each round reads its tokens to the host once, after the replay, and
that is its only synchronisation.  A tracer with a stamp source (``obs``,
off by default; :mod:`repro_torch.obs.trace`) adds none: the fused
round puts marks at its start, at the verify / draft boundary and at its
end, the rollback at its start and end (captured into the graphs only
when the tracer is on), and the tracer reads them after the round's host
read.  Each replay is a host span on the ``launch`` track.
"""
from __future__ import annotations

import ctypes
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
from repro_torch.kernels import _build, add_launches, launch_counts
from repro_torch.models import model as M
from repro_torch.obs import NULL_OBS


@dataclass
class BatchState:
    """Per-interleaved-batch decoding state, read and written in place
    at fixed addresses (see the module's docstring): ``drafts`` and
    ``draft_pendings`` are the staged flags, ``draft_buf`` and
    ``pend_buf`` while drafts await verification and None otherwise."""
    target_cache: dict
    draft_cache: dict
    t_next: torch.Tensor         # (B,) last committed token (not yet fed)
    drafts: torch.Tensor | None  # (B, m) candidates awaiting verification
                                 # ((B, N) tree buffer in tree mode)
    draft_pendings: list | None  # rollback info for the draft steps
    emitted: list                # host-side: list of (tokens, n_emitted)
    draft_buf: torch.Tensor | None = None  # the drafts' storage
    pend_buf: list | None = None           # the pendings' storage
    out_buf: torch.Tensor | None = None    # (B, W + 2): the tokens, n_emitted
                                 # and n_accept of the round that verified
                                 # this batch last


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
                           n_cand: int, mesh=None, mark=None):
    """The fused round: the target verifies batch V's drafts while the
    draft model generates candidates for batch D.

    verify_state: {target_cache, t_next, drafts}
    draft_state:  {draft_cache, t_next}
    ``mark``: called with "draft_begin" between the target's commit and
    the draft's passes (the tracer's boundary mark).
    Returns (verify_out, draft_out).
    """
    drafts = verify_state["drafts"]
    v_in = torch.cat([verify_state["t_next"][:, None], drafts], dim=1)
    tlogits, tcache, tpend = M.decode(target_params, target_cfg,
                                      verify_state["target_cache"], v_in,
                                      mesh)
    a, nxt, n_commit = greedy_acceptance(drafts, tlogits)
    tcache = M.commit(target_cfg, tcache, tpend, n_commit, n_cand + 1)
    if mark is not None:
        mark("draft_begin")

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
                                branching: tuple, mesh=None, mark=None):
    """Tree-mode fused round: the target verifies batch V's speculation
    tree (ancestor-masked, one forward over all ``n_nodes`` buffer rows)
    while the draft expands a fresh tree for batch D (``mark`` as in
    :func:`fused_verify_and_draft`).

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
    if mark is not None:
        mark("draft_begin")

    drafts, _, dcache = draft_tree_generate(
        draft_params, draft_cfg, draft_state["draft_cache"],
        draft_state["t_next"], branching, mesh)
    verify_out = {"target_cache": tcache, "draft_cache": vdcache,
                  "tokens": out, "n_emitted": a + 1, "t_next": nxt,
                  "n_accept": a}
    draft_out = {"drafts": drafts, "draft_cache": dcache, "pendings": None}
    return verify_out, draft_out


def _signature(*trees, leaf=lambda t: (tuple(t.shape), t.dtype)) -> tuple:
    """Shapes and dtypes (or ``leaf`` of each tensor) of every tensor in
    nested dicts/lists."""
    sig = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            sig.append(leaf(x))
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


def _hold(buf, new):
    """``new`` (a tensor, or dicts / lists of them) copied in place into
    ``buf``, the buffers an earlier round made for it; a buffer is made
    where ``buf`` holds none of ``new``'s shape, never inside a CUDA graph
    capture.  Returns the buffers."""
    if isinstance(new, torch.Tensor):
        if not (isinstance(buf, torch.Tensor) and buf.shape == new.shape
                and buf.dtype == new.dtype and buf.device == new.device):
            if new.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a round buffer would be made inside a "
                                   "CUDA graph capture")
            buf = torch.empty_like(new, memory_format=torch.contiguous_format)
        return buf.copy_(new)
    if isinstance(new, dict):
        buf = buf if isinstance(buf, dict) else {}
        return {k: _hold(buf.get(k), v) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        if not (isinstance(buf, list) and len(buf) == len(new)):
            buf = [None] * len(new)
        return [_hold(b, v) for b, v in zip(buf, new)]
    return new


def capture_graph(body, pool=None):
    """``body()``'s kernels captured as a CUDA graph (recorded on a side
    stream, none run) to replay on the current stream, whose kernel
    workspaces they use (:func:`repro_torch.kernels._build.replay_stream`).
    ``thread_local``: the asyncio front door runs rounds in a worker
    thread while its loop thread goes on.  The captured graph is kept
    beside its instantiation (``keep_graph``), so :func:`graph_nodes` can
    count it."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with _build.replay_stream(torch.cuda.current_stream().cuda_stream), \
            torch.cuda.graph(graph, pool=pool,
                             capture_error_mode="thread_local"):
        body()
    graph.instantiate()
    return graph


def graph_nodes(graph) -> int | None:
    """The nodes of a captured CUDA graph (``cuGraphGetNodes`` on
    ``raw_cuda_graph()``), or None for a test's stand-in."""
    try:
        handle = graph.raw_cuda_graph()
    except AttributeError:
        return None
    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(handle), None, ctypes.byref(n))
    return int(n.value) if rc == 0 else None


class RoundGraph:
    """``body`` captured once by ``capture`` (:func:`capture_graph`; a
    test passes a stand-in) and replayed at the addresses it captured.
    The kernel wrappers count launches on the host, which the capture
    runs and a replay does not: the capture's counts are taken back and
    added again at every replay, so the counts are the launches the card
    ran.  ``nodes``: the graph's node count (:func:`graph_nodes`);
    ``marks``: the tracer's marks the capture recorded, [(kind, slot)],
    which every replay stamps anew."""

    def __init__(self, body, pool=None, capture=capture_graph):
        before = launch_counts()
        self.graph = capture(body, pool)
        self.launches = {k: n - before[k] for k, n in launch_counts().items()
                         if n != before[k]}
        add_launches(self.launches, -1)
        self.nodes = graph_nodes(self.graph)
        self.marks: list = []

    def replay(self) -> None:
        self.graph.replay()
        add_launches(self.launches)


class InterleavedPipeline:
    """Dual-batch rotation, drivable one round at a time.

    ``trace_counts`` records, per entry point, how many distinct input
    shape signatures it has run with; a scheduler that keeps shapes
    stable sees ``trace_counts['fused'] == 1`` for its whole lifetime.
    ``graph_captures`` counts, per entry point, the CUDA graphs captured
    (``capture_s`` their wall seconds).  ``graphs``: None runs the
    entry points as graphs when the states are on a card and there is no
    mesh, True insists (and raises on CPU tensors or with a mesh), False
    keeps them eager.  A capture or replay that fails raises.  ``tree``
    (a branching tuple) selects tree mode, which needs all-attention
    decoder-only target and draft models; its rounds never call the
    rollback entry.  ``obs`` receives the warmup, verify, draft, rollback
    and launch spans, and ``pipeline_graph_nodes{entry}`` (the node count
    of each entry's latest graph, also ``graph_nodes``).  Over a ``mesh``
    (the parameters and caches the rank's,
    :class:`repro_torch.core.pipeline.SpecOffloadEngine` with a mesh)
    every rank runs the same rounds on the same tokens.
    """

    def __init__(self, target_params, target_cfg, draft_params, draft_cfg,
                 n_cand: int, tree=None, obs=None, mesh=None, graphs=None):
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
        if graphs and mesh is not None:
            raise ValueError("graphs=True with a mesh: its collectives run "
                             "on the host and cannot be captured")
        self.graphs = graphs
        self.trace_counts = {"fused": 0, "draft": 0, "rollback": 0}
        self._seen = {k: set() for k in self.trace_counts}
        self._exported_traces = {k: 0 for k in self.trace_counts}
        self.graph_captures = {k: 0 for k in self.trace_counts}
        self.graph_nodes: dict = {}
        self.capture_s = 0.0
        self.capture = capture_graph     # a test may pass a stand-in
        self._graphs: dict = {}          # key -> RoundGraph
        self._eager: set = set()         # keys run eagerly once
        self._pool = None                # one memory pool for every graph
        self._got: list = []             # the run's marks, [(kind, handle)]
        self._capturing = False

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

    def _use_graphs(self, state: BatchState) -> bool:
        if self.graphs is None:
            return self.mesh is None and state.t_next.is_cuda
        if self.graphs and not state.t_next.is_cuda:
            raise ValueError("graphs=True needs the states on a card")
        return self.graphs

    def _mark(self, kind: str) -> None:
        """Put the tracer's mark ``kind`` on the stream (nothing without a
        stamp source): eagerly, or into the graph being captured."""
        tr = self.obs.tracer
        if tr.marks is not None:
            self._got.append((kind, tr.mark(kind, keep=self._capturing)))

    def _run(self, entry: str, touched, body, graphs: bool) -> dict:
        """Run ``body``, an entry point writing its results into the
        states' buffers: eagerly, or by the graph protocol of the module's
        docstring, keyed on the shapes and addresses of ``touched()``.
        Returns the marks the run put on the stream, {kind: handle}."""
        self._got = []
        if not graphs:
            body()
            return dict(self._got)

        def key():
            trees = touched()
            return (entry, _signature(*trees),
                    _signature(*trees, leaf=lambda t: t.data_ptr()))
        now = key()
        graph = self._graphs.get(now)
        if graph is None and now in self._eager:
            t0 = time.perf_counter()
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            self._capturing = True
            try:
                graph = RoundGraph(body, self._pool, self.capture)
            finally:
                self._capturing = False
            graph.marks = [(k, h[0]) for k, h in self._got if h is not None]
            self._graphs[now] = graph
            self.graph_captures[entry] += 1
            self.capture_s += time.perf_counter() - t0
            if graph.nodes is not None:
                self.graph_nodes[entry] = graph.nodes
                self.obs.metrics.gauge(
                    "pipeline_graph_nodes",
                    "nodes of each entry point's latest CUDA graph").set(
                        graph.nodes, entry=entry)
        if graph is not None:
            with self.obs.tracer.span("launch", entry):
                t = time.perf_counter()
                graph.replay()
            return {k: (slot, t) for k, slot in graph.marks}
        body()
        self._eager.add(key())       # with any buffer the run made
        return dict(self._got)

    # ------------------------------------------------------------------
    def _draft_body(self, state: BatchState) -> None:
        if self.tree is not None:
            d, _, dc = draft_tree_generate(self.dp, self.dcfg,
                                           state.draft_cache, state.t_next,
                                           self.tree, self.mesh)
            pend = None
        else:
            d, _, dc, pend = draft_generate(self.dp, self.dcfg,
                                            state.draft_cache, state.t_next,
                                            self.n_cand, self.mesh)
        state.draft_cache["pos"].copy_(dc["pos"])
        state.draft_buf = _hold(state.draft_buf, d)
        state.pend_buf = _hold(state.pend_buf, pend)

    def warmup(self, state: BatchState) -> None:
        """Slot t_0 (paper Fig. 4): draft candidates for ``state`` so the
        next :meth:`step` can verify it.  No-op if drafts are staged."""
        if state.drafts is not None:
            return
        self._count("draft", state.draft_cache, state.t_next)
        with self.obs.tracer.span("draft_generate", "warmup",
                                  cat="device", stream=True):
            self._run("draft", lambda: (state.draft_cache, state.t_next,
                                        state.draft_buf, state.pend_buf),
                      lambda: self._draft_body(state),
                      self._use_graphs(state))
        state.drafts, state.draft_pendings = state.draft_buf, state.pend_buf

    def _fused_body(self, verify: BatchState, gen: BatchState,
                    vstate: dict, dstate: dict) -> None:
        self._mark("round_begin")
        if self.tree is not None:
            vout, dout = fused_tree_verify_and_draft(
                self.tp, self.tcfg, self.dp, self.dcfg, vstate, dstate,
                self.tree, self.mesh, self._mark)
            # batch V's draft cache was compacted inside the fused round
            verify.draft_cache["pos"].copy_(vout["draft_cache"]["pos"])
        else:
            vout, dout = fused_verify_and_draft(
                self.tp, self.tcfg, self.dp, self.dcfg, vstate, dstate,
                self.n_cand, self.mesh, self._mark)
        verify.target_cache["pos"].copy_(vout["target_cache"]["pos"])
        verify.t_next.copy_(vout["t_next"])
        verify.out_buf = _hold(verify.out_buf, torch.cat(
            [vout["tokens"], vout["n_emitted"][:, None],
             vout["n_accept"][:, None]], dim=1))
        gen.draft_cache["pos"].copy_(dout["draft_cache"]["pos"])
        gen.draft_buf = _hold(gen.draft_buf, dout["drafts"])
        gen.pend_buf = _hold(gen.pend_buf, dout["pendings"])
        self._mark("round_end")

    def _rollback_body(self, verify: BatchState) -> None:
        """Batch V: roll its draft cache back to the accepted prefix (the
        round's ``n_emitted`` column of its output row)."""
        self._mark("rollback_begin")
        n_emitted = verify.out_buf[:, -2]
        dc = rollback_draft(self.dcfg, verify.draft_cache, verify.pend_buf,
                            n_emitted)
        verify.draft_cache["pos"].copy_(dc["pos"])
        self._mark("rollback_end")

    def step(self, verify: BatchState, gen: BatchState,
             record: bool = True) -> RoundOutput:
        """One rotation round: verify ``verify``'s staged drafts while
        drafting fresh candidates for ``gen``.

        Mutates both states in place; on return ``verify.drafts is None``
        (the safe window for slot surgery) and ``gen`` holds new drafts.
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
        graphs = self._use_graphs(verify)
        tr = self.obs.tracer
        # the fused round does both phases: a verify span and a draft
        # span, on the device split by the round's boundary mark; timed
        # on the host, the draft span mirrors the verify's interval
        # (bubble accounting unions the overlap)
        with tr.span("target_verify", "verify(fused)", cat="device") as sp:
            got = self._run("fused", lambda: (vstate, dstate, verify.out_buf,
                                              gen.draft_buf, gen.pend_buf),
                            lambda: self._fused_body(verify, gen, vstate,
                                                     dstate), graphs)
            sp.device(got.get("round_begin"), got.get("draft_begin"))
        if tr.enabled:
            tr.complete("draft_generate", "draft(fused)", sp.t0, sp.t1,
                        cat="device", device=(got.get("draft_begin"),
                                              got.get("round_end")))
        if self.tree is None:
            self._count("rollback", verify.draft_cache,
                        verify.draft_pendings)
            with tr.span("rollback", "rollback", cat="device") as rb:
                got = self._run("rollback", lambda: (verify.draft_cache,
                                                     verify.pend_buf,
                                                     verify.out_buf),
                                lambda: self._rollback_body(verify), graphs)
                rb.device(got.get("rollback_begin"), got.get("rollback_end"))
        verify.drafts, verify.draft_pendings = None, None
        gen.drafts, gen.draft_pendings = gen.draft_buf, gen.pend_buf
        # the round's one host synchronisation (a copy: on the CPU numpy()
        # would share the buffer the next round writes), after which the
        # tracer reads the round's marks
        host = verify.out_buf.cpu().numpy().copy()
        tr.resolve(time.perf_counter())
        m1 = host.shape[1] - 2
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
