"""The round at fixed addresses, the graph protocol and its launch
accounting (``repro_torch.core.interleave``), on the CPU.

(a) A ``ServingEngine`` run in every mode (paged chain, contiguous chain,
paged tree (3, 2), contiguous with a reduced RWKV-6 and RecurrentGemma
target), with admissions, retirements and a preemption: after the first
round of each half every tensor a round reads or writes keeps its
address to the end.  (b) The same runs' streams equal the JAX engine's
and the greedy decode.  (c) ``graphs=True`` raises on CPU tensors and
with a mesh; a CPU run captures nothing.  (d) The launch counts of a
captured graph's replays equal the eager calls'.  (e) ``rope_table``
with a host-scalar base gives the bits of the former tensor base.
The graph protocol (eager, capture, replays) also runs on the CPU with a
stand-in capture whose replay runs the round's body."""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import MISTRAL_7B as J_MISTRAL  # noqa: E402
from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.configs.recurrentgemma_2b import CONFIG as J_RG  # noqa: E402
from repro.configs.rwkv6_7b import CONFIG as J_RWKV  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import engine as jserve  # noqa: E402
from repro_torch.configs import (ALL_CONFIGS, MISTRAL_7B,  # noqa: E402
                                 MIXTRAL_8X7B, RECURRENTGEMMA_2B, RWKV6_7B)
from repro_torch.core import interleave as TI  # noqa: E402
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.kernels import (launch_counts,  # noqa: E402
                                 paged_decode_attention, reset_launches)
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.layers import rope_table  # noqa: E402
from repro_torch.models.transformer import init_cache  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.serving import engine as tserve  # noqa: E402

CPU = "cpu"
# mode -> (target family, paged, tree); the draft is Mistral-7B reduced
# (all-attention under a tree)
MODES = {"paged-chain": ("mixtral", True, None),
         "contiguous-chain": ("mixtral", False, None),
         "paged-tree": ("mixtral", True, (3, 2)),
         "contiguous-rwkv6": ("rwkv6", False, None),
         "contiguous-recurrentgemma": ("recurrentgemma", False, None)}
TARGETS = {"mixtral": (J_MIXTRAL, MIXTRAL_8X7B), "rwkv6": (J_RWKV, RWKV6_7B),
           "recurrentgemma": (J_RG, RECURRENTGEMMA_2B)}


def _models(family: str, tree):
    """Both packages' target (``reduced(d_model=64)``) and draft
    (Mistral-7B ``reduced(d_model=32)``, window 8, all-attention under a
    tree), f32, and one set of JAX weights converted to the port."""
    jc, tc = TARGETS[family]
    jt, tt = jc.reduced(d_model=64), tc.reduced(d_model=64)
    extra = (dict(layer_pattern=("attn",) * 2, n_layers=2) if tree
             else dict(sliding_window=8))
    jd = dataclasses.replace(J_MISTRAL.reduced(d_model=32,
                                               vocab=jt.vocab_size), **extra)
    td = dataclasses.replace(MISTRAL_7B.reduced(d_model=32,
                                                vocab=tt.vocab_size), **extra)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtp, jdp = JM.init_params(jt, k1), JM.init_params(jd, k2)
    conv = lambda p, c: from_jax(jax.tree.map(np.asarray, p), c, CPU)
    return (jt, jd, jtp, jdp), (tt, td, conv(jtp, tt), conv(jdp, td))


def _greedy(params, cfg, prompt, steps):
    """The port's target-only greedy decode (prefill + decode_step)."""
    cache = init_cache(cfg, 1, len(prompt) + steps + 1, CPU)
    lg, cache = TM.prefill(params, cfg, torch.as_tensor(prompt[None]).long(),
                           cache)
    out = []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        out.append(int(tok[0]))
        lg, cache = TM.decode_step(params, cfg, cache, tok[:, None])
    return np.asarray(out)


def _addresses(eng) -> dict:
    """{name: data_ptr} of every tensor of both halves that a round reads
    or writes: the caches' leaves, ``pos`` and ``block_tables``,
    ``t_next``, the staged drafts, the pendings and the output row."""
    out = {}

    def walk(name, x):
        if isinstance(x, torch.Tensor):
            out[name] = x.data_ptr()
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{name}.{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{name}[{i}]", v)
    for h, half in enumerate(eng._halves):
        for field in ("target_cache", "draft_cache", "t_next", "draft_buf",
                      "pend_buf", "out_buf"):
            walk(f"h{h}.{field}", getattr(half, field))
    return out


def _serve(mod, eng, vocab, watch=None):
    """4 long priority-2 requests at t = 0 on 2 x 2 slots, a short
    priority-0 one after 4 steps (a preemption), driven by ``run_step``
    to the end.  ``watch(step)`` is called after every step."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, int(n)).astype(np.int32)
               for n in rng.integers(5, 13, 5)]
    longs = [mod.ServeRequest(i, p, 12, priority=2)
             for i, p in enumerate(prompts[:4])]
    short = mod.ServeRequest(9, prompts[4], 3, priority=0)
    for r in longs:
        assert eng.submit(r)
    steps = 0
    while eng.has_work():
        eng.run_step()
        steps += 1
        if steps == 4:
            assert eng.submit(short)
        if watch is not None:
            watch(steps)
    return longs + [short]


def _engines(mode):
    family, paged, tree = MODES[mode]
    (jt, jd, jtp, jdp), (tt, td, ttp, tdp) = _models(family, tree)
    cfg = dict(max_batch=2, n_cand=2, spec_tree=tree, paged=paged,
               block_size=4, qos=True, preempt=True, preempt_min_remaining=2,
               max_len=64)
    te = tserve.ServingEngine(tt, td, config=tserve.SchedulerConfig(**cfg),
                              device=CPU)
    te.load(ttp, tdp)
    je = jserve.ServingEngine(jt, jd, config=jserve.SchedulerConfig(**cfg))
    je.load(jtp, jdp)
    return te, je, tt, ttp


@pytest.mark.parametrize("mode", list(MODES))
def test_round_state_at_fixed_addresses(mode):
    te, je, tt, ttp = _engines(mode)
    seen = {}

    def watch(step):
        rounds = te.stats()["rounds"]
        if rounds < 2:                 # each half's first round makes its
            return                     # buffers
        now = _addresses(te)
        if not seen:
            seen.update(now)
            return
        assert now == seen, {k: (seen.get(k), now.get(k))
                             for k in set(now) | set(seen)
                             if now.get(k) != seen.get(k)}

    treqs = _serve(tserve, te, tt.vocab_size, watch)
    jreqs = _serve(jserve, je, tt.vocab_size)
    assert seen, "no round after each half's first"
    names = " ".join(seen)
    for part in ("target_cache.pos", "draft_cache.pos", "t_next", "draft_buf",
                 "out_buf", "draft_cache.layers[0]"):
        assert part in names, part
    tree = MODES[mode][2]
    assert ("pend_buf" in names) == (tree is None)
    assert ("block_tables" in names) == MODES[mode][1]
    assert te.preempted_total >= 1 and te.preempted_total == je.preempted_total
    st = te.stats()
    assert st["fused_compiles"] == 1
    assert st["graph_captures"] == {"fused": 0, "draft": 0, "rollback": 0}
    for tr, jr in zip(treqs, jreqs):
        np.testing.assert_array_equal(tr.result, jr.result,
                                      err_msg=f"rid {tr.rid} vs JAX")
        np.testing.assert_array_equal(
            tr.result, _greedy(ttp, tt, tr.prompt, tr.max_new_tokens),
            err_msg=f"rid {tr.rid} vs greedy")


class _ReplayOnHost:
    """A CPU stand-in for a CUDA graph: the capture keeps the body and
    runs nothing, each replay runs the body (a CUDA graph's capture runs
    the body's host code and records its kernels, a replay runs those)."""

    def __init__(self, body, pool):
        self.body, self.replays = body, 0

    def replay(self):
        self.replays += 1
        self.body()


@pytest.mark.parametrize("tree", [None, (3, 2)], ids=["chain", "tree"])
def test_graph_protocol_captures_each_key_once(tree):
    """Eager at a key's first round, captured and replayed at its second,
    replayed after: the rotation's two address sets give two fused (and
    two rollback) graphs for the whole run, and the streams stay the
    greedy decode's."""
    _, (tt, td, ttp, tdp) = _models("mixtral", tree)
    eng = tserve.ServingEngine(tt, td, device=CPU, config=tserve.
                               SchedulerConfig(max_batch=2, n_cand=2,
                                               spec_tree=tree, block_size=4,
                                               max_len=64))
    eng.load(ttp, tdp)
    pipe = eng.engine.pipeline(2, tree=tree)
    pipe._use_graphs = lambda state: True
    pipe.capture = _ReplayOnHost
    pipe._pool = "host"                # no CUDA graph pool on the CPU
    reqs = _serve(tserve, eng, tt.vocab_size)
    assert eng.engine._pipe is pipe
    rounds = eng.stats()["rounds"]
    assert pipe.graph_captures == {"fused": 2, "draft": 0,
                                   "rollback": 0 if tree else 2}
    replays = sum(g.graph.replays for g in pipe._graphs.values())
    # the first two rounds run eagerly, each later one replays its graphs
    assert replays == (rounds - 2) * (1 if tree else 2)
    for r in reqs:
        np.testing.assert_array_equal(
            r.result, _greedy(ttp, tt, r.prompt, r.max_new_tokens),
            err_msg=f"rid {r.rid} vs greedy")


class _MarkLog:
    """A stand-in stamp source that logs each mark (kind, made inside a
    capture) and stamps the real time."""

    def __init__(self):
        self.log = []

    def mark(self, kind, keep=False):
        self.log.append((kind, keep))
        return len(self.log) - 1

    def read(self, slot):
        return time.time_ns()

    def release(self, slot):
        pass


ROUND_MARKS = ["round_begin", "draft_begin", "round_end", "rollback_begin",
               "rollback_end"]


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_captured_round_holds_marks_only_when_traced(traced):
    """Under a stand-in capture that runs the body's host code once and
    whose replay runs nothing (the first four rounds: each half's eager
    round, then each half's capture, replayed at once), the round puts
    no mark on the stream with tracing off, and with it on the five
    marks in order every round: eagerly, then into the fused and the
    rollback graphs, which keep them."""
    from repro_torch.obs import NULL_REGISTRY, Obs
    from repro_torch.obs.trace import NULL_TRACER, Tracer
    _, (tt, td, ttp, tdp) = _models("mixtral", None)
    src = _MarkLog()
    obs = Obs(Tracer(marks=src) if traced else NULL_TRACER, NULL_REGISTRY)
    eng = SpecOffloadEngine(tt, td, device=CPU, obs=obs)
    eng.load(ttp, tdp)
    prompts = np.random.default_rng(0).integers(0, tt.vocab_size, (4, 6))
    states = [eng.prefill_batch(prompts[i:i + 2], 32) for i in (0, 2)]
    pipe = eng.pipeline(2)
    pipe._use_graphs = lambda state: True
    pipe._pool = "host"

    class Recorded:
        def __init__(self, body, pool):
            body()

        def replay(self):
            pass
    pipe.capture = Recorded
    verify, gen = states
    pipe.warmup(verify)
    for _ in range(4):
        pipe.step(verify, gen)
        verify, gen = gen, verify
    assert pipe.graph_captures == {"fused": 2, "draft": 0, "rollback": 2}
    graphs = [g.marks for g in pipe._graphs.values()]
    round_marks = [(k, keep) for k, keep in src.log if k != "span"]
    if not traced:
        assert src.log == [] and graphs == [[], [], [], []]
        return
    assert round_marks == ([(k, False) for k in ROUND_MARKS] * 2
                           + [(k, True) for k in ROUND_MARKS] * 2)
    assert sorted(len(m) for m in graphs) == [2, 2, 3, 3]
    assert [k for m in graphs for k, _ in m if len(m) == 3] == \
        ROUND_MARKS[:3] * 2


def test_graphs_true_raises_on_cpu_and_with_a_mesh():
    _, (tt, td, ttp, tdp) = _models("mixtral", None)
    with pytest.raises(ValueError, match="with a mesh"):
        TI.InterleavedPipeline(ttp, tt, tdp, td, 2, mesh=object(),
                               graphs=True)
    prompts = np.random.default_rng(0).integers(0, tt.vocab_size, (2, 6))
    eng = SpecOffloadEngine(tt, td, device=CPU, graphs=True)
    eng.load(ttp, tdp)
    with pytest.raises(ValueError, match="on a card"):
        eng.generate(prompts, gen_len=6, n_cand=2)
    te = tserve.ServingEngine(tt, td, device=CPU, config=tserve.
                              SchedulerConfig(max_batch=2, n_cand=2,
                                              graphs=True))
    te.load(ttp, tdp)
    te.submit(tserve.ServeRequest(0, prompts[0], 4))
    with pytest.raises(ValueError, match="on a card"):
        te.run()
    # the default on CPU tensors: eager, nothing captured
    eng = SpecOffloadEngine(tt, td, device=CPU)
    eng.load(ttp, tdp)
    eng.generate(prompts, gen_len=6, n_cand=2)
    assert eng._pipe.graph_captures == {"fused": 0, "draft": 0,
                                        "rollback": 0}
    assert eng._pipe.capture_s == 0.0


def test_replayed_launch_counts_equal_the_eager_calls():
    """A stand-in capture runs the body's host code once, as a CUDA
    graph's capture does (the wrappers count there), and its replay runs
    none of it: the capture's counts come back off and every replay adds
    them, so N replays count what N eager calls count."""
    fn = paged_decode_attention.paged_decode_attention

    def body():                        # what a round's wrapper calls count
        fn.launches += 2
        fn.route_launches["tree"] += 2

    class Recorded:
        def __init__(self, body, pool):
            body()

        def replay(self):
            pass

    reset_launches()
    for _ in range(5):
        body()
    eager = launch_counts()
    reset_launches()
    graph = TI.RoundGraph(body, capture=Recorded)
    assert graph.launches == {"paged_decode_attention": 2,
                              "paged_decode_attention tree": 2}
    assert not any(launch_counts().values())
    for _ in range(5):
        graph.replay()
    assert launch_counts() == eager
    reset_launches()


def _former_rope(positions, head_dim, theta):
    """``rope_table`` with its base as a tensor (before the base became a
    host scalar)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


@pytest.mark.parametrize("name", sorted(n for n, c in ALL_CONFIGS.items()
                                        if c.use_rope))
def test_rope_table_bits_unchanged(name):
    """At the serve shapes: a chain verify's (B 4, m 5) positions past a
    512-token prompt, a tree (3, 2) buffer's depths, a prefill's 1280."""
    cfg = ALL_CONFIGS[name]
    pos = torch.tensor([512, 530, 700, 5])[:, None]
    for p in (pos + torch.arange(5),
              pos + torch.tensor([0, 1, 1, 1, 2, 2, 2, 2, 2, 2]),
              torch.arange(1280)):
        got = rope_table(p, cfg.head_dim, cfg.rope_theta)
        want = _former_rope(p, cfg.head_dim, cfg.rope_theta)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


def test_capture_takes_the_replay_streams_workspace():
    """Inside ``replay_stream(s)`` a kernel's workspace is stream s's, the
    one its eager call made (the legacy default stream is 0), whatever
    stream the capture records on."""
    from repro_torch.kernels import _build
    table = {}
    eager = _build.workspace(table, 8, torch.int32, CPU, 0)
    with _build.replay_stream(0):
        assert _build.workspace(table, 8, torch.int32, CPU, 777) is eager
    assert _build.workspace(table, 8, torch.int32, CPU, 777) is not eager
    grown = _build.workspace(table, 16, torch.int32, CPU, 0)
    assert grown.numel() == 16 and not grown.any()
    assert any(t is eager for t in _build._OUTGROWN)   # still allocated


def test_a_rebuilt_pipeline_drops_the_old_graphs():
    """``SpecOffloadEngine.pipeline`` for another ``n_cand`` builds a new
    pipeline; nothing keeps the old one, so its graphs and their memory
    pool go with it."""
    import gc
    import weakref
    _, (tt, td, ttp, tdp) = _models("mixtral", None)
    eng = SpecOffloadEngine(tt, td, device=CPU)
    eng.load(ttp, tdp)
    gone = weakref.ref(eng.pipeline(2))
    assert eng.pipeline(3).n_cand == 3
    gc.collect()
    assert gone() is None
