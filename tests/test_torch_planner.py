"""The port's planner, placement and simulator against the JAX package's:
the config parameter counts, ``ParaSpecPlanner.evaluate`` over a grid of
policies and workloads, ``search`` / ``search_spec``, ``plan_placement``,
every simulator and baseline function, the engine's policy and placement
and the launcher's ``--plan`` lines.  All of it is plain Python
arithmetic on the same fields, so every comparison is exact (``==`` on
floats and on dataclasses turned into dicts)."""
import contextlib
import dataclasses
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core import placement as JP  # noqa: E402
from repro.core import planner as JPL  # noqa: E402
from repro.core.pipeline import SpecOffloadEngine as JEngine  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.sim import baselines as JB  # noqa: E402
from repro.sim import hardware as JH  # noqa: E402
from repro.sim import simulator as JSIM  # noqa: E402
from repro_torch.configs import (ALL_CONFIGS, MISTRAL_7B,  # noqa: E402
                                 MIXTRAL_8X7B)
from repro_torch.core import placement as TP  # noqa: E402
from repro_torch.core import planner as TPL  # noqa: E402
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402
from repro_torch.sim import baselines as TB  # noqa: E402
from repro_torch.sim import hardware as TH  # noqa: E402
from repro_torch.sim import simulator as TSIM  # noqa: E402

CPU = "cpu"
ENVS = ("env1", "env2")
PAIRS = {"8x7b": ("mixtral-8x7b", "mistral-7b"),
         "8x22b": ("mixtral-8x22b", "mistral-7b")}


def _pair(name):
    """(jax target, jax draft, torch target, torch draft)."""
    t, d = PAIRS[name]
    return j_get_config(t), j_get_config(d), ALL_CONFIGS[t], ALL_CONFIGS[d]


def _same(a, b):
    """Dataclasses (nested ones included) as dicts, compared exactly."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _policies(mod):
    P = mod.Policy
    out = [P(bp, bd, bdr, m) for bp, bd, bdr, m in
           [(16, 32, 4, 1), (64, 160, 10, 4), (128, 320, 16, 8),
            (50, 64, 8, 2), (96, 256, 5, 6)]]
    out += [P(64, 160, 10, len(t), tree=t) for t in ((3, 2), (2, 2, 2), (4,))]
    return out


def _workloads(mod):
    W = mod.Workload
    return [W(512, 64), W(24, 16, 0.3, 0.5), W(1024, 256, 0.9, 1.0),
            W(256, 32, 0.7, 0.8, kv_bytes_per_seq=3.5e6)]


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("name", sorted(ALL_CONFIGS))
def test_config_param_counts_match_jax(name):
    tc, jc = ALL_CONFIGS[name], j_get_config(name)
    for cfg in ((tc, jc), (tc.reduced(d_model=64), jc.reduced(d_model=64))):
        t, j = cfg
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.n_moe_layers == j.n_moe_layers
        for moe in (None, True, False):
            assert t._ffn_params(moe) == j._ffn_params(moe)
        for bp in (1, 2, 4):
            assert t.param_bytes(bp) == j.param_bytes(bp)
        assert t.attention_free == j.attention_free
        assert t.q_per_kv == j.q_per_kv


def test_mixtral_8x22b_matches_jax_field_for_field():
    t = dataclasses.asdict(ALL_CONFIGS["mixtral-8x22b"])
    j = dataclasses.asdict(j_get_config("mixtral-8x22b"))
    assert t == {k: j[k] for k in t}


# ---------------------------------------------------------------------------
# hardware, planner


@pytest.mark.parametrize("env", ENVS)
def test_paper_hardware_specs_match_jax(env):
    _same(TH.ENVS[env], JH.ENVS[env])


def test_h100_spec_states_no_tpu_number():
    h = TH.ENVS["h100"]
    assert "TPU" not in h.name and h.ici_bw == 0.0
    assert h.accel_flops == 989e12 * 0.6 and h.accel_mem_bw == 3.35e12
    assert set(TH.ENVS) == {"env1", "env2", "h100"}


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_planner_evaluate_matches_jax(pair, env):
    jt, jd, tt, td = _pair(pair)
    jp = JPL.ParaSpecPlanner(jt, jd, JH.ENVS[env])
    tp = TPL.ParaSpecPlanner(tt, td, TH.ENVS[env])
    for jpol, tpol in zip(_policies(JPL), _policies(TPL)):
        for jwl, twl in zip(_workloads(JPL), _workloads(TPL)):
            _same(tp.evaluate(tpol, twl), jp.evaluate(jpol, jwl))


def test_planner_helpers_match_jax():
    jt, jd, tt, td = _pair("8x7b")
    for fn in ("layer_ffn_bytes", "layer_attn_bytes", "kv_bytes_per_token"):
        for bp in (1, 2):
            assert getattr(TPL, fn)(tt, bp) == getattr(JPL, fn)(jt, bp)
    for ctx in (1, 600):
        assert TPL.attn_flops_per_token(td, ctx) == \
            JPL.attn_flops_per_token(jd, ctx)
    assert TPL.dense_flops_per_token(tt) == JPL.dense_flops_per_token(jt)
    for kw in ({}, {"block_size": 16}, {"quant": True},
               {"block_size": 16, "quant": True}):
        assert TPL.stored_kv_bytes_per_seq(tt, 517, **kw) == \
            JPL.stored_kv_bytes_per_seq(jt, 517, **kw)
    assert TPL.TREE_GRID == JPL.TREE_GRID


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_planner_search_matches_jax(pair, env):
    jt, jd, tt, td = _pair(pair)
    jp = JPL.ParaSpecPlanner(jt, jd, JH.ENVS[env])
    tp = TPL.ParaSpecPlanner(tt, td, TH.ENVS[env])
    for args in ((512, 64), (24, 16, 0.3, 0.6)):
        _same(tp.search(TPL.Workload(*args)), jp.search(JPL.Workload(*args)))
        _same(tp.search_spec(TPL.Workload(*args)),
              jp.search_spec(JPL.Workload(*args)))


def test_planner_search_spec_picks_a_tree_at_low_acceptance():
    """The joint search's tree branch is taken somewhere on the grid, so
    the comparison above covers both of its outcomes."""
    jt, jd, tt, td = _pair("8x7b")
    tp = TPL.ParaSpecPlanner(tt, td, TH.ENV1)
    jp = JPL.ParaSpecPlanner(jt, jd, JH.ENV1)
    trees = 0
    for p in (0.1, 0.2, 0.4):
        t = tp.search_spec(TPL.Workload(512, 64, p))
        _same(t, jp.search_spec(JPL.Workload(512, 64, p)))
        trees += t.policy.tree is not None
    assert trees > 0


def test_planner_search_raises_like_jax_when_nothing_fits():
    jt, jd, tt, td = _pair("8x7b")
    tiny = dataclasses.replace(TH.ENV1, accel_mem_bytes=1e6)
    jtiny = dataclasses.replace(JH.ENV1, accel_mem_bytes=1e6)
    with pytest.raises(ValueError, match="no feasible policy"):
        TPL.ParaSpecPlanner(tt, td, tiny).search(TPL.Workload(512, 64))
    with pytest.raises(ValueError, match="no feasible policy"):
        JPL.ParaSpecPlanner(jt, jd, jtiny).search(JPL.Workload(512, 64))


# ---------------------------------------------------------------------------
# placement


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_plan_placement_matches_jax(pair, env):
    jt, jd, tt, td = _pair(pair)
    for kw in ({}, {"draft_batch": 32, "draft_ctx": 4096},
               {"bytes_per_param": 1, "reserve_activations": 0.3}):
        t = TP.plan_placement(tt, td, TH.ENVS[env], **kw)
        j = JP.plan_placement(jt, jd, JH.ENVS[env], **kw)
        _same(t, j)
        assert TP.hbm_pinned_fraction(t) == JP.hbm_pinned_fraction(j)
        assert t.streamed_bytes_per_token_step() == \
            j.streamed_bytes_per_token_step()
        for tier in TP.TIERS:
            assert t.bytes_in(tier) == j.bytes_in(tier)
        assert t.tier_of("target/stream_slot0") == \
            j.tier_of("target/stream_slot0")


def test_plan_placement_without_draft_and_with_disk_matches_jax():
    jt, _, tt, _ = _pair("8x22b")
    small = dict(host_mem_bytes=64 * TH.GB)
    t = TP.plan_placement(tt, None, dataclasses.replace(TH.ENV1, **small))
    j = JP.plan_placement(jt, None, dataclasses.replace(JH.ENV1, **small))
    _same(t, j)
    assert t.disk_used > 0 and len(t.notes) == 2


# ---------------------------------------------------------------------------
# simulator and baselines


@pytest.mark.parametrize("env", ENVS)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_simulator_matches_jax(pair, env):
    jt, jd, tt, td = _pair(pair)
    jhw, thw = JH.ENVS[env], TH.ENVS[env]
    jwl, twl = JPL.Workload(512, 64), TPL.Workload(512, 64)
    jpol, tpol = JPL.Policy(64, 160, 10, 4), TPL.Policy(64, 160, 10, 4)
    jbad, tbad = JPL.Policy(16, 32, 32, 1), TPL.Policy(16, 32, 32, 1)
    for mode in ("full", "serial_sd", "no_sd", "no_policy"):
        _same(TSIM.simulate_specoffload(tt, td, thw, twl, tpol, mode),
              JSIM.simulate_specoffload(jt, jd, jhw, jwl, jpol, mode))
    t, j = (TSIM.end_to_end(tt, td, thw, twl, tpol),
            JSIM.end_to_end(jt, jd, jhw, jwl, jpol))
    assert list(t) == list(j)
    for k in t:
        _same(t[k], j[k])
    t, j = (TSIM.ablation(tt, td, thw, twl, tpol, tbad),
            JSIM.ablation(jt, jd, jhw, jwl, jpol, jbad))
    assert list(t) == list(j)
    for k in t:
        _same(t[k], j[k])
    fracs = (0.0, 0.25, 0.5, 1.0)
    assert TSIM.memory_sweep(tt, thw, twl, fracs) == \
        JSIM.memory_sweep(jt, jhw, jwl, fracs)
    assert TSIM.disk_mode(tt, td, thw, twl, tpol) == \
        JSIM.disk_mode(jt, jd, jhw, jwl, jpol)
    assert TSIM.disk_mode(tt, td, thw, twl, tpol, os_reserve=200 * TH.GB,
                          disk_eff=0.5) == \
        JSIM.disk_mode(jt, jd, jhw, jwl, jpol, os_reserve=200 * JH.GB,
                       disk_eff=0.5)
    tl, jl = (TSIM.decode_timeline(tt, td, thw, twl, tpol, 5),
              JSIM.decode_timeline(jt, jd, jhw, jwl, jpol, 5))
    _same(tl, jl)
    assert tl.busy_fraction() == jl.busy_fraction()


@pytest.mark.parametrize("name", sorted(JB.BASELINES))
@pytest.mark.parametrize("env", ENVS)
def test_baselines_match_jax(name, env):
    assert list(TB.BASELINES) == list(JB.BASELINES)
    for tname in ("mixtral-8x7b", "mixtral-8x22b", "mistral-7b"):
        tc, jc = ALL_CONFIGS[tname], j_get_config(tname)
        for args in ((512, 64), (128, 32)):
            _same(TB.BASELINES[name](tc, TH.ENVS[env], *args),
                  JB.BASELINES[name](jc, JH.ENVS[env], *args))
        _same(TB.BASELINES[name](tc, TH.ENVS[env], 512, 64, batch=8),
              JB.BASELINES[name](jc, JH.ENVS[env], 512, 64, batch=8))
    for args in ((0.5,), (0.3, 0.2, 0.1), (1.0, 1.0, 1.0)):
        assert TB.nvsmi_util(*args) == JB.nvsmi_util(*args)


# ---------------------------------------------------------------------------
# the engine and the launcher


def _smoke_pair():
    """The serving bench's smoke pair, as (jax cfgs, torch cfgs)."""
    j = (j_get_config("mixtral-8x7b").reduced(d_model=64),
         j_get_config("mistral-7b").reduced(d_model=32))
    t = (MIXTRAL_8X7B.reduced(d_model=64), MISTRAL_7B.reduced(d_model=32))
    return j, t


@pytest.mark.parametrize("env", ENVS)
def test_engine_policy_and_placement_match_jax(env):
    """``generate`` on the smoke pair: the same default policy, the same
    placement plan, and (on ``from_jax`` weights) the same tokens."""
    (jt, jd), (tt, td) = _smoke_pair()
    je = JEngine(jt, jd, hw=JH.ENVS[env])
    je.init_from_seed(0)
    te = SpecOffloadEngine(tt, td, hw=TH.ENVS[env], device=CPU)
    te.load(from_jax(jax.tree.map(np.asarray, je.tp), tt, CPU),
            from_jax(jax.tree.map(np.asarray, je.dp), td, CPU))
    prompts = np.random.default_rng(0).integers(0, tt.vocab_size, (4, 8))
    jr = je.generate(jax.numpy.asarray(prompts, jax.numpy.int32), 6, n_cand=3)
    tr = te.generate(prompts, 6, n_cand=3)
    _same(tr.policy, jr.policy)
    _same(tr.placement, jr.placement)
    _same(te.placement, je.placement)
    assert (tr.tokens == np.asarray(jr.tokens)).all()


@pytest.mark.parametrize("accept", [0.7, 0.3])
def test_engine_plan_matches_jax(accept):
    (jt, jd), (tt, td) = _smoke_pair()
    jbig, tbig = (j_get_config("mixtral-8x7b"), j_get_config("mistral-7b")), \
        (MIXTRAL_8X7B, MISTRAL_7B)
    for (jt_, jd_), (tt_, td_) in (((jt, jd), (tt, td)), (jbig, tbig)):
        je = JEngine(jt_, jd_, hw=JH.ENV2)
        te = SpecOffloadEngine(tt_, td_, hw=TH.ENV2, device=CPU)
        _same(te.plan(512, 64, accept, 0.8), je.plan(512, 64, accept, 0.8))
        assert te.policy is not None
        _same(te.plan(1, 1), je.plan(1, 1))        # kept once found
    pol = TPL.Policy(2, 2, 2, 3)
    assert SpecOffloadEngine(tt, td, policy=pol, device=CPU).plan(9, 9) is pol


def test_engine_generate_follows_a_given_policy():
    """A policy given to the engine sets the prefill microbatch and the
    candidates, as the JAX engine's ``generate`` does."""
    (jt, jd), (tt, td) = _smoke_pair()
    jpol, tpol = JPL.Policy(1, 2, 2, 2), TPL.Policy(1, 2, 2, 2)
    je = JEngine(jt, jd, policy=jpol)
    je.init_from_seed(1)
    te = SpecOffloadEngine(tt, td, policy=tpol, device=CPU)
    te.load(from_jax(jax.tree.map(np.asarray, je.tp), tt, CPU),
            from_jax(jax.tree.map(np.asarray, je.dp), td, CPU))
    prompts = np.random.default_rng(1).integers(0, tt.vocab_size, (4, 6))
    jr = je.generate(jax.numpy.asarray(prompts, jax.numpy.int32), 5, n_cand=4)
    tr = te.generate(prompts, 5, n_cand=4)
    assert tr.policy is tpol and te.pipeline(2).n_cand == 2
    assert (tr.tokens == np.asarray(jr.tokens)).all()
    assert tr.rounds == jr.rounds


def _run_main(main, argv, monkeypatch=None):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if monkeypatch is None:
            main(argv)
        else:
            monkeypatch.setattr(sys, "argv", ["serve"] + argv)
            main()
    return out.getvalue()


@pytest.mark.parametrize("argv", [
    ["--plan", "--env", "env1"],
    ["--plan", "--env", "env2", "--prompt-len", "512", "--gen", "64"],
    ["--plan", "--env", "env1", "--arch", "mixtral-8x22b"],
] + [["--plan", "--env", ("env1", "env2")[i % 2], "--arch", name]
     for i, name in enumerate(sorted(set(ALL_CONFIGS)
                                     - {"mixtral-8x7b", "mixtral-8x22b"}))])
def test_serve_plan_prints_what_the_jax_launcher_prints(argv, monkeypatch):
    """Every configuration: the same policy, throughput and placement
    lines, or, for the two targets no policy fits into the paper's host
    and accelerator memory (Llama-3-405B, Llama-4 Maverick), the same
    error."""
    def outcome(*args):
        try:
            return _run_main(*args)
        except ValueError as e:
            return f"ValueError: {e}"
    got = outcome(t_serve.main, argv)
    want = outcome(j_serve.main, argv, monkeypatch)
    assert got == want
    if argv[-1] in ("llama3-405b", "llama4-maverick-400b-a17b"):
        assert got.startswith("ValueError: no feasible policy")
    else:
        assert got.startswith(
            "policy (bs_prefill, bs_decode, bs_draft, n_cand)")


def test_serve_plan_h100_runs_before_any_device_work(monkeypatch):
    """``--plan --env h100`` needs no card: the launcher exits before it
    would resolve a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = _run_main(t_serve.main, ["--plan", "--env", "h100",
                                   "--prompt-len", "512", "--gen", "64"])
    assert f"on {TH.H100.name}" in out and "placement: hbm=" in out
