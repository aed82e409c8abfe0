"""The harness end to end on the CPU at smoke size (everything but the
look for a card), and the faults its check has to catch."""
from __future__ import annotations

import pytest
import torch

from specbench import check as chk
from specbench import run
from conftest import ROOT, TINY_MIXES, tiny_cell

SEED = 2 ** 33 + 21


def _run(kind, mix, seconds=2.5, trace=False):
    out = run.run_cell(tiny_cell(kind), TINY_MIXES[mix], SEED, seconds,
                       trace, "cpu", log=lambda s: None)
    rows = run.checks(tiny_cell(kind), out)
    return out, rows, all(ok for *_, ok in rows)


@pytest.mark.parametrize("kind,mix", [("moe", "closed"), ("rwkv", "closed"),
                                      ("moe", "poisson")])
def test_sound_run_is_correct(kind, mix):
    out, rows, ok = _run(kind, mix)
    assert ok, rows
    if mix == "closed":
        assert out["e2e"]["tok_per_s"] > 0
    else:
        assert out["e2e"]["ttft_p90_ms"] > 0 and out["e2e"]["tpot_p90_ms"] > 0


def test_traced_run_reads_layer_metrics():
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = "mixtral-spec.offline-decode"
    readers = {m["name"]: run.load_reader(m["name"])
               for m in bench["per_layer"]
               if cell in m.get("workloads", [cell])}
    out = run.run_cell(tiny_cell("moe"), TINY_MIXES["closed"], SEED, 1.5,
                       True, "cpu", readers=readers, log=lambda s: None)
    assert out["layer"]["occupancy.offline"] > 50
    assert out["layer"]["round_ms.offline"] > 0
    # no device operation runs on the CPU: no roofline is read
    assert "moe_ffn_roofline.offline" not in out["layer"]


def _alter_tokens(monkeypatch):
    from repro_torch.core import interleave
    real = interleave.emit_slots

    def altered(drafts, a, nxt):
        return (real(drafts, a, nxt) + 1) % 128
    monkeypatch.setattr(interleave, "emit_slots", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.core import interleave
    real = interleave.M.commit

    def commit(cfg, cache, pendings, n_commit, sq):
        return real(cfg, cache, pendings, torch.zeros_like(n_commit), sq)
    monkeypatch.setattr(interleave.M, "commit", commit)


def _half_batch(monkeypatch):
    from repro_torch.core import interleave
    real = interleave.M.decode

    def decode(params, cfg, cache, tokens, mesh=None, spec_tree=None):
        lg, c, p = real(params, cfg, cache, tokens, mesh, spec_tree)
        h = lg.shape[0] // 2
        lg = torch.cat([lg[:h], lg[:lg.shape[0] - h]], dim=0)
        return lg, c, p
    monkeypatch.setattr(interleave.M, "decode", decode)


def _draft_altered(monkeypatch):
    from repro_torch.core import interleave
    real = interleave.draft_generate

    def altered(*args, **kwargs):
        d, *rest = real(*args, **kwargs)
        return ((d + 1) % 128, *rest)
    monkeypatch.setattr(interleave, "draft_generate", altered)


def _draft_not_rolled_back(monkeypatch):
    from repro_torch.core import interleave

    def rollback(cfg, cache, pendings, n_emitted):
        return cache
    monkeypatch.setattr(interleave, "rollback_draft", rollback)


TARGET = ("mean_gap", "widest_gap")
DRAFT = ("draft_mean_gap", "draft_widest_gap")


@pytest.mark.parametrize("fault,side", [
    (_alter_tokens, TARGET), (_state_unchanged, TARGET),
    (_half_batch, TARGET), (_draft_altered, DRAFT),
    (_draft_not_rolled_back, DRAFT)],
    ids=["token_altered", "state_unchanged", "half_batch", "draft_altered",
         "draft_not_rolled_back"])
@pytest.mark.parametrize("kind", ["moe", "rwkv"])
def test_fault_is_caught(monkeypatch, fault, side, kind):
    fault(monkeypatch)
    _, rows, ok = _run(kind, "closed")
    assert not ok, rows
    ok = dict((n, good) for n, _, _, good in rows)
    assert not all(ok[n] for n in side), rows


@pytest.mark.parametrize("kind", ["moe", "rwkv"])
def test_fp8_control_fails_the_check(kind):
    """The control put in the program's place comes out not correct
    through the harness's own checks; the program's readings pass."""
    from specbench import control
    cfg = tiny_cell(kind)
    out = run.run_cell(cfg, TINY_MIXES["closed"], SEED, 2.5, False, "cpu",
                       check=False, log=lambda s: None)
    program, ctl, rec = control.readings(cfg, out, SEED, others=("fp8",))
    assert all(ok for *_, ok in run.checks(cfg, program))
    rows = run.checks(cfg, ctl)
    assert not all(ok for *_, ok in rows), rows
    for side in ("target", "draft"):
        assert rec[side]["fp8"]["mean"] > 3 * rec[side]["program"]["mean"]


def test_every_engine_key_reaches_the_engine():
    cfg = run.scheduler_config({"max_batch": 3, "spec_tree": [3, 2],
                                "preempt": True, "admission": "sjf"},
                               clock="real")
    assert (cfg.max_batch, cfg.spec_tree, cfg.preempt, cfg.admission) == (
        3, (3, 2), True, "sjf")
    with pytest.raises(TypeError):
        run.scheduler_config({"max_batch": 3, "no_such_key": 1})
    with pytest.raises(ValueError):
        run.scheduler_config({"clock": "virtual"}, clock="real")


def test_chains_recorded_for_every_verified_slot():
    """Every round a sampled request was verified in left its chain of
    drafts, after the tokens it had then, on the slot that served it."""
    out, _, _ = _run("rwkv", "closed")
    for rid, toks in out["served"].items():
        chains = out["rounds"][rid]
        if not toks:                # still queued at the close
            continue
        if not chains:              # admitted, its first chain not verified
            assert len(toks) == 1
            continue
        assert all(len(c) == 4 for _, c in chains)
        befores = [n for n, _ in chains]
        assert befores == sorted(befores) and befores[0] == 1
        assert befores[-1] <= len(toks)
        assert rid in out["slot_of"]
    assert len(set(out["slot_of"].values())) == 4


@pytest.mark.card
def test_cell_runs_on_card(card):
    import json
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "-m", "specbench.run", "--workload",
         "rwkv6-spec.offline-decode", "--seed", str(SEED), "--seconds", "3",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
