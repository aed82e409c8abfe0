"""The generator repeats for a seed, gives every seed the same schedule
(lengths, arrivals and their order) with other tokens, and reads its
parameters from the mix: rates, bursts, a mix that extends another."""
from __future__ import annotations

import numpy as np
import pytest

from specbench import generator
from conftest import ROOT

FOLDER = ROOT / "specbench" / "traffic"
MIXES = sorted(p.stem for p in FOLDER.glob("*.json"))
BIG = 2 ** 33 + 12345


def _mix(name):
    mix = generator.load_mix(name, FOLDER)
    if mix["arrivals"] == "poisson":
        mix.setdefault("rate_rps", 1.0)     # a base mix leaves it to others
    return mix


@pytest.mark.parametrize("name", MIXES)
def test_repeats_and_differs(name):
    mix = _mix(name)
    a = generator.make_requests(mix, BIG, 32000)
    b = generator.make_requests(mix, BIG, 32000)
    c = generator.make_requests(mix, BIG + 1, 32000)
    for x, y in zip(a["requests"], b["requests"]):
        assert np.array_equal(x["prompt"], y["prompt"])
        assert x["max_new"] == y["max_new"] and x["due_s"] == y["due_s"]
    assert any(not np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a["requests"], c["requests"]))


@pytest.mark.parametrize("name", MIXES)
def test_same_schedule_every_seed(name):
    mix = _mix(name)
    runs = [generator.make_requests(mix, s, 32000)["requests"]
            for s in (1, 2, BIG)]
    for reqs in runs:
        assert [len(r["prompt"]) for r in reqs] == [
            len(r["prompt"]) for r in runs[0]]
        assert [(r["max_new"], r["due_s"]) for r in reqs] == [
            (r["max_new"], r["due_s"]) for r in runs[0]]
    reqs = runs[0]
    lo, hi = mix["prompt_len"]
    assert all(lo <= len(r["prompt"]) <= hi for r in reqs)
    lo, hi = mix["output_len"]
    assert all(lo <= r["max_new"] <= hi for r in reqs)
    blk = mix.get("block", 16)
    lens = sorted(len(r["prompt"]) for r in reqs[:blk])
    assert lens == sorted(len(r["prompt"]) for r in reqs[blk:2 * blk])
    if mix["arrivals"] == "poisson":
        dues = [r["due_s"] for r in reqs]
        assert dues == sorted(dues)
        assert abs(len(dues) / dues[-1] / mix["rate_rps"] - 1) < 0.1


@pytest.mark.parametrize("burst", [[1, 1], [4, 12]])
def test_bursts_keep_the_rate(burst):
    mix = {"arrivals": "poisson", "rate_rps": 8.0, "burst": burst,
           "burst_spacing_s": 0.001, "prompt_len": [4, 8],
           "output_len": [2, 4], "n_requests": 4096, "block": 16}
    dues = [r["due_s"] for r in generator.make_requests(mix, 3, 100)
            ["requests"]]
    assert abs(len(dues) / dues[-1] / 8.0 - 1) < 0.1
    together = np.sum(np.diff(dues) <= 0.001 + 1e-9) / len(dues)
    if burst == [1, 1]:
        assert together < 0.05
    else:
        assert together > 0.8


def test_a_mix_extends_another(tmp_path):
    (tmp_path / "base.json").write_text(
        '{"arrivals": "poisson", "rate_rps": 1.0, "prompt_len": [1, 2]}')
    (tmp_path / "fast.json").write_text(
        '{"extends": "base", "rate_rps": 5.0}')
    assert generator.load_mix("fast", tmp_path) == {
        "arrivals": "poisson", "rate_rps": 5.0, "prompt_len": [1, 2]}
