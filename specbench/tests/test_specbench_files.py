"""Every file the benchmark names loads by name, and BENCHMARK.json keeps
to its own rules."""
from __future__ import annotations

import json
import re

import pytest

from specbench import generator, run
from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    c, cfg, mix, per_layer, e2e = run.load_cell(cell)
    assert c["chips"] == 1
    for side in ("target", "draft"):
        run.model_config(cfg[side])            # the program accepts it
    assert generator.make_requests(mix, 1, cfg["target"]["vocab_size"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(run.load_reader(m["name"]))
    assert run.load_driver(mix) is run.run_cell


def test_one_reader_per_quantity():
    """Readers are found by the metric's name or its base, and no two
    reader files are alike."""
    folder = ROOT / "specbench" / "metrics"
    texts = [p.read_text() for p in folder.glob("*.py")
             if p.name != "__init__.py"]
    assert len(texts) == len(set(texts))
    assert run.load_reader("round_ms.offline") is not None
    assert run.load_reader("round_ms.some_later_cell").__module__ \
        .endswith("round_ms")


def test_names_and_units():
    names = ([m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


def test_configs_used_and_files_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        for key in cfg["reduced"]:
            assert key in cfg["published"]
            assert cfg["target"][key] != cfg["published"][key]
