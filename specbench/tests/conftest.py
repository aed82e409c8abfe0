"""Shared pieces of the benchmark's own tests (run them with
``PYTHONPATH=src python -m pytest -q specbench/tests`` from the root of
the repository).  Tests that need a card take the ``card`` fixture,
which skips them where there is none; the decision is made inside the
fixture, never at import."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_TARGETS = {
    "moe": dict(name="t", arch_type="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=128,
                layer_pattern=["attn"], sliding_window=64, n_experts=4,
                top_k=2, capacity_factor=2.0, rope_theta=1e6,
                dtype="float32"),
    "rwkv": dict(name="t", arch_type="ssm", n_layers=2, d_model=64,
                 n_heads=0, n_kv_heads=0, head_dim=16, d_ff=96,
                 vocab_size=128, layer_pattern=["rwkv"], rwkv_head_size=16,
                 dtype="float32"),
}
TINY_DRAFT = dict(name="d", arch_type="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                  vocab_size=128, layer_pattern=["swa"], sliding_window=16,
                  rope_theta=1e4, dtype="float32")
TINY_MIXES = {
    "closed": {"arrivals": "closed", "prompt_len": [8, 24],
               "output_len": [6, 14], "backlog": 2, "n_requests": 256,
               "block": 4, "trace_s": 0.5},
    "poisson": {"arrivals": "poisson", "rate_rps": 20.0,
                "prompt_len": [8, 24], "output_len": [6, 14],
                "n_requests": 256, "block": 4, "warmup": 4, "trace_s": 0.5},
}


def tiny_cell(kind: str) -> dict:
    """A configuration file's content at smoke size (float32)."""
    return {"target": copy.deepcopy(TINY_TARGETS[kind]),
            "draft": copy.deepcopy(TINY_DRAFT),
            "engine": {"max_batch": 2, "n_cand": 4,
                       "paged": kind == "moe", "block_size": 16},
            "check": {"sample": 3,
                      "limits": {"mean_gap": 0.01, "widest_gap": 0.05,
                                 "draft_mean_gap": 0.01,
                                 "draft_widest_gap": 0.05},
                      "min_tokens": 5}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (none here)")
    return torch.device("cuda")
