"""Data pipeline: synthetic token streams (for examples/benchmarks) and a
simple packed-LM batcher over token files.

A copy of ``repro/data/pipeline.py`` (numpy only): for the same seed
every function gives the JAX package's arrays.

The paper's workloads are offline batch-inference datasets (HumanEval,
C-Eval, SummEval, SAMSum); we model them with prompt-length distributions
matching Table 2 so planner/simulator inputs are faithful without shipping
the datasets themselves.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenDataset:
    """A set of prompts (ragged) + dataset statistics (paper Table 2)."""
    name: str
    prompts: list          # list[np.ndarray] of token ids
    s_avg: float
    s_max: int
    s_std: float

    @property
    def n(self):
        return len(self.prompts)


# Paper Table 2 statistics.
DATASET_STATS = {
    "humaneval": dict(s_avg=157.54, s_max=437, s_std=72.46),
    "ceval": dict(s_avg=165.46, s_max=483, s_std=103.18),
    "summeval": dict(s_avg=503.02, s_max=783, s_std=138.68),
    "samsum": dict(s_avg=168.10, s_max=1144, s_std=120.53),
}


def synthetic_dataset(name: str, n_prompts: int = 64, vocab: int = 32000,
                      seed: int = 0) -> TokenDataset:
    """Prompts with the named paper-dataset's length distribution."""
    stats = DATASET_STATS[name]
    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.normal(stats["s_avg"], stats["s_std"], n_prompts).astype(int),
        8, stats["s_max"])
    prompts = [rng.integers(0, vocab, int(l)).astype(np.int32)
               for l in lengths]
    return TokenDataset(name, prompts, **stats)


def pad_batch(prompts: list, pad_to: int | None = None,
              pad_id: int = 0) -> np.ndarray:
    """Left-pad prompts to a common length (common-length batches)."""
    n = max(len(p) for p in prompts)
    n = pad_to or n
    out = np.full((len(prompts), n), pad_id, np.int32)
    for i, p in enumerate(prompts):
        out[i, n - len(p):] = p[:n]
    return out


def make_lm_batches(batch: int, seq: int, vocab: int, seed: int = 0,
                    structured: bool = True):
    """Infinite iterator of {'tokens': (B, S)} LM batches.

    ``structured=True`` makes the stream learnable (arithmetic token
    sequences + noise) so training-loss curves actually go down in the
    end-to-end example.
    """
    rng = np.random.default_rng(seed)
    while True:
        if structured:
            start = rng.integers(0, vocab, (batch, 1))
            step = rng.integers(1, 7, (batch, 1))
            toks = (start + step * np.arange(seq)[None, :]) % vocab
            noise = rng.random((batch, seq)) < 0.02
            toks = np.where(noise, rng.integers(0, vocab, (batch, seq)), toks)
        else:
            toks = rng.integers(0, vocab, (batch, seq))
        yield {"tokens": toks.astype(np.int32)}
