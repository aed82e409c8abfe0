"""The one traffic generator: reads a mix's parameters (a JSON file under
``specbench/traffic/``) and draws its requests.

A mix holds:

* ``arrivals``: ``"closed"`` (a backlog of ``backlog`` queued requests is
  kept behind the busy slots: the queue never empties) or ``"poisson"``
  (open loop at ``rate_rps`` requests a second, each request due at its
  own time whatever the system does);
* ``burst`` (open loop, optional): ``[lo, hi]`` requests that arrive
  together, uniform; the bursts come as a Poisson process at
  ``rate_rps`` / the mean burst, so the mix still offers ``rate_rps``;
  ``burst_spacing_s`` (default 0) spaces the requests of one burst;
* ``prompt_len`` / ``output_len``: ``[lo, hi]``, uniform;
* ``n_requests``: the pool drawn for one run (more than a window uses);
* ``warmup``: requests served before the window (their lengths are the
  ends of the two ranges, so every kind of shape the window meets has
  run once);
* ``trace_s``: the seconds at the window's end that a traced run records;
* ``extends`` (optional): the name of another mix whose keys this one
  takes where it does not set them.

The schedule (every length, every arrival time, and their order) is the
same for every seed: within each block of ``block`` consecutive requests
the lengths and gaps are the block's evenly spaced quantiles of their
distributions, in an order drawn once from a fixed generator.  The seed
draws the prompt tokens alone, so two runs of a cell differ by their
tokens and by noise, never by the work or the arrivals.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC = Path(__file__).resolve().parent / "traffic"
SCHEDULE = 0x5BE7C4            # the fixed generator of lengths and gaps


def load_mix(name: str, folder: Path = TRAFFIC) -> dict:
    """The mix ``<folder>/<name>.json`` with what it ``extends`` merged in
    under it."""
    mix = json.loads((folder / f"{name}.json").read_text())
    base = mix.pop("extends", None)
    if base is None:
        return mix
    if base == name:
        raise ValueError(f"mix {name!r} extends itself")
    return {**load_mix(base, folder), **mix}


def _quantiles(lo: int, hi: int, k: int) -> np.ndarray:
    q = (np.arange(k) + 0.5) / k
    return np.minimum(lo + np.floor(q * (hi - lo + 1)), hi).astype(np.int64)


def _stratified(lo: int, hi: int, n: int, block: int, rng) -> np.ndarray:
    grid = _quantiles(lo, hi, block)
    out = [rng.permutation(grid) for _ in range(-(-n // block))]
    return np.concatenate(out)[:n]


def _gaps(rate: float, n: int, block: int, rng) -> np.ndarray:
    q = (np.arange(block) + 0.5) / block
    grid = -np.log1p(-q) / rate
    out = [rng.permutation(grid) for _ in range(-(-n // block))]
    return np.concatenate(out)[:n]


def _dues(mix: dict, n: int, block: int, rate: float, rng) -> list:
    """Due times (seconds after the window opens) of ``n`` requests."""
    blo, bhi = mix.get("burst", [1, 1])
    sizes = _stratified(int(blo), int(bhi), n, block, rng)
    mean = float(np.mean(_quantiles(int(blo), int(bhi), block)))
    starts = np.cumsum(_gaps(rate / mean, len(sizes), block, rng))
    spacing = float(mix.get("burst_spacing_s", 0.0))
    dues = [float(t) + i * spacing for t, k in zip(starts, sizes)
            for i in range(int(k))]
    return dues[:n]


def make_requests(mix: dict, seed: int, vocab: int,
                  rate: float | None = None) -> dict:
    """``{"requests": [...], "warmup": [...]}``; each request a dict with
    ``prompt`` (int32 array), ``max_new`` and ``due_s`` (seconds after
    the window opens; None in a closed loop).  ``rate`` overrides the
    mix's ``rate_rps`` (the rate sweep)."""
    sched = np.random.default_rng(SCHEDULE)
    toks = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                  0x5BE7C4])
    n, block = int(mix["n_requests"]), int(mix.get("block", 16))
    plo, phi = mix["prompt_len"]
    olo, ohi = mix["output_len"]
    plen = _stratified(plo, phi, n, block, sched)
    olen = _stratified(olo, ohi, n, block, sched)
    due = [None] * n
    if mix["arrivals"] == "poisson":
        r = float(rate if rate is not None else mix["rate_rps"])
        due = _dues(mix, n, block, r, sched)
    elif mix["arrivals"] != "closed":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    reqs = [{"prompt": toks.integers(0, vocab, int(p), dtype=np.int32),
             "max_new": int(o), "due_s": d}
            for p, o, d in zip(plen, olen, due)]
    ends = [(phi, olo), (plo, ohi), (phi, ohi), (plo, olo)]
    warm = [{"prompt": toks.integers(0, vocab, p, dtype=np.int32),
             "max_new": o, "due_s": None}
            for p, o in ends[:int(mix.get("warmup", 0))]]
    return {"requests": reqs, "warmup": warm}


def max_lengths(mix: dict) -> tuple:
    """(longest prompt, longest output) the mix can draw."""
    return int(mix["prompt_len"][1]), int(mix["output_len"][1])
