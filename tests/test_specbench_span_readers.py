"""The benchmark's readers of the program's device marks and launch spans
(``specbench/metrics/verify_ms.py``, ``draft_ms.py``, ``rollback_ms.py``,
``launch_ms.py``) on synthetic traced slices: the profiler's device
timeline as ``specbench.devtrace.stop`` returns it (kernels sorted by
start, microseconds) with the host's annotations beside it."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from specbench import run  # noqa: E402

ROUND = ("round_begin", "draft_begin", "round_end", "rollback_begin",
         "rollback_end")


def _ctx(device=(), host=(), rounds=2):
    ctx = run.Context(target={}, draft={}, engine={}, peaks={})
    ctx.trace = {"device": sorted(device, key=lambda d: d[1]),
                 "host": list(host)}
    ctx.trace_rounds = rounds
    return ctx


def _mark(kind, t):
    return (f"obs_mark_{kind}", t, t + 1.5)


def _rounds(t0, verify_us, draft_us, rollback_us, n):
    """``n`` rounds from ``t0``: the five marks a round, a kernel of
    other work between each two, 100 us of host time between rounds."""
    dev, t = [], t0
    for _ in range(n):
        for kind, gap in zip(ROUND, (verify_us, draft_us, 20.0,
                                      rollback_us, 100.0)):
            dev.append(_mark(kind, t))
            dev.append(("sm90_xmma_gemm", t + 2.0, t + gap - 1.0))
            t += gap
    return dev


@pytest.mark.parametrize("metric,want_ms", [
    ("verify_ms.offline", 30.0), ("draft_ms.offline", 80.0),
    ("rollback_ms.offline", 0.5)])
def test_mark_readers_mean_complete_pairs(metric, want_ms):
    """Three whole rounds, then a round the slice's edge cuts after its
    verify began, and before them the end of a round the slice caught
    from its last fused mark on: only complete pairs count."""
    dev = _rounds(1e6, 30e3, 80e3, 500.0, 3)
    head = [_mark("round_end", 50e3), _mark("rollback_begin", 50e3 + 20),
            _mark("rollback_end", 50e3 + 520)]
    tail = [_mark("round_begin", 9e6)]
    ctx = _ctx(head + dev + tail)
    assert run.load_reader(metric)(ctx) == pytest.approx(want_ms)


@pytest.mark.parametrize("metric", ["verify_ms.offline", "draft_ms.offline",
                                    "rollback_ms.offline",
                                    "launch_ms.offline"])
def test_readers_without_marks_or_launches_read_nothing(metric):
    """A slice of a program without marks or launch spans (the parent of
    the marks), a slice with nothing traced, and an untraced run: None,
    never 0."""
    read = run.load_reader(metric)
    other = [("sm90_xmma_gemm", 0.0, 10.0), ("direct_copy_kernel", 12.0,
                                              20.0)]
    host = [("user_annotation", "target_verify/verify(fused)", 0.0, 30.0),
            ("cuda_runtime", "cudaGraphLaunch", 1.0, 25.0)]
    assert read(_ctx(other, host)) is None
    assert read(_ctx()) is None
    ctx = _ctx(other, host)
    ctx.trace = None
    assert read(ctx) is None


def test_a_lone_end_mark_pairs_with_nothing():
    """Marks of one kind in a row (a round whose boundary mark fell out
    of the slice) pair the last begin with the next end only."""
    dev = [_mark("round_begin", 0.0), _mark("round_begin", 100.0),
           _mark("draft_begin", 400.0), _mark("draft_begin", 900.0)]
    assert run.load_reader("verify_ms.offline")(_ctx(dev)) == \
        pytest.approx(0.3)


def test_launch_ms_is_host_launch_time_a_round():
    host = [("user_annotation", "launch/fused", 0.0, 30e3),
            ("user_annotation", "launch/rollback", 31e3, 31.5e3),
            ("user_annotation", "launch/fused", 50e3, 75e3),
            ("user_annotation", "launch/rollback", 76e3, 76.5e3),
            ("user_annotation", "target_verify/verify(fused)", 0.0, 31e3),
            ("cuda_runtime", "cudaGraphLaunch", 1.0, 29e3)]
    ctx = _ctx(host=host, rounds=2)
    assert run.load_reader("launch_ms.offline")(ctx) == pytest.approx(28.0)
    ctx.trace_rounds = 0
    assert run.load_reader("launch_ms.offline")(ctx) is None
