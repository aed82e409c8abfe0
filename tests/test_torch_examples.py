"""The four ``examples/torch_*.py`` against the JAX package's examples on
the same weights, on the CPU (``--device cpu``, f32).  Each JAX example
runs unchanged in a subprocess with ``PYTHONPATH=src`` (all four at
once), through a wrapper that hands back its stdout and, pickled, the
weights it drew and what it computed; the port's ``main`` gets those
weights through ``repro_torch.params.from_jax``.

- quickstart: stdout equal line for line (every ``round k: accepted per
  seq`` line, the summary, the losslessness line), and the emitted
  streams equal row for row;
- planner demo: stdout equal line for line;
- serving example (``--requests 4 --gen 6``): the target / placement /
  note lines and ``fused compiles=1`` equal, every request's tokens
  equal by request id; admission and ``rounds=`` follow the virtual
  clock, which advances by measured wall time, so the counts, occupancy,
  latency lines and ``first result tokens`` (whichever request finished
  first) are held to their form;
- training example (``--steps 10``): every logged loss within rtol 1e-4
  of JAX's ``train_loop`` on the same weights and batches, and both stop
  at the ``did not learn`` assertion (10 steps do not halve the loss);
- each example, given no ``--device`` on a machine without a card,
  raises.
"""
import ast
import importlib.util
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import MISTRAL_7B, get_config  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
SERVE_ARGS = ["--requests", "4", "--gen", "6"]
TRAIN_ARGS = ["--steps", "10"]
# example: (its arguments, the JAX script's globals a test reads back)
JAX_RUNS = {
    "quickstart": ([], "dict(out=out, tp=tp, dp=dp, prompts=prompts)"),
    "planner_demo": ([], "{}"),
    "serve_spec_offload": (SERVE_ARGS, "dict(results={r.rid: np.asarray("
                           "r.result).tolist() for r in done}, "
                           "tp=eng.engine.tp, dp=eng.engine.dp)"),
    "train_small": (TRAIN_ARGS, "dict(log=log, params=M.init_params("
                    "cfg, jax.random.PRNGKey(0)))"),
}
# the script runs as its own __main__; an assertion it stops at is
# printed, and the globals named are pickled with JAX arrays as numpy
WRAPPER = """
import pickle, sys
import jax, numpy as np
script, out, keep, *argv = sys.argv[1:]
sys.argv = [script, *argv]
g = {"__name__": "__main__", "__file__": script}
try:
    exec(compile(open(script).read(), script, "exec"), g)
except AssertionError as e:
    print(f"AssertionError: {e}")
kept = jax.tree.map(lambda a: np.asarray(a) if isinstance(a, jax.Array)
                    else a, eval(keep, g))
with open(out, "wb") as f:
    pickle.dump(kept, f)
"""


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_{name}", ROOT / "examples" / f"torch_{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{example: (stdout lines, kept globals)}, the four run at once."""
    tmp = tmp_path_factory.mktemp("jax_examples")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", WRAPPER, str(ROOT / "examples" / f"{name}.py"),
         str(tmp / f"{name}.pkl"), keep, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, (args, keep) in JAX_RUNS.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-4000:]
            with open(tmp / f"{name}.pkl", "rb") as f:
                out[name] = (stdout.splitlines(), pickle.load(f))
    finally:
        for p in procs.values():
            p.kill()
    return out


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_and_emits_what_jax_does(jax_runs, capsys):
    want, kept = jax_runs["quickstart"]
    mod = _example("quickstart")
    out = mod.main(CPU, target_params=from_jax(kept["tp"], mod.target_cfg,
                                               "cpu"),
                   draft_params=from_jax(kept["dp"], mod.draft_cfg, "cpu"),
                   prompts=kept["prompts"])
    got = _lines(capsys)
    assert sum(line.startswith("round ") for line in got) >= 2
    assert got == want
    assert out == kept["out"]


def test_planner_demo_prints_what_jax_does(jax_runs, capsys):
    _example("planner_demo").main(CPU)
    got = _lines(capsys)
    assert len(got) > 10 and got == jax_runs["planner_demo"][0]


def test_serving_example_serves_what_jax_does(jax_runs, capsys):
    want, kept = jax_runs["serve_spec_offload"]
    tcfg = get_config("mixtral-8x7b").reduced(d_model=128)
    dcfg = MISTRAL_7B.reduced(d_model=64, vocab=tcfg.vocab_size)
    done = _example("serve_spec_offload").main(
        SERVE_ARGS + CPU, target_params=from_jax(kept["tp"], tcfg, "cpu"),
        draft_params=from_jax(kept["dp"], dcfg, "cpu"))
    got = _lines(capsys)
    assert {r.rid: r.result.tolist() for r in done} == kept["results"]
    assert len(done) == 4
    # the lines before the blank one: target, placement, notes
    head = want.index("")
    assert head >= 3 and got[:head + 1] == want[:head + 1]
    toks = sum(len(v) for v in kept["results"].values())
    forms = [rf"served 4 requests / {toks} tokens in [\d.]+s "
             r"\([\d.]+ tok/s\)",
             r"occupancy=[\d.]+, rounds=\d+, fused compiles=1",
             r"ttft: \{'p50': [\d.e-]+, 'p95': [\d.e-]+, 'p99': [\d.e-]+\}",
             r"e2e:  \{'p50': [\d.e-]+, 'p95': [\d.e-]+, 'p99': [\d.e-]+\}",
             r"first result tokens: \[[\d, ]+\]"]
    for lines in (got, want):
        assert len(lines) == head + 1 + len(forms)
        for line, form in zip(lines[head + 1:], forms):
            assert re.fullmatch(form, line), (line, form)
    first = ast.literal_eval(got[-1].split(": ", 1)[1])
    assert first == done[0].result.tolist()


def test_training_example_logs_what_jax_train_loop_does(jax_runs, capsys,
                                                        monkeypatch):
    want, kept = jax_runs["train_small"]
    mod = _example("train_small")
    logs, train_loop = [], mod.train_loop

    def recording(*a, **k):             # the log main would return
        res = train_loop(*a, **k)
        logs.append(res[2])
        return res
    monkeypatch.setattr(mod, "train_loop", recording)
    with pytest.raises(AssertionError, match="did not learn"):
        mod.main(TRAIN_ARGS + CPU,
                 params=from_jax(kept["params"], mod.cfg, "cpu"))
    got = _lines(capsys)
    assert want[-1] == "AssertionError: did not learn"
    assert got[0] == want[0] == "model: 0.84M params, pattern ('swa', 'attn')"
    step = lambda lines: [line.split("  loss")[0] for line in lines[1:]
                          if line.startswith("step")]
    assert step(got) == step(want) == [f"step {i:4d}" for i in range(10)]
    (log,) = logs
    assert [r["step"] for r in log] == [r["step"] for r in kept["log"]]
    np.testing.assert_allclose([r["loss"] for r in log],
                               [r["loss"] for r in kept["log"]], rtol=1e-4)


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_example_without_a_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _example(name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(JAX_RUNS[name][0])
