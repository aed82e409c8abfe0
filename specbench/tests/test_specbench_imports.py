"""No module of the benchmark imports JAX or the JAX package ``repro``
(by whole top-level name: ``repro_torch`` is the port), and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "specbench"
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_independent(path):
    assert "repro_torch" not in set(_imports(path))


def test_a_run_loads_no_jax():
    """The harness, the program and the reference in one process leave
    no forbidden module in ``sys.modules``."""
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import specbench.run as r, specbench.control, specbench.check;"
            "import repro_torch.serving.engine;"
            "print(r.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
