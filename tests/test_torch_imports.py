"""The port stands alone: no module of ``repro_torch`` (nor
``chip_smoke.py`` nor ``examples/torch_*.py``) imports JAX or the JAX
package, a kernel wrapper
given a CUDA tensor launches its kernel or raises (never the plain
version), and entry points refuse to guess a device."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402
from repro_torch.kernels import moe_ffn as mf  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pd  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(repro_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PKG], "repro_torch."))


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(_modules()) >= 25
    assert {"repro_torch.kernels.decode_attention",
            "repro_torch.kernels.rglru_scan", "repro_torch.kernels.wkv6",
            "repro_torch.models.rglru",
            "repro_torch.models.rwkv", "repro_torch.obs.metrics",
            "repro_torch.obs.trace", "repro_torch.obs.request_trace",
            "repro_torch.obs.slo", "repro_torch.obs.schema",
            "repro_torch.serving.server",
            "repro_torch.kernels.flash_attention_bwd",
            "repro_torch.training.optimizer",
            "repro_torch.training.train_loop",
            "repro_torch.training.checkpoint", "repro_torch.data.pipeline",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.tree"} <= set(_modules())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _examples():
    ex = os.path.join(ROOT, "examples")
    return sorted(os.path.join(ex, n) for n in os.listdir(ex)
                  if n.startswith("torch_") and n.endswith(".py"))


def test_importing_the_examples_loads_no_jax():
    """Each ``examples/torch_*.py`` loaded as a module (its ``main`` not
    run) pulls in neither JAX nor the JAX package."""
    code = (
        "import importlib.util, sys\n"
        f"paths = {_examples()!r}\n"
        "for i, p in enumerate(paths):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(paths))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 4


def test_no_source_names_jax_or_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")] + _examples()
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


WRAPPER_CALLS = {
    "paged": (pd, "paged_decode_attention_ref", lambda: pd.paged_decode_attention(
        torch.zeros(1, 4, 2, 64), torch.zeros(3, 8, 2, 64),
        torch.zeros(3, 8, 2, 64), torch.ones(1, 2, dtype=torch.int32),
        torch.tensor([5], dtype=torch.int32))),
    "flash": (fa, "flash_attention_ref", lambda: fa.flash_attention(
        torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64),
        torch.zeros(1, 2, 8, 64))),
    "flash_bwd": (fb, "flash_attention_bwd_ref",
                  lambda: fb.flash_attention_bwd(
                      torch.zeros(1, 4, 8, 64), torch.zeros(1, 2, 8, 64),
                      torch.zeros(1, 2, 8, 64), torch.zeros(1, 4, 8, 64),
                      torch.zeros(1, 4, 8), torch.zeros(1, 4, 8, 64))),
    "moe": (mf, "moe_ffn_ref", lambda: mf.moe_ffn(
        torch.zeros(2, 3, 8), torch.zeros(2, 8, 4), torch.zeros(2, 8, 4),
        torch.zeros(2, 4, 8))),
    "decode": (da, "decode_attention_ref", lambda: da.decode_attention(
        torch.zeros(1, 4, 2, 64), torch.zeros(1, 2, 8, 64),
        torch.zeros(1, 2, 8, 64), torch.tensor([5], dtype=torch.int32))),
    "rglru": (rg, "rglru_scan_ref", lambda: rg.rglru_scan(
        torch.zeros(1, 3, 8), torch.zeros(1, 3, 8), torch.zeros(1, 8))),
    "wkv6": (wk, "wkv6_ref", lambda: wk.wkv6(
        *[torch.zeros(1, 2, 3, 64)] * 4, torch.zeros(2, 64),
        torch.zeros(1, 2, 64, 64))),
}


@pytest.mark.parametrize("which", sorted(WRAPPER_CALLS))
def test_cuda_call_without_a_build_raises(which, monkeypatch):
    """Flag the call as a CUDA call and make the build loader fail: the
    wrapper must raise, never fall back to its plain version."""
    mod, ref_name, call = WRAPPER_CALLS[which]
    plain_calls = []
    monkeypatch.setattr(ref, ref_name,
                        lambda *a, **k: plain_calls.append(1))
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)

    def no_build(name):
        raise _build.KernelBuildError(f"no build of {name}")
    monkeypatch.setattr(_build, "load_library", no_build)
    fn = getattr(mod, mod.__name__.rsplit(".", 1)[1])
    before = fn.launches
    with pytest.raises(_build.KernelBuildError):
        call()
    assert plain_calls == [] and fn.launches == before


def test_cpu_calls_take_the_plain_version_without_counting():
    mod, ref_name, call = WRAPPER_CALLS["moe"]
    before = mf.moe_ffn.launches
    out = call()
    assert out.shape == (2, 3, 8) and mf.moe_ffn.launches == before


def test_entry_points_default_to_cuda(monkeypatch):
    from repro_torch.configs import MIXTRAL_8X7B
    from repro_torch.core.pipeline import SpecOffloadEngine
    from repro_torch.models.transformer import init_cache
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MIXTRAL_8X7B.reduced(d_model=64)
    for make in (lambda: SpecOffloadEngine(cfg, cfg),
                 lambda: ServingEngine(cfg, cfg),
                 lambda: init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_chip_smoke_refuses_a_machine_without_a_card(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result;
    alone in a directory (no package beside it) it fails as well."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, str(tmp_path / "chip_smoke.py"))):
        if cwd == tmp_path:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
