"""Dry run of the production layouts: rank 0 of a 256- or 512-rank mesh
runs each (architecture x input shape) combination's step once, on meta
tensors, and reports what it holds, computes and moves, and whether that
fits one H100.

Counterpart of ``repro/launch/dryrun.py``.  Where the JAX dry run
lowers and compiles for 512 emulated host devices and reads XLA's
memory and cost analyses, this one runs the port's own step code
(``launch/specs.build_step``) eagerly in one process: a ``"fake"``
process group (``torch.testing``'s ``FakeStore``) of 256 or 512 ranks
with this process as rank 0, the production mesh over it
(:func:`repro_torch.launch.mesh.make_production_mesh`), and every
parameter, optimizer-state, input and cache block a meta tensor of the
rank's shape.  The collectives return at once without data, the kernel
wrappers return empty meta outputs and count their kernels' FLOPs
(``kernels/_build.meta_flops``).  Per combination it records:

* ``argument_bytes``: the rank's parameter, optimizer-state and
  input/cache blocks, exact (each storage once);
* ``peak_bytes``: the most bytes live at once during the step, the
  arguments included (a dispatch mode that follows every storage an
  operation makes until it is freed);
* ``flops``: ``FlopCounterMode``'s count of the PyTorch operations plus
  the kernels' own (``kernel_flops``);
* ``collectives``: ``collective_bytes()`` by operation, what rank 0
  hands each kind of collective;
* ``seconds``: the run's wall time on this host.

``fits_80gb`` compares the peak with the H100's memory
(``sim/hardware.py``'s ``H100.accel_mem_bytes``).  ``parse_collectives``
and ``shape_bytes`` of the JAX module parse XLA's optimised HLO and have
no counterpart: the port counts its collectives as it runs them.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

Results go to ``build/dryrun/{single,multi}/<arch>__<shape>.json`` at
the root of the checkout.  Without the ``"fake"`` backend the run
raises; it never counts on another one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH_SHAPES = {"single": (16, 16), "multi": (2, 16, 16)}


def _fake_group(world: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``world`` ranks."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                # never count on another backend
        raise RuntimeError("the dry run needs torch's 'fake' process group "
                           "(torch.testing._internal.distributed.fake_pg)"
                           ) from e
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors, each storage once."""
    seen = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


class LiveBytes(TorchDispatchMode):
    """Follows every storage the operations under it make (and those of
    ``baseline``), each counted once until it is freed; ``peak`` is the
    most bytes live at once.  A freed storage is noticed when the count
    would pass the peak, so the peak is exact."""

    def __init__(self, baseline=()):
        super().__init__()
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.live: dict = {}
        self.now = self.peak = 0
        for t in baseline:
            self._add(t)

    def _sweep(self) -> None:
        for key, (ref, n) in list(self.live.items()):
            if ref.expired():
                del self.live[key]
                self.now -= n

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        old = self.live.get(key)
        if old is not None and not old[0].expired():
            return
        if old is not None:
            self.now -= old[1]
        self.live[key] = (self._ref(st), st.nbytes())
        self.now += st.nbytes()
        if self.now > self.peak:
            self._sweep()
            self.peak = max(self.peak, self.now)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _tensors(out):
            self._add(t)
        return out


def run_step(cfg, shape, mesh) -> dict:
    """``build_step``'s function for (cfg, shape) on ``mesh`` once, on
    meta tensors: the record's numbers (see the module's docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import _build
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch.specs import build_step
    from repro_torch.sim.hardware import H100

    t0 = time.perf_counter()
    fn, args, _ = build_step(cfg, shape, mesh)
    arg_bytes = tree_bytes(args)
    tmesh.reset_collective_bytes()
    _build.meta_flops.clear()
    with FlopCounterMode(display=False) as flops:
        with LiveBytes(_tensors(args)) as mem:
            fn(*args)
    kernel_flops = dict(_build.meta_flops)
    return {"argument_bytes": arg_bytes, "peak_bytes": mem.peak,
            "fits_80gb": bool(mem.peak <= H100.accel_mem_bytes),
            "flops": flops.get_total_flops() + sum(kernel_flops.values()),
            "kernel_flops": kernel_flops,
            "collectives": tmesh.collective_bytes(),
            "seconds": time.perf_counter() - t0}


def run_one(cfg, shape, mesh_shape: tuple) -> dict:
    """One combination as rank 0 of a fake group over ``mesh_shape``:
    ``("data", "model")`` for two dims, ``("pod", "data", "model")`` for
    three."""
    import math

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import applicable

    rec = {"arch": cfg.name, "shape": shape.name, "phase": shape.phase,
           "mesh": list(mesh_shape)}
    ok, reason = applicable(cfg, shape)
    if not ok:
        return dict(rec, status="skip", reason=reason)
    _fake_group(math.prod(mesh_shape))
    axes = ("data", "model") if len(mesh_shape) == 2 else ("pod", "data",
                                                          "model")
    mesh = make_mesh(mesh_shape, axes, device_type="cpu")
    return dict(rec, status="ok", n_ranks=math.prod(mesh_shape),
                **run_step(cfg, shape, mesh))


def result_path(arch: str, shape: str, mesh_kind: str) -> Path:
    return RESULTS_DIR / mesh_kind / f"{arch}__{shape}.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) in a subprocess of its own, "
                    "half the host's CPUs at once")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        todo = [(a, s, m) for m in meshes for a in ARCHS
                for s in INPUT_SHAPES
                if args.force or not result_path(a, s, m).exists()]
        failures, running = [], []
        jobs = max(1, (os.cpu_count() or 2) // 2)
        t_all = time.perf_counter()

        def reap(proc, combo):
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(combo)
                print(out[-2000:] + err[-4000:])

        for combo in todo:
            while len(running) >= jobs:
                done = [r for r in running if r[0].poll() is not None]
                if not done:
                    time.sleep(0.5)
                for r in done:
                    running.remove(r)
                    reap(*r)
            a, s, m = combo
            print(f"[run] {m:6s} {a:28s} {s}", flush=True)
            running.append((subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", a, "--shape", s, "--mesh", m],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                combo))
        for proc, combo in running:
            reap(proc, combo)
        print(f"done in {time.perf_counter() - t_all:.0f}s; "
              f"{len(failures)} failures: {failures}")
        return 1 if failures else 0
    if args.mesh == "both":
        ap.error("one combination takes --mesh single or multi")
    rec = run_one(get_config(args.arch), INPUT_SHAPES[args.shape],
                  MESH_SHAPES[args.mesh])
    rec["mesh"] = args.mesh
    out = result_path(args.arch, args.shape, args.mesh)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
