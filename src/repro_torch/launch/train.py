"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro/launch/train.py``, with its flags, defaults and
printed lines, plus ``--device`` (``cuda`` unless ``--device cpu``).
It trains the reduced config (``--d-model``) on the synthetic LM stream
and prints the loss every tenth of the run, then ``loss a -> b
(LEARNED)`` when the last loss is under 0.7 of the first.  With
``--production-plan`` it prints the JAX launcher's three lines about the
full config, then ``train_4k``'s layout and accumulation steps on both
production meshes from :mod:`repro_torch.launch.specs`, and trains
nothing.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, resolve_device
from repro_torch.data.pipeline import make_lm_batches
from repro_torch.params import init_params
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-12b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--production-plan", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    full = get_config(args.arch)
    if args.production_plan:
        print(f"arch={full.name} params={full.param_count()/1e9:.1f}B "
              f"optimizer={full.optimizer} "
              f"offload_carries={full.offload_carries}")
        print("single-pod: batch=P('data'), seq-parallel axis='model', "
              f"accum=per launch/specs.pick_accum")
        print("multi-pod : batch=P(('pod','data')), weights podified "
              "(FSDP over pod+data)")
        from repro_torch.configs import INPUT_SHAPES
        from repro_torch.launch.specs import pick_accum, train_layout
        shape = INPUT_SHAPES["train_4k"]
        for kind, axes, sizes in (("single-pod", ("data", "model"), (16, 16)),
                                  ("multi-pod ", ("pod", "data", "model"),
                                   (2, 16, 16))):
            mesh = argparse.Namespace(mesh_dim_names=axes, shape=sizes)
            print(f"{kind}: train_4k (batch, seq, seq-parallel axis)="
                  f"{train_layout(full, shape, mesh)} "
                  f"accum={pick_accum(full, shape, mesh)}")
        return

    device = resolve_device(args.device)
    cfg = full.reduced(d_model=args.d_model)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    opt_init, _ = make_optimizer(cfg.optimizer)
    opt_state = opt_init(params, cfg)
    data = make_lm_batches(args.batch, args.seq, cfg.vocab_size)
    params, opt_state, log = train_loop(cfg, params, opt_state, data,
                                        args.steps, lr=args.lr,
                                        log_every=max(args.steps // 10, 1))
    for row in log:
        print(f"step {row['step']:4d}  loss {row['loss']:.4f}  "
              f"({row['elapsed_s']:.1f}s)")
    first, last = log[0]["loss"], log[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'LEARNED' if last < first * 0.7 else 'check hyperparams'})")


if __name__ == "__main__":
    main()
