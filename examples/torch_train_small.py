"""Train a small model for a few hundred steps on the synthetic LM
stream, over the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 200] \\
        [--device cpu]

The counterpart of ``examples/train_small.py``, and it prints what that
script prints.  Exercises the port's training substrate: model init,
the flash attention forward and backward kernels (``FlashAttentionFn``:
windowed and causal, on the card), chunked cross-entropy, AdamW.  Loss
should fall from ~ln(V) to near 0 on the structured stream.  Runs on the
card unless ``--device cpu``.  The weights are drawn from the JAX
script's seed (0) with ``torch.Generator``, unless the caller hands them
in.
"""
import argparse

import torch

from repro_torch.configs import ModelConfig, resolve_device
from repro_torch.data.pipeline import make_lm_batches
from repro_torch.params import init_params
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_loop import train_loop
from repro_torch.tree import tree_leaves

cfg = ModelConfig(name="train-small", arch_type="dense", n_layers=4,
                  d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
                  vocab_size=211, layer_pattern=("swa", "attn"),
                  sliding_window=32, dtype="float32", remat=False)


def main(argv=None, *, params=None):
    """Returns the training log (a row every ``steps // 10`` steps)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if params is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params/1e6:.2f}M params, pattern {cfg.layer_pattern}")

    opt_init, _ = make_optimizer("adamw")
    data = make_lm_batches(args.batch, args.seq, cfg.vocab_size)
    params, _, log = train_loop(cfg, params, opt_init(params, cfg), data,
                                args.steps, lr=2e-3,
                                log_every=max(args.steps // 10, 1))
    for row in log:
        print(f"step {row['step']:4d}  loss {row['loss']:.4f}")
    assert log[-1]["loss"] < log[0]["loss"] * 0.5, "did not learn"
    print("training OK: loss fell >2x")
    return log


if __name__ == "__main__":
    main()
