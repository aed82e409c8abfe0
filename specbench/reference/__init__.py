"""The plain reference: the served models' forward passes in float32
PyTorch, computed layer by layer from the weights the benchmark made.

It imports nothing of the program.  :func:`logits_at` dispatches on the
configuration's layer kinds; ``quant="fp8"`` computes every weight
product with both operands rounded to float8 (e4m3, one scale per
output channel of the weight and per token of the input): the control
that a comparison has to fail; ``quant="bf16"`` rounds both operands
to bfloat16 (a witness at the served precision).
"""
from __future__ import annotations

from .common import full_precision


def logits_at(params: dict, cfg: dict, seqs: list, positions: list,
              quant: str | None = None, layouts: list | None = None) -> list:
    """For each token sequence (an int64 tensor on the weights' device)
    the f32 logits (n, V) at its ``positions`` (indices into it).
    ``layouts`` (decoders only): per sequence None (a plain causal
    sequence) or a tree, (pos, lim, branch) as
    :func:`specbench.check.draft_inputs` makes it."""
    layouts = layouts or [None] * len(seqs)
    with full_precision():
        if all(k == "rwkv" for k in cfg["layer_pattern"]):
            if any(lay is not None for lay in layouts):
                raise ValueError("the RWKV-6 reference reads plain "
                                 "sequences only")
            from .rwkv6 import logits_at as run
            return run(params, cfg, seqs, positions, quant)
        from .decoder import logits_at as run
        return run(params, cfg, seqs, positions, quant, layouts)
