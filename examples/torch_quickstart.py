"""Quickstart over the PyTorch/CUDA port: speculative decoding with
SpecOffload.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py``, over ``repro_torch``, and
it prints what that script prints.  Builds a tiny target + draft pair,
prefills a prompt batch, and runs draft-then-verify rounds, printing
per-round acceptance so you can watch speculative decoding emit
1..n_cand+1 tokens per target pass.  The output stream of every sequence
is verified to equal the target's own greedy decoding (speculative
decoding is lossless).  Runs on the card unless ``--device cpu``; on the
card the prefill runs the ``flash_attention`` kernel and each verify the
``decode_attention`` kernel.  The weights and prompts are drawn from the
JAX script's seeds (0, 1 and 2) with ``torch.Generator``, unless the
caller hands them in.
"""
import argparse

import torch

from repro_torch.configs import ModelConfig, resolve_device
from repro_torch.core.spec_decode import spec_round
from repro_torch.models import model as M
from repro_torch.models.transformer import init_cache
from repro_torch.params import init_params

target_cfg = ModelConfig(name="target", arch_type="dense", n_layers=4,
                         d_model=128, n_heads=4, n_kv_heads=2, d_ff=384,
                         vocab_size=211, dtype="float32", remat=False)
draft_cfg = ModelConfig(name="draft", arch_type="dense", n_layers=2,
                        d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
                        vocab_size=211, dtype="float32", remat=False)

B, L, GEN, N_CAND = 4, 16, 24, 4


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def main(argv=None, *, target_params=None, draft_params=None,
         prompts=None):
    """Returns the emitted streams, one list of tokens a sequence."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tp = (init_params(target_cfg, _gen(device, 0), device)
          if target_params is None else target_params)
    dp = (init_params(draft_cfg, _gen(device, 1), device)
          if draft_params is None else draft_params)
    if prompts is None:
        prompts = torch.randint(0, 211, (B, L), generator=_gen(device, 2),
                                device=device)
    prompts = torch.as_tensor(prompts, device=device).long()

    tc = init_cache(target_cfg, B, 128, device)
    dc = init_cache(draft_cfg, B, 128, device)
    logits, tc = M.prefill(tp, target_cfg, prompts, tc)
    _, dc = M.prefill(dp, draft_cfg, prompts, dc)
    t_next = torch.argmax(logits, -1)

    out = [[t] for t in t_next.tolist()]
    rounds = 0
    while min(len(o) for o in out) < GEN:
        r = spec_round(tp, target_cfg, tc, dp, draft_cfg, dc, t_next,
                       N_CAND)
        tc, dc, t_next = r["target_cache"], r["draft_cache"], r["t_next"]
        print(f"round {rounds:2d}: accepted per seq = "
              f"{r['n_accept'].tolist()} (+1 bonus each)")
        for o, n, toks in zip(out, r["n_emitted"].tolist(),
                              r["tokens"].tolist()):
            o.extend(toks[:n])
        rounds += 1

    total = sum(min(len(o), GEN) for o in out)
    print(f"\n{total} tokens in {rounds} verify rounds "
          f"({total/B/rounds:.2f} tokens/seq/round vs 1.0 for plain "
          f"decoding)")

    # losslessness check vs the target's own greedy decoding, every row
    cache = init_cache(target_cfg, B, 128, device)
    lg, cache = M.prefill(tp, target_cfg, prompts, cache)
    tok = torch.argmax(lg, -1)
    for t in range(GEN):
        ref = tok.tolist()
        for b in range(B):
            assert out[b][t] == ref[b], (b, t, out[b][t], ref[b])
        lg, cache = M.decode_step(tp, target_cfg, cache, tok[:, None])
        tok = torch.argmax(lg, -1)
    print("lossless: speculative output == target greedy decoding  [OK]")
    return out


if __name__ == "__main__":
    main()
