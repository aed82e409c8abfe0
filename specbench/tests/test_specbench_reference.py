"""The plain reference against the program's own CPU path at smoke size
(the test imports the program; the reference does not)."""
from __future__ import annotations

import pytest
import torch

from specbench import reference, weights
from specbench.run import model_config
from conftest import TINY_DRAFT, TINY_TARGETS


@pytest.mark.parametrize("kind", ["moe", "rwkv", "draft"])
def test_reference_matches_program(kind):
    from repro_torch.models import model as M
    cfg = TINY_DRAFT if kind == "draft" else TINY_TARGETS[kind]
    params, _ = weights.make_weights(cfg, TINY_DRAFT, 5, "cpu")
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg["vocab_size"], (2, 40), generator=gen)
    want = M.forward_train(params, model_config(cfg), {"tokens": toks})
    pos = torch.arange(40)
    got = reference.logits_at(params, cfg, [toks[0], toks[1]], [pos, pos])
    for b in range(2):
        err = (got[b] - want[b]).abs().max().item()
        assert err < 1e-4 * max(1.0, want[b].abs().max().item()), err


@pytest.mark.parametrize("kind", ["moe", "rwkv"])
def test_fp8_control_departs(kind):
    """The control computes in float8: its logits leave the f32
    reference's by far more than float32's rounding."""
    cfg = TINY_TARGETS[kind]
    params, _ = weights.make_weights(cfg, TINY_DRAFT, 9, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (48,),
                         generator=torch.Generator().manual_seed(1))
    pos = torch.arange(48)
    ref = reference.logits_at(params, cfg, [toks], [pos])[0]
    ctl = reference.logits_at(params, cfg, [toks], [pos], quant="fp8")[0]
    rel = ((ctl - ref).abs().max() / ref.abs().max()).item()
    assert rel > 1e-3


def test_tree_reads_each_branch_as_its_own_sequence():
    """The draft's chains as branches of one tree give the logits that
    each chain, read as a plain sequence after its prefix, gives."""
    from specbench import check as chk
    params, _ = weights.make_weights(TINY_DRAFT, TINY_DRAFT, 7, "cpu")
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, 128, (20,), generator=g).numpy()
    served = torch.randint(0, 128, (12,), generator=g).numpy()
    rounds = [(n, torch.randint(0, 128, (4,), generator=g).numpy())
              for n in (1, 5, 12)]
    seq, layout, reads, picks = chk.draft_inputs(prompt, served, rounds)
    t = torch.as_tensor
    tree = reference.logits_at(params, TINY_DRAFT, [t(seq)], [t(reads)],
                               layouts=[tuple(t(a) for a in layout)])[0]
    k = 0
    for n, chain in rounds:
        plain = torch.cat([t(prompt), t(served[:n]), t(chain[:3])]).long()
        c = len(prompt) + n
        want = reference.logits_at(params, TINY_DRAFT, [plain],
                                   [torch.arange(c - 1, c + 3)])[0]
        assert (tree[k:k + 4] - want).abs().max() < 1e-4
        assert list(picks[k:k + 4]) == list(chain)
        k += 4
