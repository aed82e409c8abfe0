"""The one-token decode over a sliding-window ring on the card: the
``decode_attention`` kernel's route against the plain masked ring
attention at the Mistral-7B draft's shapes (B 8, 1,568 slots, 32 / 8
heads of 128, bf16), before and after the ring wraps; and a fused round
over a sliding-window draft, captured and replayed as CUDA graphs,
against the same rounds run eagerly.

Each test skips without a CUDA device.  This file imports no JAX, so it
runs where only the port is installed; on a card:

    python -m pytest -q --noconftest tests/test_torch_ring_card.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import MISTRAL_7B  # noqa: E402
from repro_torch.core.pipeline import SpecOffloadEngine  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launches  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

# the offline-decode cell's draft: 8 rows a half, 1,568 slots a ring
B, SLOTS, HQ, HKV, D, WINDOW = 8, 1568, 32, 8, 128, 4096


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("pos", [[0, 1, 63, 64, 700, 1000, 1400, 1566],
                                 [1567, 1568, 1569, 2000, 2500, 3136, 3200,
                                  4100]], ids=["unwrapped", "wrapped"])
def test_ring_step_kernel_equals_plain(card, pos, monkeypatch):
    """``apply_attention`` at one token over a ring whose every slot holds
    rows (the stale ones past a row's length too): the kernel route's
    output, with one ``decode_attention`` launch, against the plain path
    on the same tensors; both write the same rows."""
    gen = torch.Generator(device=card).manual_seed(0)
    dm = HQ * D
    w = lambda n, m: (torch.randn(n, m, generator=gen, device=card)  # noqa
                      * n ** -0.5).to(torch.bfloat16)
    params = {"wq": w(dm, HQ * D), "wk": w(dm, HKV * D),
              "wv": w(dm, HKV * D), "wo": w(HQ * D, dm)}
    x = torch.randn(B, 1, dm, generator=gen, device=card).to(torch.bfloat16)
    kv = {k: torch.randn(B, SLOTS, HKV, D, generator=gen, device=card)
          .to(torch.bfloat16) for k in ("k", "v")}
    pos = torch.tensor(pos, device=card)
    outs, caches = {}, {}
    for kernel in (False, True):
        monkeypatch.setattr(TA, "on_card", lambda t, _k=kernel: _k)
        cache = {k: t.clone() for k, t in kv.items()}
        reset_launches()
        out, cache, saved = TA.apply_attention(
            params, x, n_heads=HQ, n_kv_heads=HKV, head_dim=D,
            rope_theta=1e4, window=WINDOW, cache=cache, pos=pos,
            phase="decode")
        torch.cuda.synchronize()
        assert launch_counts()["decode_attention"] == int(kernel)
        assert saved["k"].shape == (B, 1, HKV, D)
        outs[kernel], caches[kernel] = out.float(), cache
    err = (outs[True] - outs[False]).abs().max().item()
    assert err <= 2e-2 * outs[False].abs().max().item(), err
    for k in ("k", "v"):
        assert torch.equal(caches[True][k], caches[False][k])
    reset_launches()


def test_fused_round_graphs_equal_eager_rounds(card):
    """Target and draft the same sliding-window model (window 8, head dim
    32, f32) on the same weights, so the drafts are accepted: the
    streams and the per-round accepted counts of a run whose rounds are
    CUDA graphs equal an eager run's, the graphs were captured and
    replayed, and the draft's steps launched ``decode_attention``."""
    cfg = dataclasses.replace(MISTRAL_7B.reduced(d_model=128),
                              sliding_window=8)
    assert cfg.head_dim in da.F32_HEAD_DIMS
    params = init_params(cfg, torch.Generator(device=card).manual_seed(0),
                         card)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 12))
    runs = {}
    for graphs in (False, True):
        eng = SpecOffloadEngine(cfg, cfg, device=card, graphs=graphs)
        eng.load(params, params)
        reset_launches()
        res = eng.generate(prompts, gen_len=32, n_cand=4)
        torch.cuda.synchronize()
        runs[graphs] = (res, launch_counts(), eng._pipe.graph_captures)
    (eager, _, none), (graphed, launches, captures) = runs[False], runs[True]
    assert none == {"fused": 0, "draft": 0, "rollback": 0}
    assert captures["fused"] >= 1 and graphed.rounds > 4
    assert launches["decode_attention"] > 0
    np.testing.assert_array_equal(graphed.tokens, eager.tokens)
    assert [np.asarray(a).tolist() for a in graphed.accept_counts] == \
        [np.asarray(a).tolist() for a in eager.accept_counts]
    assert sum(np.asarray(a).sum() for a in eager.accept_counts) > 0
    reset_launches()
