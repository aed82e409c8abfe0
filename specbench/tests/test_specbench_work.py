"""The work functions against counts made by hand."""
from __future__ import annotations

from specbench.work import flash_attention, model, moe_ffn, wkv6


def test_moe_ffn_one_call():
    # 40 tokens, top-2, D 4096, F 14336, all 8 experts read (bf16)
    f, b = moe_ffn.call(40, 2, 4096, 14336, 8)
    assert f == 2 * 3 * 80 * 4096 * 14336
    assert b == 8 * 3 * 4096 * 14336 * 2 + 2 * 80 * 4096 * 2
    assert 7.999 < moe_ffn.experts_touched(40, 2, 8) < 8.0


def test_wkv6_one_call():
    # B 2, H 3, S 5, hd 4, every state kept
    f, b = wkv6.call(2, 3, 5, 4, True)
    assert f == 7 * 2 * 3 * 5 * 16
    seq = 2 * 3 * 5 * 4 * 4
    assert b == 4 * seq + 3 * 4 * 4 + 2 * 3 * 16 * 4 + seq + 6 * 2 * 3 * 16 * 4
    f1, b1 = wkv6.call(1, 1, 10, 2, False)
    assert b1 == 4 * 80 + 8 + 16 + 80 + 16


def test_flash_attention_one_call():
    # causal L 4 without window: 10 pairs; with window 2: 1 + 2 + 2 + 2
    assert flash_attention.visible_pairs(4, None) == 10
    assert flash_attention.visible_pairs(4, 2) == 7
    f, b = flash_attention.call(1, 4, 8, 2, 16, None)
    assert f == 4 * 8 * 16 * 10
    assert b == 4 * 16 * (2 * 8 + 2 * 2) * 2


def test_round_counts_every_call():
    t = dict(d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16,
             vocab_size=10, n_layers=1, layer_pattern=["attn"],
             sliding_window=100, n_experts=0, top_k=0, dtype="float32")
    f, _ = model.forward(t, 1, 1, 0, stack=False)
    # head 2*8*10, projections 2*(2*8*4*3), attention 4*2*4*1, ffn 2*3*8*16
    assert f == 160 + 2 * 2 * 8 * 4 * 3 + 32 + 2 * 3 * 8 * 16
    fr, _ = model.spec_round(t, t, 1, 0, 0)
    assert fr == 2 * f
