"""The precision contract of the port's tensor-core kernels, on the CPU.

The bf16 paths of ``flash_attention`` and ``moe_ffn`` run on the tensor
cores (``csrc/flash_attention.cu``, ``csrc/moe_ffn.cu``) and round where
the plain versions do not.  Test-local emulations round at the same
places, and each is held to the JAX Pallas kernel in interpret mode
within ``chip_smoke.py``'s bf16 tolerance (2e-2 absolute plus relative):

- flash: bf16 inputs, f32 scores and softmax, the probabilities P
  rounded to bf16 before the P V product, the row sum from the f32 P;
- moe_ffn: bf16 inputs, f32 products, act(g) * u rounded to bf16 before
  the down product.

Also: the wrapper reads the model's (B, S, H, d) tensors as transposed
views, the tensor-map strides it derives from them, the zero padding of
a ragged F, and the generated wgmma header.  Inputs come from numpy
seeds.
"""
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_ffn as mf  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = dict(rtol=2e-2, atol=2e-2)          # chip_smoke.py's bf16 tolerance
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _bf16(rng, shape, scale=1.0):
    """A numpy f32 array of bf16-representable values and its bf16
    tensor (the same numbers in both packages)."""
    t = torch.from_numpy((rng.standard_normal(shape) * scale)
                         .astype(np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


def _flash_tensor_core(q, k, v, *, causal, window):
    """Flash attention rounded as the wgmma kernel rounds it."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float().reshape(b, hkv, g, sq, d),
                     k.float()) * d ** -0.5
    qp = torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    s = torch.where(ok, s, torch.full_like(s, ref.NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(),
                     v.float()) / torch.clamp_min(l, 1e-30)
    return o.reshape(b, hq, sq, d).to(torch.bfloat16)


def _moe_tensor_core(buf, w_gate, w_up, w_down, activation):
    """The expert FFN rounded as the wgmma kernels round it."""
    x = buf.float()
    h = ref.ffn_act(torch.bmm(x, w_gate.float()), activation)
    h = (h * torch.bmm(x, w_up.float())).to(torch.bfloat16)
    return torch.bmm(h.float(), w_down.float()).to(torch.bfloat16)


def _pallas_flash(q, k, v, causal, window):
    return np.asarray(ops.flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), causal=causal, window=window,
        block_q=64, block_k=64, interpret=True), np.float32)


@pytest.mark.parametrize("b,hq,hkv,sq,d,causal,window", [
    (1, 2, 2, 128, 64, True, None),        # causal, g 1
    (1, 4, 1, 128, 128, True, None),       # causal, g 4
    (1, 2, 2, 128, 256, True, None),       # head dim 256
    (1, 4, 4, 128, 64, True, 40),          # sliding window
    (1, 4, 1, 100, 256, True, 40),         # window, MQA, ragged Sq
    (2, 4, 1, 128, 64, False, None),       # bidirectional, g 4
    (1, 4, 1, 100, 128, True, None),       # ragged Sq
    (1, 2, 2, 100, 256, False, None),      # bidirectional, d 256, ragged
])
def test_flash_tensor_core_rounding_within_bf16_tolerance(b, hq, hkv, sq, d,
                                                          causal, window):
    rng = np.random.default_rng(11)
    qn, qt = _bf16(rng, (b, hq, sq, d))
    kn, kt = _bf16(rng, (b, hkv, sq, d))
    vn, vt = _bf16(rng, (b, hkv, sq, d))
    want = _pallas_flash(qn, kn, vn, causal, window)
    got = _flash_tensor_core(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("e,c,d,f,activation", [
    (2, 100, 128, 300, "swiglu"),     # ragged C and F
    (4, 20, 64, 192, "gelu"),         # verify-sized capacity
    (3, 7, 64, 200, "swiglu"),        # C under one 8-wide token tile
    (2, 33, 32, 130, "geglu"),        # D under one 64-deep K step
])
def test_moe_tensor_core_rounding_within_bf16_tolerance(e, c, d, f,
                                                        activation):
    rng = np.random.default_rng(12)
    bn, bt_ = _bf16(rng, (e, c, d))
    gn, gt = _bf16(rng, (e, d, f), 0.1)
    un, ut = _bf16(rng, (e, d, f), 0.1)
    dn, dt_ = _bf16(rng, (e, f, d), 0.1)
    want = np.asarray(ops.moe_ffn(
        *(jnp.asarray(x, jnp.bfloat16) for x in (bn, gn, un, dn)),
        activation=activation, block_c=64, block_f=128, interpret=True),
        np.float32)
    got = _moe_tensor_core(bt_, gt, ut, dt_, activation)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL)


@pytest.mark.parametrize("hq,hkv,d,window", [
    (4, 2, 64, None), (4, 1, 128, None), (2, 1, 256, 40)])
def test_flash_reads_model_layout_views(hq, hkv, d, window):
    """(B, S, H, d) tensors handed over as transpose(1, 2) views, as the
    model's prefill does, give JAX's result."""
    rng = np.random.default_rng(13)
    b, s = 2, 96
    qn = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    kn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    vn = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    q, k, v = (torch.from_numpy(x).transpose(1, 2) for x in (qn, kn, vn))
    assert not q.is_contiguous()
    got = fa.flash_attention(q, k, v, causal=True, window=window)
    want = ops.flash_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (qn, kn, vn)),
        causal=True, window=window, block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("shape,view,want", [
    ((2, 96, 8, 128), True, [96 * 8 * 128, 128, 8 * 128]),   # model layout
    ((2, 8, 96, 64), False, [8 * 96 * 64, 96 * 64, 64]),     # contiguous
    ((1, 512, 1, 256), True, [512 * 256, 256, 256]),         # MQA k/v
])
def test_flash_tensor_map_strides(shape, view, want):
    t = torch.zeros(shape)
    assert fa._strides(t.transpose(1, 2) if view else t) == want


def test_flash_tensor_map_strides_refuse_unaligned_layouts():
    with pytest.raises(ValueError, match="multiples of 8"):
        fa._strides(torch.zeros(1, 2, 100, 12)[..., :4])   # rows 24 B apart
    with pytest.raises(ValueError, match="last dim"):
        fa._strides(torch.zeros(1, 2, 8, 64).transpose(2, 3))


@pytest.mark.parametrize("f", [130, 300])
def test_moe_zero_padding_of_ragged_f_changes_nothing(f):
    """The bf16 wrapper pads F to a multiple of 8 (zero columns of
    w_gate/w_up, zero rows of w_down) for TMA's 16-byte strides."""
    rng = np.random.default_rng(14)
    e, c, d, pad = 2, 9, 32, -f % 8
    buf = torch.from_numpy(rng.standard_normal((e, c, d)).astype(np.float32))
    wg, wu = (torch.from_numpy(rng.standard_normal((e, d, f))
                               .astype(np.float32) * 0.1) for _ in range(2))
    wd = torch.from_numpy(rng.standard_normal((e, f, d)).astype(np.float32)
                          * 0.1)
    F = torch.nn.functional
    padded = mf.moe_ffn(buf, F.pad(wg, (0, pad)), F.pad(wu, (0, pad)),
                        F.pad(wd, (0, 0, 0, pad)))
    torch.testing.assert_close(padded, mf.moe_ffn(buf, wg, wu, wd),
                               rtol=1e-6, atol=1e-6)


def test_wgmma_header_is_the_generators_output():
    gen = runpy.run_path(str(CSRC / "gen_wgmma.py"))
    assert (CSRC / "wgmma.cuh").read_text() == gen["header"]()
