"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode, at the cases
of tests/test_kernels.py plus int8 pools, tree ancestor bitmasks, sliding
windows, padding, gelu and the recurrences' state stacks.  Inputs come
from numpy seeds and go through both packages.  Tolerances are the
Pallas tests': attention and the FFN f32 2e-5, bf16 2e-2; ``rglru_scan``
1e-5; ``wkv6`` 2e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_ffn as mf  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pd  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=2e-5, atol=2e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _both(x, dt):
    """One numpy array as a (jax, torch) pair in dtype ``dt``."""
    jd, td = DT[dt]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _close(got_torch, want_jax, dt):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (1, 4, 2, 128, 128, 64, True, None),
    (2, 2, 1, 256, 256, 128, True, None),
    (1, 4, 4, 128, 128, 64, True, 40),     # sliding window
    (1, 2, 2, 100, 100, 64, True, None),   # non-multiple seq (padding)
    (2, 8, 2, 128, 128, 64, False, None),  # bidirectional
])
def test_flash_attention_matches_pallas(dt, b, hq, hkv, sq, skv, d, causal,
                                        window):
    rng = np.random.default_rng(0)
    qj, qt = _both(rng.standard_normal((b, hq, sq, d), np.float32), dt)
    kj, kt = _both(rng.standard_normal((b, hkv, skv, d), np.float32), dt)
    vj, vt = _both(rng.standard_normal((b, hkv, skv, d), np.float32), dt)
    want = ops.flash_attention(qj, kj, vj, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dt)


def _paged_case(rng, b, hkv, mbs, bs, d, quant):
    """Random pool, disjoint per-sequence block tables, optional scales."""
    nb = b * mbs + 3
    perm = rng.permutation(nb)[:b * mbs].reshape(b, mbs).astype(np.int32)
    if quant:
        kp = rng.integers(-127, 128, (nb, bs, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb, bs, hkv, d)).astype(np.int8)
        scs = rng.uniform(0.01, 0.1, (2, nb, bs, hkv, 1)).astype(np.float32)
        return kp, vp, perm, scs
    kp = rng.standard_normal((nb, bs, hkv, d), np.float32)
    vp = rng.standard_normal((nb, bs, hkv, d), np.float32)
    return kp, vp, perm, None


TREE_ANC = np.array([1, 3, 5, 11], np.int32)   # root, 2 children, grandchild


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,m,mbs,bs,d,quant,tree", [
    (2, 4, 2, 1, 4, 16, 64, False, False),   # plain paged decode
    (2, 4, 2, 5, 4, 16, 64, False, False),   # speculative verify
    (1, 8, 1, 4, 8, 8, 128, False, False),   # MQA, small blocks
    (2, 2, 2, 3, 3, 32, 64, True, False),    # int8 pool + scales
    (1, 4, 2, 4, 5, 16, 64, True, False),    # int8, MBS under the pool
    (2, 4, 2, 4, 4, 16, 64, False, True),    # tree ancestor bitmasks
    (2, 4, 2, 4, 3, 16, 64, True, True),     # tree on an int8 pool
])
def test_paged_decode_attention_matches_pallas(dt, b, hq, hkv, m, mbs, bs, d,
                                               quant, tree):
    rng = np.random.default_rng(1)
    qj, qt = _both(rng.standard_normal((b, hq, m, d), np.float32), dt)
    kp, vp, bt, scs = _paged_case(rng, b, hkv, mbs, bs, d, quant)
    lengths = rng.integers(m + 1, mbs * bs + 1, b).astype(np.int32)
    if quant:
        kpj, kpt = jnp.asarray(kp), torch.from_numpy(kp)
        vpj, vpt = jnp.asarray(vp), torch.from_numpy(vp)
        sc_j = dict(k_scale=jnp.asarray(scs[0]), v_scale=jnp.asarray(scs[1]))
        sc_t = dict(k_scale=torch.from_numpy(scs[0]),
                    v_scale=torch.from_numpy(scs[1]))
    else:
        kpj, kpt = _both(kp, dt)
        vpj, vpt = _both(vp, dt)
        sc_j, sc_t = {}, {}
    anc_j = jnp.asarray(TREE_ANC) if tree else None
    anc_t = torch.from_numpy(TREE_ANC) if tree else None
    want = ops.paged_decode_attention(qj, kpj, vpj, jnp.asarray(bt),
                                      jnp.asarray(lengths), anc_bits=anc_j,
                                      interpret=True, **sc_j)
    got = pd.paged_decode_attention(qt, kpt, vpt, torch.from_numpy(bt),
                                    torch.from_numpy(lengths),
                                    anc_bits=anc_t, **sc_t)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dt)


def test_paged_null_table_entries_read_block_zero():
    """Table entries <= 0 resolve to block 0, as on the TPU."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 2, 2, 64), np.float32)
    kp = rng.standard_normal((4, 8, 1, 64), np.float32)
    vp = rng.standard_normal((4, 8, 1, 64), np.float32)
    bt = np.array([[2, -1, 0]], np.int32)
    lengths = np.array([20], np.int32)
    want = ops.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(bt),
                                      jnp.asarray(lengths), interpret=True)
    got = pd.paged_decode_attention(torch.from_numpy(q), torch.from_numpy(kp),
                                    torch.from_numpy(vp), torch.from_numpy(bt),
                                    torch.from_numpy(lengths))
    _close(got, want, "f32")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f,activation", [
    (4, 128, 64, 256, "swiglu"),
    (2, 100, 128, 300, "swiglu"),     # non-multiples (padding)
    (8, 64, 32, 128, "swiglu"),
    (4, 20, 64, 192, "gelu"),         # gelu, decode-sized capacity
])
def test_moe_ffn_matches_pallas(dt, e, c, d, f, activation):
    rng = np.random.default_rng(3)
    bj, bt_ = _both(rng.standard_normal((e, c, d), np.float32), dt)
    wg = (rng.standard_normal((e, d, f), np.float32) * 0.1)
    wu = (rng.standard_normal((e, d, f), np.float32) * 0.1)
    wd = (rng.standard_normal((e, f, d), np.float32) * 0.1)
    (gj, gt), (uj, ut), (dj, dt_) = _both(wg, dt), _both(wu, dt), _both(wd, dt)
    want = ops.moe_ffn(bj, gj, uj, dj, activation=activation, block_c=64,
                       block_f=128, interpret=True)
    got = mf.moe_ffn(bt_, gt, ut, dt_, activation=activation)
    assert got.dtype == bt_.dtype and got.shape == bt_.shape
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("b,hq,hkv,m,skv,d,window,tree", [
    (2, 4, 2, 1, 256, 64, None, False),     # plain decode
    (2, 4, 2, 5, 256, 64, None, False),     # speculative verify (n_cand=4)
    (1, 8, 1, 4, 512, 128, None, False),    # MQA
    (2, 2, 2, 3, 300, 64, None, False),     # non-multiple cache length
    (1, 4, 2, 4, 256, 64, 64, False),       # sliding window cache
    (2, 4, 2, 4, 128, 64, None, True),      # tree ancestor bitmasks
])
def test_decode_attention_matches_pallas(dt, b, hq, hkv, m, skv, d, window,
                                         tree):
    rng = np.random.default_rng(6)
    qj, qt = _both(rng.standard_normal((b, hq, m, d), np.float32), dt)
    kj, kt = _both(rng.standard_normal((b, hkv, skv, d), np.float32), dt)
    vj, vt = _both(rng.standard_normal((b, hkv, skv, d), np.float32), dt)
    lengths = rng.integers(m + 8, skv + 1, b).astype(np.int32)
    anc_j = jnp.asarray(TREE_ANC) if tree else None
    anc_t = torch.from_numpy(TREE_ANC) if tree else None
    want = ops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                window=window, block_k=64, anc_bits=anc_j,
                                interpret=True)
    got = da.decode_attention(qt, kt, vt, torch.from_numpy(lengths),
                              window=window, anc_bits=anc_t)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    _close(got, want, dt)


def test_decode_attention_reads_a_transposed_cache():
    """The model hands the kernel its (B, S, Hkv, d) cache as a transposed
    view; the result equals the contiguous (B, Hkv, S, d) call."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 4, 5, 64), np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 2, 40, 2, 64),
                                                 np.float32))
    lengths = torch.tensor([17, 40], dtype=torch.int32)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    got = da.decode_attention(q, k, v, lengths)
    want = da.decode_attention(q, k.contiguous(), v.contiguous(), lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,s,w", [(2, 64, 256), (1, 128, 100), (4, 32, 512)])
def test_rglru_scan_matches_pallas(b, s, w):
    rng = np.random.default_rng(8)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w), np.float32)))
    g = rng.standard_normal((b, s, w), np.float32)
    h0 = rng.standard_normal((b, w), np.float32)
    want = ops.rglru_scan(jnp.asarray(a), jnp.asarray(g), jnp.asarray(h0),
                          block_w=128, interpret=True)
    got = rg.rglru_scan(torch.from_numpy(a), torch.from_numpy(g),
                        torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,h,s,hd", [(1, 2, 32, 64), (2, 4, 16, 64),
                                      (1, 1, 64, 128)])
def test_wkv6_matches_pallas(b, h, s, hd):
    """y and the final state against the Pallas kernel; the state stack's
    last entry is the final state and its first the initial one."""
    rng = np.random.default_rng(9)
    r, k, v = (rng.standard_normal((b, h, s, hd), np.float32)
               for _ in range(3))
    w = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, h, s, hd), np.float32)))
    u = rng.standard_normal((h, hd), np.float32) * 0.1
    s0 = rng.standard_normal((b, h, hd, hd), np.float32) * 0.1
    want_y, want_s = ops.wkv6(*map(jnp.asarray, (r, k, v, w, u, s0)),
                              interpret=True)
    tin = [torch.from_numpy(x) for x in (r, k, v, w, u, s0)]
    y, s_fin, stack = wk.wkv6(*tin, stack=True)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **tol)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(want_s), **tol)
    assert stack.shape == (b, s + 1, h, hd, hd)
    torch.testing.assert_close(stack[:, 0], tin[5], rtol=0, atol=0)
    torch.testing.assert_close(stack[:, -1], s_fin, rtol=0, atol=0)
    y2, s2 = wk.wkv6(*tin)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)
    torch.testing.assert_close(s2, s_fin, rtol=0, atol=0)


def test_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 4, 2, 64)
    pool = torch.zeros(3, 8, 2, 64)
    bt = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError):       # int8 pool without scales
        pd.paged_decode_attention(q, pool.to(torch.int8),
                                  pool.to(torch.int8), bt, lens)
    with pytest.raises(ValueError):       # head dims disagree
        fa.flash_attention(q, torch.zeros(1, 2, 2, 32), torch.zeros(1, 2, 2, 32))
    with pytest.raises(ValueError):       # dtype mismatch
        mf.moe_ffn(torch.zeros(2, 3, 8), torch.zeros(2, 8, 4).double(),
                   torch.zeros(2, 8, 4), torch.zeros(2, 4, 8))
    with pytest.raises(ValueError):       # mixed devices are refused
        _build.use_kernel(q, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):       # the recurrences take f32 only
        rg.rglru_scan(torch.zeros(1, 2, 8).bfloat16(),
                      torch.zeros(1, 2, 8).bfloat16(), torch.zeros(1, 8))
    with pytest.raises(ValueError):       # u must be (H, hd)
        x = torch.zeros(1, 2, 3, 32)
        wk.wkv6(x, x, x, x, torch.zeros(3, 32), torch.zeros(1, 2, 32, 32))
    with pytest.raises(ValueError):       # a window and a tree together
        da.decode_attention(q, torch.zeros(1, 2, 8, 64),
                            torch.zeros(1, 2, 8, 64), lens, window=4,
                            anc_bits=torch.ones(2, dtype=torch.int32))
