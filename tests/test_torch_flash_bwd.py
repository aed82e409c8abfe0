"""The flash backward's plain version and its autograd plumbing against
the JAX package: ``flash_attention_ref``'s log-sum-exp against
``_flash_forward``'s, ``flash_attention_bwd_ref`` against ``jax.vjp`` of
``attention_chunked`` (whose custom VJP is ``_flash_bwd_rule``), over
causal, sliding-window and bidirectional masks, GQA (g 1, 2 and 8), Sq
!= Skv (also under a causal mask, both ways), lengths that are no
multiple of the KV chunk, and the edges of the bf16 kernels' tiles (Sq
and Skv of 63, 65 and 129; a window of 23, under a tile and no multiple
of 16); ``FlashAttentionFn`` on
CPU tensors against autograd of the materialised plain attention; and
the attention layer's train phase against JAX's.  Inputs are drawn with
numpy from a seed; f32, atol 1e-5 (rtol 1e-5)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fb  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

TOL = 1e-5

# (b, hq, hkv, sq, skv, d, causal, window, kv_chunk)
CASES = {
    "causal": (2, 4, 4, 40, 40, 16, True, None, 16),
    "window": (1, 4, 2, 40, 40, 16, True, 8, 16),
    "bidirectional": (2, 2, 2, 33, 33, 16, False, None, 16),
    "gqa-g2": (1, 4, 2, 48, 48, 32, True, None, 16),
    "sq-ne-skv": (2, 4, 2, 24, 40, 16, False, None, 16),
    "ragged-37": (1, 2, 1, 37, 37, 16, True, 12, 16),
    # the edges of the bf16 kernels' tiles (64 query rows; 128 or 64 keys a
    # dK / dV CTA; 128 query rows and 128 or 32 keys a dQ tile)
    "edge-63": (1, 4, 2, 63, 63, 32, True, None, 16),
    "edge-65": (1, 4, 2, 65, 65, 16, True, None, 16),
    "edge-129": (1, 2, 1, 129, 129, 16, True, None, 32),
    "edge-window-23": (1, 4, 2, 129, 129, 16, True, 23, 16),
    "edge-g1": (1, 2, 2, 65, 65, 32, True, 23, 16),
    "edge-g8": (1, 8, 1, 65, 65, 16, True, None, 16),
    "edge-causal-sq-lt-skv": (1, 4, 2, 63, 129, 16, True, None, 16),
    "edge-causal-sq-gt-skv": (1, 4, 2, 129, 65, 16, True, None, 16),
}


def _inputs(case, seed=0):
    b, hq, hkv, sq, skv, d, causal, window, chunk = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    dout = rng.standard_normal((b, sq, hq * d)).astype(np.float32)
    return q, k, v, dout


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _heads_first(x):
    """(B, S, H, d) numpy -> (B, H, S, d) torch view."""
    return torch.from_numpy(x).transpose(1, 2)


def _jax_fn(case):
    b, hq, hkv, sq, skv, d, causal, window, chunk = CASES[case]
    qp = jnp.arange(sq, dtype=jnp.int32)
    kp = jnp.arange(skv, dtype=jnp.int32)
    return lambda q, k, v: jattn.attention_chunked(
        q, k, v, qp, kp, d ** -0.5, window=window, causal=causal,
        kv_chunk=chunk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_lse_matches_jax_flash_forward(case):
    b, hq, hkv, sq, skv, d, causal, window, chunk = CASES[case]
    q, k, v, _ = _inputs(case)
    out_j, lse_j = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.arange(sq, dtype=jnp.int32), jnp.arange(skv, dtype=jnp.int32),
        d ** -0.5, window, causal, chunk)
    out, lse = ref.flash_attention_ref(_heads_first(q), _heads_first(k),
                                       _heads_first(v), causal=causal,
                                       window=window, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    _close(lse, np.asarray(lse_j).reshape(b, hq, sq))
    _close(out.transpose(1, 2).reshape(b, sq, hq * d), out_j)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bwd_ref_matches_jax_custom_vjp(case):
    b, hq, hkv, sq, skv, d, causal, window, chunk = CASES[case]
    q, k, v, dout = _inputs(case, seed=1)
    out_j, vjp = jax.vjp(_jax_fn(case), jnp.asarray(q), jnp.asarray(k),
                         jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(dout))
    tq, tk, tv = _heads_first(q), _heads_first(k), _heads_first(v)
    out, lse = ref.flash_attention_ref(tq, tk, tv, causal=causal,
                                       window=window, return_lse=True)
    do = torch.from_numpy(dout).reshape(b, sq, hq, d).transpose(1, 2)
    # the wrapper on CPU tensors is the plain version
    before = fb.flash_attention_bwd.launches
    dq, dk, dv = fb.flash_attention_bwd(tq, tk, tv, out, lse, do,
                                        causal=causal, window=window)
    assert fb.flash_attention_bwd.launches == before
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        _close(got.transpose(1, 2), want)


def _plain_attention(q, k, v, causal, window):
    """Materialised softmax attention, (B, H, S, d) in and out."""
    g = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    qp = torch.arange(q.shape[2])[:, None]
    kp = torch.arange(k.shape[2])[None, :]
    ok = torch.ones_like(s, dtype=torch.bool)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.softmax(s.masked_fill(~ok, float("-inf")), -1) @ v


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_function_matches_autograd_of_plain_attention(case):
    b, hq, hkv, sq, skv, d, causal, window, chunk = CASES[case]
    q, k, v, dout = _inputs(case, seed=2)
    do = torch.from_numpy(dout).reshape(b, sq, hq, d).transpose(1, 2)
    grads = []
    for fn in (lambda *t: tattn.FlashAttentionFn.apply(*t, d ** -0.5, causal,
                                                        window),
               lambda *t: _plain_attention(*t, causal, window)):
        leaves = [_heads_first(x).clone().requires_grad_(True)
                  for x in (q, k, v)]
        out = fn(*leaves)
        grads.append((out.detach(), *torch.autograd.grad(out, leaves, do)))
    for got, want in zip(*grads):
        _close(got, want.numpy())


def test_flash_bshd_takes_the_function_only_under_grad(monkeypatch):
    """``flash_bshd`` goes through ``FlashAttentionFn`` when autograd
    records the call and straight to the forward wrapper otherwise."""
    q, k, v, _ = _inputs("gqa-g2")
    applied = []
    real = tattn.FlashAttentionFn.apply
    monkeypatch.setattr(tattn.FlashAttentionFn, "apply",
                        lambda *a: applied.append(1) or real(*a))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tattn.flash_bshd(tq, tk, tv, 0.25, causal=True)
    assert applied == []
    tattn.flash_bshd(tq.requires_grad_(True), tk, tv, 0.25, causal=True)
    assert applied == [1]
    with torch.no_grad():
        tattn.flash_bshd(tq, tk, tv, 0.25, causal=True)
    assert applied == [1]


@pytest.mark.parametrize("window", [None, 8])
def test_train_phase_attention_matches_jax(window):
    """The attention layer's train phase (projections, RoPE, the flash
    Function) and its weight gradients against JAX's apply_attention
    (train phase, kv_chunk 128) under ``jax.grad``."""
    rng = np.random.default_rng(3)
    b, s, dm, hq, hkv, d = 2, 20, 32, 4, 2, 8
    x = rng.standard_normal((b, s, dm)).astype(np.float32)
    w = {n: (rng.standard_normal(shape) * dm ** -0.5).astype(np.float32)
         for n, shape in (("wq", (dm, hq * d)), ("wk", (dm, hkv * d)),
                          ("wv", (dm, hkv * d)), ("wo", (hq * d, dm)))}
    dy = rng.standard_normal((b, s, dm)).astype(np.float32)
    kw = dict(n_heads=hq, n_kv_heads=hkv, head_dim=d, rope_theta=10000.0,
              window=window, phase="train")

    def jloss(p, xx):
        out, _, _ = jattn.apply_attention(p, xx, **kw)
        return jnp.sum(out * dy)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k_: jnp.asarray(v_) for k_, v_ in w.items()}, jnp.asarray(x))
    tw = {k_: torch.from_numpy(v_).requires_grad_(True) for k_, v_ in
          w.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _, _ = tattn.apply_attention(tw, tx, **kw)
    grads = torch.autograd.grad((out * torch.from_numpy(dy)).sum(),
                                [tx] + list(tw.values()))
    _close(grads[0], jgx)
    for name, g in zip(tw, grads[1:]):
        _close(g, jg[name])


# -- the bf16 kernels' tile walks, emulated (csrc/flash_attention_bwd.cu:
# q_range, kv_range, live_tile, whole_tile and the loops over them) --------

def _ranges_mask(sq, skv, causal, window, qoff=0):
    i = qoff + np.arange(sq)[:, None]
    j = np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= j > i - window
    return ok


def _walks(sq, skv, d, causal, window, qoff=0):
    """[(kernel, q0, nq, k0, nk, whole)] of every (query tile, key tile) a
    consumer warpgroup computes, as the two bf16 kernels walk them (query
    row i at position ``qoff + i``)."""
    w = window or 0
    wide = (d + 63) // 64 * 64 > 128
    bkv, bkvq = (64, 32) if wide else (128, 128)

    def live(q0, nq, k0, nk):
        return (q0 < sq and k0 < skv
                and (not causal or k0 <= q0 + qoff + nq - 1)
                and (w <= 0 or q0 + qoff < k0 + nk - 1 + w))

    def whole(q0, nq, k0, nk):
        return (q0 + nq <= sq and k0 + nk <= skv
                and (not causal or k0 + nk - 1 <= q0 + qoff)
                and (w <= 0 or k0 > q0 + qoff + nq - 1 - w))

    out = []
    for k0 in range(0, skv, bkv):              # dK / dV: a CTA's keys
        lo = max(0, k0 - qoff) if causal else 0
        hi = min(sq, k0 + bkv - 1 + w - qoff) if w > 0 else sq
        for t in range(lo // 64, -(-hi // 64) if hi > lo else 0):
            for kw0 in range(k0, k0 + bkv, 64):    # d <= 128: 2 warpgroups
                if live(64 * t, 64, kw0, 64):
                    out.append(("dkdv", 64 * t, 64, kw0, 64,
                                whole(64 * t, 64, kw0, 64)))
    for q0 in range(0, sq, 128):               # dQ: 128 query rows a CTA
        lo = max(0, q0 + qoff - w + 1) if w > 0 else 0
        hi = min(skv, q0 + qoff + 128) if causal else skv
        first = lo // bkvq * bkvq
        for k0 in range(first, hi if hi > first else first, bkvq):
            for qw0 in (q0, q0 + 64):
                if live(qw0, 64, k0, bkvq):
                    out.append(("dq", qw0, 64, k0, bkvq,
                                whole(qw0, 64, k0, bkvq)))
    return out


# (sq, skv, causal, window): CASES' shapes, and windows on both sides of
# the tiles' 32 / 64 / 128 rows over 300 tokens
WALKS = sorted({(c[3], c[4], c[6], c[7]) for c in CASES.values()}
               | {(300, 300, True, w) for w in (1, 8, 23, 31, 60, 64, 65,
                                                92, 100, 129)}
               | {(300, 300, False, 40), (200, 300, True, 50),
                  (300, 200, True, 50), (300, 200, False, None)},
               key=str)


@pytest.mark.parametrize("d", [128, 240])
@pytest.mark.parametrize("shape", WALKS, ids=str)
def test_tile_walks_cover_every_visible_pair_once(shape, d):
    """Each kernel computes every visible (query, key) pair in exactly one
    tile, and a tile it treats as whole (no per-element mask) holds only
    visible pairs."""
    sq, skv, causal, window = shape
    ok = _ranges_mask(sq, skv, causal, window)
    for kernel in ("dkdv", "dq"):
        seen = np.zeros((sq, skv), int)
        for kern, q0, nq, k0, nk, whole in _walks(sq, skv, d, causal, window):
            if kern != kernel:
                continue
            seen[q0:q0 + nq, k0:k0 + nk] += 1
            if whole:
                assert ok[q0:q0 + nq, k0:k0 + nk].all(), (kernel, q0, k0)
        assert (seen[ok] == 1).all(), kernel


# (sq, skv, causal, window, q offset): a rank's block of the queries
# under context parallelism, offsets on and off the tiles' rows
WALKS_OFFSET = [(sq, skv, causal, w, off)
                for sq, skv, off in ((128, 512, 128), (100, 400, 300),
                                     (64, 256, 37), (200, 300, 100))
                for causal, w in ((True, None), (True, 60), (False, None))]


@pytest.mark.parametrize("d", [128, 240])
@pytest.mark.parametrize("shape", WALKS_OFFSET, ids=str)
def test_tile_walks_with_a_query_offset_cover_every_pair_once(shape, d):
    """As the test above, the queries at positions ``offset + i``."""
    sq, skv, causal, window, off = shape
    ok = _ranges_mask(sq, skv, causal, window, off)
    for kernel in ("dkdv", "dq"):
        seen = np.zeros((sq, skv), int)
        for kern, q0, nq, k0, nk, whole in _walks(sq, skv, d, causal, window,
                                                  off):
            if kern != kernel:
                continue
            seen[q0:q0 + nq, k0:k0 + nk] += 1
            if whole:
                assert ok[q0:q0 + nq, k0:k0 + nk].all(), (kernel, q0, k0)
        assert (seen[ok] == 1).all(), kernel
