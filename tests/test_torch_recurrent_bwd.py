"""The backward of the port's recurrences and the MoE layer's train route
against the JAX package on the CPU, and the backward kernels' orders
emulated in PyTorch:

* (a) the plain ``wkv6_bwd_ref`` against ``jax.vjp`` of the JAX
  package's ``repro.kernels.ref.wkv6_ref`` (S 1, 17, 64, 130; head sizes
  64 and 128; nonzero s0 and final-state gradient; the model's decays
  with w == 0 and w = 1 - 1e-7 channels); an emulation of
  ``csrc/wkv6_bwd.cu``'s chunked kernel (head sizes 64 and 128: pass 1's
  state before every 16-step chunk, pass 2's chunks in reverse with the
  decays inside a chunk as running products, column slabs added in
  order) in f64 and f32 against the plain version and ``jax.vjp``; and
  of its serial kernel at head size 32 (checkpoints every ``kSeg``
  steps, a segment's sub-checkpoints every ``kSub`` steps, the per-step
  states re-formed forward, the reverse recurrence, row sums by column
  group in order);
* (b) the port's ``models.rglru._rglru_scan`` (the gate products, then
  ``RGLRUScanFn`` whose backward is ``rglru_gated_scan_bwd_ref`` on the
  CPU) against ``jax.vjp`` of ``repro.models.rglru._rglru_scan`` over
  every parameter, x and h0 (S 1, 16, 17, 300; x f32 and bf16), the
  plain backward against the port's autograd of the plain forward, the
  reverse time-parallel scan of ``csrc/rglru_scan_bwd.cu``'s sequence
  route (segments of ``LAYOUT``, tiles from the last) against the plain
  reverse scan, and its chunked route (runs of a chunk, the ordered
  carry between chunks, the partial sums) against the plain reverse
  scan and the plain backward, its route by shape and its scratch;
* (c) ``torch.autograd.gradcheck`` in f64 through ``WKV6Fn`` and
  ``RGLRUScanFn``;
* (d) the MoE layer under a gradient (``MoEFFNFn``, whose backward is
  ``moe_ffn_bwd_ref`` on the CPU; tests/test_torch_moe_bwd.py holds the
  kernel's own steps) against ``jax.vjp`` of the JAX ``apply_moe``;
* (e) CUDA calls of the backward wrappers without a build raise, and
  their launches are counted;
* (f) remat's recompute counts, which the card's training runs in
  ``chip_smoke.py`` require launch for launch.

Tolerances as ROADMAP section 3 states them: gradients f32 atol 1e-5
plus rtol 5e-5, the atol times the gradient's largest magnitude where
that passes 1 (bf16 x: its rounding, 1e-2 on dx)."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=5e-5)


def _close(got, want, **tol):
    """Gradients: ``GRAD_TOL`` with atol scaled by the largest magnitude
    where that passes 1 (the recurrences' gradients reach 10-100 here,
    and f32 sums over a head and over time round in different orders in
    the two packages)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not tol:
        tol = dict(GRAD_TOL)
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# (a) wkv6


def _wkv6_inputs(b, h, s, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(dtype)
    r, k, v, dy = (f(b, h, s, hd) for _ in range(4))
    w = np.exp(-np.exp(rng.uniform(-8, 4, (b, h, s, hd)))).astype(dtype)
    w[..., 0] = 0.0
    w[..., 1] = 1.0 - 1e-7
    u, s0 = f(h, hd) * 0.1, f(b, h, hd, hd) * 0.1
    ds_fin = f(b, h, hd, hd)
    return r, k, v, w, u, s0, dy, ds_fin


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 17, 64, 130])
def test_wkv6_bwd_ref_matches_jax_vjp(s, hd):
    """Head sizes 64 and 128 (``HEAD_DIMS``; 32 is the launcher's reduced
    config, held by the whole-model gradient tests)."""
    r, k, v, w, u, s0, dy, ds_fin = _wkv6_inputs(2, 2, s, hd, seed=s + hd)
    _, vjp = jax.vjp(jref.wkv6_ref, *map(jnp.asarray, (r, k, v, w, u, s0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds_fin)))
    got = ref.wkv6_bwd_ref(*map(torch.from_numpy,
                                (r, k, v, w, u, s0, dy, ds_fin)))
    for g, j in zip(got, want):
        _close(g.numpy(), np.asarray(j))


# csrc/wkv6_bwd.cu's serial Cfg at head size 32 (keep the two in step):
# (kSeg, kSub), the spacing of the checkpoints in device memory and of a
# segment's sub-checkpoints in shared memory
BWD_LAYOUT = {32: (128, 16)}


def wkv6_bwd_emulation(r, k, v, w, u, s0, dy, ds_fin):
    """``csrc/wkv6_bwd.cu``'s order over (B, H) at once: pass A writes
    the state before every kSeg-th step; pass B walks the segments in
    reverse, writes the state before every kSub-th step of the segment,
    then walks the sub-segments in reverse, re-forms their kSub per-step
    states forward and runs the reverse recurrence.  dr / dk / dw are
    summed over each of the 8 column groups, then the groups in order,
    then the u terms added; dv is summed over each row slab's (min(64,
    hd) rows) warps of 32 rows, the warps added in order, (r.(u k)) dy
    added by slab 0, then the slabs in order."""
    b, h, s, hd = r.shape
    seg, sub = BWD_LAYOUT[hd]
    cols, n_slabs = hd // 8, max(1, hd // 64)
    ckpt, st = {}, s0.clone()
    for t in range(s):
        if t % seg == 0:
            ckpt[t // seg] = st.clone()
        st = w[:, :, t, :, None] * st + k[:, :, t, :, None] * v[:, :, t, None, :]
    g = ds_fin.clone()
    grads = [torch.zeros_like(r) for _ in range(4)]
    dr, dk, dv, dw = grads
    du = torch.zeros((b, h, hd))
    for n in range((s + seg - 1) // seg - 1, -1, -1):
        tb, te = n * seg, min(s, n * seg + seg)
        subck, st = [], ckpt[n].clone()
        for t0 in range(tb, te, sub):
            subck.append(st.clone())
            for t in range(t0, min(te, t0 + sub)):
                st = (w[:, :, t, :, None] * st
                      + k[:, :, t, :, None] * v[:, :, t, None, :])
        for ms in range(len(subck) - 1, -1, -1):
            t0 = tb + ms * sub
            steps = list(range(t0, min(te, t0 + sub)))
            sb = [subck[ms]]
            for t in steps[:-1]:
                sb.append(w[:, :, t, :, None] * sb[-1]
                          + k[:, :, t, :, None] * v[:, :, t, None, :])
            for m in range(len(steps) - 1, -1, -1):
                t = steps[m]
                rt, kt, vt, wt, dyt = (z[:, :, t] for z in (r, k, v, w, dy))
                q = (vt * dyt).sum(-1, keepdim=True)
                p = (rt * (u * kt)).sum(-1, keepdim=True)

                def by_groups(z):       # (B, H, hd, hd) -> rows, in order
                    parts = z.reshape(b, h, hd, 8, cols).sum(-1)
                    acc = parts[..., 0]
                    for gi in range(1, 8):
                        acc = acc + parts[..., gi]
                    return acc

                dr[:, :, t] = by_groups(sb[m] * dyt[:, :, None, :]) + u * q * kt
                dk[:, :, t] = by_groups(g * vt[:, :, None, :]) + u * q * rt
                dw[:, :, t] = by_groups(g * sb[m])
                halves = (kt[..., None] * g).reshape(b, h, n_slabs, -1, 32,
                                                     hd).sum(4)
                slabs = halves[:, :, :, 0]
                for hf in range(1, halves.shape[3]):
                    slabs = slabs + halves[:, :, :, hf]
                acc = slabs[:, :, 0] + p * dyt
                for si in range(1, slabs.shape[2]):
                    acc = acc + slabs[:, :, si]
                dv[:, :, t] = acc
                du += rt * kt * q
                g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    du_sum = du[0]
    for bi in range(1, b):
        du_sum = du_sum + du[bi]
    return dr, dk, dv, dw, du_sum, g


@pytest.mark.parametrize("hd,s", [(32, 1), (32, 129), (32, 300)])
def test_wkv6_bwd_emulation_matches_the_plain_backward(hd, s):
    """The serial kernel (head size 32): across checkpoint and
    sub-checkpoint boundaries, and a ragged last segment (128 steps a
    segment)."""
    args = tuple(map(torch.from_numpy, _wkv6_inputs(2, 2, s, hd, seed=7)))
    got = wkv6_bwd_emulation(*args)
    want = ref.wkv6_bwd_ref(*args)
    for g, w_ in zip(got, want):
        _close(g.numpy(), w_.numpy())


# csrc/wkv6_bwd.cu's chunked kernel (keep the two in step): steps a chunk
CHUNK = 16


def wkv6_bwd_chunked_emulation(r, k, v, w, u, s0, dy, ds_fin, slab):
    """``csrc/wkv6_bwd.cu``'s chunked order over (B, H) at once, one
    column slab of S and G at a time.  Pass 1: the state before every
    chunk, S <- tot S + (k Q)^T V with Q_s the product of w after s in
    the chunk.  Pass 2, the chunks in reverse: S_in dy_t, G v_t and B[s][t]
    = v_s . dy_t over the slab; per step t and channel the running decay
    products alpha_s = D_ts k_s (s < t), beta_s = E_ts r_s (s > t) and
    gamma_x = sum_s alpha_s B[s][x], which give dr, dk, dw and A's row;
    then dv = (k Q') G + A^T dy and G <- tot G + (r P)^T dy.  A ragged last
    chunk is padded with r = k = v = dy = 0 and w = 1.  dr / dk / dw of
    the slabs are added in order, du over the chunks, then the batch and
    the slabs in order."""
    b, h, s, hd = r.shape
    n_ch, dt = -(-s // CHUNK), r.dtype
    pad = n_ch * CHUNK - s
    padded = lambda x, fill=0.0: torch.cat(
        [x, torch.full((b, h, pad, hd), fill, dtype=dt)], 2)
    rp, kp, vp, wp, dyp = (padded(r), padded(k), padded(v), padded(w, 1.0),
                           padded(dy))
    n_sl = hd // slab
    parts = torch.zeros((n_sl, 3, b, h, n_ch * CHUNK, hd), dtype=dt)
    dv = torch.zeros((b, h, n_ch * CHUNK, hd), dtype=dt)
    du_part = torch.zeros((b, h, n_sl, hd), dtype=dt)
    ds0 = torch.zeros_like(s0)
    for sl in range(n_sl):
        cols = slice(sl * slab, (sl + 1) * slab)
        st, ckpt = s0[..., cols].clone(), []
        for c in range(n_ch):
            ckpt.append(st.clone())
            steps = slice(c * CHUNK, (c + 1) * CHUNK)
            wc, kc = wp[:, :, steps], kp[:, :, steps]
            q, kq = torch.ones((b, h, hd), dtype=dt), torch.empty_like(kc)
            for t in range(CHUNK - 1, -1, -1):
                kq[:, :, t] = kc[:, :, t] * q
                q = q * wc[:, :, t]
            st = q[..., None] * st + torch.einsum(
                "bhsi,bhsj->bhij", kq, vp[:, :, steps, cols])
        g = (ds_fin[..., cols].clone() if ds_fin is not None
             else torch.zeros((b, h, hd, slab), dtype=dt))
        du = torch.zeros((b, h, hd), dtype=dt)
        for c in range(n_ch - 1, -1, -1):
            steps = slice(c * CHUNK, (c + 1) * CHUNK)
            rc, kc, wc = rp[:, :, steps], kp[:, :, steps], wp[:, :, steps]
            vc, dyc = vp[:, :, steps, cols], dyp[:, :, steps, cols]
            s_in = ckpt[c]
            sdy = torch.einsum("bhtj,bhij->bhti", dyc, s_in)
            gv = torch.einsum("bhtj,bhij->bhti", vc, g)
            bm = torch.einsum("bhsj,bhtj->bhst", vc, dyc)
            rowdot = (g * s_in).sum(-1)
            p, qp = torch.empty_like(rc), torch.empty_like(rc)
            a_mat = torch.zeros((b, h, CHUNK, CHUNK), dtype=dt)
            for t in range(CHUNK):
                alpha, beta = torch.zeros_like(rc), torch.zeros_like(rc)
                dd, ee = torch.ones_like(rowdot), torch.ones_like(rowdot)
                for x in range(t - 1, -1, -1):
                    alpha[:, :, x] = dd * kc[:, :, x]
                    dd = dd * wc[:, :, x]
                for x in range(t + 1, CHUNK):
                    beta[:, :, x] = ee * rc[:, :, x]
                    ee = ee * wc[:, :, x]
                p[:, :, t], qp[:, :, t] = dd, ee
                gam = torch.einsum("bhsi,bhsx->bhxi", alpha, bm)
                btt = bm[:, :, t, t, None]
                uq = u * btt
                row = parts[sl][:, :, :, c * CHUNK + t]
                row[0] = dd * sdy[:, :, t] + gam[:, :, t] + uq * kc[:, :, t]
                row[1] = (ee * gv[:, :, t]
                          + (beta * bm[:, :, t, :, None]).sum(2)
                          + uq * rc[:, :, t])
                row[2] = (dd * ee * rowdot + ee * (alpha * gv).sum(2)
                          + dd * (beta * sdy).sum(2) + (beta * gam).sum(2))
                a_mat[:, :, t] = torch.einsum("bhi,bhsi->bhs", rc[:, :, t],
                                              alpha)
                a_mat[:, :, t, t] = (rc[:, :, t] * u * kc[:, :, t]).sum(-1)
                du = du + rc[:, :, t] * kc[:, :, t] * btt
            dv[:, :, steps, cols] = (
                torch.einsum("bhti,bhij->bhtj", kc * qp, g)
                + torch.einsum("bhst,bhsj->bhtj", a_mat, dyc))
            tot = p[:, :, -1] * wc[:, :, -1]
            g = tot[..., None] * g + torch.einsum("bhti,bhtj->bhij",
                                                  rc * p, dyc)
        ds0[..., cols] = g
        du_part[:, :, sl] = du
    out = parts[0]
    for sl in range(1, n_sl):
        out = out + parts[sl]
    du_sum = du_part[0, :, 0]
    for bi in range(b):
        for sl in range(n_sl):
            if bi or sl:
                du_sum = du_sum + du_part[bi, :, sl]
    dr, dk, dw = out[:, :, :, :s]
    return dr, dk, dv[:, :, :s], dw, du_sum, ds0


@pytest.mark.parametrize("hd,s,b,h,ds_fin,dtype,slabs", [
    (64, 1, 2, 2, True, "float64", (32, 64)),
    (64, 16, 2, 2, True, "float64", (64,)),
    (64, 17, 1, 3, False, "float64", (32, 64)),
    (64, 50, 1, 2, True, "float32", (64,)),
    (64, 40, 2, 1, False, "float32", (32,)),
    (128, 33, 2, 2, True, "float64", (32,)),
    (128, 37, 1, 2, False, "float32", (32,)),
    (128, 20, 1, 1, True, "float64", (32,))])
def test_wkv6_bwd_chunked_emulation_matches_plain_and_jax(hd, s, b, h,
                                                          ds_fin, dtype,
                                                          slabs):
    """Head sizes 64 (whole heads and 32-column slabs) and 128 (four
    slabs): one step, one whole chunk, a ragged last chunk (17, 20, 33,
    37, 40, 50), no final-state gradient; the model's decays with w == 0
    and w = 1 - 1e-7 channels.  f64 against the plain version to 1e-12
    of each output's largest magnitude; f32 also against ``jax.vjp``."""
    args = list(_wkv6_inputs(b, h, s, hd, seed=s + hd, dtype=dtype))
    if not ds_fin:
        args[7] = None
    ts = [None if x is None else torch.from_numpy(x) for x in args]
    want = ref.wkv6_bwd_ref(*(None if x is None else x.double() for x in ts))
    for slab in slabs:
        got = wkv6_bwd_chunked_emulation(*ts, slab)
        for g, w_ in zip(got, want):
            assert g.shape == w_.shape and g.dtype == ts[0].dtype
            if dtype == "float64":
                err = float((g - w_).abs().max())
                assert err <= 1e-12 * float(w_.abs().max()), err
            else:
                _close(g.numpy(), w_.numpy())
    if dtype == "float32":
        jargs = [jnp.asarray(x) for x in args[:6]]
        _, vjp = jax.vjp(jref.wkv6_ref, *jargs)
        dsf = (jnp.asarray(args[7]) if ds_fin
               else jnp.zeros_like(jnp.asarray(args[5])))
        for g, j in zip(got, vjp((jnp.asarray(args[6]), dsf))):
            _close(g.numpy(), np.asarray(j))


def test_chunked_backward_slabs_follow_the_heads():
    """Head size 64: two 32-column slabs a head while they fit in one
    wave of the card's 132 SMs (B x H up to 66: RWKV-6-7B at B 1), the
    whole head past that (5t-k: B 2, H 64); always 32-column slabs at
    head size 128; the serial kernel's head size 32 whole."""
    assert wk.bwd_slab(2, 64, 64) == 64
    assert wk.bwd_slab(2, 40, 64) == 64
    assert wk.bwd_slab(1, 67, 64) == 64
    assert wk.bwd_slab(1, 66, 64) == 32
    assert wk.bwd_slab(1, 64, 64) == 32
    assert wk.bwd_slab(2, 8, 64) == 32
    assert wk.bwd_slab(1, 32, 128) == 32
    assert wk.bwd_slab(2, 64, 128) == 32
    assert wk.bwd_slab(1, 1, 32) == 32


def test_head_size_32_runs_the_serial_kernel():
    assert wk.route(4096, False, 32) == "serial"
    assert wk.route(4096, False, 64) == "chunked"


def test_wkv6_bwd_without_final_gradient_is_a_zero_one():
    args = tuple(map(torch.from_numpy, _wkv6_inputs(1, 2, 9, 64, seed=3)))
    got = ref.wkv6_bwd_ref(*args[:7], None)
    want = ref.wkv6_bwd_ref(*args[:7], torch.zeros_like(args[7]))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (b) the gated RG-LRU


def _rglru_params(w, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.9, 0.999, w)
    p = {"w_a": rng.standard_normal((w, w)) * w ** -0.5,
         "w_i": rng.standard_normal((w, w)) * w ** -0.5,
         "b_a": rng.standard_normal(w) * 0.5,
         "b_i": rng.standard_normal(w) * 0.5,
         "a_param": np.log(np.expm1(-np.log(u) / 8.0))}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 16, 17, 300])
def test_rglru_gradients_match_jax_vjp(s, x_dtype):
    """Every parameter, x and h0 through the port's ``_rglru_scan`` (f32
    products, then ``RGLRUScanFn``) against ``jax.vjp`` of JAX's."""
    b, w = 2, 16
    rng = np.random.default_rng(s)
    params = _rglru_params(w, seed=s)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    jx = jnp.asarray(x).astype(x_dtype)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (h_all, _), vjp = jax.vjp(jrglru._rglru_scan, jp, jx, jnp.asarray(h0))
    jgp, jgx, jgh0 = vjp((jnp.asarray(dh), jnp.zeros_like(h_all)))

    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, x_dtype)).requires_grad_(True)
    th0 = torch.from_numpy(h0).requires_grad_(True)
    out = trglru._rglru_scan(tp, tx, th0)
    _close(out.detach().numpy(), np.asarray(h_all), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(out, [*tp.values(), tx, th0],
                                torch.from_numpy(dh))
    for name, g in zip(tp, grads):
        _close(g.numpy(), np.asarray(jgp[name]))
    tol = GRAD_TOL if x_dtype == "float32" else dict(atol=1e-2, rtol=1e-2)
    _close(grads[-2].float().numpy(), np.asarray(jgx.astype(jnp.float32)),
           **tol)
    _close(grads[-1].numpy(), np.asarray(jgh0))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_rglru_bwd_ref_matches_autograd_of_the_plain_forward(x_dtype):
    """The written-out backward against torch's autograd through
    ``rglru_gated_scan_ref``, a few channels past softplus's threshold."""
    b, s, w = 2, 23, 12
    gen = torch.Generator().manual_seed(0)
    rn = lambda *shape: torch.randn(shape, generator=gen)
    xa, xi, h0, dh = rn(b, s, w), rn(b, s, w), rn(b, w), rn(b, s, w)
    x = rn(b, s, w).to(x_dtype)
    b_a, b_i, a_param = rn(w) * 0.5, rn(w) * 0.5, rn(w)
    a_param[:2] = 25.0
    leaves = [t.clone().requires_grad_(True)
              for t in (xa, xi, x, b_a, b_i, a_param, h0)]
    h_all = ref.rglru_gated_scan_ref(*leaves)
    want = torch.autograd.grad(h_all, leaves, dh)
    got = ref.rglru_gated_scan_bwd_ref(xa, xi, x, b_a, b_i, a_param, h0,
                                       h_all.detach(), dh)
    order = (0, 1, 2, 3, 4, 5, 6)
    for i in order:
        tol = (GRAD_TOL if got[i].dtype != torch.bfloat16
               else dict(atol=1e-2, rtol=1e-2))
        torch.testing.assert_close(got[i].float(), want[i].float(), **tol)
    assert got[2].dtype == x_dtype


def rglru_reverse_scan_emulation(a, dh):
    """``csrc/rglru_scan_bwd.cu``'s reverse scan dH_t = dh_t + a_{t+1}
    dH_{t+1} in its layout: tiles of ``LAYOUT``'s segments walked from the
    last tile to the first, a ragged last tile padded past the end (a = 1,
    dh = 0, where dH stays 0); in a tile, segment 0 the latest steps,
    each segment composed backwards into (prod a, dH from 0), a
    Hillis-Steele scan over each warp's segments, the warps' totals
    composed in order onto the tile's carry, then every segment re-walked
    from its incoming dH."""
    seg, per_warp, per_tile = rg.LAYOUT
    b, s, w = a.shape
    tile_len = seg * per_tile
    pad = (-s) % tile_len
    coef = torch.cat([a[:, 1:], torch.ones((b, 1 + pad, w))], 1)
    d = torch.cat([dh, torch.zeros((b, pad, w))], 1)
    carry, tiles = torch.zeros((b, w)), []
    for t0 in range(s + pad - tile_len, -1, -tile_len):
        # (B, segment, step) with segment 0 the latest, steps latest first
        ct = coef[:, t0:t0 + tile_len].flip(1).reshape(b, per_tile, seg, w)
        dt = d[:, t0:t0 + tile_len].flip(1).reshape(b, per_tile, seg, w)
        big_a, big_h = torch.ones((b, per_tile, w)), torch.zeros(
            (b, per_tile, w))
        for k in range(seg):
            big_h = ct[:, :, k] * big_h + dt[:, :, k]
            big_a = big_a * ct[:, :, k]
        big_a = big_a.reshape(b, -1, per_warp, w)
        big_h = big_h.reshape(b, -1, per_warp, w)
        step = 1
        while step < per_warp:
            new_h, new_a = big_h.clone(), big_a.clone()
            new_h[:, :, step:] = (big_a[:, :, step:] * big_h[:, :, :-step]
                                  + big_h[:, :, step:])
            new_a[:, :, step:] = big_a[:, :, step:] * big_a[:, :, :-step]
            big_a, big_h, step = new_a, new_h, 2 * step
        starts = []
        for wi in range(per_tile // per_warp):
            x = carry.clone()
            for wj in range(wi):
                x = big_a[:, wj, -1] * x + big_h[:, wj, -1]
            for si in range(per_warp):
                starts.append(x if si == 0 else
                              big_a[:, wi, si - 1] * x + big_h[:, wi, si - 1])
        x, outs = torch.stack(starts, 1), []
        for k in range(seg):
            x = ct[:, :, k] * x + dt[:, :, k]
            outs.append(x)
        tile = torch.stack(outs, 2).reshape(b, tile_len, w).flip(1)
        tiles.insert(0, tile)
        carry = tile[:, 0]
    return torch.cat(tiles, 1)[:, :s]


@pytest.mark.parametrize("b,s,w", [(2, 1, 4), (2, 17, 36), (1, 100, 64),
                                   (2, 513, 20), (1, 1100, 12)])
def test_reverse_rglru_scan_emulation_matches_the_plain_reverse_scan(b, s,
                                                                     w):
    """Ragged segments, warps and tiles, RecurrentGemma's decays (a in
    [0.9, 0.999]) with two channels whose products underflow."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.9, 0.999, (b, s, w)).astype(np.float32)
    a[..., :2] = np.float32(1e-30)
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    a, dh = torch.from_numpy(a), torch.from_numpy(dh)
    want, carry = torch.empty_like(dh), torch.zeros((b, w))
    for t in range(s - 1, -1, -1):
        carry = dh[:, t] + (a[:, t + 1] * carry if t + 1 < s else 0)
        want[:, t] = carry
    got = rglru_reverse_scan_emulation(a, dh)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# csrc/rglru_scan_bwd.cu's chunked route (keep in step): kCWarps, the runs
# of T / kCWarps steps a chunk of T (``rg.BWD_CHUNK``) is cut into
RGLRU_CHUNK_WARPS = 8


def rglru_chunked_reverse_scan(a, dh, chunk):
    """``csrc/rglru_scan_bwd.cu``'s chunked reverse scan dH_t = dh_t +
    a_{t+1} dH_{t+1}: chunks of ``chunk`` steps, the latest first; in a
    chunk, run w (``RGLRU_CHUNK_WARPS`` runs) composed from its last live
    step down into (prod A, dH from 0) with A = a_{t+1} (1 past the end);
    the runs composed from the latest into the chunk's aggregate; the
    carry into a chunk the inclusive carry the chunk after it published
    (its aggregate applied to its own carry); each run's carry the runs
    after it composed onto the chunk's, then the run re-walked.  Returns
    dH (B, S, W)."""
    b, s, w = a.shape
    run_len = chunk // RGLRU_CHUNK_WARPS
    one, zero = torch.ones((b, w), dtype=a.dtype), torch.zeros(
        (b, w), dtype=a.dtype)
    decay = lambda t: a[:, t] if t < s else one
    out, carry = torch.empty_like(dh), zero
    for t0 in range(chunk * ((s - 1) // chunk), -1, -chunk):
        bounds = [(lo, min(lo + run_len, s - t0))
                  for lo in range(0, chunk, run_len)]
        runs = []
        for lo, top in bounds:
            big_a, big_h = one, zero
            for j in range(top - 1, lo - 1, -1):
                big_h = decay(t0 + j + 1) * big_h + dh[:, t0 + j]
                big_a = big_a * decay(t0 + j + 1)
            runs.append((big_a, big_h))
        agg_a, agg_h = one, zero
        for big_a, big_h in reversed(runs):
            agg_h = big_a * agg_h + big_h
            agg_a = agg_a * big_a
        for wi, (lo, top) in enumerate(bounds):
            x = carry
            for big_a, big_h in reversed(runs[wi + 1:]):
                x = big_a * x + big_h
            for j in range(top - 1, lo - 1, -1):
                x = decay(t0 + j + 1) * x + dh[:, t0 + j]
                out[:, t0 + j] = x
        carry = agg_a * carry + agg_h
    return out


def rglru_bwd_chunked_emulation(xa, xi, x, b_a, b_i, a_param, h0, h_all,
                                dh, chunk):
    """The chunked route's outputs in its order: the tiles as TMA stages
    them (rows past S zero; h_all from step max(t0 - 1, 0), step t
    reading h_{t-1} at row t - 1 - that), the reverse scan above, each
    step's gradients as the source forms them, the sums each run's steps
    from its last, then the runs in order into a (sequence, chunk)
    partial; the partials (sequence major) added by the slab's last CTA,
    warp k the rows k, k + 8, ..., then the warps in order."""
    b, s, w = xa.shape
    n_chunks = -(-s // chunk)
    pad = lambda t: torch.cat([t, torch.zeros(
        (b, n_chunks * chunk + 1 - s, w), dtype=t.dtype)], 1)
    xa_p, xi_p, x_p, h_p, dh_p = map(pad, (xa, xi, x.to(xa.dtype), h_all,
                                           dh))
    c = -8.0 * torch.nn.functional.softplus(a_param)
    r_all = torch.sigmoid(xa_p + b_a)
    a_all = torch.exp(c * r_all)
    d_h = rglru_chunked_reverse_scan(a_all[:, :s], dh, chunk)
    run_len = chunk // RGLRU_CHUNK_WARPS
    dxa, dxi, dx = (torch.empty_like(xa) for _ in range(3))
    dh0, parts = torch.empty_like(h0), []
    for bi_ in range(b):
        for t0 in range(0, n_chunks * chunk, chunk):
            h_row0 = max(t0 - 1, 0)
            h_tile = h_p[bi_, h_row0:h_row0 + chunk]
            sums = []
            for lo in range(0, chunk, run_len):
                acc = [torch.zeros(w, dtype=xa.dtype) for _ in range(3)]
                for j in range(min(lo + run_len, s - t0) - 1, lo - 1, -1):
                    t = t0 + j
                    xv, X = x_p[bi_, t], d_h[bi_, t]
                    r = r_all[bi_, t]
                    i = torch.sigmoid(xi_p[bi_, t] + b_i)
                    log_a = c * r
                    a = torch.exp(log_a)
                    m = -torch.expm1(2.0 * log_a)
                    e2 = 1.0 - m
                    sq = torch.sqrt(torch.clamp(m, 1e-6, 1.0))
                    hp = h_tile[t - 1 - h_row0] if t > 0 else h0[bi_]
                    gx = X * sq * i
                    gxi = gx * xv * (1.0 - i)
                    dm = torch.where((m >= 1e-6) & (m <= 1.0),
                                     X * i * xv / (2.0 * sq),
                                     torch.zeros_like(m))
                    dlog = X * hp * a - 2.0 * e2 * dm
                    gxa = dlog * c * r * (1.0 - r)
                    acc = [acc[0] + gxa, acc[1] + gxi, acc[2] + dlog * r]
                    dxa[bi_, t], dxi[bi_, t], dx[bi_, t] = gxa, gxi, gx
                    if t == 0:
                        dh0[bi_] = a * X
                sums.append(acc)
            part = sums[0]
            for run in sums[1:]:
                part = [part[k] + run[k] for k in range(3)]
            parts.append(part)
    by_warp = []          # warp k adds the rows k, k + 8, ...
    for k in range(RGLRU_CHUNK_WARPS):
        acc = [torch.zeros(w, dtype=xa.dtype) for _ in range(3)]
        for part in parts[k::RGLRU_CHUNK_WARPS]:
            acc = [acc[q] + part[q] for q in range(3)]
        by_warp.append(acc)
    total = by_warp[0]
    for acc in by_warp[1:]:
        total = [total[q] + acc[q] for q in range(3)]
    da_param = total[2] * -8.0 * torch.sigmoid(a_param)
    return dxa, dxi, dx.to(x.dtype), total[0], total[1], da_param, dh0


def _rglru_bwd_inputs(b, s, w, seed, dtype=torch.float32):
    """RecurrentGemma's decays (a in [0.9, 0.999]) with two channels past
    softplus's threshold, whose decays and products underflow."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape)).to(dtype)
    xa, xi, x, dh = f(b, s, w), f(b, s, w), f(b, s, w), f(b, s, w)
    b_a, b_i, h0 = f(w) * 0.5, f(w) * 0.5, f(b, w)
    u = rng.uniform(0.9, 0.999, w)
    a_param = torch.from_numpy(np.log(np.expm1(-np.log(u) / 8.0))).to(dtype)
    a_param[:2] = 25.0
    h_all = ref.rglru_gated_scan_ref(xa, xi, x, b_a, b_i, a_param, h0)
    return xa, xi, x, b_a, b_i, a_param, h0, h_all, dh


# (chunk, S, W): one step, a chunk less one, one chunk, one past it,
# several chunks with a ragged last one and a width that is no multiple
# of the 32-channel slab, whole chunks only
RGLRU_CHUNK_CASES = [(t, s, w) for t in sorted(set(rg.BWD_CHUNK.values()))
                     for s, w in ((1, 36), (t - 1, 36), (t, 64), (t + 1, 100),
                                  (3 * t + 5, 40), (4 * t, 32))]


@pytest.mark.parametrize("chunk,s,w", RGLRU_CHUNK_CASES)
def test_rglru_chunked_reverse_scan_matches_the_plain_reverse_scan(chunk,
                                                                   s, w):
    """RecurrentGemma's decays with two channels whose products
    underflow; f32 to 1e-5."""
    rng = np.random.default_rng(s + w)
    a = rng.uniform(0.9, 0.999, (2, s, w)).astype(np.float32)
    a[..., :2] = np.float32(1e-30)
    dh = rng.standard_normal((2, s, w)).astype(np.float32)
    a, dh = torch.from_numpy(a), torch.from_numpy(dh)
    want, carry = torch.empty_like(dh), torch.zeros((2, w))
    for t in range(s - 1, -1, -1):
        carry = dh[:, t] + (a[:, t + 1] * carry if t + 1 < s else 0)
        want[:, t] = carry
    got = rglru_chunked_reverse_scan(a, dh, chunk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (chunk, S, W) at the lengths the kernel builds: one step, one past a
# chunk (a ragged last one of a step), several chunks with a ragged last
# one at a width that is no multiple of the slab
RGLRU_BWD_CHUNK_CASES = [(t, s, w) for t in sorted(set(rg.BWD_CHUNK.values()))
                         for s, w in ((1, 36), (t + 1, 40), (2 * t + 5, 36))]


@pytest.mark.parametrize("chunk,s,w", RGLRU_BWD_CHUNK_CASES)
def test_rglru_bwd_chunked_emulation_matches_the_plain_backward(chunk, s, w):
    """Every output of the chunked route's order against the plain
    backward, in f64 to 1e-12 of each output's largest magnitude and in
    f32 within ``GRAD_TOL``."""
    for dtype in (torch.float64, torch.float32):
        args = _rglru_bwd_inputs(2, s, w, seed=s, dtype=dtype)
        got = rglru_bwd_chunked_emulation(*args, chunk)
        want = ref.rglru_gated_scan_bwd_ref(*args)
        for g, y in zip(got, want):
            if dtype == torch.float64:
                scale = max(1.0, float(y.abs().max()))
                torch.testing.assert_close(g, y, rtol=0, atol=1e-12 * scale)
            else:
                _close(g.numpy(), y.numpy())


def test_rglru_bwd_route_is_chosen_by_shape():
    """The chunked route where TMA takes every row (16-byte rows in f32
    and in x's dtype, 16-byte aligned tensors), else the sequence route."""
    z = torch.zeros(64)
    assert rg.bwd_route(2560, torch.bfloat16, z) == "chunked"
    assert rg.bwd_route(100, torch.float32, z) == "chunked"
    assert rg.bwd_route(100, torch.bfloat16, z) == "sequence"
    assert rg.bwd_route(102, torch.float32, z) == "sequence"
    assert rg.bwd_route(2560, torch.float32, z, z[1:]) == "sequence"


def test_rglru_bwd_chunk_lengths_follow_the_source():
    """The wrapper sizes the scratch from ``BWD_CHUNK``, which must name
    the source's kChunkSteps for each x dtype, each a whole number of
    runs; it is no setting."""
    src = (Path(rg.__file__).resolve().parents[1] / "csrc"
           / "rglru_scan_bwd.cu").read_text()
    bf16, f32 = map(int, re.search(
        r"constexpr int kChunkSteps = kBF16 \? (\d+) : (\d+);", src).groups())
    assert dict(rg.BWD_CHUNK) == {torch.bfloat16: bf16, torch.float32: f32}
    assert all(t % RGLRU_CHUNK_WARPS == 0 for t in rg.BWD_CHUNK.values())
    with pytest.raises(TypeError):
        rg.BWD_CHUNK[torch.float32] = 0


@pytest.mark.parametrize("x_dtype,w,s", [(torch.bfloat16, 64, 300),
                                         (torch.float32, 100, 113),
                                         (torch.bfloat16, 102, 40)])
def test_rglru_bwd_wrapper_sizes_its_scratch(monkeypatch, x_dtype, w, s):
    """What the wrapper hands the C entry on each route: the route flag
    (1 chunked, 0 sequence), partial rows B ceil(S / chunk) with the
    chunk ``BWD_CHUNK`` names for x's dtype (B on the sequence route)
    and, on the chunked route, zeroed words for the ticket, a count a
    slab and a (value, flag) word a channel of every slab and chunk, one
    buffer a stream."""
    seen = {}

    def entry(*a):
        seen["args"] = a
        return 0
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "bind", lambda src, fn, args: entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    made = []
    real_empty, real_zeros = torch.empty, torch.zeros

    def spy(real):
        def make(*a, **k):
            t = real(*a, **k)
            made.append(t)
            return t
        return make
    monkeypatch.setattr(torch, "empty", spy(real_empty))
    monkeypatch.setattr(torch, "zeros", spy(real_zeros))
    z = real_zeros((2, s, w))
    rg.rglru_gated_scan_bwd(z, z, z.to(x_dtype), *[real_zeros(w)] * 3,
                            real_zeros((2, w)), z, z)
    a = seen["args"]
    part_ptr, sync_ptr, chunked = a[16], a[17], a[23]
    by_ptr = {t.data_ptr(): t for t in made}
    route = rg.bwd_route(w, x_dtype, z)
    assert chunked == (1 if route == "chunked" else 0)
    chunk = rg.BWD_CHUNK[x_dtype] if chunked else 0
    rows = 2 * -(-s // chunk) if chunk else 2
    assert by_ptr[part_ptr].shape == (rows, 3, w)
    if chunk:
        sync = rg._SYNC[(z.device, 0)]
        assert sync.data_ptr() == sync_ptr
        assert sync.dtype == torch.int64 and not sync.any()
        n_slabs = -(-w // rg.BWD_SLAB)
        assert sync.numel() >= 1 + n_slabs * (1 + rows * rg.BWD_SLAB)
        rg.rglru_gated_scan_bwd(z, z, z.to(x_dtype), *[real_zeros(w)] * 3,
                                real_zeros((2, w)), z, z)
        assert seen["args"][17] == sync_ptr       # the same buffer again
    else:
        assert sync_ptr is None


# ---------------------------------------------------------------------------
# (c) gradcheck in f64


def test_wkv6_fn_gradcheck_f64():
    """Through the plain versions on the CPU, which take any head size
    (8 keeps the numerical Jacobian small)."""
    gen = torch.Generator().manual_seed(0)
    b, h, s, hd = 2, 2, 5, 8
    rn = lambda *shape: torch.randn(shape, generator=gen,
                                    dtype=torch.float64)
    r, k, v = rn(b, h, s, hd), rn(b, h, s, hd), rn(b, h, s, hd)
    w = torch.sigmoid(rn(b, h, s, hd))
    u, s0 = rn(h, hd) * 0.1, rn(b, h, hd, hd) * 0.1
    leaves = [t.requires_grad_(True) for t in (r, k, v, w, u, s0)]
    assert torch.autograd.gradcheck(trwkv.WKV6Fn.apply, leaves, eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


def test_rglru_fn_gradcheck_f64():
    gen = torch.Generator().manual_seed(0)
    b, s, w = 2, 7, 3
    rn = lambda *shape: torch.randn(shape, generator=gen,
                                    dtype=torch.float64)
    leaves = [t.requires_grad_(True) for t in (
        rn(b, s, w), rn(b, s, w), rn(b, s, w), rn(w) * 0.5, rn(w) * 0.5,
        rn(w), rn(b, w))]
    assert torch.autograd.gradcheck(trglru.RGLRUScanFn.apply, leaves,
                                    eps=1e-6, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# (d) the MoE layer's train route


@pytest.mark.parametrize("activation,cf", [("swiglu", 2.0), ("swiglu", 1.0),
                                           ("gelu", 2.0)])
def test_moe_train_route_gradients_match_jax(activation, cf):
    """``apply_moe`` under a gradient (capacity drops at cf 1.0; the
    ungated experts too, which run the plain products on the CPU) against
    ``jax.vjp`` of the JAX ``apply_moe`` on the same weights."""
    d, f, e, top_k = 32, 48, 4, 2
    jp = jmoe.init_moe(jax.random.PRNGKey(0), d, f, e, activation,
                       jnp.float32)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, d)).astype(np.float32)
    dout = rng.standard_normal((2, 11, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=top_k, activation=activation,
              capacity_factor=cf)
    out, vjp = jax.vjp(lambda p, xx: jmoe.apply_moe(p, xx, **kw), jp,
                       jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dout))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tmoe.apply_moe(tp, tx, **kw)
    _close(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(got, [*tp.values(), tx],
                                torch.from_numpy(dout))
    for name, g in zip(tp, grads):
        _close(g.numpy(), np.asarray(jgp[name]))
    _close(grads[-1].numpy(), np.asarray(jgx))


# ---------------------------------------------------------------------------
# (e) the wrappers on a card without a build


def _no_build(monkeypatch, plain_name):
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)

    def no_build(name):
        raise _build.KernelBuildError(f"no build of {name}")
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(ref, plain_name, lambda *a, **k: 1 / 0)


def test_wkv6_bwd_cuda_call_without_a_build_raises(monkeypatch):
    _no_build(monkeypatch, "wkv6_bwd_ref")
    x = torch.zeros(1, 2, 20, 64)
    before = wk.wkv6_bwd.launches
    with pytest.raises(_build.KernelBuildError):
        wk.wkv6_bwd(x, x, x, x, torch.zeros(2, 64),
                    torch.zeros(1, 2, 64, 64), x)
    assert wk.wkv6_bwd.launches == before


def test_rglru_bwd_cuda_call_without_a_build_raises(monkeypatch):
    _no_build(monkeypatch, "rglru_gated_scan_bwd_ref")
    z = torch.zeros(1, 20, 8)
    before = rg.rglru_gated_scan_bwd.launches
    with pytest.raises(_build.KernelBuildError):
        rg.rglru_gated_scan_bwd(z, z, z.bfloat16(), *[torch.zeros(8)] * 3,
                                torch.zeros(1, 8), z, z)
    assert rg.rglru_gated_scan_bwd.launches == before


def test_backward_wrappers_count_their_launches(monkeypatch):
    from repro_torch.kernels import launch_counts, reset_launches
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    # every entry point returns 0 (no error), wkv6_bwd_seg its kSeg
    monkeypatch.setattr(_build, "bind", lambda src, fn, args: lambda *a:
                        64 if fn == "wkv6_bwd_seg" else 0)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    reset_launches()
    x = torch.zeros(1, 2, 20, 64)
    wk.wkv6_bwd(x, x, x, x, torch.zeros(2, 64), torch.zeros(1, 2, 64, 64), x)
    z = torch.zeros(1, 20, 8)
    for _ in range(2):
        rg.rglru_gated_scan_bwd(z, z, z, *[torch.zeros(8)] * 3,
                                torch.zeros(1, 8), z, z)
    counts = launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "wkv6_bwd": 1, "rglru_gated_scan_bwd": 2}
    reset_launches()


def test_backward_wrappers_reject_bad_inputs():
    x = torch.zeros(1, 2, 4, 64)
    with pytest.raises(ValueError):         # dy of another shape
        wk.wkv6_bwd(x, x, x, x, torch.zeros(2, 64),
                    torch.zeros(1, 2, 64, 64), torch.zeros(1, 2, 5, 64))
    z = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):         # h_all must be f32
        rg.rglru_gated_scan_bwd(z, z, z, *[torch.zeros(8)] * 3,
                                torch.zeros(1, 8), z.bfloat16(), z)


# ---------------------------------------------------------------------------
# (f) remat's recompute


@pytest.mark.parametrize("arch,n_layers", [("mixtral-8x7b", 3),
                                           ("recurrentgemma-2b", 27),
                                           ("rwkv6-7b", 8)])
def test_remat_runs_each_group_as_the_card_run_reckons(arch, n_layers,
                                                       monkeypatch):
    """One train step runs every group's forward once, remat's recompute
    once more and, under sqrt-remat (past 8 groups), every group but the
    last of its superblock a third time; the backward kernels once a
    layer (the expert FFN's too).  chip_smoke.py's 5t-m / 5t-r / 5t-k
    require these launches."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as TM
    from repro_torch.models import transformer as TT
    from repro_torch.params import init_params
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch).reduced(d_model=64),
                              n_layers=n_layers, remat=True)
    from repro_torch.kernels import moe_ffn as mf
    calls = {}
    for mod, name in ((rg, "rglru_gated_scan"), (rg, "rglru_gated_scan_bwd"),
                      (wk, "wkv6"), (wk, "wkv6_bwd"),
                      (fa, "flash_attention"), (mf, "moe_ffn"),
                      (mf, "moe_ffn_bwd")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k:
                            calls.__setitem__(_n, calls.get(_n, 0) + 1)
                            or _f(*a, **k))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (1, 33),
                           generator=torch.Generator().manual_seed(0))
    torch.autograd.grad(TM.loss_fn(params, cfg, {"tokens": tokens}),
                        leaves)
    n = cfg.n_groups
    n_outer = TT._sqrt_factor(n)
    runs = 2 * n + (n - n_outer if n_outer > 1 else 0)
    per = {k: sum(kind in ks for kind in cfg.layer_pattern)
           for k, ks in (("flash_attention", ("attn", "swa")),
                         ("rglru_gated_scan", ("rglru",)),
                         ("wkv6", ("rwkv",)))}
    per["moe_ffn"] = sum(map(bool, cfg.moe_pattern)) if cfg.is_moe else 0
    want = {}
    for fwd, bwd in (("flash_attention", None),
                     ("rglru_gated_scan", "rglru_gated_scan_bwd"),
                     ("wkv6", "wkv6_bwd"), ("moe_ffn", "moe_ffn_bwd")):
        if per[fwd]:
            want[fwd] = per[fwd] * runs
            if bwd:
                want[bwd] = per[fwd] * n
    assert calls == want
