"""The algorithms of the port's recurrent kernels, emulated in PyTorch on
the CPU and held against the JAX package's Pallas kernels in interpret
mode (as tests/test_kernels.py runs them), plus the routes the wrappers
take:

* (a) the chunked ``wkv6`` prefill (``csrc/wkv6.cu``): the same chunk
  and sub-chunk lengths, the same decay products (running
  multiplication and products over whole sub-chunks, never a division or
  a difference of cumulative logs), the same compensated state carry and
  padding of a ragged chunk, in f32; at S 1, 17, 63, 64, 65 and 200, head sizes 64
  and 128, decays drawn as the model forms them, w = exp(-exp(U[-8, 4])),
  with channels at w == 0 and w = 1 - 1e-7.  The factorized form
  exp(c_{t-1}) exp(-c_s) is shown to give inf or NaN on the same input;
* (b) the time-parallel ``rglru_scan`` (``csrc/rglru_scan.cu``): segments
  composed by a warp's shuffle scan, warp totals, tiles walked in order,
  each segment re-walked from its carry, across segment, warp and tile
  boundaries;
* (c) the fused gates' plain version against JAX ``_rglru_scan`` at
  reduced RecurrentGemma widths, and the hoisted f32 gate weights;
* (d) the route (serial or chunked / parallel) from shapes and ``stack``
  alone, and CUDA calls without a build raising.

Tolerances are the Pallas tests': ``wkv6`` 2e-4, ``rglru_scan`` 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.recurrentgemma_2b import CONFIG as J_RG  # noqa: E402
from repro.kernels import ops  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch.configs import RECURRENTGEMMA_2B  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.params import from_jax, init_params  # noqa: E402

WKV6_TOL = dict(rtol=2e-4, atol=2e-4)
RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (a) chunked wkv6


def wkv6_chunked_emulation(r, k, v, w, u, s0, chunk=wk.CHUNK, sub=wk.SUB):
    """The chunked kernel's arithmetic, (B, H) at once.  Per chunk, per
    sub-chunk of ``sub`` steps: k_s Q'_s (Q'_s the product of w over the
    rest of s's sub-chunk) and T_j (a whole sub-chunk's product).  Row t
    walks s down through its own sub-chunk with D_ts = prod_{s<tau<t} w
    as a running product, leaving r_t P'_t; times the T_j of each
    sub-chunk it passes, that gives A_ts = sum_i (r_t P'_t prod T)_i
    (k_s Q'_s)_i for the earlier sub-chunks and ends at r_t P_t.  r_t u
    k_t is A's diagonal.  Then y_t = (r_t P_t) S0 + sum_s A_ts v_s and
    S <- diag(prod w) S0 + sum_s (k_s Q_s) v_s^T, S carried as a
    compensated pair (:func:`carry_state`).  Every factor lies in [0, 1]
    and none is divided.  A ragged last chunk is padded with r = k = v =
    0, w = 1."""
    b, h, s, hd = r.shape
    pad = (-s) % chunk
    zeros = torch.zeros((b, h, pad, hd))
    r, k, v = (torch.cat([x, zeros], 2) for x in (r, k, v))
    w = torch.cat([w, torch.ones((b, h, pad, hd))], 2)
    state, lo, ys = s0.clone(), torch.zeros_like(s0), []
    n_sub = chunk // sub
    for c0 in range(0, s + pad, chunk):
        rr, kk, vv, ww = (x[:, :, c0:c0 + chunk] for x in (r, k, v, w))
        kqs, subt = [None] * chunk, []
        for j in range(n_sub):
            q = torch.ones((b, h, hd))
            for s_ in range(sub * j + sub - 1, sub * j - 1, -1):
                kqs[s_] = kk[:, :, s_] * q
                q = q * ww[:, :, s_]
            subt.append(q)
        a = torch.zeros((b, h, chunk, chunk))
        rp, kq = [], []
        for t in range(chunk):
            sb = t // sub
            a[:, :, t, t] = (rr[:, :, t] * u * kk[:, :, t]).sum(-1)
            d = torch.ones((b, h, hd))
            for s_ in range(t - 1, sub * sb - 1, -1):
                a[:, :, t, s_] = (rr[:, :, t] * d * kk[:, :, s_]).sum(-1)
                d = d * ww[:, :, s_]
            y = rr[:, :, t] * d
            for j in range(sb - 1, -1, -1):
                for s_ in range(sub * j + sub - 1, sub * j - 1, -1):
                    a[:, :, t, s_] = (y * kqs[s_]).sum(-1)
                y = y * subt[j]
            rp.append(y)
            later = torch.ones((b, h, hd))
            for j in range(n_sub - 1, sb, -1):
                later = later * subt[j]
            kq.append(kqs[t] * later)
            if t == 0:
                tot = later * subt[0]
        rp, kq = torch.stack(rp, 2), torch.stack(kq, 2)
        ys.append(torch.einsum("bhti,bhij->bhtj", rp, state)
                  + torch.einsum("bhts,bhsj->bhtj", a, vv))
        state, lo = carry_state(tot[..., None], torch.einsum(
            "bhsi,bhsj->bhij", kq, vv), state, lo)
    return torch.cat(ys, 2)[:, :, :s], state + lo


def carry_state(tot, d, hi, lo):
    """The kernel's S <- tot * S + d on S = hi + lo: the product's and the
    sum's rounding errors (exact, by TwoSum) are carried in lo."""
    p = tot * hi
    pe = (tot.double() * hi.double() - p.double()).float()
    s = p + d
    bv = s - p
    e = (p - (s - bv)) + (d - bv)
    low = (tot.double() * lo.double() + (e + pe).double()).float()  # an FMA
    new_hi = s + low
    return new_hi, low - (new_hi - s)


def _wkv6_inputs(b, h, s, hd, seed):
    """r/k/v N(0, 1); w = exp(-exp(w_log)), w_log ~ U[-8, 4] as the
    model's LoRA decay spans it, with channel 0 at w == 0 and channel 1
    at w = 1 - 1e-7 for every step."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, hd), np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.uniform(-8.0, 4.0, (b, h, s, hd)))).astype(
        np.float32)
    w[..., 0] = 0.0
    w[..., 1] = np.float32(1.0 - 1e-7)
    u = rng.standard_normal((h, hd), np.float32) * 0.1
    s0 = rng.standard_normal((b, h, hd, hd), np.float32) * 0.1
    return r, k, v, w, u, s0


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("s", [1, 17, 63, 64, 65, 200])
def test_chunked_wkv6_emulation_matches_pallas(s, hd):
    b, h = (2, 2) if hd == 64 else (1, 2)
    ins = _wkv6_inputs(b, h, s, hd, seed=s + hd)
    want_y, want_s = ops.wkv6(*map(jnp.asarray, ins), interpret=True)
    y, state = wkv6_chunked_emulation(*map(torch.from_numpy, ins))
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **WKV6_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), **WKV6_TOL)


def test_chunked_wkv6_emulation_at_the_decay_edges():
    """w == 0 in every channel leaves S = k_t v_t^T after each step;
    w = 1 - 1e-7 in every channel over 200 steps keeps the state's decay
    to the serial recurrence's rounding."""
    b, h, s, hd = 1, 1, 40, 64
    r, k, v, _, u, s0 = map(torch.from_numpy, _wkv6_inputs(b, h, s, hd, 5))
    y, state = wkv6_chunked_emulation(r, k, v, torch.zeros_like(r), u, s0)
    torch.testing.assert_close(state, k[:, :, -1, :, None]
                               * v[:, :, -1, None, :], rtol=0, atol=0)
    want_y, _ = ref.wkv6_ref(r, k, v, torch.zeros_like(r), u, s0)
    torch.testing.assert_close(y, want_y, **WKV6_TOL)

    s = 200
    r, k, v, _, u, s0 = map(torch.from_numpy, _wkv6_inputs(b, h, s, hd, 6))
    w = torch.full_like(r, 1.0 - 1e-7)
    got = wkv6_chunked_emulation(r, k, v, w, u, s0)
    want = ops.wkv6(*(jnp.asarray(x.numpy()) for x in (r, k, v, w, u, s0)),
                    interpret=True)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **WKV6_TOL)


def test_factorized_decay_overflows_where_the_products_do_not():
    """The form the kernel avoids: r_t exp(c_{t-1}) times k_s exp(-c_s),
    c the chunk's cumulative log decay, is inf or NaN on the model's
    strong decays (w_log near 4: log w ~ -55 a step) and at w == 0; the
    running products give finite values that match the Pallas kernel."""
    ins = _wkv6_inputs(1, 1, wk.CHUNK, 64, seed=7)
    r, k, v, w, u, s0 = map(torch.from_numpy, ins)
    w = w.clone()
    w[..., 2:] = float(np.exp(-np.exp(4.0)))      # w_log = 4 in most channels
    c = torch.cumsum(torch.log(w[0, 0]), 0)        # (L, hd), -inf at w == 0
    c_prev = torch.cat([torch.zeros_like(c[:1]), c[:-1]], 0)
    fact = torch.einsum("ti,si->ts", r[0, 0] * torch.exp(c_prev),
                        k[0, 0] * torch.exp(-c))
    assert not torch.isfinite(torch.tril(fact, -1)).all()
    y, state = wkv6_chunked_emulation(r, k, v, w, u, s0)
    want_y, want_s = ops.wkv6(*(jnp.asarray(x.numpy())
                                for x in (r, k, v, w, u, s0)), interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **WKV6_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_s), **WKV6_TOL)


# ---------------------------------------------------------------------------
# (b) time-parallel rglru_scan


def rglru_parallel_emulation(a, g, h0):
    """The time-parallel kernel's arithmetic over (B, W) at once, in its
    layout: per tile of per_tile segments of ``seg`` steps (a
    ragged end padded with a = 1,
    g = 0), each segment's (prod a, h from 0), a Hillis-Steele inclusive
    scan over each warp's per_warp segments, the warps' totals composed in
    order onto the tile's carry, then every segment re-walked from its
    incoming state, h = a h + g."""
    seg, per_warp, per_tile = rg.LAYOUT
    b, s, w = a.shape
    tile_len = seg * per_tile
    pad = (-s) % tile_len
    a = torch.cat([a, torch.ones((b, pad, w))], 1)
    g = torch.cat([g, torch.zeros((b, pad, w))], 1)
    carry, out = h0.clone(), []
    for t0 in range(0, s + pad, tile_len):
        at = a[:, t0:t0 + tile_len].reshape(b, per_tile, seg, w)
        gt = g[:, t0:t0 + tile_len].reshape(b, per_tile, seg, w)
        big_a, big_h = torch.ones((b, per_tile, w)), torch.zeros(
            (b, per_tile, w))
        for k in range(seg):
            big_h = at[:, :, k] * big_h + gt[:, :, k]
            big_a = big_a * at[:, :, k]
        big_a = big_a.reshape(b, -1, per_warp, w)
        big_h = big_h.reshape(b, -1, per_warp, w)
        d = 1
        while d < per_warp:
            ap, hp = big_a[:, :, :-d], big_h[:, :, :-d]
            new_h, new_a = big_h.clone(), big_a.clone()
            new_h[:, :, d:] = big_a[:, :, d:] * hp + big_h[:, :, d:]
            new_a[:, :, d:] = big_a[:, :, d:] * ap
            big_a, big_h, d = new_a, new_h, 2 * d
        n_warps = per_tile // per_warp
        starts = []
        for wi in range(n_warps):
            hc = carry.clone()
            for wj in range(wi):
                hc = big_a[:, wj, -1] * hc + big_h[:, wj, -1]
            for si in range(per_warp):
                starts.append(hc if si == 0 else
                              big_a[:, wi, si - 1] * hc + big_h[:, wi, si - 1])
        h = torch.stack(starts, 1)                  # (B, segments, W)
        hs = []
        for k in range(seg):
            h = at[:, :, k] * h + gt[:, :, k]
            hs.append(h)
        tile = torch.stack(hs, 2).reshape(b, tile_len, w)
        out.append(tile)
        carry = tile[:, -1]
    return torch.cat(out, 1)[:, :s]


@pytest.mark.parametrize("b,s,w", [(2, 17, 36), (1, 100, 64), (2, 513, 20),
                                   (1, 1100, 12)])
def test_parallel_rglru_emulation_matches_pallas(b, s, w):
    """Ragged segments, warps and tiles (512 steps a tile); a few channels
    decay to a product that underflows to 0 within a segment."""
    rng = np.random.default_rng(s)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, w), np.float32)))
    a[..., :2] = np.float32(1e-30)
    a = a.astype(np.float32)
    g = rng.standard_normal((b, s, w), np.float32)
    h0 = rng.standard_normal((b, w), np.float32)
    want = ops.rglru_scan(jnp.asarray(a), jnp.asarray(g), jnp.asarray(h0),
                          block_w=128, interpret=True)
    got = rglru_parallel_emulation(*map(torch.from_numpy, (a, g, h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RGLRU_TOL)


def test_parallel_rglru_emulation_at_the_serving_decay():
    """RecurrentGemma's decays (a in [0.9, 0.999]) over 1100 steps, where
    a carry from far back still weighs in."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.9, 0.999, (1, 1100, 8)).astype(np.float32)
    g = (rng.standard_normal((1, 1100, 8)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((1, 8), np.float32)
    got = rglru_parallel_emulation(*map(torch.from_numpy, (a, g, h0)))
    want = ref.rglru_scan_ref(*map(torch.from_numpy, (a, g, h0)))
    torch.testing.assert_close(got, want, **RGLRU_TOL)


# ---------------------------------------------------------------------------
# (c) the gates fused in


@pytest.mark.parametrize("s", [5, 40])
def test_fused_gates_plain_version_matches_jax(s):
    """rglru_gated_scan on CPU tensors (its plain version) against JAX
    ``_rglru_scan`` on one reduced RecurrentGemma layer's weights."""
    cfg = J_RG.reduced(d_model=64)
    p = JM.init_params(cfg, jax.random.PRNGKey(4))["layers"][0]["rec"]
    p = jax.tree.map(lambda x: np.asarray(x)[0], p)
    rng = np.random.default_rng(s)
    wdt = cfg.rnn_width
    x = rng.standard_normal((2, s, wdt), np.float32)
    h0 = rng.standard_normal((2, wdt), np.float32)
    p = dict(p, b_a=rng.standard_normal(wdt).astype(np.float32) * 0.5,
             b_i=rng.standard_normal(wdt).astype(np.float32) * 0.5)
    want, _ = jrglru._rglru_scan(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), jnp.asarray(h0))
    t = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    xt = torch.from_numpy(x)
    got = rg.rglru_gated_scan(xt @ t["w_a"].float(), xt @ t["w_i"].float(),
                              xt, t["b_a"], t["b_i"], t["a_param"],
                              torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **RGLRU_TOL)
    a, gated = ref.rglru_gates_ref(xt @ t["w_a"].float(),
                                   xt @ t["w_i"].float(), xt, t["b_a"],
                                   t["b_i"], t["a_param"])
    torch.testing.assert_close(
        rg.rglru_scan(a, gated, torch.from_numpy(h0)), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_weights_are_cast_once_with_the_parameters(dtype):
    """init_params and from_jax store w_a and w_i f32 (the type of the
    gate products) at the values of the model's dtype, so no call casts
    them: init_params draws them as the other weights are drawn, and
    from_jax keeps the JAX leaves' values."""
    import dataclasses
    cfg = dataclasses.replace(RECURRENTGEMMA_2B.reduced(d_model=64),
                              dtype=dtype)
    jcfg = dataclasses.replace(J_RG.reduced(d_model=64), dtype=dtype)
    jp = jax.tree.map(np.asarray, JM.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    mine = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    conv = from_jax(jp, cfg, "cpu")
    for params in (mine, conv):
        recs = [l["rec"] for l in params["layers"] if "rec" in l]
        assert recs
        for rec in recs:
            for name in ("w_a", "w_i"):
                wt = rec[name]
                assert wt.dtype == torch.float32
                torch.testing.assert_close(wt, wt.to(cfg.torch_dtype).float(),
                                           rtol=0, atol=0)
                assert wt.float() is wt
    pat = len(cfg.layer_pattern)
    for l, layer in enumerate(conv["layers"]):
        if "rec" in layer:
            for name in ("w_a", "w_i"):
                want = np.asarray(jp["layers"][l % pat]["rec"][name][l // pat],
                                  np.float32)
                np.testing.assert_array_equal(layer["rec"][name].numpy(),
                                              want)


# ---------------------------------------------------------------------------
# (d) routes


def test_routes_depend_on_shapes_and_stack_only():
    assert [wk.route(s, False) for s in (1, 5, 16, 17, 512)] == [
        "serial"] * 3 + ["chunked"] * 2
    assert all(wk.route(s, True) == "serial" for s in (1, 5, 16, 17, 512))
    assert [rg.route(s) for s in (1, 5, 16, 17, 4096)] == [
        "serial"] * 3 + ["parallel"] * 2


@pytest.mark.parametrize("stack,s", [(False, 5), (False, 40), (True, 5)])
def test_wkv6_route_ignores_the_data(stack, s, monkeypatch):
    """A CUDA call (flagged) binds the entry of its route whatever w
    holds, and raises without a build; the plain version is never used."""
    bound = []

    def no_build(name, fn, argtypes):
        bound.append(fn)
        raise _build.KernelBuildError(f"no build of {name}")
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "bind", no_build)
    monkeypatch.setattr(ref, "wkv6_ref", lambda *a, **k: 1 / 0)
    want = "wkv6" if wk.route(s, stack) == "serial" else "wkv6_chunked"
    for fill in (0.0, 0.5, 1.0 - 1e-7):
        x = torch.zeros(1, 2, s, 64)
        w = torch.full_like(x, fill)
        with pytest.raises(_build.KernelBuildError):
            wk.wkv6(x, x, x, w, torch.zeros(2, 64),
                    torch.zeros(1, 2, 64, 64), stack=stack)
    assert bound == [want] * 3


def test_launches_are_counted_by_route(monkeypatch):
    """A (flagged) CUDA launch adds one to its wrapper's count and to its
    route's; launch_counts reports both and reset_launches zeroes both."""
    from repro_torch.kernels import launch_counts, reset_launches
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "bind", lambda *a: lambda *args: 0)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    reset_launches()
    for s, stack in ((5, True), (40, False), (1, False)):
        x = torch.zeros(1, 2, s, 64)
        wk.wkv6(x, x, x, x, torch.zeros(2, 64), torch.zeros(1, 2, 64, 64),
                stack=stack)
    for s in (5, 20, 30):
        z = torch.zeros(1, s, 8)
        rg.rglru_gated_scan(z, z, z, *[torch.zeros(8)] * 3,
                            torch.zeros(1, 8))
    z = torch.zeros(1, 40, 8)
    rg.rglru_scan(z, z, torch.zeros(1, 8))
    counts = launch_counts()
    assert {k: counts[k] for k in counts if counts[k]} == {
        "wkv6": 3, "wkv6 serial": 2, "wkv6 chunked": 1,
        "rglru_gated_scan": 3, "rglru_gated_scan serial": 1,
        "rglru_gated_scan parallel": 2, "rglru_scan": 1,
        "rglru_scan parallel": 1}
    reset_launches()
    assert not any(launch_counts().values())


def test_fused_rglru_cuda_call_without_a_build_raises(monkeypatch):
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)

    def no_build(name):
        raise _build.KernelBuildError(f"no build of {name}")
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(ref, "rglru_gated_scan_ref", lambda *a, **k: 1 / 0)
    before = rg.rglru_gated_scan.launches
    z = torch.zeros(1, 20, 8)
    with pytest.raises(_build.KernelBuildError):
        rg.rglru_gated_scan(z, z, z.bfloat16(), *[torch.zeros(8)] * 3,
                            torch.zeros(1, 8))
    assert rg.rglru_gated_scan.launches == before


def test_fused_rglru_rejects_bad_inputs():
    z = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):         # products must be f32
        rg.rglru_gated_scan(z.bfloat16(), z, z, *[torch.zeros(8)] * 3,
                            torch.zeros(1, 8))
    with pytest.raises(ValueError):         # biases must be (W,)
        rg.rglru_gated_scan(z, z, z, torch.zeros(4), torch.zeros(8),
                            torch.zeros(8), torch.zeros(1, 8))


def test_profile_groups_name_every_kernel_of_its_source():
    """Each ``__global__`` kernel of ``csrc/<name>.cu`` lands in its own
    group of ``launch/profile_serve.py`` (by the profiler's demangled
    name), never in the cuBLAS group or in "everything else"."""
    import glob
    import os
    import re

    from repro_torch.kernels import _build
    from repro_torch.launch.profile_serve import GROUPS
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                         r"(?:[^()]|\([^()]*\))*\)\s+)?(\w+)\s*\(")
    own = {"paged_decode_attention": "paged_decode_attention kernel",
           "decode_attention": "decode_attention kernel",
           "flash_attention": "flash_attention kernel",
           "flash_attention_bwd": "flash_attention_bwd kernels",
           "moe_ffn": "moe_ffn kernels", "rglru_scan": "rglru_scan kernels",
           "wkv6": "wkv6 kernels", "wkv6_bwd": "wkv6_bwd kernels",
           "rglru_scan_bwd": "rglru_scan_bwd kernels",
           "moe_ffn_bwd": "moe_ffn_bwd kernels", "obs_mark": "tracer marks"}
    # two kernels a source; the flash backward's five (the row sums D,
    # then dK/dV and dQ, each on wgmma and in exact f32); the wkv6
    # backward's four (the chunked kernel, the serial one of head size
    # 32, the slabs' dr / dk / dw, the batch's du); the expert FFN
    # backward's three (the products on wgmma and in exact f32, f32's
    # elementwise step); the RG-LRU backward's three (the chunked route,
    # the sequence route, the partials' sum); the tracer's six marks (the
    # generic span mark and the round's five boundaries)
    n_kernels = dict.fromkeys(own, 2) | {"flash_attention_bwd": 5,
                                         "wkv6_bwd": 4, "moe_ffn_bwd": 3,
                                         "rglru_scan_bwd": 3, "obs_mark": 6}
    seen = dict.fromkeys(own, 0)
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        src = os.path.basename(path)[:-3]
        for name in pattern.findall(open(path).read()):
            shown = f"void (anonymous namespace)::{name}<64>(float const*)"
            group = next(label for label, pat in GROUPS
                         if re.search(pat, shown))
            assert group == own[src], (name, group)
            seen[src] += 1
    assert seen == n_kernels
