"""The backward of the port's grouped expert FFN against the JAX package
on the CPU, and the backward kernel's products emulated in PyTorch:

* (a) the plain ``moe_ffn_bwd_ref`` against ``jax.vjp`` of the JAX
  package's ``repro.kernels.ref.moe_ffn_ref`` (swiglu and the
  tanh-approximate gelu; ragged shapes);
* (b) ``csrc/moe_ffn_bwd.cu``'s launches as its tables state them
  (bf16: g and u in one launch, dh with the elementwise step in its
  epilogue, dX, then the three weight gradients; f32: eight steps; each
  product read from its operands' stored layouts, K-major or MN-major,
  rounded once to the inputs' dtype) against the plain version, in f32
  and in bf16, and the bf16 launches' tile order (``tile_at``), which
  must cover every tile of every product and expert exactly once;
* (c) ``torch.autograd.gradcheck`` in f64 through ``MoEFFNFn``;
* (d) the MoE layer runs ``moe_ffn`` in every phase, and ``moe_ffn_bwd``
  where a gradient is taken, decided by the device alone;
* (e) a CUDA call of ``moe_ffn_bwd`` without a build raises, and its
  launches are counted.

Tolerances as ROADMAP section 3 states them: gradients f32 atol 1e-5
plus rtol 5e-5, the atol times the gradient's largest magnitude where
that passes 1; bf16 2e-2 of each output's largest magnitude (its
rounding of g, u, dh, dg, du and h)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import moe_ffn as mf  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

GRAD_TOL = dict(atol=1e-5, rtol=5e-5)
BF16_TOL = 2e-2


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = dict(GRAD_TOL)
    tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


def _inputs(e, c, d, f, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    rn = lambda *shape, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dtype)
    return (rn(e, c, d), rn(e, d, f, s=d ** -0.5), rn(e, d, f, s=d ** -0.5),
            rn(e, f, d, s=f ** -0.5), rn(e, c, d))


SHAPES = [(2, 5, 16, 24), (3, 9, 32, 40), (1, 1, 8, 8)]


# ---------------------------------------------------------------------------
# (a) the plain backward against JAX


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("e,c,d,f", SHAPES)
def test_moe_ffn_bwd_ref_matches_jax_vjp(e, c, d, f, activation):
    buf, wg, wu, wd, dy = _inputs(e, c, d, f, seed=c + d)
    _, vjp = jax.vjp(lambda *a: jref.moe_ffn_ref(*a, activation=activation),
                     *(jnp.asarray(t.numpy()) for t in (buf, wg, wu, wd)))
    want = vjp(jnp.asarray(dy.numpy()))
    got = ref.moe_ffn_bwd_ref(buf, wg, wu, wd, dy, activation=activation)
    for g, j in zip(got, want):
        _close(g.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# (b) the kernel's steps

# csrc/moe_ffn_bwd.cu's tables (keep them in step).  f32 (the exact
# CUDA-core route): eight steps of (A operands, B operands, ta, tb, out,
# M, N, out_mn); ta: A stored (K, M), else (M, K); tb: B stored (K, N),
# else (N, K); out_mn: out stored (M, N), else (N, M); the elementwise
# step in place between the two tables
STEPS_BEFORE = ((("wg",), ("x",), 1, 0, "g", "f", "c", 0),
                (("wu",), ("x",), 1, 0, "u", "f", "c", 0),
                (("wd",), ("dy",), 0, 0, "dh", "f", "c", 0))
STEPS_AFTER = ((("wg", "wu"), ("g", "u"), 0, 0, "dbuf", "d", "c", 0),
               (("x",), ("g",), 1, 1, "dwg", "d", "f", 1),
               (("x",), ("u",), 1, 1, "dwu", "d", "f", 1),
               (("dh",), ("dy",), 1, 1, "dwd", "f", "d", 1))
# bf16 (run_bf16): four launches of (ta, tb, mode, tile width N, products)
# with a product (A operands, B operands, outputs, M, N), every output
# stored (M, N).  "gated": the two B operands share the K steps; from
# the accumulators g and u and the stored dh, dg, du and h are written in
# place (over the workspaces g, u and dh's)
BF16_LAUNCHES = (
    (0, 0, "store", 256, ((("dy",), ("wd",), ("h",), "c", "f"),)),
    (0, 1, "gated", 128, ((("x",), ("wg", "wu"), ("g", "u", "h"), "c",
                           "f"),)),
    (0, 0, "store", 256, ((("g", "u"), ("wg", "wu"), ("dbuf",), "c",
                           "d"),)),
    (1, 1, "store", 256, ((("x",), ("g",), ("dwg",), "d", "f"),
                          (("x",), ("u",), ("dwu",), "d", "f"),
                          (("h",), ("dy",), ("dwd",), "f", "d"))))
BM = 128                    # a tile's rows


def tile_at(jobs, t):
    """``tile_at`` of the source: tile t of a launch whose products have
    (experts, row tiles, column tiles, M, N) ``jobs`` -> (product, expert,
    row tile, column tile); products in order, then experts, and within
    one the row tiles fastest where M <= N (A the smaller operand), else
    the column tiles."""
    j = 0
    while j + 1 < len(jobs) and t >= jobs[j][0] * jobs[j][1] * jobs[j][2]:
        t -= jobs[j][0] * jobs[j][1] * jobs[j][2]
        j += 1
    _, mt, nt, m_len, n_len = jobs[j]
    e, r = divmod(t, mt * nt)
    m, n = (r % mt, r // mt) if m_len <= n_len else (r // nt, r % nt)
    return j, e, m, n


def launch_jobs(e, c, d, f):
    """Per bf16 launch, (experts, row tiles, column tiles, M, N) per
    product."""
    size = dict(c=c, d=d, f=f)
    return [[(e, -(-size[m] // BM), -(-size[n] // bn), size[m], size[n])
             for *_, m, n in prods]
            for _, _, _, bn, prods in BF16_LAUNCHES]


def _product(t, a_name, b_name, ta, tb):
    """A B per expert in f32, (E, M, N), from the stored operands."""
    a, b = t[a_name].float(), t[b_name].float()
    a = a.transpose(1, 2) if ta else a               # (E, M, K)
    b = b if tb else b.transpose(1, 2)               # (E, K, N)
    return torch.bmm(a, b)


def moe_ffn_bwd_emulation(buf, wg, wu, wd, dy, activation):
    """The launches of the inputs' dtype: each product summed in f32 from
    the stored operands and rounded once to that dtype.  f32: the eight
    steps, the elementwise step in place from the stored g, u, dh.  bf16:
    the four launches, the elementwise step from g and u's f32
    accumulators and the stored dh."""
    dt = buf.dtype
    t = dict(x=buf, wg=wg, wu=wu, wd=wd, dy=dy)
    if dt == torch.float32:
        def run(steps):
            for a_names, b_names, ta, tb, out, _, _, out_mn in steps:
                acc = sum(_product(t, an, bn, ta, tb)
                          for an, bn in zip(a_names, b_names))
                t[out] = (acc if out_mn else acc.transpose(1, 2)).to(dt)

        run(STEPS_BEFORE)
        a, da = ref.ffn_act_grad(t["g"], activation)
        t["g"], t["u"], t["dh"] = (t["dh"] * t["u"] * da, t["dh"] * a,
                                   a * t["u"])
        run(STEPS_AFTER)
        return t["dbuf"], t["dwg"], t["dwu"], t["dwd"]
    for ta, tb, mode, _, prods in BF16_LAUNCHES:
        for a_names, b_names, outs, _, _ in prods:
            if mode == "gated":
                g, u = (_product(t, a_names[0], bn, ta, tb) for bn in b_names)
                a, da = ref.ffn_act_grad(g, activation)
                dh = t["h"].float()
                t["g"], t["u"], t["h"] = ((dh * u * da).to(dt),
                                          (dh * a).to(dt), (a * u).to(dt))
                continue
            acc = sum(_product(t, an, bn, ta, tb)
                      for an, bn in zip(a_names, b_names))
            t[outs[0]] = acc.to(dt)
    return t["dbuf"], t["dwg"], t["dwu"], t["dwd"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("e,c,d,f", SHAPES[:2])
def test_moe_ffn_bwd_kernel_steps_match_the_plain_version(e, c, d, f,
                                                          activation, dtype):
    ins = _inputs(e, c, d, f, seed=e * c, dtype=dtype)
    got = moe_ffn_bwd_emulation(*ins, activation)
    want = ref.moe_ffn_bwd_ref(*(x.float() for x in ins),
                               activation=activation)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        if dtype == torch.float32:
            _close(g.numpy(), w.numpy())
        else:
            err = float((g.float() - w).abs().max())
            assert err <= BF16_TOL * float(w.abs().max()), err


@pytest.mark.parametrize("e,c,d,f", [(8, 2049, 4096, 14336),
                                     (4, 37, 72, 104), (2, 1, 64, 64)])
def test_bf16_tile_order_covers_every_tile_once(e, c, d, f):
    """Mixtral-8x7B at 5t-m's shape, a ragged one (F padded to 104) and
    one token: each launch's tiles, walked by ``tile_at``, are every
    (product, expert, row tile, column tile) exactly once."""
    for jobs in launch_jobs(e, c, d, f):
        total = sum(n * mt * nt for n, mt, nt, *_ in jobs)
        seen = [tile_at(jobs, t) for t in range(total)]
        want = {(j, x, m, n) for j, (n_e, mt, nt, *_) in enumerate(jobs)
                for x in range(n_e) for m in range(mt) for n in range(nt)}
        assert len(seen) == len(want) and set(seen) == want


def test_bf16_tile_order_keeps_a_wave_on_few_tiles_of_the_larger_operand():
    """At 5t-m's shape the 132 tiles in flight at one time (one CTA an
    SM) sweep the smaller operand against few tiles of the larger one:
    dWg's wave covers all 32 row tiles of D (X, 16.8 MB an expert, stays
    in L2) against 5 column tiles of F (dg, 59 MB an expert, read about
    once); dWd's the other way round; dX's all 17 token tiles of dg / du
    against 8 of Wg / Wu's 16 column tiles, though D has fewer tiles;
    launch 1's 17 token tiles against 8 tiles of F."""
    launches = launch_jobs(8, 2049, 4096, 14336)
    first_wave = lambda jobs, t0: [tile_at(jobs, t)
                                   for t in range(t0, t0 + 132)]
    dw = launches[3]
    wave = first_wave(dw, 0)
    assert {m for _, _, m, _ in wave} == set(range(32))
    assert len({n for _, _, _, n in wave}) == 5
    dwd0 = 2 * 8 * 32 * 56                 # dWd's first tile
    wave = first_wave(dw, dwd0)
    assert {j for j, *_ in wave} == {2}
    assert {n for *_, n in wave} == set(range(16))
    assert len({m for _, _, m, _ in wave}) == 9
    for launch in (launches[1], launches[2]):
        wave = first_wave(launch, 0)
        assert {m for _, _, m, _ in wave} == set(range(17))
        assert len({n for *_, n in wave}) == 8


# ---------------------------------------------------------------------------
# (c) gradcheck in f64


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
def test_moe_ffn_fn_gradcheck_f64(activation):
    """Through the plain versions on the CPU (the wrappers take f64
    there)."""
    leaves = [x.double().requires_grad_(True)
              for x in _inputs(2, 3, 4, 5, seed=0)[:4]]
    assert torch.autograd.gradcheck(
        lambda *a: tmoe.MoEFFNFn.apply(*a, activation), leaves, eps=1e-6,
        atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# (d) the layer's route


def _layer():
    gen = torch.Generator().manual_seed(0)
    params = {"router": torch.randn(8, 4, generator=gen),
              "w_gate": torch.randn(4, 8, 6, generator=gen),
              "w_up": torch.randn(4, 8, 6, generator=gen),
              "w_down": torch.randn(4, 6, 8, generator=gen)}
    return params, torch.randn(1, 5, 8, generator=gen)


def test_moe_layer_runs_the_kernel_and_under_a_gradient_its_backward(
        monkeypatch):
    """``moe_ffn`` runs the experts in every phase; where a gradient is
    taken ``MoEFFNFn``'s backward runs ``moe_ffn_bwd`` once a call."""
    calls = []
    for name in ("moe_ffn", "moe_ffn_bwd"):
        fn = getattr(mf, name)
        monkeypatch.setattr(mf, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    params, x = _layer()
    kw = dict(n_experts=4, top_k=2, activation="swiglu")
    with torch.no_grad():
        tmoe.apply_moe(params, x, **kw)
    assert calls == ["moe_ffn"]
    calls.clear()
    for t in params.values():
        t.requires_grad_(True)
    out = tmoe.apply_moe(params, x, **kw)
    assert calls == ["moe_ffn"]
    torch.autograd.grad(out.sum(), list(params.values()))
    assert calls == ["moe_ffn", "moe_ffn_bwd"]


def test_ungated_experts_on_the_card_raise(monkeypatch):
    """No kernel takes ungated experts (no served config has them)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    params, x = _layer()
    del params["w_gate"]
    with pytest.raises(NotImplementedError):
        tmoe._expert_ffn(params, x.reshape(1, 5, 8), "gelu")


# ---------------------------------------------------------------------------
# (e) the wrapper on a card without a build


def test_moe_ffn_bwd_cuda_call_without_a_build_raises(monkeypatch):
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)

    def no_build(name):
        raise _build.KernelBuildError(f"no build of {name}")
    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(ref, "moe_ffn_bwd_ref", lambda *a, **k: 1 / 0)
    buf, wg, wu, wd, dy = _inputs(2, 3, 8, 8, seed=0)
    before = mf.moe_ffn_bwd.launches
    with pytest.raises(_build.KernelBuildError):
        mf.moe_ffn_bwd(buf, wg, wu, wd, dy)
    assert mf.moe_ffn_bwd.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_bwd_counts_its_launches_and_pads_f(monkeypatch, dtype):
    """One launch a call; bf16's F (6 here) is padded to 8 for TMA and the
    weight gradients come back at the caller's F."""
    from repro_torch.kernels import launch_counts, reset_launches
    seen = []
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "bind", lambda *a: lambda *args:
                        seen.append(args[15]) or 0)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    reset_launches()
    buf, wg, wu, wd, dy = _inputs(2, 3, 8, 6, seed=0, dtype=dtype)
    dbuf, dwg, dwu, dwd = mf.moe_ffn_bwd(buf, wg, wu, wd, dy)
    assert (dbuf.shape, dwg.shape, dwu.shape, dwd.shape) == (
        buf.shape, wg.shape, wu.shape, wd.shape)
    assert seen == [8 if dtype == torch.bfloat16 else 6]
    assert {k: v for k, v in launch_counts().items() if v} == {
        "moe_ffn_bwd": 1}
    reset_launches()


def test_moe_ffn_bwd_rejects_bad_inputs():
    buf, wg, wu, wd, dy = _inputs(2, 3, 8, 8, seed=0)
    with pytest.raises(ValueError):         # dy of another shape
        mf.moe_ffn_bwd(buf, wg, wu, wd, dy[:, :2])
    with pytest.raises(ValueError):         # mixed dtypes
        mf.moe_ffn_bwd(buf, wg, wu, wd, dy.double())
    with pytest.raises(ValueError):
        mf.moe_ffn_bwd(buf, wg, wu, wd, dy, activation="relu")
