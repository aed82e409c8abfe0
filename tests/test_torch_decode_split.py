"""The split-KV verify kernels' arithmetic, on the CPU.

``csrc/decode_attention.cu`` and ``csrc/paged_decode_attention.cu`` share
a body that cuts each sequence's keys across a (B, Hkv, n_split) grid
and merges the per-split partials in a fixed order.  A test-local
emulation does what the kernel does -- the same ``n_split`` function, the
same 64-key tiles dealt out in order, an online softmax per split with
the finite -1e30 mask, P rounded to bf16 before P V on the bf16
(tensor-core) path, 32-key steps in f32 on the exact path, the merge in
split order, kMergeChunk splits a pass, and one division by
max(l, 1e-30) at the end -- and is held to the JAX Pallas kernels in
interpret mode: bf16 within ``chip_smoke.py``'s 2e-2, f32 within 1e-4.

The cases pin what a split can do wrong: rows that see no key in a split
(a tile boundary inside the last m positions, a split before a row's
window, tree rows whose ancestors lie elsewhere), empty splits (lengths
shorter than one split), int8 pools, m = 1 and MQA at head dim 256.
Also: the split count is a function of shapes alone, and the wrappers'
q/out stride checks and what they hand the C entry points.  Inputs come
from numpy seeds.
"""
import ctypes
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import paged_decode_attention as pd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

TOL = {"bf16": dict(rtol=2e-2, atol=2e-2), "f32": dict(rtol=1e-4, atol=1e-4)}
NEG = ref.NEG_INF
MERGE_CHUNK = 8                     # kMergeChunk in common.cuh
TREE_ANC = np.array([1, 3, 5, 11], np.int32)   # root, 2 children, grandchild


def _split_ranges(length, kv_end, m, window, n_split):
    """[k_begin, k_end) of every split: split_range in common.cuh."""
    first = max(0, length - m - window + 1) if window else 0
    t_lo = first // da.KEY_TILE
    t_hi = -(-max(kv_end, 0) // da.KEY_TILE)
    nt = max(t_hi - t_lo, 0)
    out = []
    for s in range(n_split):
        ts, te = t_lo + s * nt // n_split, t_lo + (s + 1) * nt // n_split
        out.append((ts * da.KEY_TILE, min(te * da.KEY_TILE, kv_end))
                   if te > ts else (ts * da.KEY_TILE, ts * da.KEY_TILE))
    return out


def _visible(kpos, mi, length, m, kv_end, window, anc):
    """(rows, keys) visibility: key_visible in common.cuh."""
    kpos, mi = kpos[None, :], mi[:, None]
    if anc is not None:
        spec0 = length - m
        col = kpos - spec0
        bit = (torch.as_tensor(anc).long()[mi] >> col.clamp(0, 31)) & 1
        ok = (kpos < spec0) | ((col >= 0) & (kpos < length) & (bit > 0))
    else:
        qpos = length - m + mi
        ok = (kpos <= qpos) & (kpos < length)
        if window:
            ok &= kpos > qpos - window
    return ok & (kpos < kv_end)


def _partial(qr, kh, vh, k_begin, k_end, length, m, kv_end, window, anc,
             scale, tensor_core):
    """One split's (acc, m, l): the online softmax over its tiles."""
    rows, d = qr.shape
    step = da.KEY_TILE if tensor_core else 32
    mi = torch.arange(rows) % m
    m_run = torch.full((rows,), NEG)
    l_run = torch.zeros(rows)
    acc = torch.zeros(rows, d)
    for k0 in range(k_begin, k_end, step):
        keys = torch.arange(k0, k0 + step)
        live = keys < k_end
        kt = torch.zeros(step, d)
        vt = torch.zeros(step, d)
        kt[live] = kh[keys[live]]
        vt[live] = vh[keys[live]]
        s = qr @ kt.T
        s = torch.where(_visible(keys, mi, length, m, kv_end, window, anc),
                        s * scale, torch.full_like(s, NEG))
        m_new = torch.maximum(m_run, s.amax(1))
        p = torch.exp(s - m_new[:, None])
        c = torch.exp(m_run - m_new)
        l_run = l_run * c + p.sum(1)
        if tensor_core:
            p = p.to(torch.bfloat16).float()
        acc = acc * c[:, None] + p @ vt
        m_run = m_new
    return acc, m_run, l_run


def _merge(parts):
    """The last CTA's merge (split_epilogue): split order, kMergeChunk
    splits a pass; an empty split (l = 0) weighs nothing."""
    if len(parts) == 1:
        acc, _, l = parts[0]
        return acc / torch.clamp_min(l, 1e-30)[:, None]
    rows, d = parts[0][0].shape
    mg = torch.full((rows,), NEG)
    l = torch.zeros(rows)
    acc = torch.zeros(rows, d)
    for s0 in range(0, len(parts), MERGE_CHUNK):
        chunk = parts[s0:s0 + MERGE_CHUNK]
        new = mg.clone()
        for a_s, m_s, l_s in chunk:
            new = torch.where(l_s > 0, torch.maximum(new, m_s), new)
        c = torch.exp(mg - new)
        l = l * c
        acc = acc * c[:, None]
        for a_s, m_s, l_s in chunk:
            w = torch.where(l_s > 0, torch.exp(m_s - new), torch.zeros(rows))
            l = l + l_s * w
            acc = acc + torch.where(w[:, None] != 0, w[:, None] * a_s,
                                    torch.zeros_like(a_s))
        mg = new
    return acc / torch.clamp_min(l, 1e-30)[:, None]


def _emulate(q, k, v, lengths, n_split, *, window=None, anc=None,
             tensor_core, stats=None):
    """The split kernels on a (B, Hkv, S, d) cache (a paged pool gathered
    to it: kv_end = min(len, S) is len there).  ``stats`` collects, per
    (sequence, head, split), whether the split is empty and how many of
    its rows see no key."""
    b, hq, m, d = q.shape
    hkv, n_slots = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5
    out = torch.zeros(b, hq, m, d)
    for bi in range(b):
        length = int(lengths[bi])
        kv_end = min(length, n_slots)
        ranges = _split_ranges(length, kv_end, m, window, n_split)
        for h in range(hkv):
            qr = q[bi, h * g:(h + 1) * g].reshape(g * m, d).float()
            parts = []
            for k_begin, k_end in ranges:
                part = _partial(qr, k[bi, h].float(), v[bi, h].float(),
                                k_begin, k_end, length, m, kv_end, window,
                                anc, scale, tensor_core)
                parts.append(part)
                if stats is not None:
                    stats.append((k_begin >= k_end,
                                  int(((part[1] <= NEG) & (part[2] > 0))
                                      .sum())))
            out[bi, h * g:(h + 1) * g] = _merge(parts).reshape(g, m, d)
    return out.to(q.dtype)


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dt])


def _qkv(rng, b, hq, hkv, m, s, d, dt):
    """q, k, v as bf16-representable (or f32) numpy arrays and tensors."""
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    arrs = [rng.standard_normal(shape, np.float32)
            for shape in ((b, hq, m, d), (b, hkv, s, d), (b, hkv, s, d))]
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    return [t.float().numpy() for t in ts], ts


def _pallas_decode(qn, kn, vn, lengths, dt, window=None, anc=None):
    jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
    return ops.decode_attention(
        jnp.asarray(qn, jdt), jnp.asarray(kn, jdt), jnp.asarray(vn, jdt),
        jnp.asarray(lengths), window=window, block_k=64,
        anc_bits=None if anc is None else jnp.asarray(anc), interpret=True)


# ---------------------------------------------------------------------------
# contiguous cache


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
def test_split_counts_match_pallas(dt, n_split):
    rng = np.random.default_rng(20)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 2, 4, 2, 5, 512, 64, dt)
    lengths = np.array([450, 500], np.int32)
    stats = []
    got = _emulate(q, k, v, lengths, n_split, tensor_core=dt == "bf16",
                   stats=stats)
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt), dt)
    # every split of a length that fills it holds at least one whole tile
    assert sum(e for e, _ in stats) == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("lengths", [[130, 66], [194, 258]])
def test_tile_boundary_inside_the_last_m_rows(dt, lengths):
    """Lengths 64 t + 2: the last split holds keys 64 t, 64 t + 1, after
    the positions of the first three verify rows, which see no key there
    (m = -1e30 over a finite sum) and must weigh nothing."""
    rng = np.random.default_rng(21)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 2, 4, 2, 5, 320, 64, dt)
    lengths = np.array(lengths, np.int32)
    n_split = max(-(-int(x) // 64) for x in lengths)     # one tile a split
    stats = []
    got = _emulate(q, k, v, lengths, n_split, tensor_core=dt == "bf16",
                   stats=stats)
    assert sum(blind for _, blind in stats) > 0
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("n_split", [2, 3])
def test_splits_before_a_rows_sliding_window(dt, n_split):
    """Length 320, window 64: the first key tile [192, 256) lies wholly
    before the window of the last verify row (keys > 255)."""
    rng = np.random.default_rng(22)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 2, 4, 2, 5, 512, 64, dt)
    lengths = np.array([320, 450], np.int32)
    stats = []
    got = _emulate(q, k, v, lengths, n_split, window=64,
                   tensor_core=dt == "bf16", stats=stats)
    assert sum(blind for _, blind in stats) > 0
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt, window=64), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,lengths", [(5, [6, 65]), (1, [1, 2])])
def test_lengths_shorter_than_one_split(dt, m, lengths):
    """The capacity's split count against a few keys: most splits are
    empty, write (m = -1e30, l = 0) and are skipped by the merge."""
    rng = np.random.default_rng(23)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 2, 4, 2, m, 2048, 64, dt)
    lengths = np.array(lengths, np.int32)
    n_split = da.n_split(2, 2, 2048)
    stats = []
    got = _emulate(q, k, v, lengths, n_split, tensor_core=dt == "bf16",
                   stats=stats)
    assert sum(e for e, _ in stats) > len(stats) // 2
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_tree_rows_across_splits(dt):
    """anc_bits rows see the committed prefix and their ancestors in the
    buffer, which straddles a split boundary."""
    rng = np.random.default_rng(24)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 2, 4, 2, 4, 320, 64, dt)
    lengths = np.array([130, 66], np.int32)
    stats = []
    got = _emulate(q, k, v, lengths, 3, anc=TREE_ANC,
                   tensor_core=dt == "bf16", stats=stats)
    assert sum(blind for _, blind in stats) > 0
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt, anc=TREE_ANC), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_greedy_decode_m1(dt):
    rng = np.random.default_rng(25)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 4, 8, 2, 1, 640, 128, dt)
    lengths = np.array([560, 129, 1, 640], np.int32)
    got = _emulate(q, k, v, lengths, da.n_split(4, 2, 640),
                   tensor_core=dt == "bf16")
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mqa_head_dim_256(dt):
    """RecurrentGemma's verify shape: Hq 10 on one KV head, d 256."""
    rng = np.random.default_rng(26)
    (qn, kn, vn), (q, k, v) = _qkv(rng, 2, 10, 1, 5, 640, 256, dt)
    lengths = np.array([300, 640], np.int32)
    got = _emulate(q, k, v, lengths, da.n_split(2, 1, 640),
                   tensor_core=dt == "bf16")
    _close(got, _pallas_decode(qn, kn, vn, lengths, dt), dt)


# ---------------------------------------------------------------------------
# paged pool


@pytest.mark.parametrize("dt,quant,tree", [
    ("bf16", False, False), ("f32", False, False),
    ("bf16", True, False),            # int8 pool: the exact body, f32
    ("f32", True, True),              # int8 pool with a tree
])
def test_paged_splits_match_pallas(dt, quant, tree):
    rng = np.random.default_rng(27)
    b, hq, hkv, m, bs, mbs, d = 2, 4, 2, 4, 16, 12, 64
    tdt = torch.bfloat16 if dt == "bf16" else torch.float32
    nb = b * mbs + 2
    bt = (rng.permutation(nb - 1)[:b * mbs] + 1).reshape(b, mbs)
    bt = bt.astype(np.int32)
    qt = torch.from_numpy(rng.standard_normal((b, hq, m, d), np.float32)
                          ).to(tdt)
    if quant:
        kp = rng.integers(-127, 128, (nb, bs, hkv, d)).astype(np.int8)
        vp = rng.integers(-127, 128, (nb, bs, hkv, d)).astype(np.int8)
        scs = rng.uniform(0.01, 0.1, (2, nb, bs, hkv, 1)).astype(np.float32)
        kpt, vpt = torch.from_numpy(kp), torch.from_numpy(vp)
        sc_t = dict(k_scale=torch.from_numpy(scs[0]),
                    v_scale=torch.from_numpy(scs[1]))
        sc_j = dict(k_scale=jnp.asarray(scs[0]), v_scale=jnp.asarray(scs[1]))
        kpj, vpj = jnp.asarray(kp), jnp.asarray(vp)
    else:
        kpt = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d),
                                                   np.float32)).to(tdt)
        vpt = torch.from_numpy(rng.standard_normal((nb, bs, hkv, d),
                                                   np.float32)).to(tdt)
        sc_t, sc_j = {}, {}
        jdt = jnp.bfloat16 if dt == "bf16" else jnp.float32
        kpj = jnp.asarray(kpt.float().numpy(), jdt)
        vpj = jnp.asarray(vpt.float().numpy(), jdt)
    lengths = np.array([130, 66], np.int32)        # boundaries in the last m
    anc = TREE_ANC if tree else None
    want = ops.paged_decode_attention(
        jnp.asarray(qt.float().numpy(),
                    jnp.bfloat16 if dt == "bf16" else jnp.float32),
        kpj, vpj, jnp.asarray(bt), jnp.asarray(lengths),
        anc_bits=None if anc is None else jnp.asarray(anc), interpret=True,
        **sc_j)
    kg, vg = ref.gather_paged_kv_ref(kpt, vpt, torch.from_numpy(bt), **sc_t)
    if not quant:                    # the tensor-core path reads the pool
        kg, vg = kg.to(tdt), vg.to(tdt)
    n_split = da.n_split(b, hkv, mbs * bs)
    stats = []
    got = _emulate(qt, kg.transpose(1, 2), vg.transpose(1, 2), lengths,
                   n_split, anc=anc, tensor_core=dt == "bf16" and not quant,
                   stats=stats)
    assert sum(blind for _, blind in stats) > 0
    _close(got, want, dt)


# ---------------------------------------------------------------------------
# the split count and the wrappers' arguments


@pytest.mark.parametrize("b,hkv,capacity", [
    (4, 8, 640), (8, 8, 32768), (2, 1, 640), (1, 1, 64), (1, 1, 1),
    (64, 8, 4096), (3, 5, 1000), (1, 8, 32768),
])
def test_n_split_is_a_function_of_shapes(b, hkv, capacity):
    assert list(inspect.signature(da.n_split).parameters) == [
        "batch", "n_kv_heads", "capacity"]
    ns = da.n_split(b, hkv, capacity)
    tiles = -(-capacity // da.KEY_TILE)
    assert 1 <= ns <= max(1, tiles)
    assert ns == 1 or b * hkv * ns <= da.CTAS_PER_SM * da.N_SMS
    # a full sequence gives every split at least one tile
    for k_begin, k_end in _split_ranges(capacity, capacity, 5, None, ns):
        assert k_end > k_begin and k_begin % da.KEY_TILE == 0


def _fake_launch(monkeypatch, module, strides_at, n_strides):
    """Route a wrapper on CPU tensors to its C entry, replaced by a
    recorder of the arguments it is given (the stride array read while
    the call lasts)."""
    calls = []

    def entry(*args):
        strides = list((ctypes.c_int64 * n_strides).from_address(
            args[strides_at]))
        calls.append((args, strides))
        return 0

    monkeypatch.setattr(module._build, "use_kernel", lambda *t: True)
    monkeypatch.setattr(module._build, "bind", lambda *a: entry)
    monkeypatch.setattr(module._build, "stream_ptr", lambda t: 0)
    return calls


@pytest.mark.parametrize("lengths", [[1, 2], [600, 5], [640, 640]])
def test_contiguous_wrapper_grid_ignores_lengths(monkeypatch, lengths):
    """The same shapes launch the same grid whatever the lengths hold;
    the model's (B, m, H, d) q goes in through its strides and the output
    comes back in its layout."""
    calls = _fake_launch(monkeypatch, da, 9, 9)
    q = torch.zeros(2, 5, 32, 128, dtype=torch.bfloat16).transpose(1, 2)
    cache = torch.zeros(2, 640, 8, 128, dtype=torch.bfloat16)
    k = cache.transpose(1, 2)
    out = da.decode_attention(q, k, k, torch.tensor(lengths,
                                                    dtype=torch.int32))
    assert out.stride() == q.stride()
    args, strides = calls[-1]
    assert args[16] == da.n_split(2, 8, 640)             # n_split
    assert strides == [5 * 32 * 128, 128, 32 * 128] * 2 + [
        640 * 8 * 128, 128, 8 * 128]
    assert args[6] is not None and args[8] is not None   # workspace


@pytest.mark.parametrize("lengths", [[1, 2], [600, 5]])
def test_paged_wrapper_grid_ignores_lengths(monkeypatch, lengths):
    calls = _fake_launch(monkeypatch, pd, 12, 6)
    q = torch.zeros(2, 5, 32, 128, dtype=torch.bfloat16).transpose(1, 2)
    pool = torch.zeros(81, 16, 8, 128, dtype=torch.bfloat16)
    bt = torch.arange(1, 81, dtype=torch.int32).reshape(2, 40)
    out = pd.paged_decode_attention(q, pool, pool, bt,
                                    torch.tensor(lengths, dtype=torch.int32))
    assert out.stride() == q.stride()
    args, strides = calls[-1]
    assert args[20] == da.n_split(2, 8, 40 * 16)         # n_split
    assert strides == [5 * 32 * 128, 128, 32 * 128] * 2


@pytest.mark.parametrize("rows,d", [
    (1, 64), (20, 128), (128, 128), (129, 128), (160, 128), (248, 128),
    (10, 240), (80, 240), (81, 240), (160, 240), (76, 256), (124, 256),
    (1000, 64),
])
def test_row_groups_cover_every_row_once(rows, d):
    """The wrapper's row groups (host arithmetic): as few CTAs as one
    CTA's capacity allows, each group non-empty and within it, every one
    of the g * m rows in exactly one group (group i holds rows [i * per,
    min((i + 1) * per, rows)), as row_group in common.cuh)."""
    groups, per = da.row_groups(rows, d)
    assert groups == -(-rows // da.max_rows(d))
    assert 1 <= per <= da.max_rows(d)
    held = [r for i in range(groups)
            for r in range(i * per, min((i + 1) * per, rows))]
    assert sorted(held) == list(range(rows))
    assert all(min((i + 1) * per, rows) > i * per for i in range(groups))


def test_max_rows_matches_the_kernels_capacity():
    """max_group_rows in common.cuh: 128 at d 64 and 128, 80 at d 240
    (ten n-tiles; the CUDA-core body's shared memory would fit 82), 76 at
    d 256 (its shared memory)."""
    assert [da.max_rows(d) for d in (64, 128, 240, 256)] == [128, 128, 80, 76]
    smem = lambda d: (232_448 // 4 - 32 * (2 * d + 1)) // (2 * d + 35)
    assert smem(240) == 82 and smem(256) == 76


@pytest.mark.parametrize("wrapper", ["paged", "contiguous"])
def test_wrappers_pass_row_groups_past_one_cta(monkeypatch, wrapper):
    """Llama-3-405B's verify under tree (3, 2): 128 / 8 query heads x 10
    nodes = 160 rows go to two row groups of 80, the grid counts each
    group as a head for its splits, and the workspace has a unit per
    (head, group)."""
    q = torch.zeros(2, 10, 128, 128, dtype=torch.bfloat16).transpose(1, 2)
    lengths = torch.tensor([300, 600], dtype=torch.int32)
    anc = torch.ones(10, dtype=torch.int32)
    if wrapper == "paged":
        calls = _fake_launch(monkeypatch, pd, 12, 6)
        pool = torch.zeros(81, 16, 8, 128, dtype=torch.bfloat16)
        bt = torch.arange(1, 81, dtype=torch.int32).reshape(2, 40)
        pd.paged_decode_attention(q, pool, pool, bt, lengths, anc_bits=anc)
        at, cap = 20, 40 * 16
    else:
        calls = _fake_launch(monkeypatch, da, 9, 9)
        k = torch.zeros(2, 640, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
        da.decode_attention(q, k, k, lengths, anc_bits=anc)
        at, cap = 16, 640
    args, _ = calls[-1]
    ns = da.n_split(2, 8 * 2, cap)
    assert args[at:at + 3] == (ns, 2, 80)     # n_split, groups, group rows


def test_one_split_needs_no_workspace():
    assert da.split_workspace(2, 8, 1, 20, 128, "cpu") == (None, None, None)
    acc, ml, cnt = da.split_workspace(2, 8, 3, 20, 128, "cpu")
    assert acc.shape == (2, 8, 3, 20, 128) and ml.shape == (2, 8, 3, 20, 2)
    assert cnt.dtype == torch.int32 and cnt.numel() >= 16
    assert int(cnt.abs().sum()) == 0


def test_counters_are_kept_per_stream():
    """Calls on one stream run in order and share the counters; another
    stream, which could run at the same time, gets its own."""
    a = da.split_workspace(2, 8, 3, 20, 128, "cpu", 11)[2]
    b = da.split_workspace(2, 8, 3, 20, 128, "cpu", 11)[2]
    c = da.split_workspace(2, 8, 3, 20, 128, "cpu", 12)[2]
    assert a is b and a is not c


@pytest.mark.parametrize("shape,view,want", [
    ((2, 8, 5, 64), None, [2560, 320, 64]),             # (B, H, m, d)
    ((2, 5, 8, 64), (1, 2), [2560, 64, 512]),           # model layout
    ((2, 1, 8, 64), (1, 2), [512, 64, 0]),              # m = 1
    ((1, 8, 5, 64), None, [0, 320, 64]),                # B = 1
])
def test_token_strides(shape, view, want):
    t = torch.zeros(shape)
    if view is not None:
        t = t.transpose(*view)
    assert da.token_strides(t, "q") == want


def test_token_strides_refuse_what_the_kernel_cannot_read():
    with pytest.raises(ValueError):     # last dim not contiguous
        da.token_strides(torch.zeros(2, 4, 5, 64).transpose(2, 3), "q")
    with pytest.raises(ValueError):     # head stride of 12 elements
        da.token_strides(torch.zeros(2, 5, 4, 12)[..., :8], "q")
    with pytest.raises(ValueError):     # not 16-byte aligned
        da.token_strides(torch.zeros(2 * 4 * 5 * 64 + 1)[1:]
                         .reshape(2, 4, 5, 64), "q")
