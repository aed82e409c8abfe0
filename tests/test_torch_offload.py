"""The port's offload tier against the JAX package's
(``repro/core/offload.py``) on the CPU: the streamed model against JAX's
``OffloadedModel`` (f32, rtol and atol 1e-5) and bit for bit against the
port's resident model on the same ``from_jax`` weights, for an attention
config and a reduced MoE config with more layers than the two device
slots; the layers at rest in host tensors; the transfer accounting per
pass; the layer-by-layer seeded constructor against ``init_params``;
``host_attention_direct`` against JAX's (1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MIXTRAL_8X7B as J_MIXTRAL  # noqa: E402
from repro.core import offload as JO  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import MIXTRAL_8X7B, ModelConfig  # noqa: E402
from repro_torch.core import offload as TO  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax, init_params  # noqa: E402

from conftest import tiny_config  # noqa: E402

CPU = "cpu"
TOL = 1e-5
B, L, MAX_LEN, STEPS = 2, 8, 24, 3


def _configs(kind):
    """(jax cfg, torch cfg) from the same fields: the JAX suite's tiny
    attention config (2 layers) or the reduced Mixtral with 3 layers."""
    if kind == "attn":
        j = tiny_config(("attn",))
        fields = {f: getattr(j, f) for f in ModelConfig.__dataclass_fields__}
        return j, ModelConfig(**fields)
    return (J_MIXTRAL.reduced(d_model=64, n_layers=3),
            MIXTRAL_8X7B.reduced(d_model=64, n_layers=3))


def _setup(kind):
    jcfg, tcfg = _configs(kind)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)
    toks = np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, L))
    return jcfg, tcfg, jp, tp, toks


@pytest.mark.parametrize("kind", ["attn", "moe"])
def test_streamed_model_matches_jax_and_the_resident_model(kind):
    """Prefill, then ``STEPS`` greedy decode + commit steps: the streamed
    logits agree with JAX's ``OffloadedModel`` and equal the port's
    resident ``M.prefill`` / ``M.decode`` bit for bit."""
    jcfg, tcfg, jp, tp, toks = _setup(kind)
    jom = JO.OffloadedModel(jcfg, jp)
    tom = TO.OffloadedModel(tcfg, tp, CPU)
    assert tom.streamed_bytes() == jom.streamed_bytes() > 0
    jc = jom.prefill(jnp.asarray(toks, jnp.int32),
                     JT.init_cache(jcfg, B, MAX_LEN))
    ttok = torch.from_numpy(toks).long()
    tl, tc = tom.prefill(ttok, TT.init_cache(tcfg, B, MAX_LEN, CPU))
    rl, rc = TM.prefill(tp, tcfg, ttok, TT.init_cache(tcfg, B, MAX_LEN, CPU))
    jl, jc = jc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert torch.equal(tl, rl)
    nxt = torch.argmax(rl, -1)[:, None]
    ones = torch.ones((B,), dtype=torch.int64)
    for _ in range(STEPS):
        jl, jc, jpend = jom.decode(jc, jnp.asarray(nxt.numpy(), jnp.int32))
        jc = JM.commit(jcfg, jc, jpend, jnp.ones((B,), jnp.int32), 1)
        tl, tc, tpend = tom.decode(tc, nxt)
        tc = TM.commit(tcfg, tc, tpend, ones, 1)
        rl3, rc, rpend = TM.decode(tp, tcfg, rc, nxt)
        rc = TM.commit(tcfg, rc, rpend, ones, 1)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        assert torch.equal(tl, rl3)
        nxt = torch.argmax(rl3[:, 0], -1)[:, None]
        assert torch.equal(nxt, torch.argmax(tl[:, 0], -1)[:, None])
    for a, b in zip(TO.tree_leaves(tc["layers"]),
                    TO.tree_leaves(rc["layers"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["attn", "moe"])
def test_layers_rest_in_host_tensors_outside_the_slots(kind):
    """At rest every layer is a host tensor in its own buffer, equal to
    the weights it was given; the device holds two slots, as large as
    the largest layer, and layer ``l`` streams through slot ``l % 2``."""
    _, tcfg, _, tp, _ = _setup(kind)
    om = TO.OffloadedModel(tcfg, tp, CPU)
    assert TO.host_memory_kind(CPU) == "unpinned_host"
    assert len(om.layers_host) == tcfg.n_layers == len(om._flat)
    for l, (host, given) in enumerate(zip(om.layers_host, tp["layers"])):
        for a, b in zip(TO.tree_leaves(host), TO.tree_leaves(given)):
            assert a.device.type == "cpu" and torch.equal(a, b)
            assert a.data_ptr() != b.data_ptr()
            assert a.untyped_storage().data_ptr() == \
                om._flat[l].untyped_storage().data_ptr()
            assert a.data_ptr() % TO.ALIGN == \
                om._flat[l].data_ptr() % TO.ALIGN
    assert len(om._slots) == 2
    assert om._slots[0].numel() == max(f.numel() for f in om._flat)
    for l in range(tcfg.n_layers):
        slot = om._slots[l % 2].untyped_storage().data_ptr()
        for t in TO.tree_leaves(om._slot_views[l]):
            assert t.untyped_storage().data_ptr() == slot
    for k in om.params_resident:
        for a, b in zip(TO.tree_leaves(om.params_resident[k]),
                        TO.tree_leaves(tp[k])):
            assert torch.equal(a, b)


def test_transfers_count_the_streamed_bytes_per_pass():
    _, tcfg, _, tp, toks = _setup("moe")
    om = TO.OffloadedModel(tcfg, tp, CPU)
    assert om.transfers == {}         # parked from CPU tensors: no link
    per_pass = om.streamed_bytes()
    assert per_pass == sum(f.numel() for f in om._flat)
    cache = TT.init_cache(tcfg, B, MAX_LEN, CPU)
    lg, cache = om.prefill(torch.from_numpy(toks).long(), cache)
    assert om.settle()["h2d"]["bytes"] == per_pass
    nxt = torch.argmax(lg, -1)[:, None]
    for n in range(2, 4):
        _, cache, pend = om.decode(cache, nxt)
        cache = TM.commit(tcfg, cache, pend,
                          torch.ones((B,), dtype=torch.int64), 1)
        assert om.settle()["h2d"]["bytes"] == n * per_pass
        assert om.transfers["h2d"]["seconds"] > 0
    assert set(om.transfers) == {"h2d"} and om.compute_seconds == 0.0


def test_record_transfer_adds_per_tier():
    from repro_torch.obs import NULL_OBS, make_obs
    obs, d = make_obs(trace=True), {}
    for tier, nbytes, seconds in (("h2d", 10, 0.5), ("h2d", 5, -1.0),
                                  ("d2h", 3, 0.25)):
        TO.record_transfer(obs, tier, nbytes, seconds)  # -1 s clips to 0
        TO.record_transfer(NULL_OBS, tier, nbytes, seconds)   # a no-op
        TO.add_transfer(d, tier, nbytes, seconds)
    assert d == {"h2d": {"bytes": 15.0, "seconds": 0.5},
                 "d2h": {"bytes": 3.0, "seconds": 0.25}}
    snap = obs.metrics.snapshot()["counters"]
    assert snap["transfer_bytes_total"] == {'{tier="d2h"}': 3.0,
                                            '{tier="h2d"}': 15.0}
    assert snap["transfer_seconds_total"] == {'{tier="d2h"}': 0.25,
                                              '{tier="h2d"}': 0.5}
    spans = [e for e in obs.tracer.to_chrome_trace()["traceEvents"]
             if e["ph"] == "X"]
    assert [e["args"]["bytes"] for e in spans] == [10.0, 5.0, 3.0]


def test_streamed_layers_are_read_once_in_order():
    _, tcfg, _, tp, _ = _setup("moe")
    om = TO.OffloadedModel(tcfg, tp, CPU)
    layers = om.stream_layers()
    layers[0]
    with pytest.raises(IndexError, match="in order"):
        layers[2]
    with pytest.raises(RuntimeError, match="read 1 of 3"):
        layers.finish()


@pytest.mark.parametrize("kind", ["attn", "moe"])
def test_seeded_layer_by_layer_constructor_equals_init_params(kind):
    _, tcfg, _, _, _ = _setup(kind)
    want = init_params(tcfg, torch.Generator().manual_seed(7), CPU)
    om = TO.OffloadedModel.from_seed(tcfg, torch.Generator().manual_seed(7),
                                     CPU)
    for a, b in zip(TO.tree_leaves(om.layers_host),
                    TO.tree_leaves(want["layers"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert list(om.params_resident) == ["embed", "final_norm"]
    for k in om.params_resident:
        for a, b in zip(TO.tree_leaves(om.params_resident[k]),
                        TO.tree_leaves(want[k])):
            assert torch.equal(a, b)
    ref = TO.OffloadedModel(tcfg, want, CPU)
    assert om.streamed_bytes() == ref.streamed_bytes()


def test_put_host_and_tree_bytes_keep_mixed_dtypes():
    """A layer mixes dtypes (the f32 router in a bf16 MoE layer): each
    tensor keeps its own type in the host buffer."""
    tree = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "b": {"router": torch.randn(4, 2), "i": torch.arange(3)}}
    flat, views, owner = TO.put_host(tree, CPU)
    assert owner is None and flat.dtype == torch.uint8
    assert TO.tree_bytes(views) == TO.tree_bytes(tree) == 12 + 32 + 24
    for (a, b) in zip(TO.tree_leaves(views), TO.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    moved = TO.put_device(views, CPU)
    assert torch.equal(moved["b"]["router"], tree["b"]["router"])


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg, _, tp, _ = _setup("attn")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.OffloadedModel(tcfg, tp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TO.host_memory_kind()


@pytest.mark.parametrize("sq", [1, 3])
def test_host_attention_matches_jax(sq):
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 10, 2, 16)).astype(np.float32)
    mask = np.where(np.arange(10)[None, :] < 7 + np.arange(sq)[:, None], 0.0,
                    -1e30).astype(np.float32)
    want = jax.jit(lambda *x: JO.host_attention_direct(*x, 0.25))(
        *(jnp.asarray(a) for a in (q, k, v, mask)))
    got = TO.host_attention_direct(*(torch.from_numpy(a)
                                     for a in (q, k, v, mask)), 0.25)
    assert got.shape == (2, sq, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_streamed_prefill_runs_the_encoder_like_the_resident_model():
    """Whisper-base reduced with 3 decoder layers (more than the 2
    slots): ``OffloadedModel.prefill(tokens, cache, encoder_frames)``
    runs the resident encoder and stores each layer's cross K/V, bit for
    bit as ``M.prefill`` does, and the decode steps after it agree too.
    (The JAX package's ``OffloadedModel.prefill`` takes the frames and
    drops them; the port passes them on.)"""
    from repro_torch.configs import get_config
    tcfg = get_config("whisper-base").reduced(d_model=64, n_layers=3)
    tp = init_params(tcfg, torch.Generator().manual_seed(0), CPU)
    tom = TO.OffloadedModel(tcfg, tp, CPU)
    assert "encoder" in tom.params_resident
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, tcfg.vocab_size, (B, L)))
    frames = torch.as_tensor(rng.standard_normal(
        (B, tcfg.encoder_len, tcfg.d_model)).astype(np.float32))
    ca = TT.init_cache(tcfg, B, MAX_LEN, CPU)
    cb = TT.init_cache(tcfg, B, MAX_LEN, CPU)
    la, ca = TM.prefill(tp, tcfg, toks, ca, encoder_frames=frames)
    lb, cb = tom.prefill(toks, cb, encoder_frames=frames)
    assert torch.equal(la, lb)
    for a, b in zip(ca["layers"], cb["layers"]):
        assert torch.equal(a["ck"], b["ck"]) and torch.equal(a["cv"], b["cv"])
    ones = torch.ones((B,), dtype=torch.int64)
    for _ in range(STEPS):
        tok = torch.argmax(la, -1)[:, None]
        la, ca = TM.decode_step(tp, tcfg, ca, tok)
        lb, cb, pend = tom.decode(cb, tok)
        cb = TM.commit(tcfg, cb, pend, ones, 1)
        assert torch.equal(la, lb[:, 0])
