"""The encoder-decoder path (Whisper) against the JAX package on the same
weights (``params.from_jax``, the encoder's stacked layers unstacked):
``sinusoidal_positions`` and ``apply_encoder``; tests/test_models.py's
incremental test on both packages (prefill with ``encoder_frames``, then
3 ``decode_step``s), with the cross K/V the prefill stores in the cache;
Whisper-base reduced, prefill and 2 decode steps; and
``init_paged_cache`` refusing an encoder-decoder config as JAX's does.
f32, atol and rtol 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs.base import ModelConfig as JConfig  # noqa: E402
from repro.models import encdec as jenc  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ModelConfig, get_config  # noqa: E402
from repro_torch.models import encdec as tenc  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.params import from_jax  # noqa: E402

CPU = "cpu"
TOL = 1e-4

# tests/test_models.py::test_encdec_incremental's configuration
INCREMENTAL = dict(name="w", arch_type="audio", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=61,
                   use_rope=False, norm="layernorm", activation="gelu",
                   encoder_decoder=True, n_encoder_layers=2, encoder_len=12,
                   dtype="float32", remat=False)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _weights(jcfg, tcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, from_jax(jax.tree.map(np.asarray, jp), tcfg, CPU)


def _whisper():
    return (j_get_config("whisper-base").reduced(d_model=128),
            get_config("whisper-base").reduced(d_model=128))


@pytest.mark.parametrize("n,d", [(1500, 512), (32, 128), (7, 6)])
def test_sinusoidal_positions_match_jax(n, d):
    _close(tlayers.sinusoidal_positions(n, d),
           jlayers.sinusoidal_positions(n, d))


def test_apply_encoder_matches_jax():
    jcfg, tcfg = _whisper()
    jp, tp = _weights(jcfg, tcfg)
    assert len(tp["encoder"]["layers"]) == tcfg.n_encoder_layers == 2
    frames = np.random.default_rng(0).standard_normal(
        (2, tcfg.encoder_len, tcfg.d_model)).astype(np.float32)
    _close(tenc.apply_encoder(tp["encoder"], tcfg, torch.from_numpy(frames)),
           jenc.apply_encoder(jp["encoder"], jcfg, jnp.asarray(frames)))


def _incremental(jcfg, tcfg, jp, tp, b, length, steps, max_len):
    """Prefill ``length`` tokens with frames, then ``steps`` decode steps
    fed the greedy tokens, on both packages; returns both caches."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, tcfg.vocab_size, (b, length)).astype(np.int32)
    frames = rng.standard_normal((b, tcfg.encoder_len,
                                  tcfg.d_model)).astype(np.float32)
    jc = JT.init_cache(jcfg, b, max_len)
    tc = TT.init_cache(tcfg, b, max_len, CPU)
    jl, jc = JM.prefill(jp, jcfg, jnp.asarray(toks), jc,
                        encoder_frames=jnp.asarray(frames))
    tl, tc = TM.prefill(tp, tcfg, torch.from_numpy(toks).long(), tc,
                        encoder_frames=torch.from_numpy(frames))
    _close(tl, jl)
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(tok))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(tok).long())
        _close(tl, jl)
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist()
    return jc, tc


def test_incremental_decode_matches_jax():
    """tests/test_models.py:82-101's configuration: prefill 6 tokens with
    encoder frames, then 3 decode steps; the cross K/V ``ck`` / ``cv``
    each layer's cache holds are JAX's."""
    tcfg = ModelConfig(**INCREMENTAL)
    jcfg = JConfig(**INCREMENTAL)
    jp, tp = _weights(jcfg, tcfg)
    jc, tc = _incremental(jcfg, tcfg, jp, tp, b=2, length=6, steps=3,
                          max_len=11)
    for l in range(tcfg.n_layers):
        assert tc["layers"][l]["ck"].shape == (2, 12, 4, 16)
        for key in ("ck", "cv"):
            _close(tc["layers"][l][key], jc["layers"][0][key][l])


def test_whisper_base_reduced_matches_jax():
    jcfg, tcfg = _whisper()
    jp, tp = _weights(jcfg, tcfg, seed=1)
    _incremental(jcfg, tcfg, jp, tp, b=2, length=5, steps=2, max_len=16)


def test_paged_cache_refuses_encoder_decoder_like_jax():
    jcfg, tcfg = _whisper()
    with pytest.raises(ValueError) as je:
        JT.init_paged_cache(jcfg, 2, 8, 4, 2)
    with pytest.raises(ValueError) as te:
        TT.init_paged_cache(tcfg, 2, 8, 4, 2, device=CPU)
    assert str(te.value) == str(je.value)
    # the same config without the encoder has a paged cache
    TT.init_paged_cache(dataclasses.replace(tcfg, encoder_decoder=False), 2,
                        8, 4, 2, device=CPU)
