"""The port's configuration registry against the JAX package's
(``repro.configs``): all 13 configurations field for field, their
``reduced(d_model=128)`` smoke forms, the reduced forms' parameter
counts, the ``ARCHS`` / ``PAPER_MODELS`` / ``ALL_CONFIGS`` registries
and ``get_config``'s names and error text."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro import configs as J  # noqa: E402
from repro_torch import configs as T  # noqa: E402


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", sorted(J.ALL_CONFIGS))
def test_config_matches_jax_field_for_field(name):
    t, j = T.get_config(name), J.get_config(name)
    assert _fields(t) == _fields(j)
    assert _fields(t.reduced(d_model=128)) == _fields(j.reduced(d_model=128))


@pytest.mark.parametrize("name", sorted(J.ALL_CONFIGS))
def test_reduced_param_counts_match_jax(name):
    t = T.get_config(name).reduced(d_model=128)
    j = J.get_config(name).reduced(d_model=128)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert t.n_moe_layers == j.n_moe_layers
    assert [t.layer_kind(l) for l in range(t.n_layers)] == [
        j.layer_pattern[l % len(j.layer_pattern)] for l in range(j.n_layers)]


def test_registries_match_jax():
    for reg in ("ARCHS", "PAPER_MODELS", "ALL_CONFIGS"):
        t, j = getattr(T, reg), getattr(J, reg)
        assert list(t) == list(j), reg
        assert all(_fields(t[k]) == _fields(j[k]) for k in j), reg


def test_get_config_error_matches_jax():
    with pytest.raises(KeyError) as te:
        T.get_config("gemma3-27b")
    with pytest.raises(KeyError) as je:
        J.get_config("gemma3-27b")
    assert str(te.value) == str(je.value)


def test_copied_departures_from_the_model_cards():
    """What the JAX configs set where the model cards differ, kept as
    they are (ROADMAP: JAX behaviours the port copies on purpose)."""
    assert T.GEMMA3_12B.head_dim == 240
    assert T.GEMMA3_12B.param_count() == 12_630_466_560
    assert T.STARCODER2_7B.layer_pattern == (T.ATTN,)
    assert not T.WHISPER_BASE.use_rope and T.WHISPER_BASE.encoder_decoder
    assert T.LLAMA4_MAVERICK.n_moe_layers == 24
