"""Model configuration for the PyTorch port.

A copy of the JAX package's ``repro.configs`` (the port imports nothing
of that package): the frozen :class:`ModelConfig`, the layer kinds, the
parameter counts the planner, placement and simulator read, and every
configuration the JAX package registers -- the ten assigned
architectures (``ARCHS``, the ``--arch`` ids) and the SpecOffload
paper's own models (``PAPER_MODELS``: the Mixtral 8x7B / 8x22B targets
and the Mistral 7B draft) -- field for field, with their ``source``
strings and the JAX configs' departures from the model cards (listed
beside each).  ``reduced()`` gives the same smoke-size variants, so a
test can build one config for both packages from the same fields.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Layer kinds usable in ``layer_pattern``.
ATTN = "attn"      # global (full, causal) attention
SWA = "swa"        # sliding-window (local) attention
RGLRU = "rglru"    # RG-LRU recurrent block (Griffin / RecurrentGemma)
RWKV = "rwkv"      # RWKV-6 time-mix block (attention-free)

LAYER_KINDS = (ATTN, SWA, RGLRU, RWKV)


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters + framework knobs.

    ``layer_pattern`` is the repeating layer group; the model has
    ``n_layers / len(layer_pattern)`` groups, and layer ``l`` has kind
    ``layer_pattern[l % len(layer_pattern)]``.
    """

    name: str
    arch_type: str                       # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    layer_pattern: tuple = (ATTN,)
    sliding_window: int = 4096
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 2.0
    moe_dropless: bool = False           # capacity = n_tokens at every phase
    moe_pattern: tuple = ()              # which pattern positions use MoE
    # positional / misc
    rope_theta: float = 10_000.0
    use_rope: bool = True
    norm: str = "rmsnorm"                # rmsnorm|layernorm
    activation: str = "swiglu"           # swiglu|gelu|geglu
    tie_embeddings: bool = False
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500
    # recurrent (RG-LRU)
    rnn_width: int = 0                   # 0 -> d_model
    conv_width: int = 4
    # RWKV
    rwkv_head_size: int = 64
    # numerics
    dtype: str = "bfloat16"
    # KV-cache storage for full-attention layers: 'bfloat16' or 'int8'
    # (per-row-per-head absmax quantization)
    kv_cache_dtype: str = "bfloat16"
    remat: bool = True
    offload_carries: bool = False
    supports_long_context: bool = False
    optimizer: str = "adamw"
    source: str = ""                     # citation for the config

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        if self.n_layers % len(self.layer_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"layer_pattern of length {len(self.layer_pattern)}")
        for k in self.layer_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        if self.arch_type == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"{self.name}: moe arch needs n_experts/top_k")
        if self.is_moe and not self.moe_pattern:
            object.__setattr__(self, "moe_pattern",
                               tuple(k in (ATTN, SWA)
                                     for k in self.layer_pattern))
        if self.moe_pattern and len(self.moe_pattern) != len(self.layer_pattern):
            raise ValueError(f"{self.name}: moe_pattern length mismatch")

    # ------------------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def attention_free(self) -> bool:
        return all(k in (RGLRU, RWKV) for k in self.layer_pattern)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    # -- parameter counting (used by placement / planner / simulator) ----
    def param_count(self) -> int:
        """Total parameters (embedding + layers + head)."""
        d, f = self.d_model, self.d_ff
        emb = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        per_layer = 0
        for i, kind in enumerate(self.layer_pattern):
            moe_here = bool(self.is_moe and self.moe_pattern
                            and self.moe_pattern[i])
            per_layer += 2 * d  # two norms
            if kind in (ATTN, SWA):
                hd = self.head_dim
                per_layer += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                per_layer += self.n_heads * hd * d
                per_layer += self._ffn_params(moe_here)
            elif kind == RGLRU:
                w = self.rnn_width
                per_layer += 2 * d * w + w * d      # in (x2 branches) + out
                per_layer += self.conv_width * w + w  # temporal conv
                per_layer += 3 * w                   # a_param + gate biases
                per_layer += 2 * w * w               # gates (dense here)
                per_layer += self._ffn_params(False)
            elif kind == RWKV:
                per_layer += 5 * d * d              # r,k,v,g + out
                per_layer += d * d                  # channel-mix receptance
                per_layer += 2 * d * f              # channel mix up/down
                per_layer += 140 * d                # mus, decay lora, u, ln_x
        total = emb + head + self.n_groups * per_layer
        if self.encoder_decoder:
            hd = self.head_dim
            enc_layer = (2 * d
                         + d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                         + self.n_heads * hd * d + self._ffn_params())
            cross = (d + d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                     + self.n_heads * hd * d)
            total += self.n_encoder_layers * enc_layer + self.n_layers * cross
        return total

    def _ffn_params(self, moe: bool | None = None) -> int:
        d, f = self.d_model, self.d_ff
        dense = 3 * d * f if self.activation in ("swiglu", "geglu") else 2 * d * f
        moe = self.is_moe if moe is None else moe
        if moe:
            return self.n_experts * dense + d * self.n_experts  # + router
        return dense

    @property
    def n_moe_layers(self) -> int:
        if not self.is_moe:
            return 0
        return self.n_groups * sum(bool(b) for b in self.moe_pattern)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_ffn = 3 * d * f if self.activation in ("swiglu", "geglu") else 2 * d * f
        inactive = self.n_moe_layers * (self.n_experts - self.top_k) * dense_ffn
        return self.param_count() - inactive

    def param_bytes(self, bytes_per_param: int = 2) -> int:
        return self.param_count() * bytes_per_param

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_kind(self, layer: int) -> str:
        return self.layer_pattern[layer % len(self.layer_pattern)]

    def layer_is_moe(self, layer: int) -> bool:
        return bool(self.is_moe and
                    self.moe_pattern[layer % len(self.layer_pattern)])

    def reduced(self, d_model: int = 256, n_layers: int = 0,
                n_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """Smoke-test variant of the same family: <=2 groups, tiny dims
        (field for field what the JAX package's ``reduced`` gives)."""
        pat = self.layer_pattern
        if n_layers == 0:
            n_layers = len(pat) * min(2, self.n_groups)
        n_heads = max(2, min(4, self.n_heads))
        n_kv = 1 if self.n_kv_heads == 1 else max(1, min(2, self.n_kv_heads))
        while n_heads % n_kv:
            n_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=d_model * 3,
            vocab_size=vocab,
            n_experts=min(n_experts, self.n_experts) if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            rnn_width=d_model,
            sliding_window=min(self.sliding_window, 64),
            n_encoder_layers=min(2, self.n_encoder_layers),
            encoder_len=32 if self.encoder_decoder else self.encoder_len,
            rwkv_head_size=32,
            dtype="float32",
            remat=False,
        )


# ---------------------------------------------------------------------------
# The input shapes of the production layouts (``repro/configs/base.py:
# 227-239``; ``launch/specs.py`` and ``launch/dryrun.py`` read them)
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    phase: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# The paper's own models (Mixtral target + Mistral draft).
MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", arch_type="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    n_experts=8, top_k=2, rope_theta=1e6,
    source="arXiv:2401.04088",
)

MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b", arch_type="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, rope_theta=1e6,
    source="mistral.ai/news/mixtral-8x22b",
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b", arch_type="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=32000,
    layer_pattern=(SWA,), sliding_window=4096, rope_theta=1e4,
    source="arXiv:2310.06825",
)


def draft_for(target: ModelConfig, n_layers: int) -> ModelConfig:
    """The Mistral-7B-width draft of ``n_layers`` layers that serves beside
    ``target``: it takes the target's vocabulary and dtype."""
    return dataclasses.replace(MISTRAL_7B, n_layers=n_layers,
                               vocab_size=target.vocab_size,
                               dtype=target.dtype)


# Recurrent targets (served on the contiguous path, ``paged=False``).
RECURRENTGEMMA_2B = ModelConfig(
    name="recurrentgemma-2b", arch_type="hybrid",
    n_layers=26 + 1, d_model=2560, n_heads=10, n_kv_heads=1,
    d_ff=7680, vocab_size=256_000,
    layer_pattern=(RGLRU, RGLRU, SWA), sliding_window=2048,
    rnn_width=2560, conv_width=4,
    head_dim=256, tie_embeddings=True,
    supports_long_context=True,
    source="arXiv:2402.19427",
)
# The model card has 26 layers; the (RG-LRU, RG-LRU, SWA) pattern needs a
# multiple of 3, so the repo runs 27 (9 groups): one layer more.

RWKV6_7B = ModelConfig(
    name="rwkv6-7b", arch_type="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=14336, vocab_size=65536,
    layer_pattern=(RWKV,), rwkv_head_size=64,
    head_dim=64,  # informational; attention-free
    supports_long_context=True,
    source="arXiv:2404.05892",
)

# The rest of the assigned pool, as the JAX package configures each
# (``src/repro/configs/<name>.py``).  Where that departs from the model
# card, the port copies it and says so beside the config.

CHAMELEON_34B = ModelConfig(
    name="chameleon-34b", arch_type="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536,
    layer_pattern=(ATTN,), rope_theta=10_000.0,
    supports_long_context=False,
    source="arXiv:2405.09818",
)
# Images arrive as VQ tokens of the same vocabulary (the tokenizer is the
# stubbed frontend).  No QK-norm: the model uses one, the JAX config keeps
# the plain pre-norm GQA block.

GEMMA3_12B = ModelConfig(
    name="gemma3-12b", arch_type="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab_size=262144,
    layer_pattern=(SWA, SWA, SWA, SWA, SWA, ATTN), sliding_window=1024,
    rope_theta=1_000_000.0,
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt",
)
# Head dim 3840 // 16 = 240 where the model card has 256, and no QK-norm:
# both as in the JAX config.

LLAMA3_405B = ModelConfig(
    name="llama3-405b", arch_type="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab_size=128256,
    layer_pattern=(ATTN,), rope_theta=500_000.0,
    optimizer="adafactor", offload_carries=True,
    source="arXiv:2407.21783",
)

LLAMA4_MAVERICK = ModelConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    n_experts=128, top_k=1,
    layer_pattern=(ATTN, ATTN), moe_pattern=(False, True),
    rope_theta=500_000.0,
    optimizer="adafactor", offload_carries=True,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
# MoE layers interleave 1:1 with dense ones (24 + 24 of 48), 128 experts
# top-1; image patches arrive as tokens (frontend stubbed).

PHI35_MOE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2,
    layer_pattern=(ATTN,), rope_theta=10_000.0,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

PHI3_MEDIUM = ModelConfig(
    name="phi3-medium-14b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352,
    layer_pattern=(ATTN,), rope_theta=10_000.0,
    source="arXiv:2404.14219",
)

STARCODER2_7B = ModelConfig(
    name="starcoder2-7b", arch_type="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    layer_pattern=(ATTN,), rope_theta=1_000_000.0,
    activation="gelu", norm="layernorm",
    source="arXiv:2402.19173",
)
# Global attention where the released model has a 4096-token window, as
# in the JAX config; LayerNorm and a GELU MLP as in the model card.

WHISPER_BASE = ModelConfig(
    name="whisper-base", arch_type="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51865,
    layer_pattern=(ATTN,),
    use_rope=False, norm="layernorm", activation="gelu",
    tie_embeddings=True,
    encoder_decoder=True, n_encoder_layers=6, encoder_len=1500,
    supports_long_context=False,
    source="arXiv:2212.04356",
)
# The encoder takes precomputed (B, 1500, 512) frame embeddings (the
# mel + conv frontend is stubbed) plus sinusoids.  The decoder gets no
# position signal at all: no RoPE and nothing added in its place, as in
# the JAX package.

# The assigned pool (``--arch`` ids) and the paper's own models.
ARCHS = {
    "chameleon-34b": CHAMELEON_34B,
    "phi3.5-moe-42b-a6.6b": PHI35_MOE,
    "phi3-medium-14b": PHI3_MEDIUM,
    "recurrentgemma-2b": RECURRENTGEMMA_2B,
    "llama3-405b": LLAMA3_405B,
    "whisper-base": WHISPER_BASE,
    "llama4-maverick-400b-a17b": LLAMA4_MAVERICK,
    "gemma3-12b": GEMMA3_12B,
    "rwkv6-7b": RWKV6_7B,
    "starcoder2-7b": STARCODER2_7B,
}
PAPER_MODELS = {
    "mixtral-8x7b": MIXTRAL_8X7B,
    "mixtral-8x22b": MIXTRAL_8X22B,
    "mistral-7b": MISTRAL_7B,
}
ALL_CONFIGS = {**ARCHS, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    try:
        return ALL_CONFIGS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALL_CONFIGS)}")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default) needs
    a card: without one this raises instead of quietly running the plain
    versions on the CPU — pass ``device="cpu"`` for that.  ``"meta"``
    (shapes without data) serves ``launch/dryrun.py``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
