"""Model configuration for the PyTorch port.

A copy of the JAX package's ``repro.configs.base`` (the port imports
nothing of that package): the frozen :class:`ModelConfig`, the layer
kinds, the parameter counts the planner, placement and simulator read,
and the configurations the serving paths run — the Mixtral 8x7B
target and the Mistral 7B draft, and the RecurrentGemma-2B and RWKV-6
7B targets of the contiguous path — plus Mixtral 8x22B, which the
simulator's paper figures use.  ``reduced()`` gives the same
smoke-size variants, so a test can build one config for both packages
from the same fields.
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

CONFIGS = {c.name: c for c in (MIXTRAL_8X7B, MIXTRAL_8X22B, MISTRAL_7B,
                               RECURRENTGEMMA_2B, RWKV6_7B)}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(CONFIGS)}")
    return CONFIGS[name]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default) needs
    a card: without one this raises instead of quietly running the plain
    versions on the CPU — pass ``device="cpu"`` for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
