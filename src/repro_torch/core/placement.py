"""Adaptive Tensor Placement (paper §4.2).

Assigns every tensor of the (target, draft) model pair to a memory tier —
``hbm`` (accelerator), ``host`` (CPU DRAM, the streaming source), ``disk``
— by the paper's priority order:

  1. the *working set* of the streamed target execution: current + next
     layer-group slabs (double-buffered prefetch placeholders);
  2. the draft model and its KV cache (resident in HBM — the paper's
     "low-yield memory repurposing" insight);
  3. extra pinned target tensors, highest-reuse first (embeddings, norms,
     then layer slabs round-robin) while HBM headroom remains;
  4. everything else to host memory; overflow beyond host capacity to disk.

The result is a :class:`PlacementPlan` whose ``target/stream_slot0/1``
entries are the two device slots :class:`repro_torch.core.offload.
OffloadedModel` streams the target's layers through, and which the
simulator charges each tier's bandwidth for.  A copy of
``repro/core/placement.py``: the same entries and notes.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.configs import ModelConfig
from repro_torch.core.planner import kv_bytes_per_token, layer_ffn_bytes
from repro_torch.sim.hardware import HardwareSpec

TIERS = ("hbm", "host", "disk")


@dataclass
class TensorEntry:
    name: str               # e.g. "target/layer03/ffn", "draft/params"
    bytes: int
    tier: str
    pinned: bool = False    # stays resident (not streamed)
    prefetch_slot: bool = False


@dataclass
class PlacementPlan:
    entries: list
    hbm_used: int
    host_used: int
    disk_used: int
    hbm_capacity: int
    host_capacity: int
    notes: list = field(default_factory=list)

    def tier_of(self, name: str) -> str:
        for e in self.entries:
            if e.name == name:
                return e.tier
        raise KeyError(name)

    def bytes_in(self, tier: str) -> int:
        return sum(e.bytes for e in self.entries if e.tier == tier)

    def streamed_bytes_per_token_step(self) -> int:
        """Bytes that must cross host->HBM per decode step (non-pinned
        target layer slabs)."""
        return sum(e.bytes for e in self.entries
                   if e.name.startswith("target/layer") and not e.pinned
                   and e.tier != "hbm")


def plan_placement(target: ModelConfig, draft: ModelConfig | None,
                   hw: HardwareSpec, *,
                   draft_batch: int = 8, draft_ctx: int = 2048,
                   bytes_per_param: int = 2,
                   reserve_activations: float = 0.10) -> PlacementPlan:
    """Build the placement plan for decode-phase SpecOffload."""
    bp = bytes_per_param
    hbm_cap = int(hw.accel_mem_bytes * (1 - reserve_activations))
    host_cap = int(hw.host_mem_bytes)
    entries: list[TensorEntry] = []
    notes: list[str] = []
    hbm = host = disk = 0

    def place(name, nbytes, want_hbm, pinned=False, prefetch=False):
        nonlocal hbm, host, disk
        nbytes = int(nbytes)
        if want_hbm and hbm + nbytes <= hbm_cap:
            entries.append(TensorEntry(name, nbytes, "hbm", pinned, prefetch))
            hbm += nbytes
            return "hbm"
        if host + nbytes <= host_cap:
            entries.append(TensorEntry(name, nbytes, "host", pinned))
            host += nbytes
            return "host"
        entries.append(TensorEntry(name, nbytes, "disk", pinned))
        disk += nbytes
        return "disk"

    # --- priority 1: streamed working set (double buffer of largest slab)
    slab = layer_ffn_bytes(target, bp)
    place("target/stream_slot0", slab, True, prefetch=True)
    place("target/stream_slot1", slab, True, prefetch=True)

    # --- priority 2: draft model + its KV (the paper's key move)
    if draft is not None:
        t = place("draft/params", draft.param_bytes(bp), True, pinned=True)
        if t != "hbm":
            notes.append("draft did not fit HBM -> speculative decoding "
                         "disabled (falls back to plain offloading)")
        kv = draft_batch * draft_ctx * kv_bytes_per_token(draft, bp)
        place("draft/kv_cache", kv, True, pinned=True)

    # --- priority 3: pin extra target tensors, embeddings first
    emb = target.vocab_size * target.d_model * bp
    place("target/embedding", emb, True, pinned=True)
    attn_bytes = _attn_layer_bytes(target, bp)
    for i in range(target.n_layers):
        place(f"target/layer{i:03d}/attn", attn_bytes, True, pinned=True)
    for i in range(target.n_layers):
        place(f"target/layer{i:03d}/ffn", layer_ffn_bytes(target, bp), True,
              pinned=True)

    # --- target KV cache lives with the host attention compute
    notes.append("target KV cache placed on host (attention computed "
                 "host-side per paper §4.1.2)")

    if disk:
        notes.append(f"{disk/2**30:.1f} GiB overflow to disk "
                     f"(paper §5.5 disk mode)")

    return PlacementPlan(entries, hbm, host, disk, hbm_cap, host_cap, notes)


def _attn_layer_bytes(cfg: ModelConfig, bp: int) -> int:
    hd = cfg.head_dim
    return (cfg.d_model * cfg.n_heads * hd
            + 2 * cfg.d_model * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * cfg.d_model + 2 * cfg.d_model) * bp


def hbm_pinned_fraction(plan: PlacementPlan) -> float:
    """Fraction of target layer params resident in HBM (Fig 2 x-axis)."""
    tot = pin = 0
    for e in plan.entries:
        if e.name.startswith("target/layer"):
            tot += e.bytes
            if e.tier == "hbm":
                pin += e.bytes
    return pin / max(tot, 1)
