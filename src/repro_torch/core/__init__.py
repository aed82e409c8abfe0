"""SpecOffload core: the paper's contribution in PyTorch.

- ``spec_decode`` — draft-then-verify speculative decoding, chain and
  tree (+ Appendix A.1 acceptance model, Eq. 12 erratum corrected).
- ``interleave``  — the dual-batch Interleaved Batch Pipeline (§4.1).
- ``placement``   — Adaptive Tensor Placement across HBM/host/disk (§4.2).
- ``planner``     — ParaSpec policy planner (§4.3).
- ``offload``     — host->device weight streaming through two slots.
- ``pipeline``    — SpecOffloadEngine tying it all together (§3).
"""
from repro_torch.core.interleave import (BatchState, InterleavedPipeline,
                                         RoundOutput, fused_verify_and_draft)
from repro_torch.core.offload import OffloadedModel
from repro_torch.core.pipeline import SpecOffloadEngine
from repro_torch.core.placement import PlacementPlan, plan_placement
from repro_torch.core.planner import ParaSpecPlanner, Policy, Workload
from repro_torch.core.spec_decode import (expected_generated,
                                          greedy_acceptance,
                                          sampled_acceptance, spec_round)

__all__ = [
    "BatchState", "InterleavedPipeline", "RoundOutput",
    "fused_verify_and_draft", "OffloadedModel", "SpecOffloadEngine",
    "PlacementPlan", "plan_placement", "ParaSpecPlanner", "Policy",
    "Workload", "expected_generated", "greedy_acceptance",
    "sampled_acceptance", "spec_round",
]
