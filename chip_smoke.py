#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py
    python3 chip_smoke.py --eq-readings   # 5t-eq-k's limit readings only
    python3 chip_smoke.py --trace-check   # run 3g-tr alone

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; imports nothing of JAX.  Phases, each printed
on its own lines with its wall seconds:

1. environment: the card's name and power limit, torch/CUDA versions,
   the kernels' build time (every ``csrc/*.cu``, one nvcc each, in
   parallel), and what ``-Xptxas -v`` said of the tensor-core kernels,
   the verify kernels and the recurrences' kernels (registers, static
   shared memory, spills per instantiation; the head dim 240
   instantiations again on a line of their own); the host's MemTotal /
   MemAvailable, RLIMIT_MEMLOCK and CPUs, the bare page-locked
   host<->device copy rate of one 2.7 GiB buffer each way, a timed f32
   CPU matmul (the H100 spec's ``h2d_bw`` / ``d2h_bw`` / ``host_flops``
   in ``repro_torch/sim/hardware.py``), and ``repro_torch.launch.serve
   --plan --env h100`` for Mixtral-8x7B / Mistral-7B at prompt 512, gen
   64;
2. every kernel against its plain PyTorch version on the card at the
   cases of tests/test_kernels.py, the serving paths' shapes and a
   stress shape each, plus the edges of the tensor-core kernels (flash
   at 100 tokens, windowed and bidirectional at head dims 64/128/240/256
   and fed (B, S, H, d) views; ``moe_ffn`` at C 1, 7, 33 and 300 at Mixtral
   widths, at the tree verify's dispatch, C 40 in bf16 for 3e and
   C 20 in f32 for 4e/4f, and at 3f's C 513 and C 2) and of the split-KV
   verify kernels (``decode_attention`` also at 3f's B 2, m 1; the grid,
   n_split and CTA count printed for the serve and stress shapes;
   lengths 1, 6, 63, 64 and 65 in a 32768-token capacity, where nearly
   every split is empty;
   a 64-key tile boundary inside the last m positions, in f32, bf16,
   int8 and a tree; a sliding window; m = 1; q and the output as
   (B, S, H, d) views; the serve-shape call made twice and replayed
   twice from a CUDA graph of the call, every output required to be
   bitwise equal (the graph's split-KV counters zero at each replay);
   speculation trees at the serve shape,
   ``anc_bits`` of tree (3, 2) at m 10 and of (2, 2, 2, 2) at m 31, in
   f32 and bf16, each also with a 64-key tile boundary inside the last m
   rows, with ``scaled_dot_product_attention`` under the equivalent
   boolean mask as the library yardstick; ``decode_attention`` with a
   key offset and its log-sum-exp at one rank's block of Gemma-3-12B's
   and Llama-3-405B's ``decode_32k`` caches on the pod, ``DECODE_OFFSET``,
   a slice before, across and past the sequences' length, bf16 and f32,
   and a tree buffer half outside its slice; offset 0 with the lse
   bitwise the call without them) and of the recurrences (``wkv6`` with
   the model's decay range, w = exp(-exp(U[-8, 4])) with channels at
   w == 0 and w = 1 - 1e-7, at the verify, prefill and stress shapes, at
   ragged lengths 100 and 1000 and at head size 128; the RG-LRU with its
   gates fused in at the verify, prefill and stress shapes, x in bf16
   and f32, widths 100 and 102), each ``flash_attention`` and
   ``moe_ffn`` line naming the path that ran (tensor-core bf16 or exact
   f32) and each recurrence line its route (serial, chunked or
   parallel): max error against the tolerance (attention and the FFN
   f32 2e-5 with TF32 off, bf16 2e-2; ``rglru_scan`` 1e-5; ``wkv6`` 2e-4,
   against its plain version evaluated in f64), kernel time (CUDA
   events, L2 flushed before each launch), its bound on this card and
   what sets it, the plain
   version's time and one library call's time as a yardstick where one
   PyTorch call computes the same function;
3. serve, bf16, weights from a seed, ``max_batch=4``, ``n_cand=4``,
   Poisson requests (prompt 512, gen 32-64), every kernel's launch count
   read around each run (a graph's replays count the launches its
   capture recorded), the rounds as the pipeline's CUDA graphs: every
   serve and lossless run prints its ``graph_captures`` and capture wall
   and must have captured the round; (a) paged, Mixtral-8x7B /
   Mistral-7B widths, ``SERVE_LAYERS`` (2) layers each, 12 requests,
   then (a-e) the same requests on the eager round (``graphs=False``),
   every stream equal to (a)'s, the round times side by side; (b) contiguous
   (``paged=False``),
   RWKV-6-7B at full width, 8 of its 32 layers
   (``RECURRENT_SERVE_LAYERS``), with a 2-layer
   Mistral-7B-width draft, 8 requests; (c) contiguous,
   RecurrentGemma-2B at full width, 9 of its 27 layers, the same kind
   of draft, 8 requests (the RG-LRU through its fused entry, never the
   bare scan); (d) contiguous, the widths of (a), 8 requests; (e) paged
   tree speculation, tree (3, 2), the widths of (a) with the draft made
   all-attention, 8 requests: one fused shape signature, every verify
   round through ``paged_decode_attention`` with ``anc_bits`` (those
   launches counted apart from the causal ones), and the histogram of
   accepted path lengths; and, run first, while the host's memory is
   untouched: (f) Mixtral-8x7B at its full width, 8 of its 32 layers
   (``OFFLOAD_LAYERS``; 21.6 GiB in bf16), drawn from seed 0 layer by
   layer into page-locked
   host memory, B 2 prompts of 512 tokens prefilled and 8 greedy decode
   + commit steps, every pass streamed through two device slots: per
   pass its wall, link seconds and bytes (and GB/s beside phase 1's bare
   rate), the compute stream's span over the layers (copy landed to
   the layer's last kernel, host dispatch waits included) and the rest
   of the wall as its idle share, peak device memory (held under
   resident + 3 layers + KV + 2 GiB) and launches
   (``flash_attention`` and ``moe_ffn`` one a layer in the prefill,
   ``decode_attention`` and ``moe_ffn`` one a layer a step, no paged
   launch), and
   the planner's per-layer stream time for the H100 spec beside the
   measured one, and one more decode step under ``torch.profiler`` for
   the device's own kernel time in a pass; (f-eq) the same tier at
   Mixtral-8x7B widths and 3 layers (more than its 2 device slots): the
   weights drawn layer by layer equal ``init_params``'s, the streamed
   prefill and 8 greedy decode steps give the resident model's logits
   bit for bit, and ``host_attention_direct`` over host KV agrees with
   the plain attention on the card within 1e-6 (f32); then (g) the
   asyncio front door at (a)'s widths on the real clock with QoS,
   preemption, metrics, request timelines and a TTFT objective
   (``hw=H100``): tenant "batch" (priority 1, 12 requests, prompt 512,
   gen 64, all at t = 0) and tenant "interactive" (priority 0, 4
   requests, prompt 512, gen 32, Poisson 4/s from t = 1 s), replayed
   open loop at speed 1 through ``AsyncServingServer(max_queue=16)``:
   per-tenant TTFT and end-to-end latency, preemptions, rejections, SLO
   violations, flight-recorder triggers; every stream exactly
   ``max_new_tokens`` and equal to the request's result, at least one
   preemption, ``pipeline_traces_total{entry="fused"} == 1`` through the
   registry, the metrics snapshot, Prometheus text and timelines valid;
   (g-tr) (a)'s trace again with the span tracer on (device spans timed
   by marks, never a synchronisation) and entering ``record_function``
   ranges: tok/s beside (a)'s, steady rounds in ABBA windows against an
   untraced engine on the same weights (the marks' cost on one host),
   the bubble report (``gpu_busy_frac``, ``mean_round_busy_frac``,
   stall, idle, rounds), span seconds per track, the round graphs' node
   counts, the Chrome trace validated, then 5 steady rounds timed and 5
   under ``torch.profiler`` (the ranges ``target_verify/verify(fused)``,
   ``rollback/rollback``, ``launch/fused`` and ``launch/rollback``
   required): the device's kernel time over the rounds' wall beside the
   report's busy fraction of the same rounds, and the tracer's clock
   against the profiler's (:func:`clock_check`: every device span's two
   ends against the profiler's start of the mark kernels that timed
   them, target 20 us; every host span's start against its
   ``record_function`` range, target 50 us); ``--trace-check`` runs
   (g-tr) alone;
4. lossless, f32, ``max_batch=2``, 6 requests with mid-flight
   admission, every stream equal to the port's own target-only greedy
   decode: Mixtral / Mistral widths (2 layers) paged and contiguous,
   RWKV-6 widths (2 layers), RecurrentGemma widths (3 layers, one
   group); then tree (3, 2) at Mixtral widths (2 layers), paged (e) and
   contiguous (f), the draft being the target's configuration with the
   target's weights plus seeded noise (``DRAFT_NOISE`` times each
   tensor's standard deviation), so that rounds accept part of the path
   as well as all of it (both are required); and (g) sampled
   acceptance: ``sampled_acceptance`` and ``tree_sampled_acceptance``
   on the card against the same call on the CPU with the same f32
   logits and noise (the tokens must be equal), and a Leviathan check
   (vocabulary 8, fixed draft and target logits, 2^18 rows, drafts
   sampled from the draft): the first emitted token's frequencies must
   lie within 5 standard errors of the target's softmax; (h) lossless
   preemption: the widths of (a), paged, ``max_batch=2``, QoS and
   preemption on the virtual clock, 4 priority-1 requests, then after
   round 3 of a ``run_step()`` drive 2 priority-0 requests: at least one
   preemption, and every stream (the resumed ones too) equal to the
   greedy decode; (i) recurrent drafts at the target's vocabulary
   (RecurrentGemma-2B widths, 3 layers; RWKV-6-7B widths, 2 layers)
   beside the 2-layer Mixtral target, paged and contiguous, 6 requests
   each: every stream equal to the greedy decode, ``rglru_gated_scan``
   or ``wkv6`` and the run's verify kernel launched while serving;
   (j) the other families in f32: Gemma-3-12B's widths at one group (6
   layers) with prompts of 1280, paged and contiguous (``decode_attention``
   at head dim 240), StarCoder2-7B and Phi-3.5-MoE widths at 2 layers,
   every stream equal to the greedy decode; and Whisper-base, whose
   ``decode_step`` tokens must equal a prefill recomputed at every step;
5. training, the launches of each run read around it: (t) Gemma-3-12B
   at its published widths, depth cut to one group (6 layers: 5 of
   window 1024 + 1 global, head dim 240), bf16, ``remat`` as in its
   config, AdamW at lr 3e-4, 5 steps of ``train_loop`` over
   ``make_lm_batches`` at B 2 x S 4096: per step loss, gradient norm and
   wall, tokens/s after the first step, peak memory, launches a step (6
   forward + 6 recomputed ``flash_attention``, 6 ``flash_attention_bwd``,
   required exactly), finite losses and norms, no plain attention, then
   one more step under ``torch.profiler``: the device's kernel time by
   group (``launch/profile_serve.py``'s: the backward and forward flash
   kernels, cuBLAS, the rest) and its idle share against the untraced
   steps' wall;
   (t-eq) the same widths in f32, B 1 x 1281 tokens: loss and every
   gradient leaf on the card against the same step on the CPU (plain
   versions, same weights); (t-m) Mixtral-8x7B at published widths cut
   to 3 layers, B 1 x 4096, (t-r) RecurrentGemma-2B whole (27 layers), B
   2 x 4096, (t-k) RWKV-6-7B cut to 8 layers, B 2 x 4096, each bf16 with
   remat and AdamW as configured, 4 steps and a profiled one, launches a
   step required exactly as reckoned from the layer pattern and remat's
   recompute (``_expected_launches``; the expert FFN's ``moe_ffn`` once
   a run of its group and ``moe_ffn_bwd`` once a step), the profiled
   step showing its backward kernels' groups; (t-eq-m / -r / -k) those
   widths in f32 at a few layers, B 2 x 257, card against CPU as 5t-eq
   (5t-eq-k at its own fixed gradient limit, ``TRAIN_EQ_GRAD_TOL``, whose
   readings ``--eq-readings`` prints), Mixtral's experts and drop slots
   first required equal on both devices token by token;
   (t-w) Whisper-base whole (6 + 6 layers, B 4 x 1500 frames, 448
   tokens), 3 steps: bidirectional, causal and cross attention through
   the backward kernel; (t-l) ``python -m repro_torch.launch.train`` at
   its defaults, and with ``--arch`` mixtral-8x7b, recurrentgemma-2b and
   rwkv6-7b, each of which must print ``LEARNED``.  Phase 2 also holds
   the recurrences' backward kernels against their plain versions in f64
   (``wkv6_bwd`` at 5t-k's shape with the device time of each of its
   launches, head size 128, ragged S and one step;
   ``rglru_gated_scan_bwd`` at 5t-r's shape in bf16 and f32, an odd
   S, B 8 x S 4096, B 1 x S 16384, S a multiple of the chunk and one
   step past it, partial slabs, widths 100 and 102 (the sequence
   route), one step; each output within
   ``TOL_BWD`` of its largest magnitude, each printing each output's
   err/max, the main cases bitwise equal twice with the device time of
   each launch; ``wkv6_bwd`` at head size 64 with 32-column slabs and
   whole heads, B x H 32 to 128, timed side by side: the readings behind
   ``bwd_slab``), the expert
   FFN's backward kernels (``moe_ffn_bwd`` at 5t-m's shape in bf16,
   twice, with the device time of each of its launches and the library
   yardstick ``moe_bwd_library``, seven ``bmm`` and a ``baddbmm``;
   5t-eq-m's in f32; ragged, gelu and one-token cases), and the
   forward's log-sum-exp against
   the plain one in every flash case and the backward kernel against
   ``flash_attention_bwd_ref`` (Gemma-3 S 4096 window and global, the
   f32 5t-eq shapes, Mistral widths, RecurrentGemma-2B's d 256 MQA (g
   10) under a window of 2048 at S 4096, Whisper's encoder, decoder and
   cross attention, head dim 32, partial tiles at S 100, Sq != Skv), the
   library yardstick being the backward of
   ``scaled_dot_product_attention``; both flash kernels with a query
   offset (``FLASH_OFFSET``: a context-parallel rank's 1024 queries at
   offsets 1024 and 3072 over 4096 keys, global and window 1024, head
   dims 128, 240 and 256, bf16, and two f32 cases), and ``q_offset=0``
   bitwise equal to the call without it;
6. (a) the four ``examples/torch_*.py`` in this process on the card at
   their defaults, through their ``main``: each one's printed lines, wall
   and launches (the quickstart must launch ``flash_attention`` and
   ``decode_attention`` and print its ``lossless ... [OK]`` line, the
   serving example ``flash_attention``, ``paged_decode_attention`` and
   ``moe_ffn`` and ``fused compiles=1``, the training example
   ``flash_attention`` and ``flash_attention_bwd`` over 200 steps and
   ``training OK``, the planner demo nothing), no kernel's plain
   version; (b) the MoE layer's mesh modes at Mixtral-8x7B's widths (E
   8, D 4096, F 14336, top-2), each rank a process of a gloo group on
   this card: ``ep`` on a (1, 2) mesh at B 1 x S 512 and ``tp`` on (1,
   7) in f32 and bf16, ``ep_psum`` on (1, 2) at B 4 x S 1 in f32, each
   against the single-process layer on the same weights (f32 within
   ``TOL_MESH`` of the output's largest magnitude, bf16 to ``TOL``),
   each rank launching ``moe_ffn`` in ``ep`` and ``tp``; (c) prefill
   (``ep``) and 8 greedy ``decode_step``s (``ep_psum``) of Mixtral-8x7B's
   widths at 2 layers, f32, dropless, on the (1, 2) mesh, each rank
   holding its ``shard_model`` blocks (every layer over the mesh: 16 of
   the 32 heads a rank): logits within ``TOL_MESH_LOGITS`` of their
   largest magnitude and greedy tokens equal to the single process's,
   the walls printed beside each other; (d) the main path on the (1, 2)
   mesh: ``SpecOffloadEngine(mesh=).generate`` with Mixtral-8x7B
   (dropless) and a Mistral-7B draft at full width, 2 layers each, f32,
   4 prompts of 128
   tokens, 16 generated each at ``n_cand`` 4 (``MESH_ENGINE``): every
   rank's streams equal to the one-process engine's, one fused shape
   signature, each rank's ``decode_attention``, ``flash_attention`` and
   ``moe_ffn`` launches (16 of 32 heads, 4 of 8 experts) required and
   printed, the generate walls for the record only; (e) one AdamW step
   of Mixtral-8x7B's widths at 1 layer, f32, dropless, B 2 x 256
   (``MESH_TRAIN``) on (1, 2) (tensor parallel and ``ep``) and (2, 1)
   (FSDP, the batch split): each rank also runs the same step in one
   process and keeps its blocks of the result; the loss within
   ``TOL_MESH_LOSS`` and every block under the first-step rule (within
   1e-6 where the gradient's magnitude passes 1e-4, within 2 lr
   anywhere), ``flash_attention_bwd`` and ``moe_ffn_bwd`` launched on
   every rank, its peak memory printed; (f) / (g) sequence parallelism
   under the default profile on one (1, 2) spawn (``MESH_SEQ``):
   RecurrentGemma-2B at full width, 3 layers (context-parallel attention,
   the RG-LRU on 1280 channels a rank) and RWKV-6-7B at full width, 2
   layers (32 heads a rank), f32, B 2 x S 512: prefill and 8 greedy
   steps against one process (as (c)), one AdamW step against one
   process (as (e)), the launches each rank must make (6f:
   ``flash_attention`` -- with a nonzero ``q_offset`` on rank 1, whose
   block of the queries starts at 256 --, ``flash_attention_bwd``,
   ``rglru_gated_scan``, ``rglru_gated_scan_bwd``; 6g: ``wkv6``,
   ``wkv6_bwd``), and the bytes a rank holds when the step starts, which
   must equal the dry run's argument bytes for the same step and mesh
   (``launch/dryrun.py`` in a process of its own), the two peaks
   printed side by side; (h) / (i) decode caches in the production
   layout on one (2, 2) spawn (``MESH_LAYOUT``): each rank holds its
   rows of the batch and its slice of the slots, every kv head, and the
   verify kernel's partials (``decode_attention`` with ``kv_offset`` and
   ``return_lse``, its ``partial`` route) merge by log-sum-exp;
   Gemma-3-12B at full width, 6 layers (five windowed, one global), B 2,
   4096 slots, a 2044-token prompt and 8 greedy steps across slot 2048,
   and Whisper-base whole (its encoder on its blocks): logits and tokens
   against one process, the ``partial`` launches (one a global layer a
   step), and the bytes a rank holds when the decode starts against the
   dry run of the decode step on the same mesh;
7. the kernels as one JSON object; 8. the device as one JSON object.

The families' cases of phase 2: flash at head dim 240 (Gemma-3-12B's 16
/ 8 heads: 256-wide tiles, zero columns past 240) causal at s512 in bf16
and f32, windowed 1024 at s1280 and global at s1280, beside d 256 at
s512; Whisper's bidirectional encoder attention (B 4, T 1500, d 64) and
its cross attention (Sq 1 and 5 over Skv 1500; f32 for 4j); paged and
contiguous verify at head dim 240 (B 4, Hq 16, Hkv 8, m 5, ~560 and
~1300 tokens; bf16, f32 and an int8 pool; a tree; a tile boundary), at
StarCoder2's 36 / 4 (45 rows) and Llama-3-405B's 128 / 8 heads (80
rows), and Llama-3-405B under tree (3, 2), 160 rows in two row groups
(bitwise equal twice); ``moe_ffn`` at Phi-3.5-MoE (E 16, F 6400) and
Llama-4 Maverick (E 128, D 5120, F 8192) widths at verify C 20 and at a
512-token prompt's prefill capacity.  Phase 3 ends with (h) Gemma-3-12B
at full width, 12 of its 48 layers (``GEMMA_SERVE_LAYERS``: 10
sliding-window and 2 global) beside a 2-layer
Mistral-7B-width draft, paged chain, 8 requests with prompts of 512 and
1280 in turn (the 1024-token window binds, the rings wrap), every target
flash and paged verify launch at head dim 240; (i) Chameleon-34B,
Phi-3-medium-14B, StarCoder2-7B, Llama-3-405B, Phi-3.5-MoE and Llama-4
Maverick at their published widths, each cut to 2 layers (Llama-4: one
dense + MoE group), 4 requests each of prompt 512 and gen 32; (j)
Whisper-base at full size, B 4 frame embeddings: the encoder alone,
a prefill of 4 tokens and 32 greedy ``decode_step``s, with their walls
and launches.

Any failure raises and exits non-zero; so does a machine with no card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_RGLRU, TOL_WKV6 = 1e-5, 2e-4      # tests/test_kernels.py:153,169-171
TREE = (3, 2)                         # the served speculation tree
DRAFT_NOISE = 0.05                    # 4e/4f: the draft's weight noise
# 3a / 3d / 3e / 3g / 3g-tr: Mixtral-8x7B and its Mistral-7B-width draft
# at 2 layers each (cut from 4 to pay for phase 6's mesh runs)
SERVE_LAYERS = 2
# 3b / 3c: RWKV-6-7B and RecurrentGemma-2B at 8 of 32 and 9 (three
# groups of the pattern) of 27 layers (whole models until PR 25, 16 / 15
# to pay for 6d / 6e, 8 / 9 to pay for 6f / 6g)
RECURRENT_SERVE_LAYERS = (8, 9)
# 3f: Mixtral-8x7B streamed from host memory at a depth fixed here (never
# chosen at run time): 8 of its 32 layers, cut from 32 to 16 to pay for
# phase 6's mesh runs (6d, 6e) and to 8 for 6f / 6g, B 2 prompts of 512
# tokens, 8 decode steps
OFFLOAD_LAYERS, OFFLOAD_B, OFFLOAD_PROMPT, OFFLOAD_STEPS = 8, 2, 512, 8
OFFLOAD_MAX_LEN = OFFLOAD_PROMPT + OFFLOAD_STEPS + 8   # + the traced step
# 3f-eq: more layers than the 2 slots (cut from 4, the same cut)
OFFLOAD_EQ_LAYERS = 3
COPY_BYTES = int(2.7 * 2**30)         # phase 1's bare copy: one layer's size
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:297",
    "flash_attention": "src/repro/kernels/flash_attention.py:111",
    "moe_ffn": "src/repro/kernels/moe_ffn.py:68",
    "decode_attention": "src/repro/kernels/decode_attention.py:129",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:49",
    "wkv6": "src/repro/kernels/wkv6.py:57",
    # no pallas_call: the custom VJP's backward rule of the JAX flash
    # attention, which the training path runs
    "flash_attention_bwd": "src/repro/models/attention.py:231",
    # the TPU kernel rglru_scan with the gates of models/rglru.py:97-103
    "rglru_gated_scan": "src/repro/kernels/rglru_scan.py:49",
    # no pallas_call: the JAX package's autodiff through its checkpointed
    # WKV scan and through its RG-LRU scan, which training runs
    "wkv6_bwd": "src/repro/models/rwkv.py:145",
    "rglru_gated_scan_bwd": "src/repro/models/rglru.py:88",
    # no pallas_call: the JAX package's autodiff through its three expert
    # einsums (in every phase), which training runs
    "moe_ffn_bwd": "src/repro/models/moe.py:160",
}
# the training run whose launches each training-path kernel reports, and
# its source
TRAIN_PATH = {"flash_attention_bwd": ("5t", "flash_attention_bwd"),
              "rglru_gated_scan": ("5t-r", "rglru_scan"),
              "wkv6_bwd": ("5t-k", "wkv6_bwd"),
              "rglru_gated_scan_bwd": ("5t-r", "rglru_scan_bwd"),
              "moe_ffn_bwd": ("5t-m", "moe_ffn_bwd")}
# the serving run whose launches each kernel reports (its path)
PATH_RUN = {"paged_decode_attention": "3a", "flash_attention": "3a",
            "moe_ffn": "3a", "decode_attention": "3a", "rglru_scan": "3c",
            "wkv6": "3b"}
# the wrapper whose launches a kernel reports, where the path calls
# another entry of the kernel's source than the TPU kernel's counterpart
PATH_ENTRY = {"rglru_scan": "rglru_gated_scan"}
RUN_STATS: dict = {}                  # serve run label -> its stats()
RUN_STREAMS: dict = {}                # serve run label -> {rid: tokens}
# 3g: the interactive tenant's TTFT objective (seconds)
SLO_TTFT_INTERACTIVE = 0.25


def _bound(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Bench:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch (the serving path finds its KV and weights cold).  The card is
    first held busy while the host queues every launch, so the events
    time the device's work, not the host's dispatch."""

    HOLD_CYCLES = 40_000_000       # ~20 ms at the H100's ~2 GHz SM clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")

    def ms(self, fn, budget_ms: float = 150.0, max_iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        est = 1e3 * (time.perf_counter() - t0)
        iters = int(max(1, min(max_iters, budget_ms / max(est, 1e-3))))
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(self.HOLD_CYCLES)
        for s, e in ev:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))


def _graph_outputs(call, replays: int = 2) -> list:
    """``call()``'s output from ``replays`` replays of a CUDA graph
    captured over it (the pipeline's ``RoundGraph``): the split-KV
    counters the graph holds must be zero at every replay."""
    import torch

    from repro_torch.core.interleave import RoundGraph
    box = {}
    graph = RoundGraph(lambda: box.update(out=call()))
    outs = []
    for _ in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(box["out"].clone())
    return outs


def _check(name, case, got, want, dtype, tol=None):
    import torch
    tol = TOL[dtype] if tol is None else tol
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    bad = int(torch.isnan(got.float()).sum())
    max_err = float(err.max())
    if not ok or bad:
        raise AssertionError(f"{name} {case}: kernel disagrees with its plain "
                             f"version (max abs err {max_err:.3e}, tol {tol}, "
                             f"{bad} NaN)")
    return max_err


def _report(name, case, dtype, max_err, ms, bound, plain_ms, lib_ms,
            path=""):
    bound_ms, bound_by = bound
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    path = f" [{path}]" if path else ""
    print(f"  {name:<23} {case:<34} {dtype:<8} err={max_err:.2e} "
          f"kernel={ms:.4f}ms bound={bound_ms:.4f}ms({bound_by}) "
          f"plain={plain_ms:.4f}ms library={lib}ms{path}", flush=True)


def _tc_path(dt) -> str:
    """Which kernel of flash_attention / moe_ffn a dtype runs."""
    return "tensor-core bf16" if str(dt).endswith("bfloat16") else "exact f32"


# ---------------------------------------------------------------------------
# phase 1: the host beside the card


def _meminfo() -> dict:
    with open("/proc/meminfo") as f:
        return {k: int(v.split()[0]) * 1024 for k, v in
                (line.split(":", 1) for line in f)}


def host_phase(torch) -> dict:
    """Print the host's memory, lock limit and cores, the bare copy rate
    over the link both ways (one ``COPY_BYTES`` page-locked buffer, CUDA
    events), a timed f32 CPU matmul, and the planner's ``--plan`` for
    the H100 spec.  Returns {"h2d": bytes/s, "d2h": bytes/s}."""
    import resource

    from repro_torch.core.offload import PinnedBuffer
    mem = _meminfo()
    soft, hard = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    lim = lambda x: "unlimited" if x == resource.RLIM_INFINITY else str(x)
    print(f"  host: MemTotal {mem['MemTotal']} B "
          f"({mem['MemTotal'] / 2**30:.2f} GiB), MemAvailable "
          f"{mem['MemAvailable']} B ({mem['MemAvailable'] / 2**30:.2f} GiB), "
          f"RLIMIT_MEMLOCK soft "
          f"{lim(soft)} hard {lim(hard)}, {os.cpu_count()} CPUs; card "
          f"total_memory {torch.cuda.get_device_properties(0).total_memory} B",
          flush=True)
    buf = PinnedBuffer(COPY_BYTES)
    dev = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    rates = {}
    for tier, dst, src in (("h2d", dev, buf.tensor), ("d2h", buf.tensor, dev)):
        secs = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            dst.copy_(src, non_blocking=True)
            ev[1].record()
            ev[1].synchronize()
            secs.append(ev[0].elapsed_time(ev[1]) / 1e3)
        rates[tier] = COPY_BYTES / float(np.median(secs))
        print(f"  bare {tier} copy of {COPY_BYTES} B (page-locked host): "
              f"median {float(np.median(secs)):.4f}s of 5 = "
              f"{rates[tier] / 1e9:.3f} GB/s (min {min(secs):.4f}s, max "
              f"{max(secs):.4f}s)", flush=True)
    del dev
    buf.close()
    n = 4096
    a = torch.randn((n, n), generator=torch.Generator().manual_seed(0))
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        a @ a
        secs.append(time.perf_counter() - t0)
    print(f"  host f32 matmul {n}^3 on {torch.get_num_threads()} threads: "
          f"best {min(secs):.4f}s of 3 = {2 * n**3 / min(secs) / 1e12:.4f} "
          f"TFLOP/s", flush=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    plan = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--plan", "--env",
         "h100", "--arch", "mixtral-8x7b", "--prompt-len", "512", "--gen",
         "64"], env=env, capture_output=True, text=True, check=True)
    print("  serve --plan --env h100 (mixtral-8x7b / mistral-7b, prompt 512, "
          "gen 64):")
    for line in plan.stdout.strip().splitlines():
        print("    " + line, flush=True)
    return rates


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions

# the verify kernels' tree cases at the serve shape: (branching, m, lengths
# putting a 64-key tile boundary inside the last m rows of every sequence)
TREE_CASES = (((3, 2), 10, [130, 70, 200, 260]),
              ((2, 2, 2, 2), 31, [150, 80, 210, 270]))


def tree_bits(branching) -> list:
    """The int32 ancestor bitmasks of a speculation tree's buffer."""
    from repro_torch.core.spec_decode import tree_layout
    return tree_layout(branching)["anc_bits"].tolist()


def kernel_cases(bench) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_ffn as mf
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt=torch.float32: torch.randn(
        s, generator=gen, device=dev).to(dt)
    main = {}

    # -- flash attention ---------------------------------------------------
    def flash_case(label, b, hq, hkv, sq, d, causal, window, dt,
                   model_layout=False, skv=None):
        """With ``model_layout`` q/k/v are made (B, S, H, d), as the model
        keeps them, and handed over as transposed views; ``skv`` keys
        (default Sq) as in cross attention."""
        dname = str(dt).split(".")[1]
        skv = sq if skv is None else skv
        if model_layout:
            q, k, v = (rn(b, s_, h, d, dt=dt).transpose(1, 2)
                       for h, s_ in ((hq, sq), (hkv, skv), (hkv, skv)))
        else:
            q, k, v = rn(b, hq, sq, d, dt=dt), rn(b, hkv, skv, d, dt=dt), \
                rn(b, hkv, skv, d, dt=dt)
        kw = dict(causal=causal, window=window)
        got, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                 **kw)
        torch.cuda.synchronize()
        err = _check("flash_attention", label, got, want, dname)
        # the log-sum-exp the backward reads, f32 whatever the inputs
        _check("flash_attention lse", label, lse, want_lse, "float32")
        qp = np.arange(sq)[:, None]
        kp = np.arange(skv)[None, :]
        okm = np.ones((sq, skv), bool)
        if causal:
            okm &= kp <= qp
        if window is not None:
            okm &= kp > qp - window
        pairs = int(okm.sum())
        bound = _bound(_nbytes(q, k, v, got), 4.0 * b * hq * d * pairs, dname)
        ke = k.repeat_interleave(hq // hkv, 1)
        ve = v.repeat_interleave(hq // hkv, 1)
        mask = (None if (causal and window is None) or not (causal or window)
                else torch.as_tensor(okm, device=dev))
        lib = lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask,
            is_causal=bool(causal and window is None))
        r = (err, bench.ms(lambda: fa.flash_attention(q, k, v, **kw)), bound,
             bench.ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
             bench.ms(lib))
        _report("flash_attention", label, dname, *r, path=_tc_path(dt))
        return r

    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, s, d, causal, window in [
                (1, 4, 2, 128, 64, True, None), (2, 2, 1, 256, 128, True, None),
                (1, 4, 4, 128, 64, True, 40), (1, 2, 2, 100, 64, True, None),
                (2, 8, 2, 128, 64, False, None)]:
            flash_case(f"b{b} hq{hq} hkv{hkv} s{s} d{d} c{int(causal)} "
                       f"w{window}", b, hq, hkv, s, d, causal, window, dt)
    flash_case("prefill s512 f32 (lossless phase)", 1, 32, 8, 512, 128, True,
               None, torch.float32)
    main["flash_attention"] = flash_case("prefill s512 (serve path)", 1, 32, 8,
                                         512, 128, True, None, torch.bfloat16)
    flash_case("prefill s512 (B,S,H,d) views", 1, 32, 8, 512, 128, True, None,
               torch.bfloat16, model_layout=True)
    flash_case("stress s4096", 1, 32, 8, 4096, 128, True, None, torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):    # RecurrentGemma SWA prefill
        flash_case("d256 mqa s512 w2048 (rg prefill)", 1, 10, 1, 512, 256,
                   True, 2048, dt)
    flash_case("d256 mqa s512 w2048 (B,S,H,d) views", 1, 10, 1, 512, 256,
               True, 2048, torch.bfloat16, model_layout=True)
    for d in (64, 128, 240, 256):     # the tensor-core kernel's edges
        for causal, window in ((True, None), (True, 40), (False, None)):
            flash_case(f"edge s100 d{d} c{int(causal)} w{window}", 1, 4, 2,
                       100, d, causal, window, torch.bfloat16,
                       model_layout=window is not None)
    # Gemma-3-12B (16 / 8 heads of 240: 256-wide tiles, zero columns past
    # 240): 3h's prefill of 512 and 1280 tokens, global and window 1024;
    # f32 for 4j
    for dt in (torch.float32, torch.bfloat16):
        flash_case("gemma3 d240 s512 (3h prefill)", 1, 16, 8, 512, 240, True,
                   None, dt, model_layout=True)
        flash_case("gemma3 d240 s1280 w1024 (3h SWA prefill)", 1, 16, 8,
                   1280, 240, True, 1024, dt, model_layout=True)
    flash_case("gemma3 d240 s1280 global (3h prefill)", 1, 16, 8, 1280, 240,
               True, None, torch.bfloat16, model_layout=True)
    flash_case("d256 s512 beside d240 (same tiles)", 1, 16, 8, 512, 256,
               True, None, torch.bfloat16, model_layout=True)
    # Whisper-base (3j): the encoder's bidirectional attention at T 1500,
    # and the decoder's cross attention over it (Sq 1 and 5 != Skv)
    flash_case("whisper encoder b4 T1500 d64 bidir (3j)", 4, 8, 8, 1500, 64,
               False, None, torch.bfloat16, model_layout=True)
    for sq in (1, 5):
        flash_case(f"whisper cross b4 sq{sq} skv1500 d64 (3j)", 4, 8, 8, sq,
                   64, False, None, torch.bfloat16, model_layout=True,
                   skv=1500)
    flash_case("whisper cross b2 sq1 skv1500 d64 f32 (4j)", 2, 8, 8, 1, 64,
               False, None, torch.float32, model_layout=True, skv=1500)
    # head dim 32: the training launcher's reduced Gemma-3 (5t-l), f32
    for dt in (torch.float32, torch.bfloat16):
        flash_case("launcher d32 b8 hq4 hkv2 s64 w64 (5t-l)", 8, 4, 2, 64, 32,
                   True, 64, dt, model_layout=True)
    main["flash_attention_bwd"] = flash_bwd_cases(bench, rn)
    flash_offset_cases(bench, rn)
    decode_offset_cases(bench, rn)

    # -- paged decode attention --------------------------------------------
    def split_note(name, b, hkv, capacity, rows=None, d=128):
        """The split-KV grid the wrapper launches for these shapes (with
        ``rows`` = g * m, its row groups at head dim ``d`` too)."""
        groups, per = da.row_groups(rows or 1, d)
        ns = da.n_split(b, hkv * groups, capacity)
        grp = (f", {groups} row groups of {per} of the {rows} rows"
               if rows else "")
        print(f"  {name:<23} grid (B {b}, Hkv {hkv}{grp}, n_split {ns}) = "
              f"{b * hkv * groups * ns} CTAs for capacity {capacity}",
              flush=True)

    def q_tensor(b, hq, m, d, dt, model_layout):
        """With ``model_layout`` q is made (B, m, Hq, d), as the model
        keeps it, and handed over as a transposed view."""
        if model_layout:
            return rn(b, m, hq, d, dt=dt).transpose(1, 2)
        return rn(b, hq, m, d, dt=dt)

    def paged_case(label, b, hq, hkv, m, bs, d, lengths, dt, quant=False,
                   anc=None, capacity=None, model_layout=False, repeat=False):
        """``capacity`` (tokens, a multiple of bs) sets the block table's
        width beyond the longest sequence, as the serving pool does; with
        ``repeat`` the call is made twice and must give the same bits."""
        dname = str(dt).split(".")[1]
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        mbs = -(-max(int(lengths.max()), capacity or 0) // bs)
        nb = b * mbs + 1
        perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)
        bt = perm.reshape(b, mbs).to(torch.int32)
        q = q_tensor(b, hq, m, d, dt, model_layout)
        if quant:
            kp = torch.randint(-127, 128, (nb, bs, hkv, d), generator=gen,
                               device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb, bs, hkv, d), generator=gen,
                               device=dev, dtype=torch.int8)
            sc = dict(k_scale=rn(nb, bs, hkv, 1).abs() * 0.01,
                      v_scale=rn(nb, bs, hkv, 1).abs() * 0.01)
        else:
            kp, vp = rn(nb, bs, hkv, d, dt=dt), rn(nb, bs, hkv, d, dt=dt)
            sc = {}
        ab = None if anc is None else torch.as_tensor(anc, dtype=torch.int32,
                                                      device=dev)
        call = lambda: pd.paged_decode_attention(q, kp, vp, bt, lengths,
                                                 anc_bits=ab, **sc)
        plain = lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, lengths,
                                                       anc_bits=ab, **sc)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("paged_decode_attention", label, got, want, dname)
        if model_layout:
            assert got.stride() == q.stride(), "output not in q's layout"
        if repeat:
            again = call()
            torch.cuda.synchronize()
            assert torch.equal(got, again), (
                f"paged_decode_attention {label}: two calls differ")
            assert all(torch.equal(got, r) for r in _graph_outputs(call)), (
                f"paged_decode_attention {label}: a graph replay differs")
            print(f"  paged_decode_attention  {label}: two calls and two "
                  "replays of a CUDA graph of the call bitwise equal",
                  flush=True)
        kg, vg = ref.gather_paged_kv_ref(kp, vp, bt, dtype=dt, **sc)
        kg = kg.transpose(1, 2).repeat_interleave(hq // hkv, 1).contiguous()
        vg = vg.transpose(1, 2).repeat_interleave(hq // hkv, 1).contiguous()
        s_all = kg.shape[2]
        kpos = torch.arange(s_all, device=dev)[None, None, :]
        qpos = (lengths.long()[:, None, None] - m
                + torch.arange(m, device=dev)[None, :, None])
        vis = ((kpos <= qpos) & (kpos < lengths.long()[:, None, None]))
        if ab is not None:
            col = kpos - (lengths.long()[:, None, None] - m)
            bit = (ab.long()[None, :, None] >> col.clamp(0, 31)) & 1
            vis = (col < 0) | ((col >= 0) & (kpos < lengths.long()[:, None,
                                                                   None])
                               & (bit > 0))
        mask = vis[:, None]
        lens = lengths.long().cpu().numpy()
        row_b = kp.element_size() * d + (4 if quant else 0)   # one head's row
        kv_bytes = float(2 * hkv * row_b * lens.sum())
        bound = _bound(kv_bytes + _nbytes(q, got, bt, lengths),
                       4.0 * hq * d * float(vis.sum()), dname)
        lib = lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                     attn_mask=mask)
        r = (err, bench.ms(call), bound, bench.ms(plain), bench.ms(lib))
        _report("paged_decode_attention", label, dname, *r)
        return r

    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, m, mbs, bs, d, quant in [
                (2, 4, 2, 1, 4, 16, 64, False), (2, 4, 2, 5, 4, 16, 64, False),
                (1, 8, 1, 4, 8, 8, 128, False), (2, 2, 2, 3, 3, 32, 64, True),
                (1, 4, 2, 4, 5, 16, 64, True)]:
            lens = rng.integers(m + 1, mbs * bs + 1, b)
            paged_case(f"b{b} hq{hq} hkv{hkv} m{m} bs{bs} d{d}"
                       + (" int8" if quant else ""), b, hq, hkv, m, bs, d,
                       lens, dt, quant)
        paged_case("tree anc_bits m4", 2, 4, 2, 4, 16, 64, [37, 50], dt,
                   anc=[1, 3, 5, 11])
    main_lens = rng.integers(512, 608, 4)
    paged_case("verify f32 (lossless phase)", 2, 32, 8, 5, 16, 128,
               main_lens[:2], torch.float32)
    split_note("paged_decode_attention", 4, 8, 640)
    main["paged_decode_attention"] = paged_case(
        "verify b4 m5 ~560 tokens (serve path)", 4, 32, 8, 5, 16, 128,
        main_lens, torch.bfloat16, capacity=640, repeat=True)
    split_note("paged_decode_attention", 8, 8, 32768)
    paged_case("stress b8 L32768 m5", 8, 32, 8, 5, 16, 128, [32768] * 8,
               torch.bfloat16)
    # split edges: nearly every split of a 32768-token capacity is empty
    paged_case("split edges m1 L1 cap32768", 4, 32, 8, 1, 16, 128,
               [1, 1, 2, 7], torch.bfloat16, capacity=32768)
    paged_case("split edges m5 L6/63/64/65 cap32768", 4, 32, 8, 5, 16, 128,
               [6, 63, 64, 65], torch.bfloat16, capacity=32768)
    # a 64-key tile boundary inside the last m positions of every sequence
    for dt in (torch.float32, torch.bfloat16):
        paged_case("boundary in last m5", 4, 32, 8, 5, 16, 128,
                   [130, 66, 194, 258], dt, capacity=640)
    paged_case("boundary in last m5 int8", 4, 32, 8, 5, 16, 128,
               [130, 66, 194, 258], torch.bfloat16, quant=True, capacity=640)
    paged_case("boundary tree anc_bits m4", 2, 4, 2, 4, 16, 64, [130, 66],
               torch.bfloat16, anc=[1, 3, 5, 11], capacity=640)
    paged_case("verify b4 m1 (greedy)", 4, 32, 8, 1, 16, 128, main_lens,
               torch.bfloat16, capacity=640)
    paged_case("verify b4 m5 (B,S,H,d) q/out", 4, 32, 8, 5, 16, 128,
               main_lens, torch.bfloat16, capacity=640, model_layout=True)
    paged_case("verify b4 m5 f32 (B,S,H,d) q/out", 2, 32, 8, 5, 16, 128,
               main_lens[:2], torch.float32, capacity=640, model_layout=True)
    for br, m, bnd in TREE_CASES:
        for dt in (torch.float32, torch.bfloat16):
            paged_case(f"tree {br} m{m} ~560 tokens", 4, 32, 8, m, 16, 128,
                       main_lens, dt, anc=tree_bits(br), capacity=640)
            paged_case(f"tree {br} m{m} boundary in last m", 4, 32, 8, m,
                       16, 128, bnd, dt, anc=tree_bits(br), capacity=640)
    # Gemma-3-12B's 8 global layers (3h, 4j): head dim 240 on the 256-wide
    # tile, at ~560 and ~1300 tokens (prompts of 512 and 1280)
    gemma_lens = {"~560": main_lens, "~1300": rng.integers(1290, 1340, 4)}
    split_note("paged_decode_attention", 4, 8, 1360, rows=10, d=240)
    for tag, lens in gemma_lens.items():
        for dt, quant in ((torch.float32, False), (torch.bfloat16, False),
                          (torch.bfloat16, True)):
            paged_case(f"gemma3 d240 verify b4 m5 {tag} tokens"
                       + (" int8" if quant else ""), 4, 16, 8, 5, 16, 240,
                       lens, dt, quant=quant, capacity=1360,
                       model_layout=True)
    paged_case("gemma3 d240 tree (3, 2) m10 boundary in last m", 4, 16, 8,
               10, 16, 240, TREE_CASES[0][2], torch.bfloat16,
               anc=tree_bits((3, 2)), capacity=1360)
    paged_case("gemma3 d240 boundary in last m5 f32", 2, 16, 8, 5, 16, 240,
               [130, 66], torch.float32, capacity=640)
    # 3i's widths at m 5, d 128: StarCoder2 (36 / 4 heads: 45 rows),
    # Llama-3-405B (128 / 8: 80 rows) and its tree (3, 2) at m 10: 160
    # rows, two row groups of 80 reading the same KV tiles
    paged_case("starcoder2 hq36 hkv4 m5 (45 rows)", 4, 36, 4, 5, 16, 128,
               main_lens, torch.bfloat16, capacity=640, model_layout=True)
    paged_case("llama3-405b hq128 hkv8 m5 (80 rows)", 4, 128, 8, 5, 16, 128,
               main_lens, torch.bfloat16, capacity=640, model_layout=True)
    split_note("paged_decode_attention", 4, 8, 640, rows=160)
    for dt in (torch.float32, torch.bfloat16):
        paged_case("llama3-405b tree (3, 2) m10 (160 rows)", 4, 128, 8, 10,
                   16, 128, main_lens, dt, anc=tree_bits((3, 2)),
                   capacity=640, model_layout=True)
    paged_case("llama3-405b tree (3, 2) m10 (160 rows) boundary", 4, 128, 8,
               10, 16, 128, TREE_CASES[0][2], torch.bfloat16,
               anc=tree_bits((3, 2)), capacity=640, repeat=True)
    torch.cuda.empty_cache()

    # -- MoE FFN -------------------------------------------------------------
    def moe_weights(e, d, f, dt):
        """Drawn an expert at a time: no f32 copy of a whole stack (21.5
        GB at Llama-4's) is made."""
        def stack(rows, cols):
            w = torch.empty((e, rows, cols), dtype=dt, device=dev)
            for i in range(e):
                w[i] = (rn(rows, cols) * rows ** -0.5).to(dt)
            return w
        return stack(d, f), stack(d, f), stack(f, d)

    def moe_case(label, e, c, d, f, dt, activation="swiglu", weights=None):
        dname = str(dt).split(".")[1]
        buf = rn(e, c, d, dt=dt)
        wg, wu, wd = weights or moe_weights(e, d, f, dt)
        call = lambda: mf.moe_ffn(buf, wg, wu, wd, activation=activation)
        plain = lambda: ref.moe_ffn_ref(buf, wg, wu, wd, activation=activation)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("moe_ffn", label, got, want, dname)
        bound = _bound(_nbytes(buf, wg, wu, wd, got), 6.0 * e * c * d * f,
                       dname)

        def lib():                    # the einsum path as three bmm calls
            h = ref.ffn_act(torch.bmm(buf, wg), activation)
            return torch.bmm(h * torch.bmm(buf, wu), wd)
        r = (err, bench.ms(call), bound, bench.ms(plain), bench.ms(lib))
        _report("moe_ffn", label, dname, *r, path=_tc_path(dt))
        return r

    for dt in (torch.float32, torch.bfloat16):
        for e, c, d, f in [(4, 128, 64, 256), (2, 100, 128, 300),
                           (8, 64, 32, 128)]:
            moe_case(f"e{e} c{c} d{d} f{f}", e, c, d, f, dt)
        moe_case("gelu e4 c20 d64 f192", 4, 20, 64, 192, dt, "gelu")
    moe_case("verify c10 f32 (lossless phase)", 8, 10, 4096, 14336,
             torch.float32)
    moe_case("tree verify c20 f32 (4e/4f: B 2 x 10 nodes)", 8, 20, 4096,
             14336, torch.float32)
    mix_w = moe_weights(8, 4096, 14336, torch.bfloat16)
    main["moe_ffn"] = moe_case("verify c20 (serve path)", 8, 20, 4096, 14336,
                               torch.bfloat16, weights=mix_w)
    moe_case("tree verify c40 (3e serve path: B 4 x 10 nodes)", 8, 40, 4096,
             14336, torch.bfloat16, weights=mix_w)
    moe_case("prefill c257 (serve path)", 8, 257, 4096, 14336, torch.bfloat16,
             weights=mix_w)
    moe_case("offload prefill c513 (3f: B 2 x 512 tokens)", 8, 513, 4096,
             14336, torch.bfloat16, weights=mix_w)
    moe_case("offload decode c2 (3f: B 2, m 1)", 8, 2, 4096, 14336,
             torch.bfloat16, weights=mix_w)
    for c in (1, 7, 33, 300):         # token tiles of 8, 8, 40, 2 x 152
        moe_case(f"edge c{c} d4096 f14336", 8, c, 4096, 14336,
                 torch.bfloat16, weights=mix_w)
    del mix_w
    torch.cuda.empty_cache()
    # 3i's MoE families at verify (B 4 x m 5 = C 20, dropless: every
    # expert's buffer is C rows, so the call reads every expert's weights)
    # and at the prefill of a 512-token prompt (capacity int(512 * top_k *
    # 2 / E) + 1, models/moe.py): Phi-3.5-MoE (E 16, F 6400, top-2) and
    # Llama-4 Maverick (E 128, D 5120, F 8192, top-1: 32.2 GB of weights)
    from repro_torch.configs import LLAMA4_MAVERICK, PHI35_MOE
    for cfgm in (PHI35_MOE, LLAMA4_MAVERICK):
        e, d, f = cfgm.n_experts, cfgm.d_model, cfgm.d_ff
        c_pre = int(512 * cfgm.top_k * cfgm.capacity_factor / e) + 1
        w = moe_weights(e, d, f, torch.bfloat16)
        for c, tag in ((20, "verify"), (c_pre, "prefill")):
            moe_case(f"{cfgm.name.split('-')[0]} e{e} d{d} f{f} {tag} c{c} "
                     "(3i)", e, c, d, f, torch.bfloat16, weights=w)
        del w
        torch.cuda.empty_cache()
    moe_case("phi3.5 e16 d4096 f6400 verify c10 f32 (4j)", 16, 10, 4096,
             6400, torch.float32)
    torch.cuda.empty_cache()

    # -- contiguous decode attention ----------------------------------------
    def decode_case(label, b, hq, hkv, m, s, d, lengths, dt, window=None,
                    anc=None, model_layout=False, repeat=False):
        """The cache is made (B, S, Hkv, d), as the model keeps it, and
        handed over as a transposed view; so is q with ``model_layout``.
        With ``repeat`` the call is made twice and must give the same
        bits."""
        dname = str(dt).split(".")[1]
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        q = q_tensor(b, hq, m, d, dt, model_layout)
        k = rn(b, s, hkv, d, dt=dt).transpose(1, 2)
        v = rn(b, s, hkv, d, dt=dt).transpose(1, 2)
        ab = None if anc is None else torch.as_tensor(anc, dtype=torch.int32,
                                                      device=dev)
        amask = None if ab is None else ref.anc_mask_from_bits(ab, m)
        call = lambda: da.decode_attention(q, k, v, lengths, window=window,
                                           anc_bits=ab)
        plain = lambda: ref.decode_attention_ref(q, k, v, lengths,
                                                 window=window,
                                                 anc_mask=amask)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("decode_attention", label, got, want, dname)
        if model_layout:
            assert got.stride() == q.stride(), "output not in q's layout"
        if repeat:
            again = call()
            torch.cuda.synchronize()
            assert torch.equal(got, again), (
                f"decode_attention {label}: two calls differ")
            assert all(torch.equal(got, r) for r in _graph_outputs(call)), (
                f"decode_attention {label}: a graph replay differs")
            print(f"  decode_attention        {label}: two calls and two "
                  "replays of a CUDA graph of the call bitwise equal",
                  flush=True)
        kpos = torch.arange(s, device=dev)[None, None, :]
        qpos = (lengths.long()[:, None, None] - m
                + torch.arange(m, device=dev)[None, :, None])
        vis = (kpos <= qpos) & (kpos < lengths.long()[:, None, None])
        if window is not None:
            vis &= kpos > qpos - window
        if ab is not None:
            col = kpos - (lengths.long()[:, None, None] - m)
            bit = (ab.long()[None, :, None] >> col.clamp(0, 31)) & 1
            vis = (col < 0) | ((col >= 0)
                               & (kpos < lengths.long()[:, None, None])
                               & (bit > 0))
        rows_read = float(lengths.clamp(max=s).sum())
        bound = _bound(2.0 * hkv * d * k.element_size() * rows_read
                       + _nbytes(q, got, lengths),
                       4.0 * hq * d * float(vis.sum()), dname)
        ke = k.repeat_interleave(hq // hkv, 1).contiguous()
        ve = v.repeat_interleave(hq // hkv, 1).contiguous()
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                     attn_mask=vis[:, None])
        r = (err, bench.ms(call), bound, bench.ms(plain), bench.ms(lib))
        _report("decode_attention", label, dname, *r)
        return r

    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, m, s, d, window in [
                (2, 4, 2, 1, 256, 64, None), (2, 4, 2, 5, 256, 64, None),
                (1, 8, 1, 4, 512, 128, None), (2, 2, 2, 3, 300, 64, None),
                (1, 4, 2, 4, 256, 64, 64)]:
            lens = rng.integers(m + 8, s + 1, b)
            decode_case(f"b{b} hq{hq} hkv{hkv} m{m} s{s} d{d} w{window}", b,
                        hq, hkv, m, s, d, lens, dt, window=window)
        decode_case("tree anc_bits m4", 2, 4, 2, 4, 128, 64, [37, 50], dt,
                    anc=[1, 3, 5, 11])
        split_note("decode_attention", 2, 1, 640)
        decode_case("d256 mqa m5", 2, 10, 1, 5, 640, 256, [300, 640], dt)
    decode_case("verify f32 (lossless phase)", 2, 32, 8, 5, 640, 128,
                main_lens[:2], torch.float32)
    split_note("decode_attention", 4, 8, 640)
    decode_case("verify b4 m5 s640 (contiguous verify)", 4, 32, 8, 5, 640,
                128, main_lens, torch.bfloat16, repeat=True)
    # the serve path: the Mistral-7B draft's one-token step over its
    # sliding-window ring (8 rows; the offline cells' 1,568 slots and the
    # online cell's 3,168), lengths min(pos + 1, slots) from 1 to the full
    # ring, every slot past a row's length holding stale rows
    for slots in (1568, 3168):
        split_note("decode_attention", 8, 8, slots)
        ring = decode_case(f"draft ring b8 m1 s{slots} (serve path)", 8, 32,
                           8, 1, slots, 128, [1, 2, 63, 64, 700, slots // 2,
                                              slots - 1, slots],
                           torch.bfloat16, repeat=True)
        main.setdefault("decode_attention", ring)
    split_note("decode_attention", 8, 8, 32768)
    decode_case("stress b8 S32768 m5", 8, 32, 8, 5, 32768, 128, [32768] * 8,
                torch.bfloat16)
    decode_case("split edges m1 L1 S32768", 4, 32, 8, 1, 32768, 128,
                [1, 1, 2, 7], torch.bfloat16)
    decode_case("split edges m5 L6/63/64/65 S32768", 4, 32, 8, 5, 32768,
                128, [6, 63, 64, 65], torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):
        decode_case("boundary in last m5", 4, 32, 8, 5, 640, 128,
                    [130, 66, 194, 258], dt)
    # keys before the window's first tile are never read; three of the
    # lengths put a 64-key tile boundary inside the last m positions
    decode_case("window 64 boundary in last m5", 4, 32, 8, 5, 4096, 128,
                [3970, 4033, 2050, 700], torch.bfloat16, window=64)
    decode_case("boundary tree anc_bits m4", 2, 4, 2, 4, 640, 64, [130, 66],
                torch.bfloat16, anc=[1, 3, 5, 11])
    decode_case("verify b4 m1 (greedy)", 4, 32, 8, 1, 640, 128, main_lens,
                torch.bfloat16)
    decode_case(f"offload decode b2 m1 s{OFFLOAD_MAX_LEN} (3f)", 2, 32, 8, 1,
                OFFLOAD_MAX_LEN, 128, [OFFLOAD_PROMPT + 1,
                                       OFFLOAD_PROMPT + OFFLOAD_STEPS],
                torch.bfloat16)
    decode_case("verify b4 m5 (B,S,H,d) q/out", 4, 32, 8, 5, 640, 128,
                main_lens, torch.bfloat16, model_layout=True)
    decode_case("verify b4 m5 f32 (B,S,H,d) q/out", 2, 32, 8, 5, 640, 128,
                main_lens[:2], torch.float32, model_layout=True)
    for br, m, bnd in TREE_CASES:
        for dt in (torch.float32, torch.bfloat16):
            decode_case(f"tree {br} m{m} s640 ~560 tokens", 4, 32, 8, m, 640,
                        128, main_lens, dt, anc=tree_bits(br))
            decode_case(f"tree {br} m{m} boundary in last m", 4, 32, 8, m,
                        640, 128, bnd, dt, anc=tree_bits(br))
    # Gemma-3-12B's global layers on the contiguous path (4j paged=False)
    for tag, lens in gemma_lens.items():
        for dt in (torch.float32, torch.bfloat16):
            decode_case(f"gemma3 d240 verify b4 m5 s1360 {tag} tokens", 4, 16,
                        8, 5, 1360, 240, lens, dt, model_layout=True)
    decode_case("gemma3 d240 m1 (greedy decode)", 4, 16, 8, 1, 1360, 240,
                gemma_lens["~1300"], torch.float32)
    decode_case("gemma3 d240 tree (3, 2) m10 boundary in last m", 4, 16, 8,
                10, 640, 240, TREE_CASES[0][2], torch.bfloat16,
                anc=tree_bits((3, 2)))
    # 160 rows (Llama-3-405B under tree (3, 2)): two row groups
    decode_case("llama3-405b tree (3, 2) m10 (160 rows)", 4, 128, 8, 10,
                640, 128, main_lens, torch.bfloat16, anc=tree_bits((3, 2)),
                repeat=True)
    decode_case("whisper d64 m1 g1 (3j decode)", 4, 8, 8, 1, 448, 64,
                [5, 20, 36, 36], torch.bfloat16)
    # the serving example's draft (Mistral-7B reduced: 4 / 2 heads of 16,
    # f32) over its 64-slot ring
    decode_case("example draft ring d16 m1 s64 (6a)", 2, 4, 2, 1, 64, 16,
                [1, 64], torch.float32)
    torch.cuda.empty_cache()

    # -- RG-LRU scan ----------------------------------------------------------
    def rglru_case(label, b, s, w):
        a = torch.sigmoid(rn(b, s, w))
        g, h0 = rn(b, s, w), rn(b, w)
        call = lambda: rg.rglru_scan(a, g, h0)
        plain = lambda: ref.rglru_scan_ref(a, g, h0)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("rglru_scan", label, got, want, "float32", TOL_RGLRU)
        bound = _bound(_nbytes(a, g, h0, got), 2.0 * b * s * w, "float32")
        r = (err, bench.ms(call), bound, bench.ms(plain), None)
        _report("rglru_scan", label, "float32", *r, path=rg.route(s))
        return r

    def gated_case(label, b, s, w, x_dt=torch.bfloat16):
        """The fused entry as the model calls it: f32 products, the conv
        output in the model's dtype, RecurrentGemma's a_param (a in
        [0.9, 0.999]) with a few channels past softplus's threshold."""
        xa, xi = rn(b, s, w), rn(b, s, w)
        x = rn(b, s, w, dt=x_dt)
        b_a, b_i = rn(w) * 0.5, rn(w) * 0.5
        u = 0.9 + 0.099 * torch.rand((w,), generator=gen, device=dev)
        a_param = torch.log(torch.expm1(-torch.log(u) / 8.0))
        a_param[:3] = 25.0
        h0 = rn(b, w)
        args = (xa, xi, x, b_a, b_i, a_param, h0)
        call = lambda: rg.rglru_gated_scan(*args)
        plain = lambda: ref.rglru_gated_scan_ref(*args)
        got, want = call(), plain()
        torch.cuda.synchronize()
        dname = str(x_dt).split(".")[1]
        err = _check("rglru_gated_scan", label, got, want, "float32",
                     TOL_RGLRU)
        # 22 f32 operations an element, as csrc/rglru_scan.cu counts them
        bound = _bound(_nbytes(*args, got), 22.0 * b * s * w, "float32")
        r = (err, bench.ms(call), bound, bench.ms(plain), None)
        _report("rglru_gated_scan", label, f"x {dname}", *r,
                path=rg.route(s))
        return r

    for b, s, w in [(2, 64, 256), (1, 128, 100), (4, 32, 512)]:
        rglru_case(f"b{b} s{s} w{w}", b, s, w)
    rglru_case("verify b4 s5 w2560 (serve path)", 4, 5, 2560)
    rglru_case("prefill b1 s512 w2560 (serve path)", 1, 512, 2560)
    rglru_case("stress b8 s4096 w2560", 8, 4096, 2560)
    rglru_case("ragged b2 s1000 w102", 2, 1000, 102)
    main["rglru_scan"] = gated_case("verify b4 s5 w2560 (serve path)", 4, 5,
                                    2560)
    gated_case("prefill b1 s512 w2560 (serve path)", 1, 512, 2560)
    gated_case("stress b8 s4096 w2560", 8, 4096, 2560)
    main["rglru_gated_scan"] = gated_case("5t-r train b2 s4096 w2560", 2,
                                          4096, 2560)
    for x_dt in (torch.float32,):        # the lossless phase's f32 model
        gated_case("verify b2 s5 w2560 f32", 2, 5, 2560, x_dt)
        gated_case("prefill b1 s130 w2560 f32", 1, 130, 2560, x_dt)
    gated_case("b2 s40 w100", 2, 40, 100)
    gated_case("b2 s40 w102 (one channel a thread)", 2, 40, 102)
    gated_case("decode b4 s1 w2560", 4, 1, 2560)

    # -- WKV-6 ----------------------------------------------------------------
    def wkv6_case(label, b, h, s, hd, stack, decay="sigmoid"):
        """r/k/v/w as the model hands them over: (B, S, H, hd) transposed.
        ``decay`` "sigmoid" draws w in ~(0.1, 0.9); "model" draws it as
        the model forms it, exp(-exp(w_log)) with w_log ~ U[-8, 4], and
        sets channel 0 to w == 0 and channel 1 to w = 1 - 1e-7."""
        r, k, v = (rn(b, s, h, hd).transpose(1, 2) for _ in range(3))
        if decay == "sigmoid":
            w = torch.sigmoid(rn(b, s, h, hd)).transpose(1, 2)
        else:
            w_log = torch.rand((b, s, h, hd), generator=gen,
                               device=dev) * 12.0 - 8.0
            w = torch.exp(-torch.exp(w_log))
            w[..., 0] = 0.0
            w[..., 1] = 1.0 - 1e-7
            w = w.transpose(1, 2)
        u, s0 = rn(h, hd) * 0.1, rn(b, h, hd, hd) * 0.1
        call = lambda: wk.wkv6(r, k, v, w, u, s0, stack=stack)
        plain = lambda: ref.wkv6_ref(r, k, v, w, u, s0, stack=stack)
        # the plain version evaluated in f64: in f32 its multiply-then-add
        # loses part of a 1 - 1e-7 decay to rounding every step, more than
        # the kernels do (printed below for the model's decays)
        got = call()
        want = [x.float() for x in ref.wkv6_ref(
            *(t.double() for t in (r, k, v, w, u, s0)), stack=stack)]
        torch.cuda.synchronize()
        err = max(_check("wkv6", label + f" out{i}", x, y, "float32",
                         TOL_WKV6) for i, (x, y) in enumerate(zip(got, want)))
        if decay == "model":
            f32 = plain()
            print(f"  {'wkv6':<23} {label}: the plain version in f32 is off "
                  f"by {float((f32[0] - want[0]).abs().max()):.2e} (y)",
                  flush=True)
            del f32
        bound = _bound(_nbytes(r, k, v, w, u, s0, *got[:1], *got[2:])
                       + (0 if stack else _nbytes(got[1])),
                       6.0 * b * h * s * hd * hd, "float32")
        r_ = (err, bench.ms(call), bound, bench.ms(plain), None)
        path = wk.route(s, stack)
        if path == "chunked":
            path += f", slab {wk.slab(b, h, hd)}"
        _report("wkv6", label, "float32", *r_, path=path)
        return r_

    for b, h, s, hd in [(1, 2, 32, 64), (2, 4, 16, 64), (1, 1, 64, 128)]:
        wkv6_case(f"b{b} h{h} s{s} hd{hd}", b, h, s, hd, False)
    # head size 128 on the serial route (verify with the stack)
    wkv6_case("hd128 verify+stack b1 h32 s5", 1, 32, 5, 128, True, "model")
    main["wkv6"] = wkv6_case("verify+stack b4 h64 s5 (serve path)", 4, 64, 5,
                             64, True)
    wkv6_case("prefill b1 h64 s512 (serve path)", 1, 64, 512, 64, False)
    wkv6_case("stress b8 h64 s2048", 8, 64, 2048, 64, False)
    # the model's decay range, exact zeros and 1 - 1e-7 included
    wkv6_case("model decay verify+stack b4 h64 s5", 4, 64, 5, 64, True,
              "model")
    wkv6_case("model decay prefill b1 h64 s512", 1, 64, 512, 64, False,
              "model")
    wkv6_case("model decay stress b8 h64 s2048", 8, 64, 2048, 64, False,
              "model")
    for s in (100, 1000):
        wkv6_case(f"model decay ragged b1 h64 s{s}", 1, 64, s, 64, False,
                  "model")
    wkv6_case("model decay prefill hd128 b1 h32 s512", 1, 32, 512, 128,
              False, "model")
    wkv6_case("model decay decode b4 h64 s1", 4, 64, 1, 64, False, "model")
    # the examples' reduced configs (phase 6a), f32: the quickstart's
    # prefill (B 4, S 16) and its target's and draft's verify / decode
    # over 128-slot caches at head dim 32; the serving example's draft
    # prefill at head dim 16 (a prompt of up to 24 tokens, window 64) and
    # its target's paged verify (B 2, m 4) at head dim 32
    f32 = torch.float32
    flash_case("quickstart prefill b4 s16 d32 (6a)", 4, 4, 2, 16, 32, True,
               None, f32, model_layout=True)
    flash_case("serve example draft prefill s24 d16 w64 (6a)", 1, 4, 2, 24,
               16, True, 64, f32, model_layout=True)
    decode_case("quickstart verify b4 m5 s128 d32 (6a)", 4, 4, 2, 5, 128, 32,
                [21, 30, 42, 77], f32, model_layout=True)
    decode_case("quickstart draft b4 hq2 hkv1 m1 s128 d32 (6a)", 4, 2, 1, 1,
                128, 32, [17, 26, 39, 71], f32, model_layout=True)
    paged_case("serve example verify b2 m4 d32 (6a)", 2, 4, 2, 4, 16, 32,
               [28, 41], f32, capacity=64, model_layout=True)
    torch.cuda.empty_cache()
    main.update(recurrent_bwd_cases(bench, gen))
    wkv6_bwd_slab_readings(bench, gen)
    main.update(moe_bwd_cases(bench, gen))
    return main


# the recurrences' backward kernels against their plain versions in f64:
# each output's worst error over its largest magnitude.  f32 sums over
# 4096 steps round ~sqrt(4096) x 2^-24 ~ 4e-6 of that magnitude; the
# tolerance leaves 25x room.
TOL_BWD = 1e-4


def _check_scaled(name, case, got, want, tol=TOL_BWD):
    """Largest |got - want| against ``tol`` x max |want| (no NaN);
    returns the largest absolute error."""
    import torch
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    bad = int(torch.isnan(got).sum())
    if bad or err > tol * max(scale, 1e-30):
        raise AssertionError(f"{name} {case}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e} of max "
                             f"{scale:.3e}, tol {tol}, {bad} NaN)")
    return err


def _wkv6_bwd_args(gen, b, h, s, hd, ds_fin=True) -> tuple:
    """``wkv6_bwd``'s inputs on the card: r, k, v, dy as the model's
    transposed (B, S, H, hd) views, the model's decays with a w == 0 and
    a w = 1 - 1e-7 channel, a nonzero s0 and (with ``ds_fin``) final-state
    gradient."""
    import torch
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    r, k, v, dy = (rn(b, s, h, hd).transpose(1, 2) for _ in range(4))
    w_log = torch.rand((b, s, h, hd), generator=gen, device="cuda") * 12 - 8
    w = torch.exp(-torch.exp(w_log))
    w[..., 0] = 0.0
    w[..., 1] = 1.0 - 1e-7
    w = w.transpose(1, 2)
    u, s0 = rn(h, hd) * 0.1, rn(b, h, hd, hd) * 0.1
    dsf = rn(b, h, hd, hd) if ds_fin else None
    return (r, k, v, w, u, s0, dy, dsf)


def wkv6_bwd_slab_readings(bench, gen) -> None:
    """The readings behind ``kernels/wkv6.py::bwd_slab`` at head size 64:
    ``wkv6_bwd`` at RWKV-6-7B's S 4096 for B x H from 32 to 128, with
    32-column slabs (two CTAs a head) and with whole heads (one), timed
    on the same inputs; the two agree within ``TOL_BWD`` of each output's
    largest magnitude (each is held to f64 in ``recurrent_bwd_cases``)."""
    import torch

    from repro_torch.kernels import wkv6 as wk

    n_sms, rows = wk.N_SMS, []
    try:
        for b, h in ((1, 32), (1, 64), (2, 40), (2, 64)):
            args = _wkv6_bwd_args(gen, b, h, 4096, 64)
            pick, ms, outs = wk.bwd_slab(b, h, 64), {}, {}
            for slab, sms in ((32, 1 << 30), (64, 0)):
                wk.N_SMS = sms      # forces the slab
                assert wk.bwd_slab(b, h, 64) == slab
                outs[slab] = wk.wkv6_bwd(*args)
                ms[slab] = bench.ms(lambda: wk.wkv6_bwd(*args))
            wk.N_SMS = n_sms
            for n, x, y in zip(("dr", "dk", "dv", "dw", "du", "ds0"),
                               outs[32], outs[64]):
                _check_scaled("wkv6_bwd", f"slab 32 against 64, B {b} H {h} "
                              f"{n}", x, y)
            rows.append(f"B x H {b * h}: slab 32 {ms[32]:.4f}"
                        f"{'*' if pick == 32 else ''}, whole head "
                        f"{ms[64]:.4f}{'*' if pick == 64 else ''}")
            del args, outs
            torch.cuda.empty_cache()
    finally:
        wk.N_SMS = n_sms
    print("  wkv6_bwd slabs at hd 64, S 4096, ms (* bwd_slab's pick): "
          + "; ".join(rows), flush=True)


def recurrent_bwd_cases(bench, gen) -> dict:
    """The backward kernels of the two recurrences against their plain
    versions evaluated in f64 on the same inputs (each output held to
    ``TOL_BWD`` of its largest magnitude), with time, bound and the plain
    version's time (f32); no single PyTorch call computes either.
    ``wkv6_bwd``: RWKV-6-7B's training shape (5t-k: B 2, H 64, S 4096, hd
    64) with the model's decays (w == 0 and w = 1 - 1e-7 channels), a
    nonzero s0 and final-state gradient, called twice (bitwise equal);
    head size 128; S not a multiple of the checkpoint spacing; one step.
    ``rglru_gated_scan_bwd``: RecurrentGemma-2B's (5t-r: B 2, S 4096, W
    2560) and the rest of ``rglru_bwd_cases``.  Returns the main cases'
    numbers by wrapper name."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6 as wk

    main = {}

    def wkv6_bwd_case(label, b, h, s, hd, ds_fin=True, twice=False):
        args = _wkv6_bwd_args(gen, b, h, s, hd, ds_fin)
        call = lambda: wk.wkv6_bwd(*args)
        got = call()
        if twice:
            again = call()
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, again)), (
                f"wkv6_bwd {label}: two calls differ")
            del again
        want = ref.wkv6_bwd_ref(*(None if t is None else t.double()
                                  for t in args))
        torch.cuda.synchronize()
        names = ("dr", "dk", "dv", "dw", "du", "ds0")
        errs = [_check_scaled("wkv6_bwd", f"{label} {n}", g, y)
                for n, g, y in zip(names, got, want)]
        err = max(errs)
        print(f"  wkv6_bwd {label}: err/max of each output (TOL_BWD "
              f"{TOL_BWD:g}): " + ", ".join(
                  f"{n} {e / float(y.abs().max()):.3e}"
                  for n, e, y in zip(names, errs, want)), flush=True)
        del want
        torch.cuda.empty_cache()
        # 12 f32 operations an entry of the state and step (the source's
        # note); each input read once, each output written once
        bound = _bound(_nbytes(*[t for t in args if t is not None], *got),
                       12.0 * b * h * s * hd * hd, "float32")
        if twice:
            _print_launches("wkv6_bwd", label, call)
        res = (err, bench.ms(call), bound,
               bench.ms(lambda: ref.wkv6_bwd_ref(*args), budget_ms=1.0),
               None)
        _report("wkv6_bwd", label, "float32", *res,
                path="bitwise equal twice" if twice else "")
        del got
        torch.cuda.empty_cache()
        return res

    main["wkv6_bwd"] = wkv6_bwd_case("5t-k b2 h64 s4096 hd64", 2, 64, 4096,
                                     64, twice=True)
    wkv6_bwd_case("hd128 b1 h32 s1024", 1, 32, 1024, 128)
    wkv6_bwd_case("ragged b2 h8 s1000 hd64 no ds_fin", 2, 8, 1000, 64,
                  ds_fin=False)
    wkv6_bwd_case("ragged b1 h4 s37 hd128", 1, 4, 37, 128)
    wkv6_bwd_case("one step b2 h4 s1 hd64", 2, 4, 1, 64)

    main.update(rglru_bwd_cases(bench, gen))
    torch.cuda.empty_cache()
    return main


def _rglru_bwd_args(gen, b, s, w, x_dt) -> tuple:
    """``rglru_gated_scan_bwd``'s inputs on the card: RecurrentGemma's
    decays (a in [0.9, 0.999]) with three channels past softplus's
    threshold, h_all from the forward kernel."""
    import torch

    from repro_torch.kernels import rglru_scan as rg
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    xa, xi, x = rn(b, s, w), rn(b, s, w), rn(b, s, w).to(x_dt)
    b_a, b_i = rn(w) * 0.5, rn(w) * 0.5
    uu = 0.9 + 0.099 * torch.rand((w,), generator=gen, device="cuda")
    a_param = torch.log(torch.expm1(-torch.log(uu) / 8.0))
    a_param[:3] = 25.0
    h0, dh = rn(b, w), rn(b, s, w)
    h_all = rg.rglru_gated_scan(xa, xi, x, b_a, b_i, a_param, h0)
    return (xa, xi, x, b_a, b_i, a_param, h0, h_all, dh)


def rglru_bwd_cases(bench, gen) -> dict:
    """``rglru_gated_scan_bwd`` against its plain version in f64: 5t-r's
    shape (B 2, S 4096, W 2560) with x in bf16 (twice: bitwise equal, and
    the device time of each launch) and in f32, 5t-eq-r's odd S, the
    chained cases (B 8 x S 4096; B 1 x S 16384, the longest carry chain,
    twice; S a multiple of the chunk and one step past it), widths whose
    last slab is partial (100 in f32, 104) and widths the tensor maps
    cannot take (100 in bf16, 102: the sequence route), one step (the
    forward at 5t-r's shape is ``kernel_cases``' "5t-r train" case).
    Returns the main case's numbers."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg

    def case(label, b, s, w, x_dt=torch.bfloat16, twice=False):
        args = _rglru_bwd_args(gen, b, s, w, x_dt)
        call = lambda: rg.rglru_gated_scan_bwd(*args)
        got = call()
        if twice:
            again = call()
            torch.cuda.synchronize()
            assert all(torch.equal(x_, y) for x_, y in zip(got, again)), (
                f"rglru_gated_scan_bwd {label}: two calls differ")
            del again
        want = ref.rglru_gated_scan_bwd_ref(*(t.double() for t in args))
        torch.cuda.synchronize()
        names = ("dxa", "dxi", "dx", "db_a", "db_i", "da_param", "dh0")
        # dx in bf16 is held to bf16's rounding (TOL) elementwise
        errs = [_check("rglru_gated_scan_bwd", f"{label} {n}", g, y,
                       "bfloat16") if g.dtype == torch.bfloat16
                else _check_scaled("rglru_gated_scan_bwd", f"{label} {n}",
                                   g, y)
                for n, g, y in zip(names, got, want)]
        err = max(errs)
        print(f"  rglru_gated_scan_bwd {label}: err/max of each output "
              f"(TOL_BWD {TOL_BWD:g}; bf16 dx elementwise to TOL): "
              + ", ".join(f"{n} {e / float(y.abs().max()):.3e}"
                          for n, e, y in zip(names, errs, want)), flush=True)
        del want
        torch.cuda.empty_cache()
        # 52 f32 operations an element on the chunked route (the source's
        # note); each input read once, each output written once
        bound = _bound(_nbytes(*args, *got), 52.0 * b * s * w, "float32")
        route = rg.bwd_route(w, x_dt, *args[:3], *args[7:])
        if route == "chunked":
            route = f"chunked, T {rg.BWD_CHUNK[x_dt]}"
        if twice:
            _print_launches("rglru_gated_scan_bwd", label, call)
        res = (err, bench.ms(call), bound,
               bench.ms(lambda: ref.rglru_gated_scan_bwd_ref(*args),
                        budget_ms=1.0), None)
        _report("rglru_gated_scan_bwd", label,
                f"x {str(x_dt).split('.')[1]}", *res,
                path=route + (", bitwise equal twice" if twice else ""))
        del args, got
        torch.cuda.empty_cache()
        return res

    main = {"rglru_gated_scan_bwd": case("5t-r b2 s4096 w2560", 2, 4096,
                                         2560, twice=True)}
    case("5t-r b2 s4096 w2560 f32", 2, 4096, 2560, torch.float32)
    case("odd b2 s257 w2560 f32 (5t-eq-r)", 2, 257, 2560, torch.float32)
    case("stress b8 s4096 w2560", 8, 4096, 2560)
    case("longest chain b1 s16384 w2560", 1, 16384, 2560, twice=True)
    case("one past T b2 s4097 w2560", 2, 4097, 2560)
    case("T x 32 b2 s3584 w2560 f32", 2, 3584, 2560, torch.float32)
    case("one past T b2 s3585 w2560 f32", 2, 3585, 2560, torch.float32)
    case("partial slab b2 s300 w100 f32", 2, 300, 100, torch.float32)
    case("partial slab b1 s1001 w104", 1, 1001, 104)
    case("b2 s40 w100", 2, 40, 100)
    case("b1 s1001 w102 (one channel a thread)", 1, 1001, 102)
    case("one step b2 s1 w2560", 2, 1, 2560)
    return main


# the expert FFN backward's bf16 outputs: the plain version in f64 rounds
# nothing, the kernel rounds g, u, dh, dg, du and h to bf16 (and each
# output once), so each output is held to 2e-2 of its largest magnitude
TOL_MOE_BWD_BF16 = 2e-2


def _launch_times(fn) -> list:
    """The device time of each kernel one call of ``fn`` launches, in
    launch order: [(kernel name without its arguments, ms)].  Two calls
    run under ``torch.profiler`` after a warm-up, each after a marker
    kernel (``torch.cuda._sleep``'s ``spin_kernel``), and the kernels
    after the last marker are reported: a profiler session can miss its
    first kernels (seen on the card), so counting halves is not safe."""
    import torch
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("Mem")),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(evs) if "spin_kernel" in e.name]
    assert marks, "no marker kernel in the profile"
    evs = evs[marks[-1] + 1:]
    short = lambda n: re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                             n)
    return [(short(e.name), e.time_range.elapsed_us() / 1e3) for e in evs]


def _print_launches(name, label, fn) -> None:
    rows = _launch_times(fn)
    print(f"  {name} {label}: {len(rows)} launches a call, device ms in "
          "launch order: " + "; ".join(f"{n} {ms:.4f}" for n, ms in rows)
          + f" (sum {sum(ms for _, ms in rows):.4f})", flush=True)


def moe_bwd_library(buf, w_gate, w_up, w_down, dy, activation):
    """The expert FFN's backward as PyTorch calls on the operands as
    stored (transposes as views): seven ``torch.bmm`` and one
    ``torch.baddbmm`` (dX adds its two products) through cuBLAS, the
    elementwise step in f32 between them, each product rounded to the
    inputs' dtype.  A yardstick only: the port runs ``moe_ffn_bwd``."""
    import torch

    from repro_torch.kernels import ref
    dt = buf.dtype
    g, u = torch.bmm(buf, w_gate), torch.bmm(buf, w_up)
    dh = torch.bmm(dy, w_down.transpose(1, 2))
    a, da = ref.ffn_act_grad(g.float(), activation)
    dg, du = (dh.float() * u.float() * da).to(dt), (dh.float() * a).to(dt)
    h = (a * u.float()).to(dt)
    del g, dh, a, da
    dx = torch.baddbmm(torch.bmm(dg, w_gate.transpose(1, 2)), du,
                       w_up.transpose(1, 2))
    xt = buf.transpose(1, 2)
    return (dx, torch.bmm(xt, dg), torch.bmm(xt, du),
            torch.bmm(h.transpose(1, 2), dy))


def moe_bwd_cases(bench, gen) -> dict:
    """The expert FFN's backward kernels against ``moe_ffn_bwd_ref``
    evaluated in f64 on the same inputs (f32 outputs within ``TOL_BWD``
    of each one's largest magnitude, bf16 within ``TOL_MOE_BWD_BF16``),
    with time, bound (eight products of 2 E C D F operations), the plain
    version's time and, in bf16, the library's (``moe_bwd_library``: no
    single PyTorch call computes it).  5t-m's shape (Mixtral-8x7B, B 1 x
    S 4096: E 8, C 2049, D 4096, F 14336, bf16) called twice (bitwise
    equal), with the device time of each of its launches;
    5t-eq-m's (B 2 x 257: C 258, f32);
    gelu and ragged C / D / F (F padded to 8 in bf16) at small widths.
    Returns the main case's numbers."""
    import torch

    from repro_torch.kernels import moe_ffn as mf
    from repro_torch.kernels import ref

    dev = "cuda"
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)

    def case(label, e, c, d, f, dt, activation="swiglu", twice=False):
        dname = str(dt).split(".")[1]
        buf, dy = rn(e, c, d).to(dt), rn(e, c, d).to(dt)
        ws = []
        for rows, cols in ((d, f), (d, f), (f, d)):
            w = torch.empty((e, rows, cols), dtype=dt, device=dev)
            for i in range(e):          # an expert at a time: no f32 stack
                w[i] = (rn(rows, cols) * rows ** -0.5).to(dt)
            ws.append(w)
        args = (buf, *ws, dy)
        call = lambda: mf.moe_ffn_bwd(*args, activation=activation)
        got = call()
        if twice:
            again = call()
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, again)), (
                f"moe_ffn_bwd {label}: two calls differ")
            del again
        want = ref.moe_ffn_bwd_ref(*(t.double() for t in args),
                                   activation=activation)
        torch.cuda.synchronize()
        tol = TOL_MOE_BWD_BF16 if dt == torch.bfloat16 else TOL_BWD
        err = max(_check_scaled("moe_ffn_bwd", f"{label} {n}", g, y, tol)
                  for n, g, y in zip(("dbuf", "dw_gate", "dw_up", "dw_down"),
                                     got, want))
        del want
        torch.cuda.empty_cache()
        # eight products of 2 E C D F (g, u, dh, dX's two, three dW)
        bound = _bound(_nbytes(*args, *got), 8 * 2.0 * e * c * d * f, dname)
        if twice:
            _print_launches("moe_ffn_bwd", label, call)
        lib = lambda: moe_bwd_library(*args, activation)
        res = (err, bench.ms(call), bound,
               bench.ms(lambda: ref.moe_ffn_bwd_ref(*args,
                                                    activation=activation),
                        budget_ms=1.0),
               bench.ms(lib) if dt == torch.bfloat16 else None)
        _report("moe_ffn_bwd", label, dname, *res,
                path=_tc_path(dt) + (", bitwise equal twice" if twice
                                     else ""))
        del got, args, ws
        torch.cuda.empty_cache()
        return res

    main = {"moe_ffn_bwd": case("5t-m e8 c2049 d4096 f14336", 8, 2049, 4096,
                                14336, torch.bfloat16, twice=True)}
    case("5t-eq-m e8 c258 d4096 f14336 f32", 8, 258, 4096, 14336,
         torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        case("ragged e4 c37 d72 f100", 4, 37, 72, 100, dt)
        case("gelu e3 c130 d136 f200", 3, 130, 136, 200, dt, "gelu")
        case("one token e2 c1 d64 f64", 2, 1, 64, 64, dt)
    return main


# phase 2's flash cases with a query offset (context parallelism: a
# rank's block of Sq queries at positions offset + i over all Skv keys):
# (Sq, Skv, offsets, head dims, windows, heads q / kv)
FLASH_OFFSET = (1024, 4096, (1024, 3072), (128, 240, 256), (None, 1024),
                (8, 2))


def flash_offset_cases(bench, rn) -> None:
    """``flash_attention`` and ``flash_attention_bwd`` with ``q_offset``
    against their plain versions at ``FLASH_OFFSET`` (bf16, the model's
    (B, S, H, d) views; two f32 cases for the exact kernels), within
    ``TOL``; each line times the kernel, its bound (its visible pairs,
    ``ref.visible_pairs``), the plain version and the library call on the
    same rows (``scaled_dot_product_attention`` under the block's mask).
    Then ``q_offset = 0`` against the call without it, bitwise, forward
    and backward."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref

    sq, skv, offsets, dims, windows, (hq, hkv) = FLASH_OFFSET

    def case(d, off, window, dt):
        dname = str(dt).split(".")[1]
        label = f"sq{sq} at {off} skv{skv} d{d} w{window}"
        q = rn(1, sq, hq, d, dt=dt).transpose(1, 2)
        k, v = (rn(1, skv, hkv, d, dt=dt).transpose(1, 2) for _ in range(2))
        dout = rn(1, sq, hq, d, dt=dt).transpose(1, 2)
        kw = dict(causal=True, window=window, q_offset=off)
        got, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                                 **kw)
        torch.cuda.synchronize()
        err = _check("flash_attention q_offset", label, got, want, dname)
        _check("flash_attention q_offset lse", label, lse, want_lse,
               "float32")
        pairs = ref.visible_pairs(sq, skv, True, window, off)
        i = off + torch.arange(sq, device="cuda")[:, None]
        j = torch.arange(skv, device="cuda")[None, :]
        okm = (j <= i) & ((j > i - window) if window else True)
        ke, ve = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve,  # noqa: E731
                                                     attn_mask=okm)
        _report("flash_attention q_offset", label, dname, err,
                bench.ms(lambda: fa.flash_attention(q, k, v, **kw)),
                _bound(_nbytes(q, k, v, got), 4.0 * hq * d * pairs, dname),
                bench.ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
                bench.ms(lib), path=_tc_path(dt))
        out = want.transpose(1, 2).contiguous().transpose(1, 2)
        gb = fb.flash_attention_bwd(q, k, v, out, want_lse, dout, **kw)
        wb = ref.flash_attention_bwd_ref(q, k, v, out, want_lse, dout, **kw)
        torch.cuda.synchronize()
        err = max(_check("flash_attention_bwd q_offset", f"{label} {n}", g,
                         w, dname) for n, g, w in zip(("dq", "dk", "dv"),
                                                      gb, wb))
        ql, kl, vl = (t.detach().clone().requires_grad_(True)
                      for t in (q, ke, ve))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=okm)
        _report("flash_attention_bwd q_offset", label, dname, err,
                bench.ms(lambda: fb.flash_attention_bwd(
                    q, k, v, out, want_lse, dout, **kw)),
                _bound(_nbytes(q, k, v, out, dout, want_lse, *gb),
                       10.0 * hq * d * pairs, dname),
                bench.ms(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, out, want_lse, dout, **kw)),
                bench.ms(lambda: torch.autograd.grad(
                    lib_out, (ql, kl, vl), dout, retain_graph=True)),
                path=_tc_path(dt))
        del ql, kl, vl, lib_out
        # q_offset 0 against the call without it, bitwise
        kw0 = dict(causal=True, window=window)
        a, la = fa.flash_attention(q, k, v, return_lse=True, **kw0)
        b, lb = fa.flash_attention(q, k, v, return_lse=True, q_offset=0,
                                   **kw0)
        ga = fb.flash_attention_bwd(q, k, v, a, la, dout, **kw0)
        gz = fb.flash_attention_bwd(q, k, v, a, la, dout, q_offset=0, **kw0)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(la, lb) and all(
            torch.equal(x, y) for x, y in zip(ga, gz)), label

    for d in dims:
        for off in offsets:
            for window in windows:
                case(d, off, window, torch.bfloat16)
    for d in (128, 256):             # the exact kernels
        case(d, offsets[-1], windows[-1], torch.float32)
    print(f"  flash q_offset 0 == no offset, bitwise: True "
          f"({len(dims) * len(offsets) * len(windows) + 2} cases)",
          flush=True)


# phase 2: decode_attention over one rank's block of a decode_32k cache
# on the single pod (16, 16): the batch over "data" (8 of 128 rows), the
# sequence over "model" (2048 of 32768 slots), every kv head; m 1
DECODE_OFFSET = {"gemma3-12b": (8, 2048, 16, 8, 240),   # B, S_r, Hq, Hkv, d
                 "llama3-405b": (8, 2048, 128, 8, 128)}
DECODE_OFFSET_LEN = 5000      # the sequences' length (global)
DECODE_OFFSETS = ((2048, "ends before the length"), (4096, "straddles it"),
                  (6144, "wholly past it"))


def decode_offset_cases(bench, rn) -> None:
    """``decode_attention`` with ``kv_offset`` and ``return_lse`` (a
    rank's slice of a cache split over the sequence) against its plain
    version, output and log-sum-exp, in bf16 and f32 at
    ``DECODE_OFFSET``'s two blocks: a slice that ends before the
    sequences' length, one that straddles it and one wholly past it (no
    visible key: output 0, lse -inf); one tree at an offset whose buffer
    lies half outside the slice.  Each bf16 line times the kernel, its
    bound (the slice's rows that hold keys, read once), the plain
    version and ``scaled_dot_product_attention`` over the slice under
    the same mask.  Then offset 0 with its lse against the call without
    them, bitwise."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref

    def case(label, b, s_r, hq, hkv, d, m, off, lengths, dt, anc=None,
             timed=True):
        dname = str(dt).split(".")[1]
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
        q = rn(b, m, hq, d, dt=dt).transpose(1, 2)
        k, v = (rn(b, s_r, hkv, d, dt=dt).transpose(1, 2) for _ in range(2))
        ab = None if anc is None else torch.as_tensor(anc, dtype=torch.int32,
                                                      device="cuda")
        amask = None if ab is None else ref.anc_mask_from_bits(ab, m)
        call = lambda: da.decode_attention(  # noqa: E731
            q, k, v, lengths, anc_bits=ab, kv_offset=off, return_lse=True)
        plain = lambda: ref.decode_attention_ref(  # noqa: E731
            q, k, v, lengths, anc_mask=amask, kv_offset=off, return_lse=True)
        (got, lse), (want, want_lse) = call(), plain()
        torch.cuda.synchronize()
        err = _check("decode_attention offset", label, got, want, dname)
        empty = torch.isinf(want_lse)
        assert torch.equal(torch.isinf(lse), empty), label
        assert bool((got.float()[empty] == 0).all()), label
        _check("decode_attention offset lse", label,
               torch.where(empty, 0.0, lse), torch.where(empty, 0.0, want_lse),
               "float32", tol=TOL[dname])
        if not timed:
            print(f"  decode_attention offset  {label:<44} {dname:<8} "
                  f"err={err:.2e} (lse -inf rows {int(empty.sum())})",
                  flush=True)
            return
        kpos = off + torch.arange(s_r, device="cuda")[None, None, :]
        ln = lengths.long()[:, None, None]
        qpos = ln - m + torch.arange(m, device="cuda")[None, :, None]
        vis = (kpos <= qpos) & (kpos < ln)
        rows = float((lengths.long() - off).clamp(0, s_r).sum())
        bound = _bound(2.0 * hkv * d * k.element_size() * rows
                       + _nbytes(q, got, lse, lengths),
                       4.0 * hq * d * float(vis.sum()), dname)
        ke, ve = (t.repeat_interleave(hq // hkv, 1) for t in (k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, ke, ve, attn_mask=vis[:, None])
        _report("decode_attention offset", label, dname, err, bench.ms(call),
                bound, bench.ms(plain), bench.ms(lib), path=_tc_path(dt))

    for name, (b, s_r, hq, hkv, d) in DECODE_OFFSET.items():
        print(f"  decode_attention offset  {name}: grid n_split "
              f"{da.n_split(b, hkv, s_r)} for S_r {s_r}", flush=True)
        for off, where in DECODE_OFFSETS:
            for dt in (torch.bfloat16, torch.float32):
                case(f"{name} b{b} S_r{s_r} at {off} ({where})", b, s_r, hq,
                     hkv, d, 1, off, [DECODE_OFFSET_LEN] * b, dt,
                     timed=dt == torch.bfloat16)
    for dt in (torch.bfloat16, torch.float32):
        case("tree m4 at 640, buffer half outside", 2, 640, 4, 2, 64, 4, 640,
             [1282, 1283], dt, anc=[1, 3, 5, 11], timed=False)
    # offset 0 with its lse: the output of the call without them, bitwise
    for dt in (torch.bfloat16, torch.float32):
        q = rn(4, 5, 32, 128, dt=dt).transpose(1, 2)
        k, v = (rn(4, 640, 8, 128, dt=dt).transpose(1, 2) for _ in range(2))
        lengths = torch.tensor([640, 300, 77, 5], dtype=torch.int32,
                               device="cuda")
        a = da.decode_attention(q, k, v, lengths)
        b_, _ = da.decode_attention(q, k, v, lengths, kv_offset=0,
                                    return_lse=True)
        torch.cuda.synchronize()
        assert torch.equal(a, b_), dt
    print("  decode_attention offset 0 with lse == the call without them, "
          "bitwise: True (bf16, f32)", flush=True)


def flash_bwd_cases(bench, rn):
    """The flash backward kernel against ``flash_attention_bwd_ref`` on the
    same q, k, v, output, log-sum-exp (the plain forward's) and output
    gradient: Gemma-3-12B's training shapes (5t: B 2, S 4096, d 240, 16 /
    8 heads, window 1024 and global; 5t-eq's f32 S 1281), Mistral widths
    at d 128, Whisper's encoder (bidirectional T 1500) and its cross
    attention (Sq 448 over 1500; 5t-w), the launcher's d 32 (5t-l), and
    partial tiles at S 100.  Each line gives the worst of dq / dk / dv
    against the tolerance (``TOL``, elementwise abs + rel), the kernel's
    ms, its bound (5 products of 2 Sq Skv_live d per (b, q head); q, k,
    v, o, dO, lse read and dq, dk, dv written), the plain version's ms and
    the library yardstick: the backward alone of
    ``scaled_dot_product_attention`` under the same mask (K / V repeated
    to the query heads).  The Gemma window case and the Mistral case are
    made twice and their outputs must be bitwise equal.  The edges of the
    bf16 kernels' tiles at d 128 and 240: Sq and Skv of 63, 65 and 129
    under a causal mask (Sq < Skv and Sq > Skv among them), a window of 23
    (under a tile, no multiple of 16), Sq > Skv bidirectional, g 1 and g
    8.  Returns the main case's numbers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention_bwd as fb
    from repro_torch.kernels import ref

    def case(label, b, hq, hkv, sq, d, causal, window, dt, skv=None,
             twice=False):
        dname = str(dt).split(".")[1]
        skv = sq if skv is None else skv
        q, k, v = (rn(b, s_, h, d, dt=dt).transpose(1, 2)
                   for h, s_ in ((hq, sq), (hkv, skv), (hkv, skv)))
        dout = rn(b, sq, hq, d, dt=dt).transpose(1, 2)
        kw = dict(causal=causal, window=window)
        out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        out = out.transpose(1, 2).contiguous().transpose(1, 2)
        got = fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        err = max(_check("flash_attention_bwd", f"{label} {n}", g, w, dname)
                  for n, g, w in zip(("dq", "dk", "dv"), got, want))
        if twice:
            again = fb.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, again)), (
                f"flash_attention_bwd {label}: two calls differ")
        qp = np.arange(sq)[:, None]
        kp = np.arange(skv)[None, :]
        okm = np.ones((sq, skv), bool)
        if causal:
            okm &= kp <= qp
        if window is not None:
            okm &= kp > qp - window
        pairs = int(okm.sum())
        bound = _bound(_nbytes(q, k, v, out, dout, lse, *got),
                       10.0 * b * hq * d * pairs, dname)
        g = hq // hkv
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in
                      (q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)))
        mask = (None if (causal and window is None) or not (causal or window)
                else torch.as_tensor(okm, device="cuda"))
        lib_out = F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask,
            is_causal=bool(causal and window is None))
        lib = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout,
                                          retain_graph=True)
        r = (err, bench.ms(lambda: fb.flash_attention_bwd(
                 q, k, v, out, lse, dout, **kw)), bound,
             bench.ms(lambda: ref.flash_attention_bwd_ref(
                 q, k, v, out, lse, dout, **kw)), bench.ms(lib))
        _report("flash_attention_bwd", label, dname, *r,
                path=_tc_path(dt) + (", bitwise equal twice" if twice
                                     else ""))
        del ql, kl, vl, lib_out
        return r

    bf16 = torch.bfloat16
    main = case("gemma3 d240 b2 s4096 w1024 (5t SWA)", 2, 16, 8, 4096, 240,
                True, 1024, bf16, twice=True)
    case("gemma3 d240 b2 s4096 global (5t)", 2, 16, 8, 4096, 240, True, None,
         bf16)
    case("gemma3 d240 b1 s1281 w1024 f32 (5t-eq)", 1, 16, 8, 1281, 240, True,
         1024, torch.float32)
    case("gemma3 d240 b1 s1281 global f32 (5t-eq)", 1, 16, 8, 1281, 240,
         True, None, torch.float32)
    case("mistral d128 b1 32/8 s4096", 1, 32, 8, 4096, 128, True, None, bf16,
         twice=True)
    # RecurrentGemma-2B's attention layers (5t-r): MQA, g 10, window 2048
    case("recurrentgemma d256 b2 10/1 s4096 w2048 (5t-r)", 2, 10, 1, 4096,
         256, True, 2048, bf16, twice=True)
    case("whisper encoder b4 T1500 d64 bidir (5t-w)", 4, 8, 8, 1500, 64,
         False, None, bf16)
    case("whisper cross b4 sq448 skv1500 d64 (5t-w)", 4, 8, 8, 448, 64, False,
         None, bf16, skv=1500)
    case("whisper decoder b4 s448 d64 causal (5t-w)", 4, 8, 8, 448, 64, True,
         None, bf16)
    for dt in (torch.float32, bf16):
        case("launcher d32 b8 hq4 hkv2 s64 w64 (5t-l)", 8, 4, 2, 64, 32, True,
             64, dt)
    for d in (32, 64, 128, 240, 256):        # partial tiles
        for causal, window in ((True, None), (True, 40), (False, None)):
            case(f"edge s100 d{d} c{int(causal)} w{window}", 1, 4, 2, 100, d,
                 causal, window, bf16)
    case("edge s100 d64 c1 wNone f32", 1, 4, 2, 100, 64, True, None,
         torch.float32)
    case("edge sq100 skv70 d128 bidir f32", 1, 4, 2, 100, 128, False, None,
         torch.float32, skv=70)
    case("edge sq70 skv100 d128 c1 (Sq < Skv)", 1, 4, 2, 70, 128, True, None,
         bf16, skv=100)
    for d in (128, 240):        # the edges of the wgmma kernels' tiles
        for sq, skv in ((63, 63), (65, 65), (129, 129), (65, 129), (129, 65)):
            case(f"edge sq{sq} skv{skv} d{d} c1", 1, 4, 2, sq, d, True, None,
                 bf16, skv=skv)
        case(f"edge s129 d{d} c1 w23", 1, 4, 2, 129, d, True, 23, bf16)
        case(f"edge sq129 skv65 d{d} bidir", 1, 4, 2, 129, d, False, None,
             bf16, skv=65)
        case(f"edge s200 d{d} g1 c1", 1, 4, 4, 200, d, True, None, bf16)
        case(f"edge s200 d{d} g8 c1 w23", 1, 8, 1, 200, d, True, 23, bf16)
    return main


# ---------------------------------------------------------------------------
# phase 3 / 4: serving


def _engine(tcfg, dcfg, config, seed, hw=None):
    import torch

    from repro_torch.params import init_params
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.sim.hardware import ENV1
    eng = ServingEngine(tcfg, dcfg, hw or ENV1, config=config, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    eng.load(init_params(tcfg, g, "cuda"), init_params(dcfg, g, "cuda"))
    return eng


def _free() -> None:
    """Give the memory of a run's dropped engine and weights back to the
    card before the next run allocates."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _graph_line(st) -> str:
    return (f"graph_captures={st['graph_captures']} (capture wall "
            f"{st['capture_s']:.3f}s)")


def _check_graphs(label, st, graphs=None) -> None:
    """A run on the default route captured the round (fused and, chain,
    rollback graphs); ``graphs=False`` captured none."""
    caps = st["graph_captures"]
    if graphs is False:
        assert not any(caps.values()), f"[{label}] eager run captured {caps}"
        return
    assert caps["fused"] > 0, f"[{label}] the round ran eagerly: {caps}"
    assert st["spec_mode"] == "tree" or caps["rollback"] > 0, caps


def serve_run(label, tcfg, dcfg, paged, n_requests, must_launch,
              must_not_launch=(), spec_tree=None, prompt_lens=(512,),
              gen=(32, 64), graphs=None) -> dict:
    """Serve ``n_requests`` Poisson requests (prompts of ``prompt_lens``
    tokens in turn, gen drawn from the ``gen`` range, ends included) with
    ``max_batch=4``, ``n_cand=4`` (or tree speculation of ``spec_tree``),
    the rounds as CUDA graphs (``graphs=False``: eager); every kernel's
    launches are counted from 0 over the run.  Returns {kernel:
    launches}."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serving.engine import SchedulerConfig, latency_percentiles
    from repro_torch.serving.trace import poisson_requests

    t_run = time.perf_counter()
    _free()           # an earlier run's engine left in a reference cycle
    eng = _engine(tcfg, dcfg, SchedulerConfig(max_batch=4, n_cand=4,
                                              paged=paged,
                                              spec_tree=spec_tree,
                                              graphs=graphs), seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size,
                            prompt_lens[i % len(prompt_lens)]).astype(np.int32)
               for i in range(n_requests)]
    gens = rng.integers(gen[0], gen[1] + 1, n_requests).tolist()
    reqs = poisson_requests(prompts, gens, rate_rps=4.0, seed=0)
    for r in reqs:
        assert eng.submit(r), f"request {r.rid} rejected"
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    st = eng.stats()
    fused = st["fused_compiles"]
    ttft = latency_percentiles(done, "ttft_s")
    mode = f"tree {spec_tree}" if spec_tree else "chain"
    print(f"  [{label}] {tcfg.name} {tcfg.n_layers} layers / draft "
          f"{dcfg.n_layers} layers, {'paged' if paged else 'contiguous'}, "
          f"{mode}, {'eager' if graphs is False else 'CUDA graphs'}: "
          f"served {len(done)} requests, {st['tokens_out']} tokens in "
          f"{wall:.3f}s wall: {st['tok_per_s']:.2f} tok/s over "
          f"{st['rounds']} rounds, occupancy {st['mean_occupancy']:.3f}")
    print(f"  [{label}] round p50={1e3 * st['round_s_p50']:.2f}ms "
          f"p95={1e3 * st['round_s_p95']:.2f}ms  ttft p50={ttft['p50']:.3f}s "
          f"p95={ttft['p95']:.3f}s (virtual clock)  acceptance="
          f"{st['acceptance']:.4f}  accepted-length histogram "
          f"{st['accept_hist']}")
    print(f"  [{label}] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  fused shape "
          f"signatures={fused}  {_graph_line(st)}  launches={launches}")
    assert len(done) == len(reqs), "not every request finished"
    _check_graphs(label, st, graphs)
    for r in reqs:
        assert r.result is not None and len(r.result) == r.max_new_tokens
        assert ((r.result >= 0) & (r.result < tcfg.vocab_size)).all()
    assert fused == 1, f"fused round ran at {fused} shape signatures"
    for name in must_launch:
        assert launches[name] > 0, f"{name} was never launched in run {label}"
    for name in must_not_launch:
        assert launches[name] == 0, f"{name} was launched in run {label}"
    if spec_tree is not None and paged:
        # every verify round: one tree launch per target layer, no other
        tree = launches["paged_decode_attention tree"]
        assert tree == tcfg.n_layers * st["rounds"], (
            f"{tree} tree verify launches over {st['rounds']} rounds")
        assert launches["paged_decode_attention causal"] == 0
        print(f"  [{label}] paged_decode_attention with anc_bits: {tree} "
              f"launches = {tcfg.n_layers} layers x {st['rounds']} verify "
              "rounds; decode_attention (the draft's root feed, m 1): "
              f"{launches['decode_attention tree']}")
    n_prefills = len(reqs) + (0 if paged else 2)    # + the parked dummies
    print(f"  [{label}] {n_prefills} prefills, {st['rounds']} rounds; "
          f"run wall {time.perf_counter() - t_run:.1f}s", flush=True)
    RUN_STATS[label] = st
    RUN_STREAMS[label] = {r.rid: r.result.tolist() for r in reqs}
    del eng, done
    _free()
    return launches


# ---------------------------------------------------------------------------
# phase 3: the offload tier (target layers streamed from host memory)


def _offload_tokens(cfg, torch):
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        (OFFLOAD_B, OFFLOAD_PROMPT)),
                           device="cuda")


def offload_eq_run(label) -> None:
    """Mixtral-8x7B at ``OFFLOAD_EQ_LAYERS`` layers: the weights drawn
    layer by layer into host memory equal ``init_params``'s; the streamed
    prefill and ``OFFLOAD_STEPS`` greedy decode + commit steps give the
    resident model's logits bit for bit; ``host_attention_direct`` on
    host KV agrees with the plain attention on the card."""
    import torch

    from repro_torch.configs import MIXTRAL_8X7B
    from repro_torch.core.offload import (OffloadedModel,
                                          host_attention_direct, tree_leaves)
    from repro_torch.models import model as M
    from repro_torch.models.attention import attention_direct
    from repro_torch.models.transformer import init_cache
    from repro_torch.params import init_params

    t_run = time.perf_counter()
    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=OFFLOAD_EQ_LAYERS)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    om = OffloadedModel(cfg, params, "cuda")
    drawn = OffloadedModel.from_seed(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    for a, b in zip(tree_leaves(om.layers_host),
                    tree_leaves(drawn.layers_host)):
        assert a.is_pinned() and b.is_pinned() and torch.equal(a, b), (
            f"[{label}] layer-by-layer draw differs from init_params")
    for a, b in zip(tree_leaves(drawn.params_resident),
                    tree_leaves({k: v for k, v in params.items()
                                 if k != "layers"})):
        assert torch.equal(a, b), f"[{label}] resident weights differ"
    drawn.close()
    del drawn
    toks = _offload_tokens(cfg, torch)
    ca = init_cache(cfg, OFFLOAD_B, OFFLOAD_MAX_LEN, "cuda")
    cb = init_cache(cfg, OFFLOAD_B, OFFLOAD_MAX_LEN, "cuda")
    la, ca = M.prefill(params, cfg, toks, ca)
    lb, cb = om.prefill(toks, cb)
    assert torch.equal(la, lb), f"[{label}] streamed prefill logits differ"
    tok = torch.argmax(la, -1)[:, None]
    ones = torch.ones((OFFLOAD_B,), dtype=torch.int64, device="cuda")
    streams = []
    for step in range(OFFLOAD_STEPS):
        la, ca = M.decode_step(params, cfg, ca, tok)
        lb, cb, pend = om.decode(cb, tok)
        cb = M.commit(cfg, cb, pend, ones, 1)
        assert torch.equal(la, lb[:, 0]), (
            f"[{label}] streamed decode logits differ at step {step}")
        tok = torch.argmax(la, -1)[:, None]
        assert torch.equal(tok, torch.argmax(lb[:, 0], -1)[:, None])
        streams.append(tok[:, 0].tolist())
    h2d = om.settle()["h2d"]
    print(f"  [{label}] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, 2 "
          f"slots: layer-by-layer draw == init_params (bitwise, pinned); "
          f"streamed "
          f"prefill + {OFFLOAD_STEPS} decode steps == resident (logits "
          f"bitwise, greedy tokens {streams}); h2d {h2d['bytes']:.0f} B "
          f"= {1 + OFFLOAD_STEPS} passes x {om.streamed_bytes()} B",
          flush=True)
    assert h2d["bytes"] == (1 + OFFLOAD_STEPS) * om.streamed_bytes()
    om.close()
    del om, params, ca, cb
    _free()
    # attention over a host-resident KV cache at 3f's decode shape, f32
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((OFFLOAD_B, 1, 32, 128), generator=gen, device="cuda")
    k = torch.randn((OFFLOAD_B, OFFLOAD_MAX_LEN, 8, 128), generator=gen,
                    device="cuda")
    v = torch.randn((OFFLOAD_B, OFFLOAD_MAX_LEN, 8, 128), generator=gen,
                    device="cuda")
    lens = torch.tensor([OFFLOAD_PROMPT + 1, OFFLOAD_PROMPT + OFFLOAD_STEPS],
                        device="cuda")
    kpos = torch.arange(OFFLOAD_MAX_LEN, device="cuda")
    mask = torch.where(kpos[None, None, :] < lens[:, None, None], 0.0,
                       float("-inf"))
    scale = 128 ** -0.5
    got = host_attention_direct(q, k.cpu(), v.cpu(), mask, scale)
    want = attention_direct(q, k, v, mask, scale)
    assert got.device == q.device
    err = _check("host_attention_direct", "b2 m1 f32", got, want, "float32",
                 1e-6)
    print(f"  [{label}] host_attention_direct (KV on the host) vs plain "
          f"attention on the card, B {OFFLOAD_B} m 1 Hq 32 Hkv 8 d 128 S "
          f"{OFFLOAD_MAX_LEN} f32: max abs err {err:.2e} (tol 1e-6); run wall "
          f"{time.perf_counter() - t_run:.1f}s", flush=True)


def offload_run(label, rates) -> dict:
    """Mixtral-8x7B at ``OFFLOAD_LAYERS`` layers, bf16, weights from seed
    0 drawn layer by layer and parked in page-locked host memory; a
    streamed prefill of ``OFFLOAD_B`` prompts and ``OFFLOAD_STEPS`` greedy
    decode + commit steps, each pass's wall, link, compute, peak memory
    and launches printed.  Returns the run's launches."""
    import torch

    from repro_torch.configs import MIXTRAL_8X7B
    from repro_torch.core.offload import (OffloadedModel, tree_bytes,
                                          tree_leaves)
    from repro_torch.core.planner import layer_ffn_bytes
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    from repro_torch.sim.hardware import H100

    t_run = time.perf_counter()
    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=OFFLOAD_LAYERS)
    print(f"  [{label}] before parking: MemAvailable "
          f"{_meminfo()['MemAvailable'] / 2**30:.2f} GiB", flush=True)
    t0 = time.perf_counter()
    om = OffloadedModel.from_seed(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    park_s = time.perf_counter() - t0
    leaves = tree_leaves(om.layers_host)
    assert all(t.is_pinned() for t in leaves), "a parked layer is not pinned"
    assert all(not t.is_cuda for t in leaves)
    pinned = sum(f.numel() for f in om._flat)
    d2h = om.transfers["d2h"]
    print(f"  [{label}] {cfg.name} {cfg.n_layers} layers {cfg.dtype} drawn "
          f"layer by layer and parked: {park_s:.2f}s wall, {pinned} B "
          f"page-locked in {len(om._flat)} buffers "
          f"({pinned / 2**30:.2f} GiB), d2h "
          f"{d2h['bytes']:.0f} B in {d2h['seconds']:.3f}s of copies; "
          f"MemAvailable now {_meminfo()['MemAvailable'] / 2**30:.2f} GiB",
          flush=True)
    _free()
    toks = _offload_tokens(cfg, torch)
    cache = init_cache(cfg, OFFLOAD_B, OFFLOAD_MAX_LEN, "cuda")
    resident = tree_bytes(om.params_resident)
    layer_b = max(f.numel() for f in om._flat)
    limit = resident + 3 * layer_b + tree_bytes(cache) + 2 * 2**30
    per_layer_pred = layer_ffn_bytes(cfg) / H100.h2d_bw
    ones = torch.ones((OFFLOAD_B,), dtype=torch.int64, device="cuda")
    om.settle()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    passes, tok = [], None
    for step in range(1 + OFFLOAD_STEPS):
        link0 = dict(om.transfers.get("h2d", {"bytes": 0.0, "seconds": 0.0}))
        busy0 = om.compute_seconds
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if step == 0:
            lg, cache = om.prefill(toks, cache)
        else:
            lg, cache, pend = om.decode(cache, tok)
            cache = M.commit(cfg, cache, pend, ones, 1)
            lg = lg[:, 0]
        tok = torch.argmax(lg, -1)[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h2d = om.settle()["h2d"]
        now = launch_counts()
        n = {k: now[k] - before[k] for k in now}
        before = now
        link_b, link_s = (h2d["bytes"] - link0["bytes"],
                          h2d["seconds"] - link0["seconds"])
        peak = torch.cuda.max_memory_allocated()
        passes.append({"wall": wall, "link_s": link_s,
                       "busy": om.compute_seconds - busy0})
        kind = "prefill" if step == 0 else f"decode {step}"
        print(f"  [{label}] {kind:<9} wall {wall:.4f}s  link {link_s:.4f}s "
              f"{link_b:.0f} B = {link_b / link_s / 1e9:.3f} GB/s (bare h2d "
              f"{rates['h2d'] / 1e9:.3f})  compute span "
              f"{passes[-1]['busy']:.4f}s (idle share "
              f"{1 - passes[-1]['busy'] / wall:.3f})  peak "
              f"{peak / 2**30:.3f} GiB  "
              f"flash {n['flash_attention']} moe_ffn {n['moe_ffn']} "
              f"decode_attention {n['decode_attention']} paged "
              f"{n['paged_decode_attention']}", flush=True)
        assert peak <= limit, (f"[{label}] peak device memory {peak} B over "
                               f"{limit} B")
        want = ({"flash_attention": cfg.n_layers, "moe_ffn": cfg.n_layers,
                 "decode_attention": 0} if step == 0 else
                {"flash_attention": 0, "moe_ffn": cfg.n_layers,
                 "decode_attention": cfg.n_layers})
        want["paged_decode_attention"] = 0
        for name, count in want.items():
            assert n[name] == count, (f"[{label}] {kind}: {name} launched "
                                      f"{n[name]} times, not {count}")
        assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all())
    launches = launch_counts()
    # one more decode step under the profiler: the device's own kernel
    # time in a pass, apart from the compute span (which includes waits
    # for the host) and from the copies
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        lg, cache, pend = om.decode(cache, tok)
        cache = M.commit(cfg, cache, pend, ones, 1)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    om.settle()
    dev = {"kernels": 0.0, "copies": 0.0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            dev["copies" if e.key.startswith("Memcpy") else "kernels"] += us
    dec = passes[1:]
    dec_wall = sum(p["wall"] for p in dec) / len(dec)
    print(f"  [{label}] traced decode step: wall {wall:.4f}s (profiler on), "
          f"device kernels {dev['kernels'] / 1e6:.4f}s, device copies "
          f"{dev['copies'] / 1e6:.4f}s; against the untraced decode "
          f"steps' mean wall {dec_wall:.4f}s the card computes "
          f"{dev['kernels'] / 1e6 / dec_wall:.4f} of a step (idle share "
          f"{1 - dev['kernels'] / 1e6 / dec_wall:.4f})", flush=True)
    assert dev["kernels"] > 0, f"[{label}] the profiler saw no kernel"
    link_per_layer = sum(p["link_s"] for p in dec) / len(dec) / cfg.n_layers
    print(f"  [{label}] per-layer stream: planner (H100 spec, "
          f"t_ffn_stream / n_layers = {layer_ffn_bytes(cfg):.0f} B / "
          f"{H100.h2d_bw / 1e9:.3f} GB/s) {per_layer_pred:.5f}s, measured "
          f"{link_per_layer:.5f}s a layer ({om.streamed_bytes()} B a pass, "
          f"mean of the decode passes); limit on peak memory {limit} B "
          f"({limit / 2**30:.3f} GiB = resident {resident} + 3 layers "
          f"{3 * layer_b} + KV {tree_bytes(cache)} + 2 GiB); launches "
          f"{launches}; run wall {time.perf_counter() - t_run:.1f}s",
          flush=True)
    om.close()
    del om, cache
    _free()
    return launches


def serve_phase(rates) -> dict:
    """Runs 3f, 3f-eq, 3a-3e, 3g, 3g-tr, then the families' 3h-3j;
    returns {run label: launches}."""
    from repro_torch.configs import (MIXTRAL_8X7B, RECURRENTGEMMA_2B,
                                     RWKV6_7B, SWA, draft_for)

    # 3f first: it page-locks 21.6 GiB of the host's memory, before any
    # other run has touched the host
    runs = {"3f": offload_run("3f", rates)}
    offload_eq_run("3f-eq")
    mix = dataclasses.replace(MIXTRAL_8X7B, n_layers=SERVE_LAYERS)
    mis = draft_for(mix, SERVE_LAYERS)
    # decode_attention: the draft's one-token steps over its rings
    runs["3a"] = serve_run("3a", mix, mis, True, 12,
                           ("paged_decode_attention", "flash_attention",
                            "moe_ffn", "decode_attention"))
    # 3a-e: the same requests on the eager round; the streams must agree
    serve_run("3a-e", mix, mis, True, 12,
              ("paged_decode_attention", "flash_attention", "moe_ffn",
               "decode_attention"), graphs=False)
    for rid, toks in RUN_STREAMS["3a"].items():
        assert RUN_STREAMS["3a-e"][rid] == toks, f"request {rid}: 3a-e != 3a"
    g, e = RUN_STATS["3a"], RUN_STATS["3a-e"]
    print(f"  [3a-e] {len(RUN_STREAMS['3a'])} streams equal 3a's request by "
          f"request; round p50 graphs {1e3 * g['round_s_p50']:.2f}ms / eager "
          f"{1e3 * e['round_s_p50']:.2f}ms, tok/s {g['tok_per_s']:.2f} / "
          f"{e['tok_per_s']:.2f}", flush=True)
    rwkv = dataclasses.replace(RWKV6_7B, n_layers=RECURRENT_SERVE_LAYERS[0])
    rw_draft = draft_for(rwkv, 2)
    runs["3b"] = serve_run("3b", rwkv, rw_draft, False, 8,
                           ("wkv6", "wkv6 serial", "wkv6 chunked",
                            "flash_attention"))
    # RWKV has no attention: every flash launch is the draft's prefill
    assert runs["3b"]["flash_attention"] == 2 * (8 + 2)
    rgem = dataclasses.replace(RECURRENTGEMMA_2B,
                               n_layers=RECURRENT_SERVE_LAYERS[1])
    rg_draft = draft_for(rgem, 2)
    runs["3c"] = serve_run("3c", rgem, rg_draft, False, 8,
                           ("rglru_gated_scan", "rglru_gated_scan serial",
                            "rglru_gated_scan parallel", "flash_attention"),
                           ("rglru_scan",))
    # one flash launch per attention layer per prefill (8 requests + the 2
    # parked dummies): the target's SWA layers run it at head dim 256
    n_swa = sum(rgem.layer_kind(l) == SWA for l in range(rgem.n_layers))
    assert runs["3c"]["flash_attention"] == (n_swa + 2) * (8 + 2)
    print(f"  [3c] flash launches at head dim 256 (target SWA prefill): "
          f"{n_swa * (8 + 2)} of {runs['3c']['flash_attention']}")
    runs["3d"] = serve_run("3d", mix, mis, False, 8,
                           ("decode_attention", "flash_attention", "moe_ffn"),
                           ("paged_decode_attention",))
    # tree speculation needs an all-attention draft (as the JAX serving
    # bench makes it)
    mis_attn = dataclasses.replace(mis,
                                   layer_pattern=("attn",) * mis.n_layers)
    runs["3e"] = serve_run("3e", mix, mis_attn, True, 8,
                           ("paged_decode_attention", "flash_attention",
                            "moe_ffn", "paged_decode_attention tree"),
                           spec_tree=TREE)
    async_run("3g")
    traced_run("3g-tr")
    runs["3h"] = gemma_run("3h")
    family_runs()
    whisper_run("3j")
    return runs


# ---------------------------------------------------------------------------
# phase 3: the other model families


# 3h: Gemma-3-12B's depth cut from 48 to 24 layers (4 groups of the
# pattern) to pay for phase 6's mesh runs (6d, 6e), to 12 (2 groups) for
# 6f / 6g
GEMMA_SERVE_LAYERS = 12


def gemma_run(label) -> dict:
    """Gemma-3-12B at full width, ``GEMMA_SERVE_LAYERS`` of its 48 layers
    (10 sliding-window layers of window 1024 and 2 global ones, 16 / 8
    heads of 240, F 15360, vocabulary 262144), bf16, weights from a
    seed, beside a
    2-layer Mistral-7B-width draft: 8 Poisson requests, prompts of 512
    and 1280 in turn (the window binds, and the rings wrap in prefill and
    in verify), paged chain.  Every flash launch of the target and every
    paged verify launch is at head dim 240."""
    from repro_torch.configs import ATTN, GEMMA3_12B, draft_for
    tcfg = dataclasses.replace(GEMMA3_12B, n_layers=GEMMA_SERVE_LAYERS)
    dcfg = draft_for(tcfg, 2)
    n = 8
    # decode_attention: the draft's one-token steps over its rings (the
    # target's local layers verify 5 tokens a round on the plain path)
    launches = serve_run(label, tcfg, dcfg, True, n,
                         ("paged_decode_attention", "flash_attention",
                          "decode_attention"), ("moe_ffn",),
                         prompt_lens=(512, 1280))
    rounds = RUN_STATS[label]["rounds"]
    n_attn = sum(tcfg.layer_kind(l) == ATTN for l in range(tcfg.n_layers))
    # one flash launch per attention layer per prefill: the target's at
    # head dim 240, the draft's 2 at 128
    assert launches["flash_attention"] == (tcfg.n_layers + dcfg.n_layers) * n
    # every verify round: one launch per global layer (the draft has none)
    paged = launches["paged_decode_attention"]
    assert paged == n_attn * rounds, (paged, rounds)
    print(f"  [{label}] head dim 240: flash {tcfg.n_layers * n} launches "
          f"(target prefill; {dcfg.n_layers * n} more for the draft at 128), "
          f"paged_decode_attention {paged} launches = {n_attn} global "
          f"layers x {rounds} verify rounds", flush=True)
    return launches


# 3i: each other decoder-only family at its published widths, its depth
# cut to 2 layers (Llama-4 Maverick: one (dense, MoE) group)
FAMILIES = ("chameleon-34b", "phi3-medium-14b", "starcoder2-7b",
            "llama3-405b", "phi3.5-moe-42b-a6.6b",
            "llama4-maverick-400b-a17b")


def family_runs() -> None:
    from repro_torch.configs import draft_for, get_config
    for name in FAMILIES:
        full = get_config(name)
        tcfg = dataclasses.replace(full, n_layers=2)
        print(f"  [3i] {name}: D {tcfg.d_model}, {tcfg.n_heads} / "
              f"{tcfg.n_kv_heads} heads of {tcfg.head_dim}, F {tcfg.d_ff}, "
              f"vocabulary {tcfg.vocab_size}"
              + (f", {tcfg.n_experts} experts top-{tcfg.top_k}"
                 if tcfg.is_moe else "")
              + f"; depth cut to 2 of {full.n_layers} layers "
              f"({tcfg.param_count() / 1e9:.2f} G parameters)", flush=True)
        moe = ("moe_ffn",) if tcfg.is_moe else ()
        serve_run(f"3i-{name}", tcfg, draft_for(tcfg, 2), True, 4,
                  ("paged_decode_attention", "flash_attention") + moe,
                  () if moe else ("moe_ffn",), gen=(32, 32))


WHISPER_B, WHISPER_PROMPT, WHISPER_STEPS = 4, 4, 32
WHISPER_MAX_LEN = 448                 # the decoder's design maximum


def whisper_run(label) -> None:
    """Whisper-base at full width and depth (6 + 6 layers, d 512,
    encoder_len 1500), bf16, weights from a seed: ``WHISPER_B`` stub
    frame embeddings, the encoder alone (timed), a prefill of
    ``WHISPER_PROMPT`` tokens with the frames, then ``WHISPER_STEPS``
    greedy ``decode_step``s reading the cross K/V from the cache."""
    import torch

    from repro_torch.configs import WHISPER_BASE
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as M
    from repro_torch.models.encdec import apply_encoder
    from repro_torch.models.transformer import init_cache
    from repro_torch.params import init_params

    t_run = time.perf_counter()
    cfg = WHISPER_BASE
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, "cuda")
    frames = torch.randn((WHISPER_B, cfg.encoder_len, cfg.d_model),
                         generator=g, device="cuda").to(cfg.torch_dtype)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (WHISPER_B, WHISPER_PROMPT)),
                             device="cuda")
    apply_encoder(params["encoder"], cfg, frames)          # warm
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    enc = apply_encoder(params["encoder"], cfg, frames)
    torch.cuda.synchronize()
    enc_wall = time.perf_counter() - t0
    n_enc = launch_counts()["flash_attention"]
    assert n_enc == cfg.n_encoder_layers, n_enc
    assert enc.shape == frames.shape and bool(torch.isfinite(enc).all())
    cache = init_cache(cfg, WHISPER_B, WHISPER_MAX_LEN, "cuda")
    reset_launches()
    t0 = time.perf_counter()
    lg, cache = M.prefill(params, cfg, prompt, cache, encoder_frames=frames)
    torch.cuda.synchronize()
    pre_wall = time.perf_counter() - t0
    pre = launch_counts()
    # encoder, decoder self attention and cross attention: one each a layer
    assert pre["flash_attention"] == cfg.n_encoder_layers + 2 * cfg.n_layers
    assert all(bool(c["ck"].abs().sum() > 0) for c in cache["layers"])
    reset_launches()
    toks = []
    t0 = time.perf_counter()
    for _ in range(WHISPER_STEPS):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        lg, cache = M.decode_step(params, cfg, cache, tok[:, None])
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) / WHISPER_STEPS
    dec = launch_counts()
    assert dec["flash_attention"] == cfg.n_layers * WHISPER_STEPS   # cross
    assert dec["decode_attention"] == cfg.n_layers * WHISPER_STEPS  # self
    assert bool(torch.isfinite(lg).all())
    assert cache["pos"].tolist() == [WHISPER_PROMPT + WHISPER_STEPS] * \
        WHISPER_B
    toks = torch.stack(toks, 1)
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    print(f"  [{label}] {cfg.name} {cfg.n_encoder_layers} + {cfg.n_layers} "
          f"layers {cfg.dtype}, B {WHISPER_B} x {cfg.encoder_len} frames: "
          f"encoder {enc_wall:.4f}s wall ({n_enc} flash launches, "
          f"bidirectional, T {cfg.encoder_len} d {cfg.head_dim}); prefill of "
          f"{WHISPER_PROMPT} tokens {pre_wall:.4f}s ({pre['flash_attention']} "
          f"flash launches); {WHISPER_STEPS} decode steps "
          f"{1e3 * step_wall:.3f} ms a step (flash {dec['flash_attention']} "
          f"cross-attention launches, decode_attention "
          f"{dec['decode_attention']}); tokens of row 0 "
          f"{toks[0, :8].tolist()}...; run wall "
          f"{time.perf_counter() - t_run:.1f}s", flush=True)
    del params, cache, frames, enc
    _free()


def _check_obs_exports(label, eng) -> None:
    """The metrics snapshot, the Prometheus text and every request
    timeline pass the port's validators; the registry reports one fused
    shape."""
    from repro_torch.obs.schema import (parse_prometheus_text,
                                        validate_metrics_snapshot,
                                        validate_request_timeline)
    snap = eng.metrics()["metrics"]
    probs = validate_metrics_snapshot(snap)
    assert probs == [], f"[{label}] metrics snapshot: {probs}"
    prom = parse_prometheus_text(eng.prometheus())
    fused = prom["pipeline_traces_total"]["samples"][(("entry", "fused"),)]
    assert fused == 1.0, f"[{label}] pipeline_traces_total fused={fused}"
    for tl in eng.request_timelines():
        probs = validate_request_timeline(tl)
        assert probs == [], f"[{label}] timeline {tl.get('rid')}: {probs}"
    print(f"  [{label}] metrics snapshot, Prometheus text "
          f"({len(prom)} series) and {len(eng.request_timelines())} request "
          'timelines valid; pipeline_traces_total{entry="fused"} = 1')


def async_run(label) -> None:
    """The asyncio front door at 3a's widths: tenant "batch" (priority 1,
    12 requests, prompt 512, gen 64, all at t = 0) fills the 8 slots and
    queues 4; tenant "interactive" (priority 0, 4 requests, prompt 512,
    gen 32, Poisson 4/s from t = 1 s) arrives while every slot is live and
    preempts.  Real clock, QoS, preemption, metrics, request timelines and
    a TTFT objective for "interactive"; replayed open loop at speed 1."""
    import asyncio

    import torch

    from repro_torch.configs import MIXTRAL_8X7B, draft_for
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.obs import SLO
    from repro_torch.serving.engine import SchedulerConfig
    from repro_torch.serving.server import AsyncServingServer
    from repro_torch.serving.trace import replay_open_loop
    from repro_torch.sim.hardware import H100

    t_run = time.perf_counter()
    mix = dataclasses.replace(MIXTRAL_8X7B, n_layers=SERVE_LAYERS)
    mis = draft_for(mix, SERVE_LAYERS)
    config = SchedulerConfig(
        max_batch=4, n_cand=4, clock="real", qos=True, preempt=True,
        preempt_min_remaining=4,
        tenant_weights={"batch": 1.0, "interactive": 2.0}, metrics=True,
        request_timeline=True,
        slos=(SLO("interactive_ttft_p95", "ttft_s", SLO_TTFT_INTERACTIVE,
                  tenant="interactive"),))
    eng = _engine(mix, mis, config, seed=0, hw=H100)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mix.vocab_size, 512).astype(np.int32)
               for _ in range(16)]
    arrive = 1.0 + np.cumsum(rng.exponential(1.0 / 4.0, 4))
    from repro_torch.serving.engine import ServeRequest
    reqs = ([ServeRequest(i, prompts[i], 64, tenant="batch", priority=1)
             for i in range(12)]
            + [ServeRequest(12 + i, prompts[12 + i], 32,
                            arrival_s=float(arrive[i]),
                            tenant="interactive", priority=0)
               for i in range(4)])

    async def drive():
        async with AsyncServingServer(eng, max_queue=16) as srv:
            tokens, handles = await replay_open_loop(srv, reqs, speed=1.0)
            return tokens, handles, srv.tenant_report()

    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokens, handles, report = asyncio.run(drive())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    st = eng.stats()
    print(f"  [{label}] {mix.name} {mix.n_layers} layers / draft "
          f"{mis.n_layers} layers, paged, real clock, hw {eng.hw.name}: "
          f"async-served {len(handles)} requests, {st['tokens_out']} tokens "
          f"in {wall:.3f}s wall: {st['tok_per_s']:.2f} tok/s over "
          f"{st['rounds']} rounds, occupancy {st['mean_occupancy']:.3f}, "
          f"round p50={1e3 * st['round_s_p50']:.2f}ms "
          f"p95={1e3 * st['round_s_p95']:.2f}ms")
    for t, d in report.items():
        print(f"  [{label}] tenant {t}: {d['requests']} requests, "
              f"{d['tokens']} tokens, {d['preemptions']} preemptions; ttft "
              f"p50={d['ttft_s']['p50']:.4f}s p95={d['ttft_s']['p95']:.4f}s;"
              f" e2e p50={d['e2e_s']['p50']:.3f}s "
              f"p95={d['e2e_s']['p95']:.3f}s")
    slo = eng.slo_report()
    print(f"  [{label}] preempted={st['preempted']} rejected={st['rejected']}"
          f" slo_violations={st['slo_violations']} (objective ttft <= "
          f"{SLO_TTFT_INTERACTIVE}s for interactive: "
          f"{ {k: v['compliance'] for k, v in slo['compliance'].items()} })"
          f" postmortems={st['postmortems']} (flight-recorder triggers by "
          f"reason {dict(Counter(t['reason'] for t in eng.recorder.triggers))}"
          "; no directory: none "
          "written)")
    print(f"  [{label}] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  "
          f"{_graph_line(st)}  launches={launches}")
    assert len(handles) == len(reqs), "a submission was rejected"
    _check_graphs(label, st)
    for h in handles:
        assert h.result is not None and len(h.result) == h.max_new_tokens, (
            f"[{label}] request {h.rid} ended with {h.result}")
        assert tokens[h.rid] == h.result.tolist(), (
            f"[{label}] request {h.rid}: streamed tokens != result")
    assert st["preempted"] >= 1, f"[{label}] no preemption"
    assert not eng.has_work()
    _check_obs_exports(label, eng)
    for name in ("paged_decode_attention", "flash_attention", "moe_ffn"):
        assert launches[name] > 0, f"{name} was never launched in run {label}"
    print(f"  [{label}] run wall {time.perf_counter() - t_run:.1f}s",
          flush=True)
    del eng
    _free()


def _track_totals(tracer) -> dict:
    """Seconds of complete spans per track."""
    from repro_torch.obs.trace import tracer_track_name
    out: dict = {}
    for ev in tracer.events:
        if ev.get("ph") == "X":
            t = tracer_track_name(tracer, ev["tid"])
            out[t] = out.get(t, 0.0) + ev["dur"] * 1e-6
    return out


def clock_check(label, tracer, prof) -> None:
    """The tracer's clock against ``torch.profiler``'s over one profiled
    stretch: each device span's two ends against the start of the mark
    kernels that timed it (the nearest of the right name), each host
    span's start against the start of its ``record_function`` range of
    the same name; both traces' ``ts`` on the profiler's time base.
    Printed with the targets (20 us, 50 us); an error over 1 ms fails."""
    import tempfile

    from repro_torch.obs.trace import tracer_track_name
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            ptrace = json.load(f)
    finally:
        os.remove(path)
    events = ptrace["traceEvents"] if isinstance(ptrace, dict) else ptrace
    shift = 0.0
    if isinstance(ptrace, dict) and "baseTimeNanoseconds" in ptrace:
        shift = (tracer.base_ns - int(ptrace["baseTimeNanoseconds"])) / 1e3
    marks, ranges = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        if cat == "kernel" and name.startswith("obs_mark_"):
            marks.setdefault(name.split("(")[0][9:], []).append(
                float(e["ts"]))
        elif cat == "user_annotation":
            ranges.setdefault(name, []).append(float(e["ts"]))
    if not marks:
        print(f"  [{label}] clock check: no mark kernel in the profiler's "
              "trace")
        return
    lo = min(min(v) for v in marks.values()) - 1e3
    hi = max(max(v) for v in marks.values()) + 1e3
    ends = {"verify(fused)": ("round_begin", "draft_begin"),
            "draft(fused)": ("draft_begin", "round_end"),
            "rollback": ("rollback_begin", "rollback_end")}

    def near(ts, kind):
        return min(abs(ts - t) for t in marks.get(kind, [float("inf")]))
    dev_err, host_err = [], []
    for ev in tracer.events:
        if ev.get("ph") != "X":
            continue
        ts = ev["ts"] + shift
        if not lo <= ts <= hi:
            continue
        args = ev.get("args", {})
        if "device_ts" in args:
            a = args["device_ts"] + shift
            b = a + args["device_dur"]
            k0, k1 = ends.get(ev["name"], ("span", "span"))
            dev_err += [near(a, k0), near(b, k1)]
        name = f"{tracer_track_name(tracer, ev['tid'])}/{ev['name']}"
        if name in ranges:
            host_err.append(min(abs(ts - t) for t in ranges[name]))
    for what, errs, target in (("device spans vs mark kernels", dev_err,
                                20.0),
                               ("host spans vs record_function", host_err,
                                50.0)):
        if not errs:
            print(f"  [{label}] clock check, {what}: nothing to compare")
            continue
        errs = sorted(errs)
        print(f"  [{label}] clock check, {what}: {len(errs)} ends, error "
              f"median {errs[len(errs) // 2]:.2f} us, max {errs[-1]:.2f} "
              f"us (target {target:g} us: "
              f"{'met' if errs[-1] <= target else 'MISSED'})")
        assert errs[-1] < 1e3, f"[{label}] {what}: {errs[-1]:.1f} us"


def traced_run(label, steady=5) -> None:
    """3a's trace served closed loop with the span tracer on (device spans
    timed by marks) and entering ``record_function`` ranges; the bubble
    report beside the untraced 3a (when it ran in this call); then
    ``steady`` full rounds timed and ``steady`` more under
    ``torch.profiler``: the device's kernel time over the rounds' wall
    beside the report's busy fraction of the same rounds, and
    :func:`clock_check` on them."""
    import torch

    from repro_torch.configs import MIXTRAL_8X7B, draft_for
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.profile_serve import _device_us
    from repro_torch.obs.schema import validate_chrome_trace
    from repro_torch.obs.trace import TRACKS, bubble_report
    from repro_torch.serving.engine import SchedulerConfig, ServingEngine
    from repro_torch.serving.trace import poisson_requests

    t_run = time.perf_counter()
    mix = dataclasses.replace(MIXTRAL_8X7B, n_layers=SERVE_LAYERS)
    mis = draft_for(mix, SERVE_LAYERS)
    eng = _engine(mix, mis, SchedulerConfig(
        max_batch=4, n_cand=4, trace=True, trace_annotations=True), seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, mix.vocab_size, 512).astype(np.int32)
               for _ in range(12)]
    gens = rng.integers(32, 65, 12).tolist()
    for r in poisson_requests(prompts, gens, rate_rps=4.0, seed=0):
        assert eng.submit(r)
    torch.cuda.synchronize()
    reset_launches()
    done = eng.run()
    torch.cuda.synchronize()
    launches = launch_counts()
    st = eng.stats()
    rep = bubble_report(eng.obs.tracer)
    base = RUN_STATS.get("3a")
    print(f"  [{label}] traced (marks, record_function) 3a: served "
          f"{len(done)} requests, {st['tokens_out']} tokens: "
          f"{st['tok_per_s']:.2f} tok/s over {st['rounds']} rounds, round "
          f"p50={1e3 * st['round_s_p50']:.2f}ms" + (
              f"; untraced 3a in this call {base['tok_per_s']:.2f} tok/s, "
              f"round p50={1e3 * base['round_s_p50']:.2f}ms (traced / "
              f"untraced tok/s {st['tok_per_s'] / base['tok_per_s']:.4f})"
              if base else ""))
    print(f"  [{label}] bubble report: gpu_busy_frac={rep['gpu_busy_frac']:.4f}"
          f" mean_round_busy_frac={rep['mean_round_busy_frac']:.4f} "
          f"stall_s={rep['stall_s']:.4f} idle_s={rep['idle_s']:.4f} "
          f"rounds={rep['rounds']} (busy_s={rep['busy_s']:.4f}, "
          f"wall_s={rep['wall_s']:.4f})")
    print(f"  [{label}] span seconds per track: " + ", ".join(
        f"{k}={v:.4f}" for k, v in sorted(_track_totals(
            eng.obs.tracer).items())))
    print(f"  [{label}] graph nodes: {st['graph_nodes']}; marks launched "
          f"{eng.obs.tracer.marks.launches}")
    assert len(done) == 12 and st["fused_compiles"] == 1
    _check_graphs(label, st)
    print(f"  [{label}] {_graph_line(st)}")
    for name in ("paged_decode_attention", "flash_attention", "moe_ffn"):
        assert launches[name] > 0, f"{name} was never launched in run {label}"
    timed = [e for e in eng.obs.tracer.events
             if "device_ts" in e.get("args", {})]
    assert timed, f"[{label}] no device span timed by marks"
    trace = eng.chrome_trace()
    probs = validate_chrome_trace(trace)
    assert probs == [], f"[{label}] chrome trace: {probs[:5]}"
    print(f"  [{label}] chrome trace valid ({len(trace['traceEvents'])} "
          f"events, {len(timed)} device spans timed by marks)")

    # steady rounds: every slot live, nobody retires in the windows; an
    # untraced engine on the same weights alternates with the traced one
    # (ABBA) for the marks' cost on one host
    plain = ServingEngine(mix, mis, config=SchedulerConfig(
        max_batch=4, n_cand=4, max_len=eng._max_len), device="cuda")
    plain.load(eng.engine.tp, eng.engine.dp)
    for e in (eng, plain):
        for r in poisson_requests(prompts[:8], 40, rate_rps=1e6, seed=0):
            r.rid += 100
            assert e.submit(r)
        while not (e.has_live() and all(not s.done for half in e._slots
                                        for s in half)):
            e.run_step()
        for _ in range(2):
            e.run_step()
    engines = {"untraced": plain, "traced": eng}
    walls = {"untraced": [], "traced": []}
    for name in ("untraced", "traced", "traced", "untraced") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steady):
            engines[name].run_step()
        torch.cuda.synchronize()
        walls[name].append(1e3 * (time.perf_counter() - t0) / steady)
    med = {k: float(np.median(w)) for k, w in walls.items()}
    print(f"  [{label}] steady rounds, ABBA x2 of {steady} rounds: untraced "
          f"{[round(w, 3) for w in walls['untraced']]} ms/round (median "
          f"{med['untraced']:.3f}), traced "
          f"{[round(w, 3) for w in walls['traced']]} (median "
          f"{med['traced']:.3f}): traced / untraced "
          f"{med['traced'] / med['untraced']:.4f}")
    plain.run()
    del plain
    torch.cuda.synchronize()
    r0 = len(bubble_report(eng.obs.tracer)["per_round"])
    t0 = time.perf_counter()
    for _ in range(steady):
        eng.run_step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steady
    per_round = bubble_report(eng.obs.tracer)["per_round"][r0:r0 + steady]
    report_busy = sum(r["busy_frac"] for r in per_round) / len(per_round)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steady):
            eng.run_step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    ranges = {e.key for e in averages if e.key.split("/")[0] in TRACKS}
    for want in ("target_verify/verify(fused)", "rollback/rollback",
                 "launch/fused", "launch/rollback"):
        assert want in ranges, f"[{label}] no record_function range {want}"
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key.split("/")[0] not in TRACKS]
    dev_ms = sum(_device_us(e) for e in kernels) / 1e3 / steady
    print(f"  [{label}] record_function ranges: {sorted(ranges)}")
    print(f"  [{label}] {steady} steady rounds: wall {wall_ms:.3f} ms/round "
          f"(traced), device kernels {dev_ms:.3f} ms/round under "
          f"the profiler: profiler busy share {dev_ms / wall_ms:.4f} "
          f"(idle share {1 - dev_ms / wall_ms:.4f}) vs bubble report "
          f"busy_frac {report_busy:.4f} over the same rounds")
    clock_check(label, eng.obs.tracer, prof)
    eng.run()
    print(f"  [{label}] run wall {time.perf_counter() - t_run:.1f}s",
          flush=True)
    del eng, engines, done
    _free()


def _greedy_check(label, tp, tcfg, reqs) -> None:
    """Every served stream equals the port's own target-only greedy
    decode; on a mismatch name the first divergent position and the
    top-2 logit gap there."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    for r in reqs:
        steps = r.max_new_tokens
        cache = init_cache(tcfg, 1, len(r.prompt) + steps + 1, "cuda")
        lg, cache = M.prefill(tp, tcfg, torch.as_tensor(
            r.prompt[None], device="cuda").long(), cache)
        ref_toks, gaps = [], []
        for _ in range(steps):
            top2 = torch.topk(lg[0], 2).values
            gaps.append(float(top2[0] - top2[1]))
            tok = torch.argmax(lg, -1)
            ref_toks.append(int(tok[0]))
            lg, cache = M.decode_step(tp, tcfg, cache, tok[:, None])
        ref_toks = np.asarray(ref_toks)
        if not np.array_equal(ref_toks, r.result):
            i = int(np.nonzero(ref_toks != r.result)[0][0])
            raise AssertionError(
                f"[{label}] request {r.rid}: served stream diverges from "
                f"greedy decode at position {i} (served {r.result[i]}, "
                f"greedy {ref_toks[i]}, top-2 logit gap there {gaps[i]:.3e})")
        print(f"  [{label}] request {r.rid}: prompt {len(r.prompt)}, {steps} "
              f"tokens identical to greedy decode (min top-2 gap "
              f"{min(gaps):.3e})")


def _noisy_copy(params, scale: float, gen):
    """The weights plus seeded Gaussian noise of ``scale`` times each
    tensor's standard deviation (constant tensors, the norms, stay)."""
    import torch
    if isinstance(params, dict):
        return {k: _noisy_copy(v, scale, gen) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(_noisy_copy(v, scale, gen) for v in params)
    if not (isinstance(params, torch.Tensor) and params.is_floating_point()
            and params.numel() > 1):
        return params
    x = params.float()
    noise = torch.randn(x.shape, generator=gen, device=x.device)
    return (x + scale * x.std() * noise).to(params.dtype)


def lossless_run(label, tcfg, dcfg, paged, must_launch, spec_tree=None,
                 serve_must_launch=(), prompt_range=(40, 130)) -> None:
    """Serve 6 requests (prompt lengths drawn from ``prompt_range``, its
    end excluded) with mid-flight admission and hold every stream
    against the greedy decode.  With ``spec_tree`` the draft is the
    target's configuration with its weights plus ``DRAFT_NOISE``, and
    the rounds must accept part of the path as well as all of it."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.params import init_params
    from repro_torch.serving.engine import SchedulerConfig, ServingEngine
    from repro_torch.serving.trace import poisson_requests

    t_run = time.perf_counter()
    config = SchedulerConfig(max_batch=2, n_cand=4, paged=paged,
                             spec_tree=spec_tree)
    if spec_tree is None:
        eng = _engine(tcfg, dcfg, config, seed=1)
    else:
        eng = ServingEngine(tcfg, tcfg, config=config, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        tp = init_params(tcfg, g, "cuda")
        eng.load(tp, _noisy_copy(tp, DRAFT_NOISE, g))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(*prompt_range, 6)]
    gens = rng.integers(16, 33, 6).tolist()
    reqs = poisson_requests(prompts, gens, rate_rps=20.0, seed=1)
    for r in reqs:
        assert eng.submit(r)
    reset_launches()
    done = eng.run()
    torch.cuda.synchronize()
    served = launch_counts()
    assert len(done) == len(reqs)
    assert any(r.queue_s > 0 for r in reqs), "no mid-flight admission"
    st = eng.stats()
    fused = st["fused_compiles"]
    assert fused == 1, f"fused round ran at {fused} shape signatures"
    _check_graphs(label, st)
    for name in serve_must_launch:
        assert served[name] > 0, f"[{label}] serving never launched {name}"
    if serve_must_launch and spec_tree is None:
        print(f"  [{label}] draft {dcfg.name} {dcfg.n_layers} layers "
              f"{dcfg.layer_pattern}: {st['rounds']} rounds; serving "
              f"launches { {k: n for k, n in served.items() if n} }")
    if spec_tree is not None:
        hist, depth = st["accept_hist"], len(spec_tree)
        print(f"  [{label}] tree {spec_tree}, draft = target + "
              f"{DRAFT_NOISE} x std noise: {st['rounds']} rounds, "
              f"accepted-length histogram (live slots, a = 0..{depth}) "
              f"{hist}; serving launches "
              f"{ {k: n for k, n in served.items() if n} }")
        assert sum(hist[1:depth]) > 0 and hist[depth] > 0, (
            f"[{label}] rounds must accept part of the path and all of it")
    reset_launches()
    _greedy_check(label, eng.engine.tp, tcfg, reqs)
    torch.cuda.synchronize()
    launches = launch_counts()
    for name in must_launch:           # the greedy decode ran the kernels
        assert launches[name] > 0, f"[{label}] greedy decode skipped {name}"
    print(f"  [{label}] {tcfg.name} {tcfg.n_layers} layers, "
          f"{'paged' if paged else 'contiguous'}: fused shape "
          f"signatures={fused}, {_graph_line(st)}; greedy decode "
          f"launches={launches}; run wall "
          f"{time.perf_counter() - t_run:.1f}s", flush=True)
    del eng, done
    _free()


def sampled_run(label) -> None:
    """Sampled acceptance on the card: chain and tree against the same
    calls on the CPU (f32 logits, the same noise; tokens equal), then the
    Leviathan check of the first emitted token's distribution."""
    import torch

    from repro_torch.core import spec_decode as S
    t_run = time.perf_counter()
    gen = torch.Generator().manual_seed(4)
    rn = lambda *shape: torch.randn(shape, generator=gen)
    b, m, v = 8, 4, 32000
    dl = 2.0 * rn(b, m, v)
    tl = torch.cat([dl, 2.0 * rn(b, 1, v)], 1) + 0.5 * rn(b, m + 1, v)
    drafts = torch.argmax(dl + S.gumbel_noise(gen, (b, m, v), "cpu"), -1)
    args = (drafts, dl, tl) + S.acceptance_noise(gen, b, m, v, "cpu")
    want = S.sampled_acceptance(*args)
    got = S.sampled_acceptance(*(x.cuda() for x in args))
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.cpu(), w_), f"[{label}] chain: card != CPU"
    # a (3, 2) tree drafted by the draft logits' top-k at each parent
    n = S.tree_n_nodes(TREE)
    lay = S.tree_layout(TREE)
    dlt = 2.0 * rn(b, n, v)
    tlt = dlt + 0.5 * rn(b, n, v)
    toks = torch.zeros((b, n), dtype=torch.int64)
    toks[:, 0] = torch.randint(0, v, (b,), generator=gen)
    for i in range(n):
        fc = int(lay["first_child"][i])
        if fc >= 0:
            k = TREE[int(lay["depth"][i])]
            toks[:, fc:fc + k] = S.top_k_indices(dlt[:, i], k)
    targs = (toks, dlt, tlt, TREE) + S.tree_acceptance_noise(gen, b, TREE, v,
                                                             "cpu")
    twant = S.tree_sampled_acceptance(*targs)
    tgot = S.tree_sampled_acceptance(*(x.cuda() if torch.is_tensor(x) else x
                                       for x in targs))
    for g_, w_ in zip(tgot, twant):
        assert torch.equal(g_.cpu(), w_), f"[{label}] tree: card != CPU"
    print(f"  [{label}] sampled_acceptance B {b} m {m} V {v}: card == CPU "
          f"(n_accept {want[0].tolist()}); tree_sampled_acceptance {TREE}: "
          f"card == CPU (n_accept {twant[0].tolist()})")
    # Leviathan: with drafts sampled from the draft, the first emitted
    # token is distributed as the target's softmax at position 0
    rows, vv = 1 << 18, 8
    cg = torch.Generator(device="cuda").manual_seed(5)
    dl8 = torch.tensor([[1.5, 0.2, -0.3, 0.9, -1.0, 0.0, 0.4, -0.6]] * m,
                       device="cuda")
    dl8[1:] = dl8[1:].roll(1, -1)
    tl8 = torch.tensor([[0.3, 1.1, -0.5, 0.0, 0.8, -1.2, 0.6, -0.1]]
                       * (m + 1), device="cuda")
    dlr, tlr = dl8.expand(rows, m, vv), tl8.expand(rows, m + 1, vv)
    dr = torch.argmax(dlr + S.gumbel_noise(cg, (rows, m, vv), "cuda"), -1)
    a, nxt, _ = S.sampled_acceptance(dr, dlr, tlr, *S.acceptance_noise(
        cg, rows, m, vv, "cuda"))
    first = torch.where(a >= 1, dr[:, 0], nxt)
    freq = torch.bincount(first, minlength=vv).double().cpu() / rows
    p = torch.softmax(tl8[0].double(), -1).cpu()
    se = torch.sqrt(p * (1 - p) / rows)
    z = float(((freq - p).abs() / se).max())
    print(f"  [{label}] Leviathan check, {rows} rows, vocabulary {vv}: "
          f"largest deviation {float((freq - p).abs().max()):.2e} = "
          f"{z:.2f} standard errors (limit 5); mean accepted "
          f"{float(a.float().mean()):.3f} of {m}; run wall "
          f"{time.perf_counter() - t_run:.1f}s", flush=True)
    assert z <= 5.0, f"[{label}] first token off the target by {z:.2f} SE"


def preempt_run(label, tcfg, dcfg) -> None:
    """Lossless preemption in f32: ``max_batch=2``, QoS and preemption on
    the virtual clock; 4 priority-1 requests at t = 0, then, after round 3
    of a ``run_step()`` drive, 2 priority-0 requests.  Every stream, the
    preempted and resumed ones included, must equal the greedy decode."""
    import torch

    from repro_torch.core.pipeline import required_cache_len
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serving.engine import SchedulerConfig, ServeRequest

    t_run = time.perf_counter()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(40, 130, 6)]
    low = [ServeRequest(i, prompts[i], int(g), priority=1)
           for i, g in enumerate(rng.integers(24, 33, 4))]
    high = [ServeRequest(4 + i, prompts[4 + i], int(g), priority=0)
            for i, g in enumerate(rng.integers(8, 17, 2))]
    max_len = max(required_cache_len(len(r.prompt), r.max_new_tokens, 4)
                  for r in low + high)
    eng = _engine(tcfg, dcfg, SchedulerConfig(max_batch=2, n_cand=4,
                                              qos=True, preempt=True,
                                              max_len=max_len), seed=1)
    for r in low:
        assert eng.submit(r)
    reset_launches()
    for _ in range(3):
        eng.run_step()
    assert all(not s.done for half in eng._slots for s in half)
    for r in high:
        assert eng.submit(r)
    while eng.has_work():
        eng.run_step()
    torch.cuda.synchronize()
    served = launch_counts()
    st = eng.stats()
    print(f"  [{label}] {tcfg.name} {tcfg.n_layers} layers, paged, QoS + "
          f"preemption: {st['rounds']} rounds, preempted={st['preempted']} "
          f"(requests {[r.rid for r in low if r.preemptions]} resumed with "
          f"{[len(r.progress) for r in low if r.preemptions]} tokens of "
          f"progress); serving launches "
          f"{ {k: n for k, n in served.items() if n} }")
    assert st["preempted"] >= 1, f"[{label}] no preemption"
    assert st["fused_compiles"] == 1
    _check_graphs(label, st)
    print(f"  [{label}] {_graph_line(st)}")
    assert max(r.finished_s for r in high) <= max(r.finished_s for r in low)
    for name in ("paged_decode_attention", "flash_attention", "moe_ffn"):
        assert served[name] > 0, f"[{label}] serving never launched {name}"
    _greedy_check(label, eng.engine.tp, tcfg, low + high)
    print(f"  [{label}] run wall {time.perf_counter() - t_run:.1f}s",
          flush=True)
    del eng
    _free()


def lossless_phase() -> None:
    from repro_torch.configs import (MIXTRAL_8X7B, RECURRENTGEMMA_2B,
                                     RWKV6_7B, draft_for)
    f32 = lambda c, n: dataclasses.replace(c, n_layers=n, dtype="float32")
    mix = f32(MIXTRAL_8X7B, 2)
    mis = draft_for(mix, 2)
    lossless_run("4a", mix, mis, True, ("flash_attention", "decode_attention",
                                        "moe_ffn"))
    lossless_run("4b", mix, mis, False, ("flash_attention",
                                         "decode_attention", "moe_ffn"))
    rw = f32(RWKV6_7B, 2)
    lossless_run("4c", rw, draft_for(rw, 2), False, ("wkv6",))
    rgc = f32(RECURRENTGEMMA_2B, 3)
    lossless_run("4d", rgc, draft_for(rgc, 2), False,
                 ("rglru_gated_scan", "flash_attention"))
    lossless_run("4e", mix, None, True, ("flash_attention",
                                         "decode_attention", "moe_ffn"),
                 spec_tree=TREE,
                 serve_must_launch=("paged_decode_attention tree",))
    lossless_run("4f", mix, None, False, ("flash_attention",
                                          "decode_attention", "moe_ffn"),
                 spec_tree=TREE, serve_must_launch=("decode_attention tree",))
    sampled_run("4g")
    preempt_run("4h", mix, mis)
    # 4i: recurrent drafts at the target's vocabulary, chain rounds
    # rolled back through the state stacks
    for name, draft, kernel in (
            ("rg", dataclasses.replace(RECURRENTGEMMA_2B, n_layers=3,
                                       vocab_size=mix.vocab_size,
                                       dtype="float32"), "rglru_gated_scan"),
            ("rwkv", dataclasses.replace(RWKV6_7B, n_layers=2,
                                         vocab_size=mix.vocab_size,
                                         dtype="float32"), "wkv6")):
        for paged, verify in ((True, "paged_decode_attention"),
                              (False, "decode_attention")):
            lossless_run(f"4i-{name}-{'paged' if paged else 'contiguous'}",
                         mix, draft, paged, ("flash_attention", "moe_ffn"),
                         serve_must_launch=(kernel, verify,
                                            "flash_attention", "moe_ffn"))
    family_lossless()


def family_lossless() -> None:
    """4j: Gemma-3-12B's widths cut to one group (6 layers: 5 SWA + 1
    global, head dim 240) with prompts of 1280, paged and contiguous;
    StarCoder2-7B and Phi-3.5-MoE widths at 2 layers; then Whisper-base's
    incremental decode against recomputing a prefill at every step."""
    from repro_torch.configs import (GEMMA3_12B, PHI35_MOE, STARCODER2_7B,
                                     draft_for)
    f32 = lambda c, n: dataclasses.replace(c, n_layers=n, dtype="float32")
    gemma = f32(GEMMA3_12B, 6)
    for paged, verify in ((True, "paged_decode_attention"),
                          (False, "decode_attention")):
        lossless_run(f"4j-gemma3-{'paged' if paged else 'contiguous'}",
                     gemma, draft_for(gemma, 2), paged,
                     ("flash_attention", "decode_attention"),
                     serve_must_launch=(verify, "flash_attention"),
                     prompt_range=(1280, 1281))
    sc = f32(STARCODER2_7B, 2)
    lossless_run("4j-starcoder2", sc, draft_for(sc, 2), True,
                 ("flash_attention", "decode_attention"),
                 serve_must_launch=("paged_decode_attention",))
    phi = f32(PHI35_MOE, 2)
    lossless_run("4j-phi3.5-moe", phi, draft_for(phi, 2), True,
                 ("flash_attention", "decode_attention", "moe_ffn"),
                 serve_must_launch=("paged_decode_attention", "moe_ffn"))
    whisper_lossless("4j-whisper")


def whisper_lossless(label, steps: int = 8) -> None:
    """Whisper-base in f32: the greedy stream of ``decode_step`` (cross
    K/V read from the cache, self attention through ``decode_attention``)
    equals the stream from recomputing a whole prefill (encoder
    included) over prompt + the tokens so far at every step."""
    import torch

    from repro_torch.configs import WHISPER_BASE
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    from repro_torch.params import init_params

    t_run = time.perf_counter()
    cfg = dataclasses.replace(WHISPER_BASE, dtype="float32")
    g = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, g, "cuda")
    b = 2
    frames = torch.randn((b, cfg.encoder_len, cfg.d_model), generator=g,
                         device="cuda")
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, WHISPER_PROMPT)), device="cuda")
    cache = init_cache(cfg, b, WHISPER_MAX_LEN, "cuda")
    lg, cache = M.prefill(params, cfg, prompt, cache, encoder_frames=frames)
    seq, gaps = prompt, []
    for step in range(steps):
        tok = torch.argmax(lg, -1)
        fresh = init_cache(cfg, b, WHISPER_MAX_LEN, "cuda")
        lg_full, _ = M.prefill(params, cfg, seq, fresh,
                               encoder_frames=frames)
        top2 = torch.topk(lg_full, 2, -1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        assert torch.equal(tok, torch.argmax(lg_full, -1)), (
            f"[{label}] step {step}: decode_step token {tok.tolist()} != "
            f"recomputed prefill {torch.argmax(lg_full, -1).tolist()} "
            f"(top-2 gap {gaps[-1]:.3e})")
        seq = torch.cat([seq, tok[:, None]], 1)
        lg, cache = M.decode_step(params, cfg, cache, tok[:, None])
    print(f"  [{label}] {cfg.name} f32, B {b}: {steps} greedy decode_step "
          f"tokens == recomputed prefill at every step "
          f"({seq[:, WHISPER_PROMPT:].tolist()}, min top-2 gap "
          f"{min(gaps):.3e}); run wall {time.perf_counter() - t_run:.1f}s",
          flush=True)
    del params, cache, frames
    _free()


# ---------------------------------------------------------------------------
# phase 5: training

# 5t: Gemma-3-12B at its published widths, depth cut to one group (5
# sliding-window layers + 1 global: 3.34 G parameters, ~40 GB with
# AdamW's state), B 2 x S 4096 (the assigned train_4k length, so the
# 1024-token window binds); 5t-eq: the same widths in f32, B 1, S 1281
# (longer than the window; loss_fn's chunk is the largest divisor of S - 1
# up to 256, so S - 1 = 1280 gives chunks of 256, where 1279, a prime,
# would give 1279 chunks of one token)
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 6, 2, 4096, 5, 3e-4
TRAIN_EQ_S = 1281
TRAIN_EQ_TOL = (1e-5, 1e-4)     # loss relative; worst leaf / its max |g|
WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 448, 3
# 5t-m / 5t-r / 5t-k: (label, config, layers, batch of TRAIN_S tokens, the
# profiler groups its step must show).  Mixtral-8x7B cut to 3 layers
# (4.6 G parameters, ~55 GB with AdamW's state at 12 bytes a parameter);
# RecurrentGemma-2B whole (27 layers, ~3.0 G); RWKV-6-7B cut to 8 layers
# (~2.3 G with its untied 65536-row embedding and head)
TRAIN_FAMILIES = (
    ("5t-m", "mixtral-8x7b", 3, 1, ("flash_attention_bwd kernels",
                                    "moe_ffn kernels",
                                    "moe_ffn_bwd kernels")),
    ("5t-r", "recurrentgemma-2b", 27, 2,
     ("flash_attention_bwd kernels", "rglru_scan kernels",
      "rglru_scan_bwd kernels")),
    ("5t-k", "rwkv6-7b", 8, 2, ("wkv6 kernels", "wkv6_bwd kernels")))
TRAIN_FAMILY_STEPS = 4
# 5t-eq-m / -r / -k: f32, B 2 x 257 (S - 1 = 256: one loss chunk), card
# against CPU; Mixtral 1 layer (cut from 2 to pay for phase 6's mesh
# runs), RecurrentGemma one group (3), RWKV 2
TRAIN_EQ_FAMILIES = (("5t-eq-m", "mixtral-8x7b", 1),
                     ("5t-eq-r", "recurrentgemma-2b", 3),
                     ("5t-eq-k", "rwkv6-7b", 2))
TRAIN_EQ_FAMILY_S = 257
# a config's own fixed gradient limit where the f32 model's spread
# between the card and the CPU passes TRAIN_EQ_TOL[1] with the summation
# order alone (eq_readings, PERF.md section 6): RWKV-6-7B's u gradient
TRAIN_EQ_GRAD_TOL = {"rwkv6-7b": 1e-3}
# 5t-l: the launcher's defaults (None: its default arch, Gemma-3)
LAUNCHER_ARCHS = (None, "mixtral-8x7b", "recurrentgemma-2b", "rwkv6-7b")


class _PlainAttentionCounter:
    """Counts calls of the plain versions while it is entered: the
    model's ``attention_direct`` / ``attention_chunked``, the flash plain
    versions, the verify kernels' and those of ``wkv6``, the RG-LRU and
    ``moe_ffn`` (forward and backward): the training runs on the card
    must make none."""

    def __enter__(self):
        from repro_torch.kernels import ref
        from repro_torch.models import attention, encdec
        self.calls = Counter()
        self.saved = []
        for mod, name in ((attention, "attention_direct"),
                          (attention, "attention_chunked"),
                          (encdec, "attention_chunked"),
                          (ref, "flash_attention_ref"),
                          (ref, "flash_attention_bwd_ref"),
                          (ref, "wkv6_ref"), (ref, "wkv6_bwd_ref"),
                          (ref, "rglru_scan_ref"),
                          (ref, "rglru_gated_scan_ref"),
                          (ref, "rglru_gated_scan_bwd_ref"),
                          (ref, "moe_ffn_ref"), (ref, "moe_ffn_bwd_ref"),
                          (ref, "decode_attention_ref"),
                          (ref, "paged_decode_attention_ref")):
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, _name=name, **k):
                self.calls[_name] += 1
                return _fn(*a, **k)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _profiled_step(label, cfg, params, opt_state, data, step_wall,
                   must_see):
    """One more train step under ``torch.profiler``: the device's kernel
    time by group (``launch/profile_serve.py``'s groups, copies apart),
    against ``step_wall`` (the untraced steps' mean) as the idle share.
    Every group of ``must_see`` must have device time."""
    import re

    import torch

    from repro_torch.launch.profile_serve import GROUPS
    from repro_torch.training import make_train_step
    step = make_train_step(cfg, lr=TRAIN_LR)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    batch = next(data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    groups = Counter()
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        name = ("copies" if e.key.startswith("Mem") else
                next(g for g, pat in GROUPS if re.search(pat, e.key)))
        groups[name] += us / 1e3
    busy = sum(groups.values())
    print(f"  [{label}] profiled step: wall {wall:.3f}s (profiler on), "
          f"device {busy:.1f} ms (" + ", ".join(
              f"{g} {ms:.1f}" for g, ms in groups.most_common())
          + f"); against the untraced steps' mean wall {step_wall:.3f}s "
          f"the card computes {busy / 1e3 / step_wall:.3f} of a step "
          f"(idle share {1 - busy / 1e3 / step_wall:.3f})", flush=True)
    missing = [g for g in must_see if groups[g] <= 0]
    assert not missing, f"[{label}] the profiler saw no {missing}"


def _train_run(label, cfg, data, steps, n_tokens, per_step=None,
               profile=()):
    """``train_loop`` over ``steps`` batches of ``data`` from seeded
    weights, AdamW at ``TRAIN_LR``: per step its loss, gradient norm and
    wall (each step ends in a read of its loss), tokens/s after the first
    step, peak device memory and launches a step.  Losses and gradient
    norms must be finite and no plain version may run; ``per_step``
    (``_expected_launches``) are the exact launches a step.  With
    ``profile`` (the groups that must show device time), one more step
    under the profiler (:func:`_profiled_step`)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.params import init_params
    from repro_torch.training import make_optimizer, train_loop
    from repro_torch.tree import tree_leaves

    t_run = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, "cuda")
    opt_init, _ = make_optimizer(cfg.optimizer)
    opt_state = opt_init(params, cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.synchronize()
    _free()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _PlainAttentionCounter() as plain:
        params, opt_state, log = train_loop(cfg, params, opt_state, data,
                                            steps, lr=TRAIN_LR, log_every=1)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert not plain.calls, f"[{label}] plain versions ran: {plain.calls}"
    walls = np.diff([0.0] + [row["elapsed_s"] for row in log])
    for row, wall in zip(log, walls):
        assert np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"]), row
        print(f"  [{label}] step {row['step']}: loss {row['loss']:.4f} "
              f"grad norm {row['grad_norm']:.4f} wall {wall:.3f}s", flush=True)
    tok_s = n_tokens * (steps - 1) / float(walls[1:].sum())
    got = {k: v / steps for k, v in launches.items() if v}
    print(f"  [{label}] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, "
          f"{n_params / 1e9:.3f} G parameters, {n_tokens} tokens a step: "
          f"{tok_s:.1f} tokens/s after the first step, peak memory "
          f"{peak:.2f} GiB, launches a step: " + ", ".join(
              f"{k} {v:g}" for k, v in got.items())
          + f"; run wall {time.perf_counter() - t_run:.1f}s", flush=True)
    if per_step is not None:
        assert got == per_step, (f"[{label}] launches a step {got}, "
                                 f"expected {per_step}")
    if profile:
        _profiled_step(label, cfg, params, opt_state, data,
                       float(walls[1:].mean()), profile)
    del params, opt_state
    _free()
    return launches, log


def _group_runs(cfg) -> int:
    """Forward runs of the layer groups in one train step: each group
    once, once more for remat's recompute and, under sqrt-remat (past 8
    groups, ``transformer._forward_train``), a third time for every group
    but the last of its superblock (torch's non-reentrant checkpoints two
    deep; tests/test_torch_recurrent_bwd.py pins the count on the CPU)."""
    from repro_torch.models.transformer import _sqrt_factor
    n = cfg.n_groups
    if not cfg.remat:
        return n
    n_outer = 1 if cfg.offload_carries else _sqrt_factor(n)
    return 2 * n + (n - n_outer if n_outer > 1 else 0)


def _expected_launches(cfg, seq: int) -> dict:
    """Exact kernel launches of one train step of a decoder-only config,
    reckoned from its layer pattern and :func:`_group_runs`: each
    attention, RG-LRU and RWKV layer launches its forward kernel once a
    run of its group and its backward kernel once, and so does each MoE
    layer's expert FFN (``moe_ffn``, ``moe_ffn_bwd``)."""
    from repro_torch.configs import ATTN, RGLRU, RWKV, SWA
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk
    kinds = Counter(cfg.layer_pattern)
    runs, n = _group_runs(cfg), cfg.n_groups
    out = Counter()
    n_moe = sum(map(bool, cfg.moe_pattern)) if cfg.is_moe else 0
    if n_moe:
        out["moe_ffn"] += n_moe * runs
        out["moe_ffn_bwd"] += n_moe * n
    for kind, fwd, bwd, route in (
            ((ATTN, SWA), "flash_attention", "flash_attention_bwd", None),
            ((RGLRU,), "rglru_gated_scan", "rglru_gated_scan_bwd",
             rg.route(seq)),
            ((RWKV,), "wkv6", "wkv6_bwd",
             wk.route(seq, False, cfg.rwkv_head_size))):
        per_group = sum(kinds[k] for k in kind)
        if per_group:
            out[fwd] += per_group * runs
            out[bwd] += per_group * n
            if route is not None:
                out[f"{fwd} {route}"] += per_group * runs
    return dict(out)


def train_phase() -> dict:
    """5t, 5t-eq, 5t-m, 5t-r, 5t-k and their eq runs, 5t-w, 5t-l; returns
    {run label: launches}."""
    import torch

    from repro_torch.configs import GEMMA3_12B, WHISPER_BASE, get_config
    from repro_torch.data.pipeline import make_lm_batches

    # 5t: one step's forward runs 6 flash launches, remat's recompute of
    # the group 6 more, and the backward 6 flash_attention_bwd launches
    cfg = dataclasses.replace(GEMMA3_12B, n_layers=TRAIN_LAYERS)
    assert cfg.remat and cfg.dtype == "bfloat16" and cfg.n_groups == 1
    data = make_lm_batches(TRAIN_B, TRAIN_S, cfg.vocab_size, seed=0)
    runs = {}
    runs["5t"], _ = _train_run("5t", cfg, data, TRAIN_STEPS,
                               TRAIN_B * TRAIN_S,
                               _expected_launches(cfg, TRAIN_S),
                               profile=("flash_attention_bwd kernels",))
    assert runs["5t"]["flash_attention"] == 2 * cfg.n_layers * TRAIN_STEPS

    train_eq_run("5t-eq", dataclasses.replace(cfg, dtype="float32"), 1,
                 TRAIN_EQ_S)

    # 5t-m / 5t-r / 5t-k: the MoE and recurrent families at published
    # widths, bf16, remat and AdamW as configured
    for label, arch, layers, batch, must_see in TRAIN_FAMILIES:
        fcfg = dataclasses.replace(get_config(arch), n_layers=layers)
        fdata = make_lm_batches(batch, TRAIN_S, fcfg.vocab_size, seed=0)
        runs[label], _ = _train_run(label, fcfg, fdata, TRAIN_FAMILY_STEPS,
                                    batch * TRAIN_S,
                                    _expected_launches(fcfg, TRAIN_S),
                                    profile=must_see)
    for label, arch, layers in TRAIN_EQ_FAMILIES:
        fcfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                   dtype="float32")
        train_eq_run(label, fcfg, 2, TRAIN_EQ_FAMILY_S, family=True)

    # 5t-w: the encoder (6 bidirectional layers, not rematerialised, as in
    # JAX), the decoder's 6 groups each a checkpoint (self + cross)
    wcfg = WHISPER_BASE
    rng = np.random.default_rng(0)
    lm = make_lm_batches(4, WHISPER_TRAIN_S, wcfg.vocab_size, seed=0)
    wdata = ({"tokens": next(lm)["tokens"],
              "encoder_frames": rng.standard_normal(
                  (4, wcfg.encoder_len, wcfg.d_model)).astype(np.float32)}
             for _ in range(WHISPER_TRAIN_STEPS))
    wl, _ = _train_run("5t-w", wcfg, wdata, WHISPER_TRAIN_STEPS,
                       4 * WHISPER_TRAIN_S)
    n_enc, n_dec = wcfg.n_encoder_layers, 2 * wcfg.n_layers
    assert wl["flash_attention"] == WHISPER_TRAIN_STEPS * (
        n_enc + n_dec * (2 if wcfg.remat else 1)), wl
    assert wl["flash_attention_bwd"] == WHISPER_TRAIN_STEPS * (
        n_enc + n_dec), wl

    # 5t-l: the launcher at its defaults (reduced configs, f32): Gemma-3
    # (head dim 32), then the MoE and recurrent families, the four
    # processes at once on the card
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"]
        + (["--arch", arch] if arch else []), cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in LAUNCHER_ARCHS}
    try:
        outs = {arch: p.communicate(timeout=600) + (p.returncode,)
                for arch, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for arch, (stdout, stderr, rc) in outs.items():
        lines = stdout.strip().splitlines()
        print(f"  [5t-l] python -m repro_torch.launch.train"
              + (f" --arch {arch}" if arch else " (defaults)") + ": "
              + " | ".join(lines[-3:]), flush=True)
        assert rc == 0, stderr[-2000:]
        assert lines and "LEARNED" in lines[-1], stdout[-2000:]
    print(f"  [5t-l] the {len(procs)} launchers' wall "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    torch.cuda.synchronize()
    return runs


class _RoutingRecorder:
    """Records every MoE layer's top-k experts and capacity slots
    (``models.moe._dispatch``'s idx and its slot output) while entered."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.fn, self.calls = moe, moe._dispatch, []

        def recorded(x_flat, idx, n_experts, capacity):
            buf, slot = self.fn(x_flat, idx, n_experts, capacity)
            self.calls.append((idx.detach().cpu(), slot.detach().cpu()))
            return buf, slot
        moe._dispatch = recorded
        return self

    def __exit__(self, *exc):
        self.mod._dispatch = self.fn
        return False


def _same_routing(label, card, cpu) -> None:
    """The card's and the CPU's MoE routing must be identical: the same
    experts and the same drop slots for every token of every layer call.
    A token where they differ (a near-tie of router probabilities) is
    reported by layer call and token, never passed."""
    assert len(card) == len(cpu), (label, len(card), len(cpu))
    bad = []
    for call, ((ic, sc), (ih, sh)) in enumerate(zip(card, cpu)):
        diff = ((ic != ih) | (sc != sh)).any(-1).nonzero().flatten()
        bad += [(call, int(t), ic[t].tolist(), ih[t].tolist(),
                 sc[t].tolist(), sh[t].tolist()) for t in diff]
    n_tok = sum(int(i.shape[0]) for i, _ in card)
    n_drop = sum(int((s < 0).sum()) for _, s in card)
    print(f"  [{label}] routing: {len(card)} MoE layer calls, {n_tok} "
          f"tokens, {n_drop} dropped slots; card == CPU for "
          f"{n_tok - len(bad)} of {n_tok} tokens", flush=True)
    assert not bad, (f"[{label}] routing differs at (call, token, experts "
                     f"card / CPU, slots card / CPU): {bad[:20]}")


def _worst_leaf(paths, got, want) -> tuple:
    """(largest error over its leaf's largest magnitude, that leaf)."""
    worst, worst_at = 0.0, None
    for path, g_, w_ in zip(paths, got, want):
        err = float((g_.to("cpu") - w_).abs().max()) / max(
            float(w_.abs().max()), 1e-30)
        if err > worst:
            worst, worst_at = err, path
    return worst, worst_at


class _BackwardRecorder:
    """Records each call of the backward wrappers (the recurrences' and
    the expert FFN's) that the model makes while entered: inputs and
    outputs.  Patches the functions on their kernel modules, which the
    model modules call through; a wrapper counts its launches on the
    function its module names, so the recording function carries the
    count while entered and hands it back on exit."""

    def __enter__(self):
        import functools

        from repro_torch.kernels import moe_ffn as mf
        from repro_torch.kernels import rglru_scan as rg
        from repro_torch.kernels import wkv6 as wk
        self.calls = []
        self.saved = [(wk, "wkv6_bwd", "wkv6_bwd_ref"),
                      (rg, "rglru_gated_scan_bwd",
                       "rglru_gated_scan_bwd_ref"),
                      (mf, "moe_ffn_bwd", "moe_ffn_bwd_ref")]
        self.saved = [(mod, name, plain, getattr(mod, name))
                      for mod, name, plain in self.saved]
        for mod, name, plain, fn in self.saved:
            @functools.wraps(fn)        # its launches attribute too
            def call(*args, _fn=fn, _name=name, _plain=plain, **kw):
                out = _fn(*args, **kw)
                self.calls.append((_name, _plain, args, kw, out))
                return out
            setattr(mod, name, call)
        return self

    def __exit__(self, *exc):
        for mod, name, _, fn in self.saved:
            fn.launches = getattr(mod, name).launches
            setattr(mod, name, fn)
        return False

    def worst(self, label) -> str:
        """Each recorded kernel call against its plain version in f64 on
        the same inputs (``TOL_BWD`` of each output's largest magnitude);
        returns a line naming the worst."""
        import torch

        from repro_torch.kernels import ref
        worst = {}
        for name, plain, args, kw, out in self.calls:
            want = getattr(ref, plain)(*(None if a is None else a.double()
                                         for a in args), **kw)
            err = max(_check_scaled(name, label, g, w) / max(
                float(w.abs().max()), 1e-30) for g, w in zip(out, want))
            worst[name] = max(worst.get(name, 0.0), err)
            del want
        torch.cuda.empty_cache()
        return ", ".join(f"{k} {len([c for c in self.calls if c[0] == k])} "
                         f"calls, worst {v:.2e} of its output's largest "
                         f"magnitude" for k, v in worst.items())


def _eq_step(cfg, params, tokens, dev, plain=False) -> dict:
    """One train step's loss and gradients of ``params`` on ``dev`` (with
    ``plain`` the card runs the plain versions: ``use_kernel`` False),
    recording the MoE routing, the plain calls and the backward calls."""
    import torch

    from repro_torch.kernels import _build as build
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    reset_launches()
    use_kernel = build.use_kernel
    if plain:
        build.use_kernel = lambda *tensors: False
    t0 = time.perf_counter()
    try:
        with _RoutingRecorder() as rec, _PlainAttentionCounter() as pc, \
                _BackwardRecorder() as bwd:
            loss = M.loss_fn(params, cfg, {"tokens": torch.as_tensor(
                tokens, device=dev).long()})
            grads = torch.autograd.grad(loss, leaves)
    finally:
        build.use_kernel = use_kernel
    if dev == "cuda":
        torch.cuda.synchronize()
    return {"loss": float(loss.detach()), "grads": grads,
            "secs": time.perf_counter() - t0, "routes": rec.calls,
            "plain": pc.calls, "bwd": bwd,
            "launches": {k: v for k, v in launch_counts().items() if v}}


def train_eq_run(label, cfg, batch, seq, family=False) -> None:
    """The same train step's loss and gradients on the card (kernels)
    and on the CPU (plain versions) from the same f32 weights, B ``batch``
    x ``seq`` tokens.  Held to ``TRAIN_EQ_TOL`` (the loss's relative
    error, and for every gradient leaf its largest error over the leaf's
    largest magnitude; a config of ``TRAIN_EQ_GRAD_TOL``, its own fixed
    gradient limit); the card's launches must be
    :func:`_expected_launches`'s, with no plain version.  ``family`` (the
    MoE and recurrent runs): a MoE config's experts and drop slots must
    first be the same on both devices (:func:`_same_routing`); the step
    runs a third time on the card through the plain versions, whose
    distance to the CPU step is printed (the f32 model's own spread
    between two devices, a diagnostic); every backward kernel call of the
    card's step is held to its plain version in f64 on its own inputs."""
    import torch

    from repro_torch.data.pipeline import make_lm_batches
    from repro_torch.params import init_params
    from repro_torch.tree import tree_flatten, tree_map

    t_run = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, g, "cuda")
    cpu_params = tree_map(lambda t: t.to("cpu"), params)
    tokens = next(make_lm_batches(batch, seq, cfg.vocab_size, seed=1))[
        "tokens"]
    card = _eq_step(cfg, params, tokens, "cuda")
    assert not card["plain"], f"[{label}] plain versions ran: " \
        f"{card['plain']}"
    cpu = _eq_step(cfg, cpu_params, tokens, "cpu")
    if family and cfg.is_moe:
        _same_routing(label, card["routes"], cpu["routes"])
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    paths = list(tree_flatten(params))
    worst, worst_at = _worst_leaf(paths, card["grads"], cpu["grads"])
    tol = TRAIN_EQ_GRAD_TOL.get(cfg.name, TRAIN_EQ_TOL[1])
    spread = ""
    if family:
        card_plain = _eq_step(cfg, params, tokens, "cuda", plain=True)
        plain_worst, plain_at = _worst_leaf(paths, card_plain["grads"],
                                            cpu["grads"])
        spread = (f"; the plain versions on the card against the CPU "
                  f"(diagnostic): {plain_worst:.2e} at {plain_at} (step "
                  f"{card_plain['secs']:.2f}s)")
        del card_plain
    n = card["launches"]
    print(f"  [{label}] {cfg.name} {cfg.n_layers} layers f32, B {batch} x "
          f"{seq}: loss card {card['loss']:.6f} / CPU {cpu['loss']:.6f} "
          f"(relative error {loss_err:.2e}, tolerance {TRAIN_EQ_TOL[0]}); "
          f"worst gradient leaf {worst_at}: max error / max |g| = "
          f"{worst:.2e} (tolerance {tol:.2e}){spread}; card step "
          f"{card['secs']:.2f}s (launches {n}), CPU step {cpu['secs']:.2f}s;"
          f" run wall {time.perf_counter() - t_run:.1f}s", flush=True)
    if card["bwd"].calls:
        print(f"  [{label}] the backward kernels on the step's own inputs "
              f"against their plain versions in f64: "
              + card["bwd"].worst(label), flush=True)
    assert loss_err <= TRAIN_EQ_TOL[0] and worst <= tol
    assert n == _expected_launches(cfg, seq), (n, _expected_launches(cfg,
                                                                     seq))
    del params, cpu_params, card, cpu
    _free()


def eq_readings(seeds=(1, 2, 3, 4)) -> None:
    """The readings that set 5t-eq-k's fixed gradient limit
    (``TRAIN_EQ_GRAD_TOL``; ``python3 chip_smoke.py --eq-readings``): at
    5t-eq-k's config, for each weight seed the worst gradient leaf of the
    plain versions run on the card against the CPU step (the f32 model's
    spread between two devices: the limit must sit above its largest),
    and of the kernels' step from the same weights rounded to bf16
    against the CPU step from the f32 weights (an error of bf16's size:
    the limit must sit below it)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_lm_batches
    from repro_torch.params import init_params
    from repro_torch.tree import tree_flatten, tree_map
    label, arch, layers = TRAIN_EQ_FAMILIES[2]
    cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                              dtype="float32")
    tokens = next(make_lm_batches(2, TRAIN_EQ_FAMILY_S, cfg.vocab_size,
                                  seed=1))["tokens"]
    for seed in seeds:
        g = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, g, "cuda")
        paths = list(tree_flatten(params))
        cpu = _eq_step(cfg, tree_map(lambda t: t.to("cpu"), params),
                       tokens, "cpu")
        kern = _eq_step(cfg, params, tokens, "cuda")
        plain = _eq_step(cfg, params, tokens, "cuda", plain=True)
        ctrl = _eq_step(cfg, tree_map(
            lambda t: t.detach().bfloat16().float(), params), tokens, "cuda")
        print(f"  [eq readings] {label} {cfg.name} {layers} layers f32, B 2 x "
              f"{TRAIN_EQ_FAMILY_S}, weight seed {seed}: worst leaf against "
              f"the CPU: kernels %.2e at %s, plain versions on the card "
              f"%.2e at %s, kernels on bf16-rounded weights %.2e at %s" % (
                  *_worst_leaf(paths, kern["grads"], cpu["grads"]),
                  *_worst_leaf(paths, plain["grads"], cpu["grads"]),
                  *_worst_leaf(paths, ctrl["grads"], cpu["grads"])),
              flush=True)
        del params, cpu, kern, plain, ctrl
        _free()


# ---------------------------------------------------------------------------
# phase 6: the examples, and the model on a mesh

# 6a: each example at its defaults: (script under examples/, the kernels
# it must launch, a line it must print)
EXAMPLES = (
    ("torch_quickstart", ("flash_attention", "decode_attention"),
     "lossless: speculative output == target greedy decoding  [OK]"),
    ("torch_serve_spec_offload",
     ("flash_attention", "paged_decode_attention", "moe_ffn",
      "decode_attention"), "fused compiles=1"),
    ("torch_train_small", ("flash_attention", "flash_attention_bwd"),
     "training OK: loss fell >2x"),
    ("torch_planner_demo", (), "give it to the draft model instead."))
# 6b: Mixtral-8x7B's expert layer (E, D, F, top-k, activation); each
# mode's mesh, B, S and dtypes.  tp on 7 ranks: 8 experts do not split
# over 7, F 14336 = 7 x 2048 does
MESH_MOE = (8, 4096, 14336, 2, "swiglu")
MESH_CASES = {(1, 2): (("ep", 1, 512, ("float32", "bfloat16")),
                       ("ep_psum", 4, 1, ("float32",))),
              (1, 7): (("tp", 1, 512, ("float32", "bfloat16")),)}
TOL_MESH = 1e-5            # f32: of the output's largest magnitude
# 6c: Mixtral-8x7B's widths at 2 layers, f32, dropless (at a finite
# capacity ep's per-rank capacity drops other tokens than one process's);
# B 2 prompts, then greedy decode steps
MESH_DECODE = (2, 2, 256, 8)          # layers, B, prompt, steps
TOL_MESH_LOGITS = 1e-4     # of the logits' largest magnitude
MESH_JOIN_S = 300          # a hung group fails within this
# 6d: the SpecOffload engine on the (1, 2) mesh: Mixtral-8x7B with a
# Mistral-7B draft at full width, 2 layers each, f32, weights from a seed,
# dropless (as 6c: ep's per-rank capacity drops other prefill tokens than
# one process's); 4 prompts of 128 tokens, 16 generated each, 4
# candidates a round
MESH_ENGINE = (2, 4, 128, 16, 4)      # layers, prompts, length, gen, n_cand
# 6e: one AdamW step of Mixtral-8x7B's widths at 1 layer, f32, dropless,
# B 2 x 256, on (1, 2) (tensor parallel, ep) and (2, 1) (FSDP, the batch
# split; a second mesh over the same two ranks), against the same step in
# one process (each rank runs that step too and keeps its blocks of the
# result)
MESH_TRAIN = (1, 2, 256, 1e-3)        # layers, B, S, lr
MESH_TRAIN_SHAPES = ((1, 2), (2, 1))
TOL_MESH_LOSS = 1e-5       # relative
# 6f / 6g (PR 27): sequence parallelism under the default profile on
# (1, 2): RecurrentGemma-2B at full width, 3 layers (RG-LRU, RG-LRU, SWA:
# one group of the pattern; its window of 2048 does not bind at S 512:
# context-parallel attention, the RG-LRU channel-parallel at 1280 of 2560
# channels a rank), and RWKV-6-7B at full width, 2 layers (32 of 64 heads
# a rank); f32, weights from a seed; prefill, greedy decode steps and one
# AdamW step, each against one process on the same card
MESH_SEQ = {"6f": ("recurrentgemma-2b", 3), "6g": ("rwkv6-7b", 2)}
MESH_SEQ_RUN = (2, 512, 8, 1e-3)      # B, S, decode steps, lr


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase() -> dict:
    """6a: each example's ``main`` in this process on the card, its
    printed lines, wall and launches.  No kernel's plain version may run;
    the model's plain attention only where the JAX package's model runs
    it too (the serving example's sliding-window draft rings)."""
    import contextlib
    import io

    import torch

    from repro_torch.kernels import launch_counts, reset_launches

    runs = {}
    for name, must, line in EXAMPLES:
        mod = _load_example(name)
        text = io.StringIO()
        _free()
        reset_launches()
        t0 = time.perf_counter()
        with _PlainAttentionCounter() as plain, \
                contextlib.redirect_stdout(text):
            mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        for row in text.getvalue().splitlines():
            print(f"  [6a {name}] | {row}")
        ring = plain.calls.pop("attention_direct", 0)
        print(f"  [6a {name}] wall {wall:.2f}s, launches: "
              + (", ".join(f"{k} {v}" for k, v in counts.items()) or "none")
              + (f"; the draft rings' plain attention: {ring} calls"
                 if ring else ""), flush=True)
        assert line in text.getvalue(), f"{name} did not print {line!r}"
        for k in must:
            assert counts.get(k, 0) > 0, f"{name} never launched {k}"
        if not must:
            assert not counts, f"{name} launched {counts}"
        assert not plain.calls, f"{name}: plain versions ran: {plain.calls}"
        assert not ring or name == "torch_serve_spec_offload", name
        runs[name] = counts
    return runs


def _mesh_rank(rank, world, shape, store, out_dir, job, args):
    """One rank of a gloo group on the card (NCCL refuses two ranks on
    one device): its mesh, then ``job(mesh, *args)``, pickled."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_JOIN_S))
    try:
        res = job(make_mesh(shape, device_type="cuda"), *args)
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn_mesh(shape, job, *args) -> list:
    """``job`` on every rank of a ``shape`` mesh, all on this card; the
    ranks' results in rank order.  A rank that raises stops the others;
    a group that hangs is killed after ``MESH_JOIN_S``."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    world = int(np.prod(shape))
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _mesh_rank, args=(world, shape, os.path.join(tmp, "store"), tmp,
                              job, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + MESH_JOIN_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise AssertionError(f"mesh {shape}: the ranks did not "
                                     f"finish in {MESH_JOIN_S} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _moe_inputs(b, s, dname):
    """Mixtral-8x7B's expert layer and x (B, S, D), drawn from seed 0 an
    expert at a time, the same in every process."""
    import torch
    e, d, f, _, _ = MESH_MOE
    dt = getattr(torch, dname)
    g = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda")
    p = {"router": rn(d, e) * d ** -0.5}
    for name, (rows, cols) in (("w_gate", (d, f)), ("w_up", (d, f)),
                               ("w_down", (f, d))):
        p[name] = torch.empty((e, rows, cols), dtype=dt, device="cuda")
        for i in range(e):
            p[name][i] = (rn(rows, cols) * rows ** -0.5).to(dt)
    return p, rn(b, s, d).to(dt)


def _mesh_moe(params, x, mesh):
    """The MoE layer, dropless; (output on the host, moe_ffn launches,
    seconds)."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import moe
    e, _, _, k, act = MESH_MOE
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    y = moe.apply_moe(params, x, n_experts=e, top_k=k, activation=act,
                      mesh=mesh, capacity_factor=float("inf"))
    torch.cuda.synchronize()
    return (y.float().cpu().numpy(), launch_counts()["moe_ffn"],
            time.perf_counter() - t0)


def _mesh_moe_job(mesh, cases):
    """Each case's layer on this rank's at-rest shard
    (``moe_storage_specs``)."""
    import torch

    from repro_torch.launch.mesh import axis_size, shard_params
    from repro_torch.models import moe
    out = {}
    for mode, b, s, dname in cases:
        params, x = _moe_inputs(b, s, dname)
        assert moe.select_moe_mode(MESH_MOE[0], s, mesh) == mode, mode
        shard = shard_params(params, moe.moe_storage_specs(
            MESH_MOE[4], MESH_MOE[0], axis_size(mesh, "model")), mesh)
        del params
        torch.cuda.empty_cache()
        out[mode, dname] = _mesh_moe(shard, x, mesh)
    return out


def _mesh_decode(mesh=None) -> dict:
    """6c: prefill and greedy decode of Mixtral-8x7B's widths at
    ``MESH_DECODE``; on a mesh each rank holds its ``shard_model``
    blocks.  Logits and tokens on the host, walls, launches."""
    import torch

    from repro_torch.configs import MIXTRAL_8X7B
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    from repro_torch.params import init_params

    layers, b, prompt, steps = MESH_DECODE
    cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=layers,
                              dtype="float32", moe_dropless=True)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if mesh is not None:
        params = M.shard_model(params, cfg, mesh)
        torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    cache = init_cache(cfg, b, prompt + steps + 1, "cuda", mesh)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    lg, cache = M.prefill(params, cfg, tokens, cache, mesh)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: v for k, v in launch_counts().items() if v}
    reset_launches()
    logits, toks, step_s = [lg], [], []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        t0 = time.perf_counter()
        lg, cache = M.decode_step(params, cfg, cache, tok[:, None], mesh)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        logits.append(lg)
    return {"logits": torch.stack(logits, 1).cpu().numpy(),
            "tokens": torch.stack(toks, 1).cpu().numpy(),
            "prefill_s": prefill_s, "step_s": step_s,
            "prefill_launches": prefill_launches,
            "decode_launches": {k: v for k, v in launch_counts().items()
                                if v}}


def _seq_cfg(label):
    from repro_torch.configs import get_config
    name, layers = MESH_SEQ[label]
    return dataclasses.replace(get_config(name), n_layers=layers,
                               dtype="float32")


def _seq_decode(label, mesh=None) -> dict:
    """6f / 6g: prefill and greedy decode at ``MESH_SEQ_RUN``; on a mesh
    each rank holds its ``shard_model`` blocks.  Logits and tokens on
    the host, launches, the recurrent state's channels a rank."""
    import torch

    from repro_torch.configs import RGLRU, RWKV
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    from repro_torch.params import init_params

    b, prompt, steps, _ = MESH_SEQ_RUN
    cfg = _seq_cfg(label)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if mesh is not None:
        params = M.shard_model(params, cfg, mesh)
        torch.cuda.empty_cache()
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))
    cache = init_cache(cfg, b, prompt + steps + 1, "cuda", mesh)
    state = {}
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == RGLRU:
            state["rglru width"] = cache["layers"][l]["h"].shape[-1]
        elif kind == RWKV:
            state["wkv6 heads"] = cache["layers"][l]["S"].shape[1]
    torch.cuda.synchronize()
    reset_launches()
    lg, cache = M.prefill(params, cfg, tokens, cache, mesh)
    torch.cuda.synchronize()
    prefill_launches = {k: v for k, v in launch_counts().items() if v}
    reset_launches()
    logits, toks = [lg], []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        lg, cache = M.decode_step(params, cfg, cache, tok[:, None], mesh)
        logits.append(lg)
    torch.cuda.synchronize()
    return {"logits": torch.stack(logits, 1).cpu().numpy(),
            "tokens": torch.stack(toks, 1).cpu().numpy(),
            "prefill_launches": prefill_launches, "state": state,
            "decode_launches": {k: v for k, v in launch_counts().items()
                                if v}}


def _mesh_seq_job(mesh):
    """6f / 6g on one rank: each model's decode and step."""
    out = {}
    for label in MESH_SEQ:
        b, s, _, lr = MESH_SEQ_RUN
        _free()
        out[label] = {"decode": _seq_decode(label, mesh)}
        _free()
        out[label]["train"] = _mesh_train(mesh, _seq_cfg(label), b, s, lr)
    return out


def _dry_run(cfg, shape: list, mesh_shape: tuple):
    """``launch/dryrun.run_one`` of ``cfg`` at ``shape`` (an InputShape's
    fields) on a fake group of ``mesh_shape``, in a process of its own:
    its Popen, read by :func:`_dry_record`."""
    code = ("import json, sys\n"
            "from repro_torch.configs import InputShape, ModelConfig\n"
            "from repro_torch.launch.dryrun import run_one\n"
            "cfg = ModelConfig(**json.loads(sys.argv[1]))\n"
            "print(json.dumps(run_one(cfg, InputShape(*json.loads("
            "sys.argv[2])), tuple(json.loads(sys.argv[3])))))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(dataclasses.asdict(cfg)),
         json.dumps(shape), json.dumps(list(mesh_shape))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))


def _seq_dry_run(label):
    """The dry run of 6f / 6g's training step on the same (1, 2) mesh."""
    b, s, _, _ = MESH_SEQ_RUN
    return _dry_run(_seq_cfg(label), [label, s, b, "train"], (1, 2))


def _dry_record(proc) -> dict:
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.splitlines()[-1])


def _seq_report(label, ranks, single, dry, smi) -> None:
    """6f / 6g: every rank against one process, its launches, and its
    argument bytes against the dry run's."""
    b, s, steps, lr = MESH_SEQ_RUN
    name, layers = MESH_SEQ[label]
    scale = float(np.abs(single["logits"]).max())
    for rank, res in enumerate(ranks):
        got = res[label]["decode"]
        err = float(np.abs(got["logits"] - single["logits"]).max())
        same = bool(np.array_equal(got["tokens"], single["tokens"]))
        print(f"  [{label}] {name} {layers} layers f32 rank {rank}: logits "
              f"max abs err {err:.3e} (max |logit| {scale:.3e}), greedy "
              f"tokens equal the single process's: {same}; state a rank "
              f"{got['state']} (one process {single['state']}); prefill "
              f"launches {got['prefill_launches']}, decode launches "
              f"{got['decode_launches']}", flush=True)
        assert err <= TOL_MESH_LOGITS * scale, (label, rank, err, scale)
        assert same, (label, rank)
        pre, dec = got["prefill_launches"], got["decode_launches"]
        if label == "6f":
            assert got["state"]["rglru width"] == 1280, got["state"]
            assert pre.get("rglru_gated_scan", 0) > 0, pre
            assert pre.get("flash_attention", 0) > 0, pre
            # rank 0's block of the queries starts at position 0
            assert (pre.get("flash_attention q_offset", 0) > 0) == (
                rank > 0), pre
            assert dec.get("rglru_gated_scan", 0) > 0, dec
        else:
            assert got["state"]["wkv6 heads"] == 32, got["state"]
            assert pre.get("wkv6", 0) > 0 and dec.get("wkv6", 0) > 0
        tr = res[label]["train"]
        rel = abs(tr["loss"] - tr["ref_loss"]) / abs(tr["ref_loss"])
        clear = max(e[0] for e in tr["errs"])
        worst = max(e[1] for e in tr["errs"])
        print(f"  [{label}] step rank {rank}: loss {tr['loss']:.6f} / one "
              f"process {tr['ref_loss']:.6f} (relative error {rel:.2e}); "
              f"parameters worst {clear:.2e} where |g| > 1e-4, {worst:.2e} "
              f"anywhere; step wall {tr['wall']:.2f}s; launches "
              f"{tr['launches']}", flush=True)
        print(f"  [{label}] rank {rank} holds {tr['args']} bytes at the "
              f"step's start (parameter + AdamW blocks + tokens); the dry "
              f"run of the same step and mesh: {dry['argument_bytes']} "
              f"bytes; peak {tr['peak'] / 2**30:.2f} GiB on the card "
              f"(its CUDA caching allocator's, both ranks on one card) / "
              f"{dry['peak_bytes'] / 2**30:.2f} GiB in the dry run; "
              f"collectives {dry['collectives']} ({smi})", flush=True)
        assert tr["args"] == dry["argument_bytes"], (label, rank)
        assert rel <= TOL_MESH_LOSS, (label, rank, rel)
        assert clear <= 1e-6 and worst <= 2 * lr, (label, rank, clear, worst)
        want = (("flash_attention_bwd", "rglru_gated_scan_bwd") if
                label == "6f" else ("wkv6_bwd",))
        for k in want:
            assert tr["launches"].get(k, 0) > 0, (label, rank, k)
        if label == "6f":
            assert (tr["launches"].get("flash_attention_bwd q_offset", 0)
                    > 0) == (rank > 0), tr["launches"]


def seq_phase(smi: str) -> None:
    """6f / 6g: the one-process references, then one (1, 2) spawn for
    both models, then the dry runs of the two steps."""
    singles = {}
    for label in MESH_SEQ:
        singles[label] = _seq_decode(label)
        _free()
    t0 = time.perf_counter()
    dry = {label: _seq_dry_run(label) for label in MESH_SEQ}  # on the host
    try:
        ranks = _spawn_mesh((1, 2), _mesh_seq_job)
    except BaseException:
        for proc in dry.values():
            proc.kill()
            proc.wait()
        raise
    print(f"  [6f/6g] mesh (1, 2): 2 ranks on cuda:0 (gloo), wall "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for label in MESH_SEQ:
        rec = _dry_record(dry[label])
        print(f"  [{label}] dry run of the step on a fake (1, 2) group, "
              f"beside the spawn: {rec['seconds']:.1f}s, "
              f"{rec['flops']:.3e} flops ({rec['kernel_flops']})",
              flush=True)
        _seq_report(label, ranks, singles[label], rec, smi)


def _mesh_pair_job(mesh, cases):
    """The two ranks' work: on the (1, 2) mesh its MoE cases, 6c's
    decode, 6d's engine and 6e's step, then 6e's step on a (2, 1) mesh
    over the same two ranks."""
    from repro_torch.launch.mesh import make_mesh
    out = _mesh_moe_job(mesh, cases)
    _free()
    out["decode"] = _mesh_decode(mesh)
    _free()
    out["engine"] = _mesh_engine(mesh)
    out["train"] = {}
    for shape in MESH_TRAIN_SHAPES:
        _free()
        out["train"][shape] = _mesh_train(
            mesh if shape == (1, 2) else make_mesh(shape, device_type="cuda"))
    return out


def _mesh_engine(mesh=None) -> dict:
    """6d: ``SpecOffloadEngine.generate`` at ``MESH_ENGINE``, over
    ``mesh`` (``load`` lays each rank's blocks out) or in one process:
    streams, rounds, the fused round's shape signatures, launches, wall."""
    import torch

    from repro_torch.configs import MIXTRAL_8X7B, draft_for
    from repro_torch.core.pipeline import SpecOffloadEngine
    from repro_torch.kernels import launch_counts, reset_launches

    layers, n, length, gen, n_cand = MESH_ENGINE
    tcfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=layers,
                               dtype="float32", moe_dropless=True)
    eng = SpecOffloadEngine(tcfg, draft_for(tcfg, layers), device="cuda",
                            mesh=mesh)
    eng.init_from_seed(0)
    _free()
    prompts = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (n, length)).astype(np.int32)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = eng.generate(prompts, gen, n_cand=n_cand)
    torch.cuda.synchronize()
    return {"tokens": res.tokens, "rounds": res.rounds,
            "fused": eng._pipe.trace_counts["fused"],
            "wall": time.perf_counter() - t0,
            "launches": {k: v for k, v in launch_counts().items() if v}}


def _mesh_train(mesh, cfg=None, b=None, s=None, lr=None) -> dict:
    """6e (6f / 6g: ``cfg``, B, S, lr) on one rank: the one-process step
    first (its result and its gradient's clear entries kept as this
    rank's blocks), then the mesh step from the same seed; the
    first-step rule on every block.  Also the bytes the rank holds when
    the step starts (parameter and optimizer blocks, the token batch)."""
    import torch

    from repro_torch.configs import MIXTRAL_8X7B
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.mesh import shard_params
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.train_loop import loss_and_grads
    from repro_torch.tree import tree_leaves, tree_unflatten

    if cfg is None:
        layers, b, s, lr = MESH_TRAIN
        cfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=layers,
                                  dtype="float32", moe_dropless=True)
    batch = {"tokens": np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)}
    specs = M.mesh_specs(cfg, mesh)
    # this rank's blocks of the one-process result, kept in host memory
    # (the mesh step's gathers need the card's room on (2, 1))
    blocks = lambda tree: [t.detach().cpu() for t in tree_leaves(  # noqa: E731
        shard_params(tree, specs, mesh))]

    def whole():
        return init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")

    params = whole()
    for p in tree_leaves(params):
        p.requires_grad_(True)
    _, grads = loss_and_grads(params, cfg, {
        "tokens": torch.as_tensor(batch["tokens"], device="cuda").long()})
    clear = blocks(tree_unflatten(params, [g.abs() > 1e-4 for g in grads]))
    del grads
    _free()
    ref_step = make_train_step(cfg, None, lr)
    params, state, ref_loss = ref_step(params, adamw_init(params), batch)
    ref = blocks(params)
    ref_loss = float(ref_loss)
    del params, state, ref_step
    _free()

    params = shard_params(whole(), specs, mesh)
    _free()
    state = adamw_init(params)
    args = tree_bytes(params) + tree_bytes(state) + b * s * 8  # int64 tokens
    step = make_train_step(cfg, mesh, lr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    params, state, loss = step(params, state, batch)
    loss = float(loss)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in launch_counts().items() if v}
    errs = []
    with torch.no_grad():
        for got, want, ok in zip(tree_leaves(params), ref, clear):
            diff = (got.detach().cpu() - want).abs()
            errs.append((float(diff[ok].max()) if ok.any() else 0.0,
                         float(diff.max())))
    return {"loss": loss, "ref_loss": ref_loss, "errs": errs, "wall": wall,
            "peak": peak, "launches": launches, "args": args,
            "grad_norm": float(step.grad_norm)}


def mesh_phase(smi: str) -> None:
    """6b-6e: every rank a process of a gloo group on this card.  Each
    case against the single-process layer, model, engine or step on the
    same card, weights and inputs."""
    import torch

    refs = {}
    for shape, cases in MESH_CASES.items():
        for mode, b, s, dnames in cases:
            for dname in dnames:
                params, x = _moe_inputs(b, s, dname)
                refs[mode, dname] = _mesh_moe(params, x, None)
                del params, x
                _free()
    single = _mesh_decode()
    _free()
    engine_ref = _mesh_engine()
    _free()
    free, total = torch.cuda.mem_get_info()
    print(f"  [6] before the spawns this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB; the card has "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free", flush=True)
    for shape, cases in MESH_CASES.items():
        flat = [(mode, b, s, dn) for mode, b, s, dns in cases for dn in dns]
        t0 = time.perf_counter()
        job = _mesh_pair_job if shape == (1, 2) else _mesh_moe_job
        ranks = _spawn_mesh(shape, job, flat)
        print(f"  [6b] mesh {shape}: {len(ranks)} ranks on cuda:0 (gloo), "
              f"wall {time.perf_counter() - t0:.1f}s", flush=True)
        for mode, b, s, dname in flat:
            want, ref_launches, ref_s = refs[mode, dname]
            scale = float(np.abs(want).max())
            errs, launches, secs = [], [], []
            for res in ranks:
                got, n, sec = res[mode, dname]
                assert got.shape == want.shape
                errs.append(float(np.abs(got - want).max()))
                launches.append(n)
                secs.append(sec)
                if dname == "bfloat16":
                    _check("moe mesh", f"{mode} {shape}", torch.as_tensor(got),
                           torch.as_tensor(want), dname)
            print(f"  [6b] {mode} mesh {shape} B {b} x S {s} {dname}: max "
                  f"abs err {max(errs):.3e} (max |out| {scale:.3e}, err/max "
                  f"{max(errs) / scale:.2e}), moe_ffn launches a rank "
                  f"{launches} (one process: {ref_launches}), seconds a rank "
                  + ", ".join(f"{t:.3f}" for t in secs)
                  + f" (one process {ref_s:.3f})", flush=True)
            if dname == "float32":
                assert max(errs) <= TOL_MESH * scale, (mode, errs, scale)
            if mode in ("ep", "tp"):
                assert all(n > 0 for n in launches), (mode, launches)
        if shape == (1, 2):
            pair = ranks
    want = single
    scale = float(np.abs(want["logits"]).max())
    for rank, res in enumerate(pair):
        got = res["decode"]
        err = float(np.abs(got["logits"] - want["logits"]).max())
        same = bool(np.array_equal(got["tokens"], want["tokens"]))
        print(f"  [6c] rank {rank}: logits max abs err {err:.3e} (max "
              f"|logit| {scale:.3e}), greedy tokens equal the single "
              f"process's: {same}; prefill launches "
              f"{got['prefill_launches']}, decode launches "
              f"{got['decode_launches']}", flush=True)
        assert err <= TOL_MESH_LOGITS * scale, (rank, err, scale)
        assert same, (got["tokens"], want["tokens"])
    mesh_run = pair[0]["decode"]
    layers, b, prompt, steps = MESH_DECODE
    print(f"  [6c] Mixtral-8x7B widths, {layers} layers, f32, B {b} x "
          f"{prompt}: prefill {mesh_run['prefill_s']:.3f}s on the (1, 2) "
          f"mesh (ep) / {want['prefill_s']:.3f}s in one process; decode "
          f"step median {1e3 * np.median(mesh_run['step_s']):.1f} ms "
          f"(ep_psum) / {1e3 * np.median(want['step_s']):.1f} ms, for the "
          f"record only ({smi})", flush=True)
    _engine_report(pair, engine_ref, smi)
    for shape in MESH_TRAIN_SHAPES:
        _train_report(shape, [res["train"][shape] for res in pair])
    _free()
    seq_phase(smi)
    _free()
    layout_phase(smi)


# 6h / 6i: decode caches in the production layout on a (2, 2) mesh (the
# batch over "data", the sequence over "model", every kv head; the
# verify kernel's partials merged by log-sum-exp), f32, weights from a
# seed, against one process: Gemma-3-12B at full width, 6 layers (five
# sliding-window layers, window 1024, and the global one), B 2, a cache
# of 4096 slots (2048 a rank: rank 1's global block starts empty) and a
# 2044-token prompt, 8 greedy steps across slot 2048; Whisper-base whole
# (the encoder on its blocks, its 8 heads 4 a rank), B 2, 128 slots, a
# 60-token prompt, 8 steps across slot 64
# label: (config, layers, B, cache slots, prompt, steps)
MESH_LAYOUT = {"6h": ("gemma3-12b", 6, 2, 4096, 2044, 8),
               "6i": ("whisper-base", 6, 2, 128, 60, 8)}
MESH_LAYOUT_SHAPE = (2, 2)


def _layout_cfg(label):
    from repro_torch.configs import get_config
    name, layers = MESH_LAYOUT[label][:2]
    return dataclasses.replace(get_config(name), n_layers=layers,
                               dtype="float32")


def _layout_shape(label):
    from repro_torch.configs import InputShape
    _, _, b, slots, _, _ = MESH_LAYOUT[label]
    return InputShape(label, slots, b, "decode")


def _layout_decode(label, mesh=None) -> dict:
    """6h / 6i on one rank (or in one process, ``mesh`` None): prefill
    and greedy steps, the cache in the production layout on a mesh;
    logits and tokens on the host, launches, the bytes the rank holds
    when the decode steps start (parameter and cache blocks, the (B, 1)
    tokens) and its global layer's cache block."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.launch.specs import cache_layout
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    from repro_torch.params import init_params

    _, _, b, slots, prompt, steps = MESH_LAYOUT[label]
    cfg = _layout_cfg(label)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    if mesh is not None:
        params = M.shard_model(params, cfg, mesh)
        _free()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, prompt), device="cuda",
                           generator=gen)
    frames = (torch.randn((b, cfg.encoder_len, cfg.d_model), device="cuda",
                          generator=gen) if cfg.encoder_decoder else None)
    layout = None if mesh is None else cache_layout(_layout_shape(label),
                                                    mesh)
    cache = init_cache(cfg, b, slots, "cuda", mesh, layout=layout)
    glob = next(l for l in range(cfg.n_layers) if cfg.layer_kind(l) == "attn")
    block = tuple(cache["layers"][glob]["k"].shape)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    lg, cache = M.prefill(params, cfg, tokens, cache, mesh,
                          encoder_frames=frames)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = {k: v for k, v in launch_counts().items() if v}
    args = tree_bytes(params) + tree_bytes(cache) + b * 8
    reset_launches()
    logits, toks, step_s = [lg], [], []
    for _ in range(steps):
        tok = torch.argmax(lg, -1)
        toks.append(tok)
        t0 = time.perf_counter()
        lg, cache = M.decode_step(params, cfg, cache, tok[:, None], mesh)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        logits.append(lg)
    return {"logits": torch.stack(logits, 1).cpu().numpy(),
            "tokens": torch.stack(toks, 1).cpu().numpy(),
            "prefill_launches": prefill_launches, "args": args,
            "block": block, "prefill_s": prefill_s, "step_s": step_s,
            "peak": torch.cuda.max_memory_allocated(),
            "decode_launches": {k: v for k, v in launch_counts().items()
                                if v}}


def _mesh_layout_job(mesh):
    out = {}
    for label in MESH_LAYOUT:
        _free()
        out[label] = _layout_decode(label, mesh)
    return out


def layout_phase(smi: str) -> None:
    """6h / 6i: the one-process references, then one (2, 2) spawn for
    both models beside their decode steps' dry runs: every rank against
    one process, its launches (``decode_attention``'s ``partial`` route
    on the global layers), and its bytes at the decode's start against
    the dry run's argument bytes."""
    singles = {}
    for label in MESH_LAYOUT:
        singles[label] = _layout_decode(label)
        _free()
    t0 = time.perf_counter()
    dry = {label: _dry_run(_layout_cfg(label), list(dataclasses.astuple(
        _layout_shape(label))), MESH_LAYOUT_SHAPE) for label in MESH_LAYOUT}
    try:
        ranks = _spawn_mesh(MESH_LAYOUT_SHAPE, _mesh_layout_job)
    except BaseException:
        for proc in dry.values():
            proc.kill()
            proc.wait()
        raise
    print(f"  [6h/6i] mesh {MESH_LAYOUT_SHAPE}: {len(ranks)} ranks on "
          f"cuda:0 (gloo), wall {time.perf_counter() - t0:.1f}s", flush=True)
    for label, (name, layers, b, slots, prompt, steps) in MESH_LAYOUT.items():
        rec = _dry_record(dry[label])
        one = singles[label]
        scale = float(np.abs(one["logits"]).max())
        n_glob = sum(_layout_cfg(label).layer_kind(l) == "attn"
                     for l in range(layers))
        print(f"  [{label}] {name} {layers} layers f32, B {b}, {slots} "
              f"slots, prompt {prompt}, {steps} steps; one process: prefill "
              f"{one['prefill_s']:.2f}s, step median "
              f"{1e3 * np.median(one['step_s']):.1f} ms, global layer's "
              f"cache {one['block']}; dry run of the decode step on a fake "
              f"{MESH_LAYOUT_SHAPE} group: {rec['argument_bytes']} argument "
              f"bytes, peak {rec['peak_bytes'] / 2**30:.2f} GiB, "
              f"collectives {rec['collectives']}", flush=True)
        for rank, res in enumerate(ranks):
            got = res[label]
            err = float(np.abs(got["logits"] - one["logits"]).max())
            same = bool(np.array_equal(got["tokens"], one["tokens"]))
            pre, dec = got["prefill_launches"], got["decode_launches"]
            print(f"  [{label}] rank {rank}: logits max abs err {err:.3e} "
                  f"(max |logit| {scale:.3e}), greedy tokens equal the "
                  f"single process's: {same}; global layer's cache block "
                  f"{got['block']}; holds {got['args']} bytes at the decode's "
                  f"start (the dry run: {rec['argument_bytes']}); prefill "
                  f"{got['prefill_s']:.2f}s, step median "
                  f"{1e3 * np.median(got['step_s']):.1f} ms, peak "
                  f"{got['peak'] / 2**30:.2f} GiB (both for the record, "
                  f"{smi}); prefill launches {pre}, decode launches {dec}",
                  flush=True)
            assert err <= TOL_MESH_LOGITS * scale, (label, rank, err, scale)
            assert same, (label, rank)
            assert got["args"] == rec["argument_bytes"], (label, rank)
            assert pre.get("flash_attention", 0) > 0, pre
            # one launch a global layer a step, each on the rank's slice
            assert dec.get("decode_attention partial", 0) == (
                n_glob * steps), dec
            assert got["block"][:2] == (b // MESH_LAYOUT_SHAPE[0],
                                        slots // MESH_LAYOUT_SHAPE[1])


def _engine_report(ranks, want, smi) -> None:
    """6d: every rank's streams against the one-process engine's."""
    layers, n, length, gen, n_cand = MESH_ENGINE
    for rank, res in enumerate(ranks):
        got = res["engine"]
        same = bool(np.array_equal(got["tokens"], want["tokens"]))
        launch = {k: got["launches"].get(k, 0) for k in
                  ("decode_attention", "flash_attention", "moe_ffn")}
        print(f"  [6d] rank {rank}: streams equal the one process's: {same}"
              f" ({got['rounds']} rounds / {want['rounds']}); fused shape "
              f"signatures={got['fused']}; launches {launch} (one process "
              + str({k: want["launches"].get(k, 0) for k in launch})
              + "; the rank attends over 16 of 32 heads and runs 4 of 8 "
              "experts)", flush=True)
        assert same, (rank, got["tokens"], want["tokens"])
        assert got["rounds"] == want["rounds"] and got["fused"] == 1, got
        assert all(v > 0 for v in launch.values()), (rank, launch)
    print(f"  [6d] Mixtral-8x7B + Mistral-7B draft, {layers} layers each, "
          f"f32, {n} prompts x {length}, {gen} tokens, n_cand {n_cand}: "
          f"generate {ranks[0]['engine']['wall']:.2f}s over "
          f"{ranks[0]['engine']['rounds']} rounds on the (1, 2) mesh / "
          f"{want['wall']:.2f}s in one process, for the record only "
          f"({smi})", flush=True)


def _train_report(shape, ranks) -> None:
    """6e: each rank's loss and blocks against the one-process step."""
    lr = MESH_TRAIN[3]
    for rank, got in enumerate(ranks):
        rel = abs(got["loss"] - got["ref_loss"]) / abs(got["ref_loss"])
        clear = max(e[0] for e in got["errs"])
        worst = max(e[1] for e in got["errs"])
        print(f"  [6e] mesh {shape} rank {rank}: loss {got['loss']:.6f} / "
              f"one process {got['ref_loss']:.6f} (relative error "
              f"{rel:.2e}, tolerance {TOL_MESH_LOSS}); parameters: worst "
              f"{clear:.2e} where |g| > 1e-4 (limit 1e-6), {worst:.2e} "
              f"anywhere (limit {2 * lr}); grad norm {got['grad_norm']:.4f};"
              f" step wall {got['wall']:.2f}s, peak "
              f"{got['peak'] / 2**30:.2f} GiB; launches {got['launches']}",
              flush=True)
        assert rel <= TOL_MESH_LOSS, (shape, rank, rel)
        assert clear <= 1e-6 and worst <= 2 * lr, (shape, rank, clear, worst)
        for k in ("flash_attention_bwd", "moe_ffn_bwd"):
            assert got["launches"].get(k, 0) > 0, (shape, rank, k)


def ptxas_report(_build) -> None:
    """What ``-Xptxas -v`` said of the tensor-core, verify and recurrence
    kernels, and of every head dim 240 instantiation apart (beside the d
    256 verify tile with the most n-tiles).  The flash backward's wgmma
    kernels must exist at head dims 32, 64, 128, 240 and 256 and spill
    nothing; so must the expert FFN backward's wgmma kernel and the
    chunked ``wkv6_bwd`` at every instantiation."""
    d240 = []
    for src, kern in (("moe_ffn", "moe_wgmma_kernel"),
                      ("flash_attention", "flash_fwd_wgmma_kernel"),
                      ("flash_attention", "flash_fwd_kernel"),
                      ("flash_attention_bwd", "bwd_dkdv_wgmma_kernel"),
                      ("flash_attention_bwd", "bwd_dq_wgmma_kernel"),
                      ("flash_attention_bwd", "bwd_dkdv_f32_kernel"),
                      ("flash_attention_bwd", "bwd_dq_f32_kernel"),
                      ("paged_decode_attention", "paged_decode_mma_kernel"),
                      ("paged_decode_attention", "paged_decode_kernel"),
                      ("decode_attention", "decode_mma_kernel"),
                      ("decode_attention", "decode_kernel"),
                      ("wkv6", "wkv6_kernel"),
                      ("wkv6", "wkv6_chunked_kernel"),
                      ("rglru_scan", "rglru_serial_kernel"),
                      ("rglru_scan", "rglru_parallel_kernel"),
                      ("wkv6_bwd", "wkv6_bwd_kernel"),
                      ("wkv6_bwd", "wkv6_bwd_chunked_kernel"),
                      ("rglru_scan_bwd", "rglru_bwd_chunked_kernel"),
                      ("rglru_scan_bwd", "rglru_bwd_kernel"),
                      ("moe_ffn_bwd", "moe_bwd_wgmma_kernel"),
                      ("moe_ffn_bwd", "moe_bwd_f32_kernel")):
        usage = _build.ptxas_usage(src, kern)
        print(f"  ptxas -v {kern} (<template args>: registers, static smem "
              "B, spill stores/loads B): " + "; ".join(
                  f"<{a}>: {r}, {sm}, {ss}/{sl}"
                  for a, r, sm, ss, sl in usage))
        d240 += [f"{kern}<{a}> {r} regs, spills {ss}/{sl} B"
                 for a, r, sm, ss, sl in usage if "240" in a.split(",")]
        if kern == "decode_mma_kernel":
            d240 += [f"(beside {kern}<{a}> {r} regs, spills {ss}/{sl} B)"
                     for a, r, sm, ss, sl in usage if a == "256,10"]
        if kern in ("moe_bwd_wgmma_kernel", "wkv6_bwd_chunked_kernel",
                    "rglru_bwd_chunked_kernel"):
            # the backward kernels redesigned for the card: every
            # instantiation built, nothing spilled
            assert usage and all(ss == sl == 0
                                 for a, r, sm, ss, sl in usage), usage
        if kern == "rglru_bwd_chunked_kernel":
            # one chunk length a dtype of x: <88,1> (bf16) and <64,0>
            import torch
            from repro_torch.kernels import rglru_scan as rg
            assert sorted(a for a, *_ in usage) == sorted(
                f"{t},{int(dt == torch.bfloat16)}"
                for dt, t in rg.BWD_CHUNK.items()), usage
        if kern in ("bwd_dkdv_wgmma_kernel", "bwd_dq_wgmma_kernel"):
            # the backward's bf16 route: every head dim, nothing spilled
            assert sorted(int(a) for a, *_ in usage) == [32, 64, 128, 240,
                                                         256], usage
            assert all(ss == sl == 0 for a, r, sm, ss, sl in usage), usage
    # ... and no wgmma serialised, no warpgroup fence or wait injected
    for src in ("flash_attention_bwd", "moe_ffn_bwd"):
        log = _build._lib_path(src).with_suffix(".log")
        notes = re.findall(r"\((C75(?:17|19|20))\)", log.read_text())
        print(f"  ptxas wgmma notes in {src}: {len(notes)} "
              f"{sorted(set(notes))}")
        assert not notes, notes
    assert any("flash_fwd_wgmma_kernel<240>" in x for x in d240), d240
    print("  head dim 240 instantiations: " + "; ".join(d240), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t_all = time.perf_counter()
    print("== 1. environment")
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    if "--trace-check" in sys.argv[1:]:
        print("== 3g-tr alone (kernels built at first use)")
        traced_run("3g-tr")
        return 0
    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"  kernels built in {time.perf_counter() - t0:.2f}s wall "
          f"(nvcc seconds per source: "
          + ", ".join(f"{k}={v:.2f}" for k, v in per_source.items()) + ")",
          flush=True)
    ptxas_report(_build)
    if "--eq-readings" in sys.argv[1:]:
        eq_readings()
        return 0
    rates = host_phase(torch)

    phases = {}
    t0 = time.perf_counter()
    print("== 2. kernels against their plain versions")
    main_cases = kernel_cases(Bench(torch))
    phases["2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== 3. serve (bf16, weights from a seed)", flush=True)
    runs = serve_phase(rates)
    phases["3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== 4. lossless (f32)", flush=True)
    lossless_phase()
    phases["4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== 5. training", flush=True)
    train_runs = train_phase()
    phases["5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== 6. the examples, and the model on a mesh", flush=True)
    examples_phase()
    mesh_phase(smi)
    phases["6"] = time.perf_counter() - t0
    print("  phase wall seconds: " + ", ".join(
        f"{k}={v:.1f}" for k, v in phases.items())
        + f", total {time.perf_counter() - t_all:.1f}")

    kernels = []
    for name, run in PATH_RUN.items():
        err, ms, (bound_ms, bound_by), plain_ms, lib_ms = main_cases[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": REPLACES[name],
                        "launches": runs[run][PATH_ENTRY.get(name, name)],
                        "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms})
    for name, (run, source) in TRAIN_PATH.items():
        err, ms, (bound_ms, bound_by), plain_ms, lib_ms = main_cases[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{source}.cu",
                        "replaces": REPLACES[name],
                        "launches": train_runs[run][name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms})
    print("== 7. kernels")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
