"""End-to-end serving run over the PyTorch/CUDA port: a Poisson
request trace through the full SpecOffload engine -- offline placement,
zig-zag prefill, dual-batch interleaved decode with speculative
verification, and the continuous-batching scheduler (EOS retirement +
mid-flight admission).

    PYTHONPATH=src python examples/torch_serve_spec_offload.py \\
        [--arch mixtral-8x7b] [--device cpu]

The counterpart of ``examples/serve_spec_offload.py``, and it prints
what that script prints.  Uses the reduced config of the chosen
architecture; the pipeline structure (placement plan, interleaved
batches, rollback, slot scheduler, paged KV) is the production one.
Runs on the card unless ``--device cpu``: there a Mixtral target runs
the ``flash_attention`` (prefill), ``paged_decode_attention`` (verify)
and ``moe_ffn`` kernels.  The weights come from seed 0
(``ServingEngine.init_from_seed``) unless the caller hands them in.
"""
import argparse

import numpy as np

from repro_torch.configs import MISTRAL_7B, get_config
from repro_torch.data.pipeline import synthetic_dataset
from repro_torch.serving.engine import (SchedulerConfig, ServingEngine,
                                        latency_percentiles)
from repro_torch.serving.trace import poisson_requests
from repro_torch.sim.hardware import ENV1


def main(argv=None, *, target_params=None, draft_params=None):
    """Returns the finished requests, in the order they finished."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="req/s (Poisson)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    tcfg = get_config(args.arch).reduced(d_model=128)
    dcfg = MISTRAL_7B.reduced(d_model=64, vocab=tcfg.vocab_size)

    print(f"target: {tcfg.name} (reduced) | draft: {dcfg.name}")
    eng = ServingEngine(tcfg, dcfg, ENV1,
                        config=SchedulerConfig(max_batch=2, n_cand=3),
                        device=args.device)
    if target_params is None:
        eng.init_from_seed(0)
    else:
        eng.load(target_params, draft_params)

    plan = eng.engine.placement
    print("placement:", {e.name: e.tier for e in plan.entries[:4]}, "...")
    for note in plan.notes:
        print("  note:", note)

    ds = synthetic_dataset("samsum", n_prompts=args.requests,
                           vocab=tcfg.vocab_size)
    rng = np.random.default_rng(1)
    gens = rng.integers(max(2, args.gen // 2), args.gen + 1, args.requests)
    reqs = poisson_requests([p[:24] for p in ds.prompts], gens.tolist(),
                            args.rate)
    for r in reqs:
        eng.submit(r)

    done = eng.run()
    st = eng.stats()
    toks = sum(len(r.result) for r in done)
    print(f"\nserved {len(done)} requests / {toks} tokens in "
          f"{st['wall_s']:.1f}s ({eng.throughput(done):.2f} tok/s)")
    print(f"occupancy={st['mean_occupancy']:.2f}, rounds={st['rounds']}, "
          f"fused compiles={st['fused_compiles']}")
    print("ttft:", latency_percentiles(done, "ttft_s"))
    print("e2e: ", latency_percentiles(done, "latency_s"))
    print("first result tokens:", np.asarray(done[0].result).tolist())
    return done


if __name__ == "__main__":
    main()
