"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Counterpart of the closed-loop path of ``repro/launch/serve.py``: the
continuous-batching engine serves a Poisson trace (``--rate`` req/s,
virtual clock) at the reduced smoke scale of the selected target family
(Mistral-7B family draft), and reports occupancy, TTFT / end-to-end
latency percentiles and tokens/s.  ``--device`` picks the card
(``cuda``, the default) or the plain CPU path (``cpu``).

``--plan`` prints the ParaSpec policy, its predicted throughput and the
tensor placement for the selected target (Mistral-7B draft) on
``--env`` (the paper's ``env1`` / ``env2``, or ``h100``), and exits
before any device work, as ``repro/launch/serve.py --plan`` does.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import MISTRAL_7B, get_config
from repro_torch.core.placement import plan_placement
from repro_torch.core.planner import ParaSpecPlanner, Workload
from repro_torch.serving.engine import (SchedulerConfig, ServingEngine,
                                        latency_percentiles)
from repro_torch.serving.trace import poisson_requests
from repro_torch.sim.hardware import ENVS


def print_plan(tcfg, hw, prompt_len: int, gen_len: int) -> None:
    """The planner's policy and predicted throughput, and the placement,
    for ``tcfg`` with the Mistral-7B draft on ``hw``."""
    dcfg = MISTRAL_7B
    rep = ParaSpecPlanner(tcfg, dcfg, hw).search(Workload(prompt_len,
                                                          gen_len))
    print(f"policy (bs_prefill, bs_decode, bs_draft, n_cand) = "
          f"{rep.policy.astuple()}")
    print(f"predicted throughput = {rep.throughput:.2f} tok/s on {hw.name}")
    plan = plan_placement(tcfg, dcfg, hw)
    print(f"placement: hbm={plan.hbm_used/2**30:.1f}G "
          f"host={plan.host_used/2**30:.1f}G "
          f"disk={plan.disk_used/2**30:.1f}G")
    for n in plan.notes:
        print(" note:", n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--env", default="env1", choices=sorted(ENVS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--n-cand", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2,
                    help="slots per interleaved half-batch")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="Poisson arrival rate (req/s, virtual clock)")
    ap.add_argument("--admission", default="fifo", choices=("fifo", "sjf"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--plan", action="store_true",
                    help="print the ParaSpec plan + placement and exit")
    args = ap.parse_args(argv)

    if args.plan:
        print_plan(get_config(args.arch), ENVS[args.env], args.prompt_len,
                   args.gen)
        return

    tcfg = get_config(args.arch).reduced(d_model=128)
    dcfg = MISTRAL_7B.reduced(d_model=64, vocab=tcfg.vocab_size)
    eng = ServingEngine(tcfg, dcfg, device=args.device,
                        config=SchedulerConfig(max_batch=args.batch,
                                               n_cand=args.n_cand,
                                               admission=args.admission))
    eng.init_from_seed(0)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size,
                            args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    gens = rng.integers(max(2, args.gen // 2), args.gen + 1, args.requests)
    for r in poisson_requests(prompts, gens.tolist(), args.rate):
        eng.submit(r)

    done = eng.run()
    st = eng.stats()
    toks = sum(len(r.result) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in "
          f"{st['wall_s']:.1f}s wall ({eng.throughput(done):.2f} tok/s on "
          f"{eng.device.type}, reduced config '{tcfg.name}')")
    print(f"occupancy={st['mean_occupancy']:.2f} over {st['rounds']} "
          f"rounds, fused compiles={st['fused_compiles']}")
    for name, attr in (("ttft", "ttft_s"), ("e2e", "latency_s")):
        pct = latency_percentiles(done, attr)
        print(f"{name:>5}: " + "  ".join(f"{k}={v:.3f}s"
                                         for k, v in pct.items()))


if __name__ == "__main__":
    main()
