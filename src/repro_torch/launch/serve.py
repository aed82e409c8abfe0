"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Counterpart of the closed-loop path of ``repro/launch/serve.py``: the
continuous-batching engine serves a Poisson trace (``--rate`` req/s,
virtual clock) at the reduced smoke scale of the selected target family
(Mistral-7B family draft), and reports occupancy, TTFT / end-to-end
latency percentiles and tokens/s.  ``--device`` picks the card
(``cuda``, the default) or the plain CPU path (``cpu``).

``--async`` serves the same trace through the asyncio front door
instead (:mod:`repro_torch.serving.server`): real clock, two tenants
with weighted fairness and priority preemption, a bounded admission
queue, token-by-token streaming, graceful drain (``--speed`` compresses
the arrival gaps).  ``--timelines`` records per-request phase timelines,
``--slo-ttft`` / ``--slo-e2e`` declare SLOs and ``--postmortem-dir``
lets the flight recorder write its bundles there.

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


def _serve_async(eng, prompts, gens, args):
    """submit -> stream -> drain through the asyncio front door: an
    open-loop two-tenant Poisson replay with live token streaming."""
    import asyncio

    from repro_torch.serving.server import AsyncServingServer
    from repro_torch.serving.trace import (replay_open_loop,
                                           tenant_poisson_requests)

    reqs = tenant_poisson_requests(
        prompts, gens, args.rate,
        {"acme": {"share": 2.0, "priority": 1},
         "beta": {"share": 1.0, "priority": 0}})

    async def drive():
        async with AsyncServingServer(eng, max_queue=max(4, args.batch * 4)
                                      ) as srv:
            tokens, handles = await replay_open_loop(srv, reqs,
                                                     speed=args.speed)
        return tokens, handles, srv.tenant_report()

    tokens, handles, per_tenant = asyncio.run(drive())
    st = eng.stats()
    toks = sum(len(v) for v in tokens.values() if v is not None)
    print(f"async-served {len(handles)} requests, {toks} streamed "
          f"tokens in {st['wall_s']:.1f}s engine wall "
          f"({eng.throughput(handles):.2f} tok/s on {eng.device.type}, "
          f"reduced config '{eng.target_cfg.name}')")
    print(f"occupancy={st['mean_occupancy']:.2f} over {st['rounds']} "
          f"rounds, fused compiles={st['fused_compiles']}, "
          f"rejected={st['rejected']}, preempted={st['preempted']}, "
          f"drained={not eng.has_work()}")
    for t, d in per_tenant.items():
        print(f"  tenant {t}: {d['requests']} reqs  ttft "
              + "  ".join(f"{k}={v:.3f}s" for k, v in d['ttft_s'].items()))
    pct = latency_percentiles(handles, "latency_s")
    print("  e2e : " + "  ".join(f"{k}={v:.3f}s" for k, v in pct.items()))
    _report_request_obs(eng)


def _report_request_obs(eng):
    """Print the request-timeline summary, SLO compliance and any
    dumped postmortem bundles (when the respective knobs are on)."""
    from repro_torch.obs import timelines_summary
    tls = eng.request_timelines()
    if tls:
        s = timelines_summary(tls)
        print(f"timelines: {s['requests']} reqs  "
              f"queue={s['queue_s_total']:.2f}s  "
              f"prefill={s['prefill_s_total']:.2f}s  "
              f"decode={s['decode_s_total']:.2f}s  "
              f"stall={s['stall_s_total']:.2f}s")
    rep = eng.slo_report()
    if rep is not None:
        for key, c in rep["compliance"].items():
            print(f"  slo {key}: {c['compliance']:.0%} of "
                  f"{c['evaluated']} in objective "
                  f"({c['violations']} violations)")
    if eng.recorder is not None and eng.recorder.bundles:
        for p in eng.recorder.bundles:
            print(f"  postmortem bundle: {p}")


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
    ap.add_argument("--async", dest="run_async", action="store_true",
                    help="serve through the asyncio front door (real "
                         "clock, 2 tenants, bounded admission queue, "
                         "token streaming, drain)")
    ap.add_argument("--speed", type=float, default=8.0,
                    help="arrival-gap compression for --async")
    ap.add_argument("--plan", action="store_true",
                    help="print the ParaSpec plan + placement and exit")
    ap.add_argument("--timelines", action="store_true",
                    help="record per-request phase timelines "
                         "(queue/prefill/decode/stall) and print a "
                         "summary digest")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="declare a TTFT SLO (seconds); compliance and "
                         "violations are reported at exit")
    ap.add_argument("--slo-e2e", type=float, default=None,
                    help="declare an end-to-end latency SLO (seconds)")
    ap.add_argument("--postmortem-dir", default=None,
                    help="dump flight-recorder postmortem bundles here "
                         "on SLO violations / anomalies")
    args = ap.parse_args(argv)

    if args.plan:
        print_plan(get_config(args.arch), ENVS[args.env], args.prompt_len,
                   args.gen)
        return

    slos = []
    if args.slo_ttft is not None:
        slos.append({"name": "ttft", "metric": "ttft_s",
                     "threshold_s": args.slo_ttft})
    if args.slo_e2e is not None:
        slos.append({"name": "e2e", "metric": "e2e_s",
                     "threshold_s": args.slo_e2e})
    tcfg = get_config(args.arch).reduced(d_model=128)
    dcfg = MISTRAL_7B.reduced(d_model=64, vocab=tcfg.vocab_size)
    eng = ServingEngine(tcfg, dcfg, ENVS[args.env], device=args.device,
                        config=SchedulerConfig(
                            max_batch=args.batch, n_cand=args.n_cand,
                            admission=args.admission,
                            clock="real" if args.run_async else "virtual",
                            qos=args.run_async, preempt=args.run_async,
                            tenant_weights={"acme": 2.0, "beta": 1.0},
                            request_timeline=args.timelines,
                            slos=tuple(slos),
                            postmortem_dir=args.postmortem_dir))
    eng.init_from_seed(0)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size,
                            args.prompt_len).astype(np.int32)
               for _ in range(args.requests)]
    gens = rng.integers(max(2, args.gen // 2), args.gen + 1, args.requests)
    if args.run_async:
        _serve_async(eng, prompts, gens.tolist(), args)
        return
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
    _report_request_obs(eng)


if __name__ == "__main__":
    main()
