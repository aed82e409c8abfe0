"""ParaSpec Planner demo over the PyTorch/CUDA port: reproduce the
paper's policy search (§4.3).

    PYTHONPATH=src python examples/torch_planner_demo.py [--device cpu]

The counterpart of ``examples/planner_demo.py``, and it prints exactly
that script's text: the port's planner and simulator give the JAX
package's floats.  Evaluates the paper's published policies for
Mixtral-8x7B on Env#1 and shows the planner's own search finding a
comparable-or-better one, plus the Fig 2 "marginal utility of GPU
memory" sweep.  It runs on the host and launches nothing; ``--device``
is there for the examples' common interface (and, like theirs, refuses
``cuda`` on a machine without a card).
"""
import argparse

from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B, resolve_device
from repro_torch.core.placement import hbm_pinned_fraction, plan_placement
from repro_torch.core.planner import ParaSpecPlanner, Policy, Workload
from repro_torch.sim.hardware import ENV1
from repro_torch.sim.simulator import memory_sweep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    resolve_device(ap.parse_args(argv).device)

    wl = Workload(prompt_len=503, gen_len=48, accept_prob=0.75)  # SummEval
    planner = ParaSpecPlanner(MIXTRAL_8X7B, MISTRAL_7B, ENV1)

    print("paper policies (Table 7):")
    for pol in [Policy(80, 192, 8, 8), Policy(80, 128, 5, 8),
                Policy(50, 256, 5, 2), Policy(80, 320, 8, 8)]:
        rep = planner.evaluate(pol, wl)
        print(f"  {pol.astuple()}: {rep.throughput:6.2f} tok/s "
              f"(E[n]={rep.expected_tokens:.2f}, "
              f"round={rep.detail['t_round']:.1f}s, "
              f"{'feasible' if rep.feasible else 'INFEASIBLE'})")

    best = planner.search(wl)
    print(f"\nplanner search -> {best.policy.astuple()} "
          f"= {best.throughput:.2f} tok/s (paper best 24.7 @ (80,192,8,8))")

    plan = plan_placement(MIXTRAL_8X7B, MISTRAL_7B, ENV1)
    print(f"\nplacement: hbm={plan.hbm_used/2**30:.1f}G "
          f"host={plan.host_used/2**30:.1f}G "
          f"disk={plan.disk_used/2**30:.1f}G "
          f"pinned-target-fraction={hbm_pinned_fraction(plan):.2f}")
    print("  (the draft model occupies the 'low-yield' HBM; Fig 2 shows "
          "why)")

    print("\nFig 2 sweep (GPU memory -> FlexGen-style throughput):")
    for row in memory_sweep(MIXTRAL_8X7B, ENV1, wl, [0.9, 0.5, 0.25, 0.166]):
        print(f"  {row['mem_gib']:5.1f} GiB "
              f"pinned={row['pinned_frac']*100:4.1f}%"
              f" -> {row['throughput']:.2f} tok/s")
    print("  => throughput barely moves: GPU memory has marginal utility, "
          "so give it to the draft model instead.")


if __name__ == "__main__":
    main()
