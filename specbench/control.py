"""Readings that set the check's limits, on the card (not part of a run).

    python3 -m specbench.control --workload <cell> --seeds 1,2,3
        --seconds <s>

For each seed: one run of the cell (the window of ``--seconds``), then
over its sample of served tokens and verified drafts the plain reference
in float32 (the program's readings, the lower ones), the control (the
same reference with every weight product in float8, the tokens it puts
first at the same positions: the upper readings) and a witness (every
product's operands in bfloat16).  The control is then put in the
program's place: its statistics go through the harness's own
:func:`specbench.run.checks`, which has to find it not correct.  Prints
one JSON line a seed: the three readings of target and draft, and
``correct`` of the program and of the control.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

from specbench import check as chk
from specbench.run import ROOT, checks, load_cell, run_cell


def readings(cfg: dict, run: dict, seed: int, others=("fp8", "bf16")):
    """(program's run, the control in its place, the record printed) for
    one run made with ``check=False``."""
    rids = chk.pick_sample(run["served"], int(cfg["check"]["sample"]), seed,
                           run["slot_of"])
    g = chk.gaps(run["params"], cfg["target"], run["prompts"],
                 run["served"], rids, others=others)
    d = chk.draft_gaps(run["draft_params"], cfg["draft"], run["prompts"],
                       run["served"], run["rounds"], rids, others=others)
    program = dict(run, gap=g, draft_gap=d)

    def swap(r, q):
        return None if r.get("stats") is None else dict(
            tokens=r["tokens"], stats=r[f"stats_{q}"])
    control = dict(run, gap=swap(g, "fp8"), draft_gap=swap(d, "fp8"))
    rec = {"seed": seed, "sample": rids, "tokens": g["tokens"],
           "draft_tokens": d["tokens"]}
    for side, r in (("target", g), ("draft", d)):
        rec[side] = {"program": r["stats"]} | {
            q: r.get(f"stats_{q}") for q in others}
    return program, control, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    _, cfg, mix, _, _ = load_cell(args.workload)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    for seed in (int(s) for s in args.seeds.split(",")):
        run = run_cell(cfg, mix, seed, args.seconds, False, "cuda",
                       check=False, log=log)
        program, control, rec = readings(cfg, run, seed)
        rows = {"program": checks(cfg, program),
                "control": checks(cfg, control)}
        for who, rs in rows.items():
            rec[f"{who}_correct"] = all(ok for *_, ok in rs)
            log(f"{who}: " + "; ".join(f"{n} {v} limit {lim}"
                                       for n, v, lim, _ in rs))
        print(json.dumps({"workload": args.workload} | rec), flush=True)
        del run, program, control
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
