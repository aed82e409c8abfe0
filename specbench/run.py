"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

    python3 -m specbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1> [--rate <req/s>]

Reads the cell from ``BENCHMARK.json`` and the files it names by name:
``specbench/configs/<config>.json`` (the two models, every
``SchedulerConfig`` setting of the engine, the deployment, the check's
sample and limits), ``specbench/traffic/<traffic>.json`` (the mix, read
by :mod:`specbench.generator`) and, with ``--trace 1``, a reader in
``specbench/metrics/`` for each per-layer metric of the cell.  A mix
that names a ``driver`` is run by ``specbench/drivers/<driver>.py``'s
``run_cell`` in place of this module's (same arguments and result).
Then, in one process:

1. makes both models' weights on the card from the seed
   (:mod:`specbench.weights`) and hands them to
   ``repro_torch.serving.engine.ServingEngine`` (real clock, the round
   as CUDA graphs, chain speculation);
2. warms up the cell's own shapes: a closed loop fills every slot and
   runs until the round's graphs are captured; an open loop serves the
   mix's warm-up requests to the end;
3. measures for ``--seconds``: a closed loop keeps ``backlog`` requests
   queued behind the slots; an open loop submits each request when it
   is due.  Every due time and every token is stamped with this
   process's ``time.perf_counter``, and every chain of drafts a round
   verified is kept (a copy on the card) with the request it was for;
4. with ``--trace 1`` the engine's spans are on (fenced) and
   ``torch.profiler`` records a slice of the window (``trace_s`` of the
   mix, whole steps) for the device metrics;
5. reads the peak memory, frees the engine, and compares a sample of the
   served tokens and of the verified drafts with the plain reference
   (:mod:`specbench.check`);
6. prints the result as the last line of standard output (one JSON
   object) and the checks, each number beside its limit, as the last
   lines of standard error.

``--rate`` replaces an open loop's rate (the sweep that finds the rate a
cell is set at).  The process exits with 1 and prints no result without
a card (or fewer cards than the cell asks for), and with 3 if ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded after the
window.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from specbench import generator  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "specbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the benchmark may not load
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(name: str, bench_file: Path | None = None) -> tuple:
    """(cell, configuration, traffic mix, per-layer metrics of the cell,
    end-to-end metrics of the cell) from ``BENCHMARK.json``."""
    bench = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                     .read_text())
    mix = generator.load_mix(cell["traffic"], BENCH / "traffic")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return (cell, cfg, mix, [m for m in bench["per_layer"] if mine(m)],
            [m for m in bench["end_to_end"] if mine(m)])


def _load(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str):
    """``read`` of ``metrics/<metric>.py``, else of ``metrics/<base>.py``
    (``<base>``: the name before its first dot)."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.')[0]}.py"
    return _load(path, "specbench_metric_").read


def load_driver(mix: dict):
    """The ``run_cell`` that drives the mix: this module's, or that of
    ``drivers/<driver>.py`` where the mix names one."""
    if "driver" not in mix:
        return run_cell
    return _load(BENCH / "drivers" / f"{mix['driver']}.py",
                 "specbench_driver_").run_cell


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class Context:
    """What a per-layer reader may read (``specbench/metrics``)."""
    target: dict
    draft: dict
    engine: dict
    peaks: dict
    window_s: float = 0.0
    rounds: int = 0
    occupancy: float = 0.0
    accept_hist: list = field(default_factory=list)
    ttft_s: list = field(default_factory=list)
    admit_s: list = field(default_factory=list)
    prefill_spans: list = field(default_factory=list)   # (seconds, length)
    trace: dict | None = None
    trace_s: float = 0.0
    trace_rounds: int = 0
    trace_prompts: list = field(default_factory=list)
    trace_work: tuple = (0.0, 0.0)
    groups: dict = field(default_factory=dict)
    busy_s: float = 0.0
    mem_peak_bytes: int = 0


@dataclass
class Rec:
    """One request as the harness sees it."""
    rid: int
    prompt: np.ndarray
    due: float | None = None          # perf_counter seconds
    stamps: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    finished: float | None = None
    rejected: bool = False
    slot: int | None = None          # the first slot that served it
    chains: list = field(default_factory=list)  # (n_before, round, row)


def scheduler_config(engine: dict, **fixed):
    """``SchedulerConfig`` from a configuration's ``engine``: every key
    reaches the engine (lists as tuples), an unknown one raises; the
    harness's own settings (``fixed``) on top."""
    from repro_torch.serving.engine import SchedulerConfig
    clash = set(engine) & set(fixed)
    if clash:
        raise ValueError(f"the harness sets {sorted(clash)} itself")
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in engine.items()}
    return SchedulerConfig(**kw, **fixed)


def model_config(d: dict):
    from repro_torch.configs import ModelConfig
    kw = dict(d)
    for key in ("layer_pattern", "moe_pattern"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", rate: float | None = None,
             peaks: dict | None = None, readers: dict | None = None,
             check: bool = True, log=print) -> dict:
    """One run of a cell; returns the result's parts (see :func:`main`).
    ``readers``: per-layer metric name -> ``read(ctx)``."""
    import torch

    from repro_torch.core.pipeline import required_cache_len
    from repro_torch.core.spec_decode import tree_n_nodes
    from repro_torch.serving.engine import ServeRequest, ServingEngine

    from specbench import check as chk
    from specbench import devtrace, generator, weights
    from specbench.work import model as work

    on_card = device != "cpu"
    tcfg, dcfg = model_config(cfg["target"]), model_config(cfg["draft"])
    eng_cfg = cfg["engine"]
    closed = mix["arrivals"] == "closed"
    plen, olen = generator.max_lengths(mix)
    draw = generator.make_requests(mix, seed, tcfg.vocab_size, rate)
    sched = scheduler_config(eng_cfg, clock="real", trace=trace,
                             trace_annotations=trace)
    tparams, dparams = weights.make_weights(cfg["target"], cfg["draft"],
                                            seed, device)
    # every slot holds the mix's longest request (the engine's own sizing:
    # a round stages n_cand drafts, or a tree's nodes but its root)
    cand = (sched.n_cand if sched.spec_tree is None
            else tree_n_nodes(sched.spec_tree) - 1)
    max_len = required_cache_len(plen, olen, cand)
    sched.max_len = -(-max_len // sched.block_size) * sched.block_size
    eng = ServingEngine(tcfg, dcfg, config=sched, device=device)
    eng.load(tparams, dparams)
    recs: dict = {}
    now = time.perf_counter
    chains = []                 # per round: the verified half's drafts

    def decode_round(verify, gen, *args, **kwargs):
        """The engine's round, then a copy (on the card) of the drafts it
        verified, with the request each live slot served and how many
        tokens that request had before them."""
        out = real_round(verify, gen, *args, **kwargs)
        h = next(i for i, st in enumerate(eng._halves) if st is verify)
        live = [(i, s.req.rid) for i, s in enumerate(eng._slots[h])
                if not s.done]
        if live and verify.draft_buf is not None:
            chains.append(verify.draft_buf.clone())
            for i, rid in live:
                r = recs[rid]
                r.chains.append((len(r.tokens), len(chains) - 1, i))
                if r.slot is None:
                    r.slot = h * len(eng._slots[h]) + i
        return out
    real_round = eng.engine.decode_round
    eng.engine.decode_round = decode_round

    def emit(req, tok):
        r = recs[req.rid]
        r.stamps.append(now())
        r.tokens.append(int(tok))

    def finish(req):
        recs[req.rid].finished = now()
    eng.emit_hook, eng.finish_hook = emit, finish

    def submit(rid, item, due=None):
        rec = recs[rid] = Rec(rid, item["prompt"], due)
        req = ServeRequest(rid, item["prompt"], item["max_new"],
                           arrival_s=eng.now())
        if not eng.submit(req):
            rec.rejected = True

    pool = draw["requests"]
    nxt = 0
    slots = 2 * eng_cfg["max_batch"]
    # ---- warm-up: the cell's own shapes, graphs captured ----------------
    if closed:
        backlog = int(mix["backlog"])
        while nxt < slots + backlog:
            submit(nxt, pool[nxt])
            nxt += 1
        last, same, steps = None, 0, 0
        while same < 3 or steps < 8:
            eng.run_step()
            while eng.pending() < backlog and nxt < len(pool):
                submit(nxt, pool[nxt])
                nxt += 1
            caps = sum(eng.stats()["graph_captures"].values())
            same = same + 1 if caps == last else 0
            last, steps = caps, steps + 1
    else:
        for i, item in enumerate(draw["warmup"]):
            submit(-1 - i, item)
        while eng.has_work():
            eng.run_step()
    warm_ids = {rid for rid in recs if rid < 0}
    if trace:                   # the profiler's own start-up, outside
        devtrace.stop(devtrace.start())
    if on_card:
        torch.cuda.synchronize()
    st0 = eng.stats()
    caps0 = sum(st0["graph_captures"].values())
    tr_events0 = len(eng.obs.tracer.events) if trace else 0
    # ---- the window ------------------------------------------------------
    t0 = now()
    setup_s = t0 - T_START
    t_end = t0 + seconds
    if not closed:
        dues = [t0 + item["due_s"] for item in pool]
    trace_from = t_end - min(float(mix["trace_s"]), seconds)
    prof, tr_t0, tr_rounds0 = None, 0.0, 0
    tr_prompts, tr_ctx_work, lateness = [], [0.0, 0.0], []
    while True:
        t = now()
        if t >= t_end:
            break
        if trace and prof is None and t >= trace_from:
            if on_card:
                torch.cuda.synchronize()
            prof = devtrace.start()
            tr_t0, tr_rounds0 = now(), eng.stats()["rounds"]
        if closed:
            while eng.pending() < backlog and nxt < len(pool):
                submit(nxt, pool[nxt])
                nxt += 1
        else:
            while nxt < len(pool) and dues[nxt] <= t:
                lateness.append(t - dues[nxt])
                submit(nxt, pool[nxt], dues[nxt])
                nxt += 1
        tracing = prof is not None
        if tracing:
            rounds_seen = eng.stats()["rounds"]
            live = [len(r.prompt) + len(r.tokens) for r in recs.values()
                    if r.stamps and r.finished is None
                    and r.rid not in warm_ids]
            firsts = {r.rid for r in recs.values() if r.stamps}
        eng.run_step()
        if tracing:
            rounds = eng.stats()["rounds"]
            if rounds > rounds_seen and live:
                mean_ctx = int(round(sum(live) / len(live)))
                f, b = work.spec_round(cfg["target"], cfg["draft"],
                                       eng_cfg["max_batch"],
                                       eng_cfg["n_cand"], mean_ctx)
                tr_ctx_work[0] += f
                tr_ctx_work[1] += b
            for r in recs.values():
                if r.stamps and r.rid not in firsts:
                    tr_prompts.append(len(r.prompt))
                    for c in (cfg["target"], cfg["draft"]):
                        f, b = work.prefill(c, len(r.prompt))
                        tr_ctx_work[0] += f
                        tr_ctx_work[1] += b
            rounds_seen = rounds
        if eng.idle_step and not closed:
            wake = min(dues[nxt] if nxt < len(pool) else t_end, t_end)
            time.sleep(max(0.0, min(wake - now(), 0.002)))
    if prof is not None:                 # the traced slice ends here
        if on_card:
            torch.cuda.synchronize()
        tr_rounds = eng.stats()["rounds"] - tr_rounds0
        trace_wall = now() - tr_t0
    t_close = now()
    while not closed and nxt < len(pool) and dues[nxt] < t_end:
        submit(nxt, pool[nxt], dues[nxt])      # due, never sent in time
        nxt += 1
    if prof is not None:
        trace_data = devtrace.stop(prof)
    if on_card:
        torch.cuda.synchronize()
    st1 = eng.stats()
    caps_in_window = sum(st1["graph_captures"].values()) - caps0
    window_s = seconds
    # ---- end-to-end metrics ----------------------------------------------
    e2e = {"setup_s": setup_s}
    live_recs = [r for r in recs.values() if r.rid not in warm_ids]
    if closed:
        n_tok = sum(1 for r in recs.values() for s in r.stamps
                    if t0 <= s < t_end)
        e2e["tok_per_s"] = n_tok / window_s
    due_in = [r for r in live_recs if r.due is not None and r.due < t_end]
    ttft = [(r.stamps[0] if r.stamps and r.stamps[0] < t_end else t_end)
            - r.due for r in due_in]
    tpot = []
    for r in live_recs:
        s = [x for x in r.stamps if t0 <= x < t_end]
        if len(s) >= 2:
            tpot.append((s[-1] - s[0]) / (len(s) - 1))
    if not closed:
        e2e["ttft_p90_ms"] = percentile(ttft, 90) * 1e3 if ttft else None
        e2e["tpot_p90_ms"] = percentile(tpot, 90) * 1e3 if tpot else None
    mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
    # ---- per-layer metrics ---------------------------------------------
    ctx = Context(target=cfg["target"], draft=cfg["draft"], engine=eng_cfg,
                  peaks=peaks or {"flops": 989e12, "bytes": 3.35e12},
                  window_s=window_s, ttft_s=ttft, mem_peak_bytes=mem_peak)
    ctx.rounds = st1["rounds"] - st0["rounds"]
    if ctx.rounds:
        ctx.occupancy = (st1["mean_occupancy"] * st1["rounds"]
                         - st0["mean_occupancy"] * st0["rounds"]) / ctx.rounds
    ctx.accept_hist = [b - a for a, b in zip(st0["accept_hist"],
                                             st1["accept_hist"])]
    if trace:
        events = eng.obs.tracer.events[tr_events0:]
        ctx.admit_s = [e["dur"] / 1e6 for e in events
                       if e.get("ph") == "X" and e.get("name") == "admit"]
        ctx.prefill_spans = [(e["dur"] / 1e6, e["args"]["prompt_len"])
                             for e in events if e.get("ph") == "X"
                             and e.get("name") == "zigzag_prefill"]
        if tr_t0:
            ctx.trace = trace_data
            ctx.trace_s = trace_wall
            ctx.trace_rounds = tr_rounds
            ctx.trace_prompts = tr_prompts
            ctx.trace_work = tuple(tr_ctx_work)
            ctx.groups = devtrace.by_group(trace_data["device"])
            ctx.busy_s = devtrace.union_us(trace_data["device"]) / 1e6
    layer_vals = {}
    for name, read in (readers or {}).items():
        v = read(ctx)
        if v is not None:
            layer_vals[name] = float(v)
    gen_late = (max(lateness) if lateness else 0.0)
    log(f"window: {seconds:g} s from set-up end, closed at "
        f"+{t_close - t0:.6f} s; rounds {ctx.rounds}; requests due "
        f"{len(due_in)}; generator late by at most {gen_late:.6f} s "
        f"(mean {np.mean(lateness) if lateness else 0.0:.6f} s over "
        f"{len(lateness)} submissions); backlog at close "
        f"{eng.pending()}")
    log(f"graph captures in the window: {caps_in_window}")
    served = {r.rid: list(r.tokens) for r in live_recs}
    prompts = {r.rid: r.prompt for r in live_recs}
    slot_of = {r.rid: r.slot for r in live_recs if r.slot is not None}
    backlog_end = eng.pending()
    # ---- free the program's state, then the check ------------------------
    del eng
    chain_rows = (torch.stack(chains).cpu().numpy() if chains
                  else np.zeros((0, 0, 0), np.int64))
    del chains
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rounds = {r.rid: [(n, chain_rows[k, i]) for n, k, i in r.chains]
              for r in live_recs}
    out = {"e2e": e2e, "layer": layer_vals, "mem_peak": mem_peak,
           "attempted": len(due_in) if not closed else len(
               [r for r in live_recs if r.stamps]),
           "failed": sum(r.rejected for r in recs.values()),
           "backlog_end": backlog_end, "caps_in_window": caps_in_window,
           "lateness_max_s": gen_late, "served": served, "prompts": prompts,
           "rounds": rounds, "slot_of": slot_of, "params": tparams,
           "draft_params": dparams}
    if trace and tr_t0:
        out["busy_s"], out["window_s"] = ctx.busy_s, ctx.trace_s
        out["breakdown"] = {
            "device_ops": devtrace.top_ops(trace_data["device"]),
            "idle_gaps": devtrace.idle_gaps(trace_data["device"],
                                            trace_data["host"])}
        out["groups"] = ctx.groups
    if check:
        rids = chk.pick_sample(served, int(cfg["check"]["sample"]), seed,
                               slot_of)
        out["sample"] = rids
        out["gap"] = (chk.gaps(tparams, cfg["target"], prompts, served, rids)
                      if rids else None)
        out["draft_gap"] = (chk.draft_gaps(dparams, cfg["draft"], prompts,
                                           served, rounds, rids)
                            if rids and sched.spec_tree is None else None)
    return out


def checks(cfg: dict, run: dict) -> list:
    """[(name, value, limit, ok)]: every number compared, with its limit.
    The configuration's ``check.limits`` names the gap statistics
    compared (:mod:`specbench.check`): ``widest_gap`` the largest,
    ``mean_gap`` the mean over the served tokens; ``draft_widest_gap``
    and ``draft_mean_gap`` the same over the verified drafts.  A run
    with no drafts compared (tree speculation: no comparison of its
    drafts exists yet) fails the draft's rows."""
    key = {"widest_gap": "max", "mean_gap": "mean"}
    rows = []
    n_min = cfg["check"]["min_tokens"]
    for side, prefix in (("gap", ""), ("draft_gap", "draft_")):
        g = run.get(side)
        stats = g["stats"] if g else None
        for name, lim in cfg["check"]["limits"].items():
            if name.startswith("draft_") != bool(prefix):
                continue
            v = None if stats is None else stats[key[name[len(prefix):]]]
            rows.append((name, v, lim, v is not None and v <= lim))
        n = g["tokens"] if g else 0
        rows.append((f"{prefix}tokens_compared", n, n_min, n >= n_min))
    rows.append(("rejected", run["failed"], 0, run["failed"] == 0))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop rate (req/s) in place of the mix's")
    args = ap.parse_args(argv)
    cell, cfg, mix, per_layer, end_to_end = load_cell(args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    peaks = json.loads((BENCH / "peaks.json").read_text())
    kind = torch.cuda.get_device_name(0)
    peak = peaks.get(kind, peaks["default"])
    readers = ({m["name"]: load_reader(m["name"]) for m in per_layer}
               if args.trace else {})
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    run = load_driver(mix)(cfg, mix, args.seed, args.seconds,
                           bool(args.trace), "cuda", args.rate, peak,
                           readers, log=log)
    bad = forbidden_loaded()
    if bad:
        print(f"loaded modules the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    units = {m["name"]: m["unit"] for m in per_layer + end_to_end}
    if args.trace:
        vals = run["layer"]
    else:
        vals = {m["name"]: run["e2e"].get(m["name"]) for m in end_to_end}
    metrics = {k: {"value": v, "unit": units[k]} for k, v in vals.items()
               if v is not None}
    rows = checks(cfg, run)
    correct = all(ok for *_, ok in rows)
    device = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
              "memory_peak_bytes": int(run["mem_peak"])}
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics, "device": device}
    if args.trace and "busy_s" in run:
        device["busy_s"], device["window_s"] = run["busy_s"], run["window_s"]
        result["breakdown"] = run["breakdown"]
        log("device groups (s, launches): " + json.dumps(
            {k: [v[0], v[1]] for k, v in run["groups"].items()}))
    log(f"sampled requests {run.get('sample')}; backlog at close "
        f"{run['backlog_end']}; served-token gaps "
        f"{json.dumps(run['gap']['stats']) if run.get('gap') else None}; "
        f"draft gaps "
        f"{json.dumps(run['draft_gap']['stats']) if run.get('draft_gap') else None}")
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in rows}
    print(json.dumps(result), flush=True)
    for n, v, lim, ok in rows:
        log(f"check {n} {v} limit {lim} {'ok' if ok else 'FAILED'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
