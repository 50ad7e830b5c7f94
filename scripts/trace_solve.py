#!/usr/bin/env python3
"""Where a global LM solve's time goes, read from the program's own spans
and counters (global_lvba_tpu_torch/utils/profiling.py), on one cell of
the benchmark (lvba_bench/: its configuration, traffic and solver
settings).  Run from the repository root on a machine with a card:

    python3 scripts/trace_solve.py --workload corridor_w4096.f32 \
        --seed 7 --seconds 20 [--out chiprun_out/trace_solve.json]

or on the CPU at the configuration's rehearsal size (a dry run, no device
numbers): add --rehearse.

Set-up as the benchmark's: the scene, the map with the tracer on (its
map.voxelize and map.upload spans, then a reset), the pool of starts, two
warm-up solves.  Then whole cycles through the pool with the tracer off
and on in turns (off, on, on, off, ...) for --seconds: the solve's ms in
each (what tracing costs) and the on cycles' spans and counters a solve.
Then the synchronizing calls of two solves with the tracer off and on
(sync debug mode), the benchmark's eval_ms / cg_ms probes, and
torch.profiler over whole solves with the tracer on, each idle gap of the
device put down to the innermost program span around its middle.

Prints one line a part and, last, one JSON object:
  route_plan_ms      lm.plan_route host ms / lm.solve count
  eval_in_solve_ms   lm.eval device ms (CUDA events) / its count
  cg_in_solve_ms     lm.damped_solve device ms / its count
  cg_live_trips      cg.live_trips / lm.damped_solve count (of the
                     route's trips)
  lm_rejects         lm.rejects / lm.solve count
  graph_captures     cg.graph_captures in the on cycles / solves
  map_voxelize_s     map.voxelize host s
  map_upload_s       map.upload host s
  plan_idle_share    idle s under lm.plan_route / all idle s of the
                     profiled solves (a card only)
beside the split of a solve's host time (plan, evaluations, damped
solves, the loop's own remainder; the read-back of the poses beside it)
and the tracing cost.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NO_SPAN = "(no program span)"


def idle_by_span(dev, host, is_span) -> dict:
    """Seconds of the device's idle gaps (between its merged operation
    intervals) by the innermost program span (a host operation whose name
    is_span accepts) around each gap's middle; NO_SPAN where none is.
    dev, host: (start s, end s, name) each."""
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    spans = sorted(h for h in host if is_span(h[2]))
    starts = [h[0] for h in spans]
    out = {}
    for (_, gs), (ge, _) in zip(merged[:-1], merged[1:]):
        mid = 0.5 * (gs + ge)
        inner, width = NO_SPAN, math.inf
        for s, e, name in spans[:bisect.bisect_right(starts, mid)]:
            if e >= mid and e - s < width:
                inner, width = name, e - s
        out[inner] = out.get(inner, 0.0) + (ge - gs)
    return out


def solve_split(snap: dict) -> dict:
    """A snapshot's host ms a solve under lm.solve's children and its own
    remainder, and the share of lm.solve's mean that they account for."""
    sp = snap["spans"]
    n = sp["lm.solve"]["count"]
    out = {name: sp[name]["host_s"] * 1e3 / n
           for name in ("lm.plan_route", "lm.eval", "lm.damped_solve")}
    out["remainder"] = sp["lm.solve"]["self_s"] * 1e3 / n
    out["lm.solve"] = sp["lm.solve"]["host_s"] * 1e3 / n
    out["accounted"] = sum(out[k] for k in (
        "lm.plan_route", "lm.eval", "lm.damped_solve",
        "remainder")) / out["lm.solve"]
    return out


def metrics(setup: dict, window: dict, trips: int, idle) -> dict:
    """The nine numbers of the module docstring from the set-up's and the
    on cycles' snapshots (a device time falls back to the host's where no
    event was recorded: the CPU runs its ops as it queues them)."""
    sp, ct = window["spans"], window["counters"]
    n = sp["lm.solve"]["count"]

    def per_call_ms(name):
        s = sp[name]
        secs = s["device_s"] if s["device_s"] is not None else s["host_s"]
        return secs * 1e3 / s["count"]

    out = dict(
        route_plan_ms=sp["lm.plan_route"]["host_s"] * 1e3 / n,
        eval_in_solve_ms=per_call_ms("lm.eval"),
        cg_in_solve_ms=per_call_ms("lm.damped_solve"),
        cg_live_trips=ct.get("cg.live_trips", 0)
        / sp["lm.damped_solve"]["count"],
        cg_trips=trips,
        lm_rejects=ct.get("lm.rejects", 0) / n,
        graph_captures=ct.get("cg.graph_captures", 0) / n,
        map_voxelize_s=setup["spans"]["map.voxelize"]["host_s"],
        map_upload_s=setup["spans"]["map.upload"]["host_s"])
    if idle:
        out["plan_idle_share"] = idle.get("lm.plan_route", 0.0) / sum(
            idle.values())
    return out


def card_of(torch, device) -> dict:
    if device.type != "cuda":
        return dict(kind="cpu")
    out = dict(kind=torch.cuda.get_device_name(device))
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"unread ({e})"
    return out


def run(workload: str, seed: int, seconds: float, rehearse: bool,
        log=print) -> dict:
    import numpy as np
    import torch

    from lvba_bench import harness
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route
    from global_lvba_tpu_torch.utils import profiling

    cell = harness.load_cell(workload, True)
    shrink = cell.config.get("rehearse") if rehearse else None
    if rehearse:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise SystemExit("no CUDA device is available (--rehearse runs on "
                         "the CPU)")
    cuda = device.type == "cuda"
    clock = harness.Clock(torch, device)
    cfg, trf, mp, sv = (cell.config, cell.traffic, cell.config["map"],
                        cell.config["solver"])
    dtype = {"float32": torch.float32, "float64": torch.float64}[trf["dtype"]]

    scene = harness.scene_of(cfg, shrink)
    W = scene.R_true.shape[0]
    profiling.reset()
    profiling.enable()
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, mp["voxel_size"],
                         eigen_ratios=tuple(mp["eigen_ratios"]),
                         min_ps=mp["min_ps"], layer_limit=mp["layer_limit"],
                         min_frames=mp["min_frames"], device=device)
    buckets = buckets_to_device(vm, W=W, dtype=dtype, device=device)
    clock.sync()
    setup = profiling.snapshot()
    profiling.disable()
    profiling.reset()
    pool_R, pool_p = harness.starts_of(scene, trf)
    R0 = torch.as_tensor(pool_R).to(device, dtype)
    p0 = torch.as_tensor(pool_p).to(device, dtype)
    P = R0.shape[0]

    def solve(k):
        res = lm_damping_iter(buckets, R0[k], p0[k],
                              max_iters=sv["max_iters"],
                              rel_tol=sv["rel_tol"])
        res.R.to("cpu", torch.float64).numpy()
        res.p.to("cpu", torch.float64).numpy()
        return res

    for k in range(min(2, P)):
        solve(k)
    clock.sync()
    log(f"{workload} on {device}: W={W}, {P} starts, set-up done; map "
        + ", ".join(f"{k} {v['host_s']:.4f} s"
                    for k, v in setup["spans"].items()))

    # whole cycles through the pool, the tracer off and on in turns
    ms = {False: [], True: []}
    t_w, cycle = time.perf_counter(), 0
    while time.perf_counter() - t_w < seconds or cycle < 4:
        on = cycle % 4 in (1, 2)
        (profiling.enable if on else profiling.disable)()
        order = np.random.default_rng(harness.seed_of(seed, cycle)) \
            .permutation(P)
        t0 = time.perf_counter()
        for k in order.tolist():
            res = solve(k)
        ms[on].append((time.perf_counter() - t0) * 1e3 / P)
        cycle += 1
    profiling.disable()
    window = profiling.snapshot()
    profiling.reset()
    route = plan_route(buckets, W)
    split = solve_split(window)
    # the window's solve also reads its poses back (outside lm.solve)
    split["readback"] = statistics.fmean(ms[True]) - split["lm.solve"]
    log(f"{cycle} cycles: solve ms off {statistics.median(ms[False]):.4f}, "
        f"on {statistics.median(ms[True]):.4f}; route {res.route}; a "
        "solve: " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))

    def two():
        for k in range(2):
            solve(k)

    syncs = {}
    for on in (False, True):
        (profiling.enable if on else profiling.disable)()
        n = harness.count_syncs(torch, two, cuda)
        syncs[on] = None if n is None else n / 2.0
    profiling.disable()
    profiling.reset()

    state = route.cgh(R0[0], p0[0])
    u = torch.full((), 0.01, dtype=dtype, device=device)
    probes = {}
    for name, fn in (("eval_ms", lambda: route.cgh(R0[0], p0[0])),
                     ("cg_ms", lambda: route.solve(state, u))):
        one = clock.device_ms(fn, 1)
        probes[name] = clock.device_ms(
            fn, int(min(400, max(10, math.ceil(300.0 / max(one, 1e-3))))))
    del state

    idle, trace = None, None
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        n_tr = int(min(10, max(1, math.ceil(
            500.0 / statistics.median(ms[False])))))
        profiling.enable()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(n_tr):
                solve(k % P)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        profiling.disable()
        profiling.reset()
        dev, host = [], []
        for e in prof.events():
            tr = e.time_range
            is_dev = str(getattr(e, "device_type", "")).endswith("CUDA")
            # a span's range shows on the device's rows too, over the
            # kernels it launched: not a device operation
            if is_dev and profiling.is_declared(e.name):
                continue
            (dev if is_dev else host).append((tr.start / 1e6, tr.end / 1e6,
                                              e.name))
        idle = idle_by_span(dev, host, profiling.is_declared)
        trace = harness.reduce_trace(dev, host, wall)
        trace["solves"] = n_tr
        trace["idle_by_span"] = idle
        log(f"profiled {n_tr} solves: busy {trace['busy_s']:.4f} s of "
            f"{wall:.4f} s; idle s by program span: " + ", ".join(
                f"{k} {v:.6g}" for k, v in idle.items()))

    out = dict(workload=workload, seed=seed, device=card_of(torch, device),
               route=res.route, W=W, cycles=cycle,
               metrics=metrics(setup, window, route.trips, idle),
               split_ms=split,
               tracing_cost=dict(
                   solve_ms_off=ms[False], solve_ms_on=ms[True],
                   median_off=statistics.median(ms[False]),
                   median_on=statistics.median(ms[True])),
               host_syncs=dict(off=syncs[False], on=syncs[True]),
               probes=probes, spans=window["spans"],
               counters=window["counters"], trace=trace)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, args.rehearse,
              log=lambda m: print(m, flush=True))
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
