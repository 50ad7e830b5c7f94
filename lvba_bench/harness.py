"""The benchmark's harness: one run of one cell.

A cell (BENCHMARK.json's `workloads`) is a configuration (configs/<name>
.json: the scene, the map's settings, the solver's) under a traffic mix
(traffic/<name>.json: the starts, their pool, the dtype).  A run:

  set-up   import, the configuration's scene (scenes/), the program's
           native library and kernels (built where the checkout has none
           yet: the build_s span), its voxel map and factor buckets on the card (map/voxelize.py,
           factors/padding.py), the traffic's pool of perturbed starts on
           the card, two warm-up solves (kernels built, the CG graphs
           captured);
  window   solves back to back (a closed loop of one caller):
           lm_damping_iter from each start of the pool in turn, in an
           order drawn from --seed for each cycle through the pool, its
           poses read back to the host; the first cycle to end after
           --seconds ends the window, so every window does whole cycles:
           the same work in another order;
  probes   with --trace 1: synchronizing calls a solve under sync debug
           mode "warn", CUDA events around the route's evaluation and its
           damped solve, torch.profiler over whole solves;
  check    the program's evaluation at a start, then, with the program's
           state freed, the float64 reference (reference/) of the map, the
           evaluation and the optimum, and compare.py's numbers against
           limits/<cell>.json.

Metrics are read from the run's record by metrics/<name>.py, each
`read(rec) -> float or None`, for the metrics BENCHMARK.json lists for
the cell.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib
import json
import math
import sys
import time
import warnings
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "global_lvba_tpu")
NAME_CHARS = 96     # an operation's name in the breakdown, cut to this


class RunError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file)."""


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    metrics: list       # the BENCHMARK.json entries that the cell reports
    chips: int


def _load(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise RunError(f"missing {path.relative_to(ROOT)}") from e


def list_cells() -> list:
    bench = _load(ROOT / "BENCHMARK.json")
    return [w["name"] for w in bench["workloads"]]


def load_cell(name: str, trace: bool) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, traffic,
    limits and the metrics it reports (end-to-end, or with `trace` the
    per-layer ones)."""
    bench = _load(ROOT / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(ROOT / cfg_entry["file"])
    traffic = _load(BENCH / "traffic" / f"{w['traffic']}.json")
    limits = _load(BENCH / "limits" / f"{name}.json")["limits"]
    kind = "per_layer" if trace else "end_to_end"
    metrics = [m for m in bench[kind]
               if "workloads" not in m or name in m["workloads"]]
    return Cell(name, config, traffic, limits, metrics, int(w["chips"]))


def read_metrics(metrics: list, rec: dict) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something in the record."""
    out = {}
    for m in metrics:
        path = BENCH / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"lvba_bench_metric_{m['name'].replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        v = mod.read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def seed_of(*parts: int) -> int:
    """A generator seed from whole numbers of any size (--seed, an index)."""
    ss = np.random.SeedSequence([int(x) % (1 << 63) for x in parts])
    return int(ss.generate_state(2, np.uint64)[0])


def scene_of(config: dict, shrink: dict = None):
    """The configuration's scene (its generator, sizes and seed)."""
    from lvba_bench.scenes.synthetic import GENERATORS

    sc = dict(config["scene"])
    gen = GENERATORS[sc.pop("generator")]
    if shrink:
        sc.update(shrink)
    return gen(**sc)


def starts_of(scene, traffic: dict):
    """The traffic's pool of starts (R (P, W, 3, 3), p (P, W, 3)) float64,
    host: start k perturbs the true poses from seed (pool_seed, k)."""
    from lvba_bench.scenes.synthetic import PERTURBATIONS

    pert = PERTURBATIONS[traffic["perturbation"]]
    Rs, ps = [], []
    for k in range(int(traffic["pool"])):
        R, p = pert(scene.R_true, scene.p_true, traffic["rot_sigma"],
                    traffic["trans_sigma"],
                    seed=seed_of(traffic["pool_seed"], k))
        Rs.append(R)
        ps.append(p)
    return np.stack(Rs), np.stack(ps)


class Clock:
    """Host-clock spans and device timing: CUDA events on a card, the
    host clock on the CPU (rehearsal)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def device_ms(self, fn, count: int) -> float:
        """ms a call of fn over `count` calls queued back to back."""
        torch = self.torch
        self.sync()
        if self.cuda:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(count):
                fn()
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / count
        t0 = time.perf_counter()
        for _ in range(count):
            fn()
        return (time.perf_counter() - t0) * 1e3 / count


def count_syncs(torch, run, cuda: bool):
    """The synchronizing calls of run() under sync debug mode "warn"; None
    on the CPU."""
    if not cuda:
        run()
        return None
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # torch's one-time notice that the mode is a prototype is not a call
    return sum(1 for w in caught if "synchronizing" in str(w.message)
               and "debug mode is a prototype" not in str(w.message))


def _union(intervals):
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def trace_solves(torch, run_solves):
    """run_solves() timed by the host's clock, then again under
    torch.profiler: busy seconds (the union of the device's operation
    intervals), the traced window's seconds, the untraced seconds of the
    same solves, the ten device operations that took most time and the ten
    longest idle gaps by the host's innermost operation during each."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_solves()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_solves()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        is_dev = str(getattr(e, "device_type", "")).endswith("CUDA")
        (dev if is_dev else host).append((tr.start / 1e6, tr.end / 1e6,
                                          e.name))
    out = reduce_trace(dev, host, wall)
    out["untraced_s"] = untraced
    return out


def reduce_trace(dev, host, wall):
    """The trace's numbers from its device operations and host operations,
    each (start s, end s, name), over a window of `wall` seconds."""
    busy = _union([(s, e) for s, e, _ in dev])
    by_op = {}
    for s, e, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (e - s)
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps between the merged device intervals, within the traced span
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    host.sort()
    starts = [h[0] for h in host]
    by_host = {}
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        # the innermost host operation around the gap's middle, among the
        # last 256 that started before it
        inner, width = "host (no traced op)", math.inf
        j = bisect.bisect_right(starts, mid)
        for s, e, name in host[max(0, j - 256):j]:
            if e >= mid and e - s < width:
                inner, width = name, e - s
        by_host[inner] = by_host.get(inner, 0.0) + (ge - gs)
    gap_top = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=wall,
                device_ops=[[k[:NAME_CHARS], v] for k, v in top],
                idle_gaps=[[k[:NAME_CHARS], v] for k, v in gap_top])


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        rehearse: dict = None, log=print) -> dict:
    """One run of `cell`; returns the result line's object.  rehearse:
    None on the card, else the scene's shrunken sizes and the run goes on
    the CPU."""
    import torch

    if rehearse is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device is available")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"the cell needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    cuda = device.type == "cuda"
    clock = Clock(torch, device)
    cfg, trf = cell.config, cell.traffic
    dtype = {"float32": torch.float32, "float64": torch.float64}[trf["dtype"]]
    spans, counters = {}, {}

    # ---- set-up -----------------------------------------------------------
    t = time.perf_counter()
    scene = scene_of(cfg, rehearse)
    W = scene.R_true.shape[0]
    spans["scene_s"] = time.perf_counter() - t

    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.kernels import build
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.native import runtime
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route

    # the program's native library and CUDA kernels, built where the
    # checkout has none yet, so that no other span holds a build
    t = time.perf_counter()
    runtime.library()
    if cuda:
        build.launcher("soa_agg")
    spans["build_s"] = time.perf_counter() - t

    mp, sv = cfg["map"], cfg["solver"]
    t = time.perf_counter()
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, mp["voxel_size"],
                         eigen_ratios=tuple(mp["eigen_ratios"]),
                         min_ps=mp["min_ps"], layer_limit=mp["layer_limit"],
                         min_frames=mp["min_frames"], device=device)
    buckets = buckets_to_device(vm, W=W, dtype=dtype, device=device)
    clock.sync()
    spans["map_build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pool_R, pool_p = starts_of(scene, trf)
    R0 = torch.as_tensor(pool_R).to(device, dtype)
    p0 = torch.as_tensor(pool_p).to(device, dtype)
    P = R0.shape[0]
    clock.sync()
    spans["pool_s"] = time.perf_counter() - t

    def solve(k):
        res = lm_damping_iter(buckets, R0[k], p0[k],
                              max_iters=sv["max_iters"],
                              rel_tol=sv["rel_tol"])
        R = res.R.to("cpu", torch.float64).numpy()
        p = res.p.to("cpu", torch.float64).numpy()
        return res, R, p

    t = time.perf_counter()
    for k in range(min(2, P)):
        solve(k)
    clock.sync()
    spans["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in spans.items()))

    # ---- window -----------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    solves = []
    t_w = time.perf_counter()
    t_end = t_w
    cycle = 0
    while t_end - t_w < seconds:
        order = np.random.default_rng(seed_of(seed, cycle)).permutation(P)
        for k in order.tolist():
            t0 = time.perf_counter()
            res, R, p = solve(k)
            t_end = time.perf_counter()
            solves.append(dict(k=k, ms=(t_end - t0) * 1e3, iters=res.iters,
                               route=res.route, R=R, p=p))
        cycle += 1
    window_s = t_end - t_w
    counters["cycles"] = cycle
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory_peak = max(peak_setup, peak_window)
    per_start = [np.mean([s["iters"] for s in solves if s["k"] == k])
                 for k in range(P)]
    log(f"window {window_s:.3f} s, {len(solves)} solves, route "
        f"{solves[0]['route']}, iterations a start "
        + " ".join(f"{x:.2f}" for x in per_start))

    rec = dict(cell=cell.name, dtype=trf["dtype"], W=W, setup_s=setup_s,
               window_s=window_s, solves=[
                   dict(ms=s["ms"], iters=s["iters"]) for s in solves],
               peak_window_bytes=peak_window, spans=spans,
               counters=counters, probes={}, trace=None, work=None,
               peak=None)

    # ---- probes (--trace 1) ---------------------------------------------
    route = plan_route(buckets, W)
    if trace:
        n_sync = count_syncs(torch, lambda: [solve(k) for k in range(2)],
                             cuda)
        if n_sync is not None:
            rec["probes"]["host_syncs"] = n_sync / 2.0
        state = route.cgh(R0[0], p0[0])
        u = torch.full((), 0.01, dtype=dtype, device=device)
        for name, fn in (("eval_ms", lambda: route.cgh(R0[0], p0[0])),
                         ("cg_ms", lambda: route.solve(state, u))):
            one = clock.device_ms(fn, 1)
            count = int(min(400, max(10, math.ceil(300.0 / max(one, 1e-3)))))
            rec["probes"][name] = clock.device_ms(fn, count)
            counters[name + "_calls"] = count
        del state
        solve_ms = window_s * 1e3 / len(solves)
        n_tr = int(min(10, max(1, math.ceil(500.0 / solve_ms))))
        if cuda:
            rec["trace"] = trace_solves(
                torch, lambda: [solve(k % P) for k in range(n_tr)])
        counters["traced_solves"] = n_tr
        if rec["trace"] is not None:
            log(f"traced {n_tr} solves: busy {rec['trace']['busy_s']:.4f} s "
                f"of {rec['trace']['window_s']:.4f} s traced, "
                f"{rec['trace']['untraced_s']:.4f} s untraced")
        from lvba_bench.compare import program_entries
        from lvba_bench.work import eval_work, peaks

        ent = program_entries(vm.buckets)
        rec["work"] = eval_work(ent[0], ent[1], W,
                                torch.tensor([], dtype=dtype).element_size())
        if cuda:
            rec["peak"] = peaks(torch.cuda.get_device_name(device))

    # ---- check ------------------------------------------------------------
    rng = np.random.default_rng(seed_of(seed, 1 << 40))
    ks = int(rng.integers(P))
    state = route.cgh(R0[ks], p0[ks])
    program_eval = (float(state[0].to("cpu", torch.float64)) * route.g_size,
                    state[1].reshape(-1).to("cpu", torch.float64).numpy())
    del state, route, buckets, R0, p0
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check(torch, cell, device, scene, vm, program_eval,
                    pool_R[ks], pool_p[ks], solves, rng, log)

    found = forbidden_modules()
    if found:
        raise RunError("modules of JAX or the JAX package were loaded: "
                       + ", ".join(found))

    from lvba_bench.compare import judge

    correct, rows = judge(numbers, cell.limits)
    failed = sum(1 for s in solves if not (np.isfinite(s["R"]).all()
                                           and np.isfinite(s["p"]).all()))
    correct = correct and failed == 0
    metrics = read_metrics(cell.metrics, rec)
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if cuda else "cpu",
               count=cell.chips if cuda else 0,
               memory_peak_bytes=int(memory_peak))
    out = dict(correct=bool(correct), attempted=len(solves), failed=failed,
               metrics=metrics, device=dev)
    if trace and rec["trace"] is not None:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = dict(device_ops=rec["trace"]["device_ops"],
                                idle_gaps=rec["trace"]["idle_gaps"])
    extra = {k: v for k, v in numbers.items() if k not in cell.limits}
    log("numbers not compared: " + ", ".join(
        f"{k} {v:.6g}" for k, v in extra.items()))
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in rows}
    out["_rows"] = rows
    return out


class Reference:
    """The float64 reference of one scene on `device`: its voxel map, and
    on demand its evaluation at a start and its optimum (the reference LM
    run to convergence)."""

    def __init__(self, torch, config, scene, device):
        from lvba_bench import compare
        from lvba_bench.reference.voxel_map import build_ref_map

        torch.backends.cuda.matmul.allow_tf32 = False
        self.torch, self.config, self.scene = torch, config, scene
        self.device = device
        mp = config["map"]
        self.map = build_ref_map(
            scene.points_body, scene.frame_ids, scene.R_true, scene.p_true,
            mp["voxel_size"], mp["eigen_ratios"], mp["min_ps"],
            mp["layer_limit"], mp["min_frames"], dtype=torch.float64,
            device=device)
        self.host, self.cells = compare.ref_entries(self.map)
        r = self.map
        self.m = (r.vox, r.frame, r.n, r.mu, r.Pc, int(r.cell.shape[0]))

    def poses(self, R, p):
        f64 = self.torch.float64
        return (self.torch.as_tensor(R).to(self.device, f64),
                self.torch.as_tensor(p).to(self.device, f64))

    def eval(self, R, p):
        from lvba_bench.reference import plane_factor as pf

        c, g = pf.cost_grad(self.m, *self.poses(R, p))
        return float(c), g.reshape(-1).cpu().numpy()

    def optimum(self, R, p):
        from lvba_bench.reference import lm as ref_lm

        rc = self.config["reference"]
        opt = ref_lm.lm_solve(self.m, *self.poses(R, p),
                              max_iters=rc["max_iters"],
                              rel_tol=rc["rel_tol"])
        self.opt = opt
        return opt

    def cost(self, R, p) -> float:
        from lvba_bench.reference import plane_factor as pf

        return float(pf.cost(self.m, *self.poses(R, p)))

    def numbers(self, entries, evaluation, results) -> dict:
        """compare.py's numbers of a side's outputs: its map entries
        (program_entries' form), its evaluation (cost, g) at the start the
        optimum was run from, and its solves' results [(R, p)]."""
        from lvba_bench import compare

        mp = self.config["map"]
        out = dict(map_err=compare.map_err(
            entries, self.scene.R_true, self.scene.p_true, self.host,
            self.cells, mp["voxel_size"], mp["layer_limit"]))
        c_ref, g_ref = self.ref_eval
        out["eval_cost_err"] = compare.rel_err(evaluation[0], c_ref)
        out["eval_grad_err"] = compare.max_rel(evaluation[1], g_ref)
        p_opt = self.opt.p.cpu().numpy()
        R_opt = self.opt.R.cpu().numpy()
        gaps, poses, rel = [], [], []
        for R, p in results:
            c = self.cost(R, p)
            gaps.append(abs(c - self.opt.cost) / abs(self.opt.cost)
                        if math.isfinite(c) else math.inf)
            poses.append(compare.aligned_rms(p, p_opt))
            rel.append(compare.rel_pose_rms(R, p, R_opt, p_opt))
        out["solve_cost_gap"] = max(gaps)
        out["solve_pose_gap"] = max(poses)
        out["solve_rel_pose_gap"] = max(rel)
        return out


def check(torch, cell, device, scene, vm, program_eval, R_start, p_start,
          solves, rng, log) -> dict:
    """compare.py's numbers of this run: the program's map, its evaluation
    at a start drawn from the seed (program_eval: the cost and g) and a
    sample of the window's solves drawn from the seed, against the float64
    reference on `device`."""
    from lvba_bench.compare import program_entries

    t = time.perf_counter()
    ref = Reference(torch, cell.config, scene, device)
    ref.ref_eval = ref.eval(R_start, p_start)
    opt = ref.optimum(R_start, p_start)
    judged = list(range(len(solves)))
    cap = int(cell.config["reference"]["judged_solves"])
    if len(judged) > cap:
        judged = sorted(rng.choice(len(solves), cap, replace=False).tolist())
    numbers = ref.numbers(program_entries(vm.buckets), program_eval,
                          [(solves[i]["R"], solves[i]["p"]) for i in judged])
    log(f"check {time.perf_counter() - t:.3f} s: reference optimum "
        f"{opt.cost:.12g} in {opt.iters} iterations, {len(judged)} solves "
        f"judged, planes {int(ref.map.cell.shape[0])} vs {vm.num_planes}")
    return numbers
