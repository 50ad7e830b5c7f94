"""The readings the limits of `correct` are set from, and the control that
has to fail them (run on the card at a cell's own size; the benchmark's
own runs never run it).

    python3 lvba_bench/control.py --workload <cell> --seeds 1,2,3 \
        [--solves 16] [--control-seeds 1,2,3] [--rehearse]

For each seed, in one process: the cell's scene, the program's map and
buckets, its solves from the first `--solves` starts of the cell's pool,
its evaluation at a start drawn from the seed, then the float64 reference
and compare.py's numbers of the program (its lower readings).  For each
control seed, the same numbers of the control in the program's place:

  float32 traffic  the reference itself in float32 with every product's
                   operands rounded to TF32 (the precision below float32
                   with TF32 off): its map, its evaluation, its LM from
                   the same starts with the program's max_iters and
                   rel_tol;
  float64 traffic  the program's own float32 path (its buckets and solves
                   in float32), the path below float64 that it has.

One JSON line a seed on standard output.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def program_side(torch, cell, scene, device, dtype, ks, n_solves, pool):
    """The program's map entries, evaluation at start ks, and results and
    iterations from the pool's first n_solves starts, in `dtype`."""
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter, plan_route

    from lvba_bench.compare import program_entries

    mp, sv = cell.config["map"], cell.config["solver"]
    W = scene.R_true.shape[0]
    vm = build_voxel_map(scene.points_body, scene.frame_ids, scene.R_true,
                         scene.p_true, mp["voxel_size"],
                         eigen_ratios=tuple(mp["eigen_ratios"]),
                         min_ps=mp["min_ps"], layer_limit=mp["layer_limit"],
                         min_frames=mp["min_frames"], device=device)
    buckets = buckets_to_device(vm, W=W, dtype=dtype, device=device)
    R0 = torch.as_tensor(pool[0]).to(device, dtype)
    p0 = torch.as_tensor(pool[1]).to(device, dtype)
    results, iters = [], []
    for k in range(min(n_solves, R0.shape[0])):
        res = lm_damping_iter(buckets, R0[k], p0[k],
                              max_iters=sv["max_iters"],
                              rel_tol=sv["rel_tol"])
        results.append((res.R.to("cpu", torch.float64).numpy(),
                        res.p.to("cpu", torch.float64).numpy()))
        iters.append(res.iters)
    route = plan_route(buckets, W)
    state = route.cgh(R0[ks], p0[ks])
    ev = (float(state[0].to("cpu", torch.float64)) * route.g_size,
          state[1].reshape(-1).to("cpu", torch.float64).numpy())
    del state, route, buckets, R0, p0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return program_entries(vm.buckets), ev, results, iters


def reference_control(torch, cell, scene, device, ks, n_solves, pool):
    """The reference in float32 with TF32 products in the program's
    place: its map entries, evaluation, LM results and their iterations."""
    from lvba_bench import compare
    from lvba_bench.reference import lm as ref_lm
    from lvba_bench.reference import plane_factor as pf
    from lvba_bench.reference.voxel_map import build_ref_map

    mp, sv = cell.config["map"], cell.config["solver"]
    f32 = torch.float32
    cm = build_ref_map(scene.points_body, scene.frame_ids, scene.R_true,
                       scene.p_true, mp["voxel_size"], mp["eigen_ratios"],
                       mp["min_ps"], mp["layer_limit"], mp["min_frames"],
                       dtype=f32, device=device, tf32=True)
    entries, _ = compare.ref_entries(cm)
    m = (cm.vox, cm.frame, cm.n, cm.mu, cm.Pc, int(cm.cell.shape[0]))
    R0 = torch.as_tensor(pool[0]).to(device, f32)
    p0 = torch.as_tensor(pool[1]).to(device, f32)
    c, g = pf.cost_grad(m, R0[ks], p0[ks], tf32=True)
    ev = (float(c), g.reshape(-1).to("cpu", torch.float64).numpy())
    results, iters = [], []
    for k in range(min(n_solves, R0.shape[0])):
        res = ref_lm.lm_solve(m, R0[k], p0[k], max_iters=sv["max_iters"],
                              rel_tol=sv["rel_tol"], tf32=True)
        results.append((res.R.to("cpu", torch.float64).numpy(),
                        res.p.to("cpu", torch.float64).numpy()))
        iters.append(res.iters)
    return entries, ev, results, iters


def readings(cell_name, seeds, control_seeds, n_solves, n_control,
             rehearse=False, emit=print):
    import numpy as np
    import torch

    from lvba_bench import harness

    cell = harness.load_cell(cell_name, False)
    shrink = cell.config.get("rehearse") if rehearse else None
    if rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise harness.RunError("no CUDA device is available")
        device = torch.device("cuda", 0)
    dtype = {"float32": torch.float32,
             "float64": torch.float64}[cell.traffic["dtype"]]
    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        scene = harness.scene_of(cell.config, shrink)
        pool = harness.starts_of(scene, cell.traffic)
        rng = np.random.default_rng(harness.seed_of(seed, 1 << 40))
        ks = int(rng.integers(pool[0].shape[0]))
        row = dict(cell=cell_name, seed=seed)
        sides = []
        if seed in seeds:
            sides.append(("program", lambda: program_side(
                torch, cell, scene, device, dtype, ks, n_solves, pool)))
        if seed in control_seeds:
            if cell.traffic["dtype"] == "float64":
                sides.append(("control", lambda: program_side(
                    torch, cell, scene, device, torch.float32, ks,
                    n_control, pool)))
            else:
                sides.append(("control", lambda: reference_control(
                    torch, cell, scene, device, ks, n_control, pool)))
        outs = [(name, fn()) for name, fn in sides]
        ref = harness.Reference(torch, cell.config, scene, device)
        ref.ref_eval = ref.eval(pool[0][ks], pool[1][ks])
        opt = ref.optimum(pool[0][ks], pool[1][ks])
        row["optimum"] = dict(cost=opt.cost, iters=opt.iters)
        for name, (entries, ev, results, iters) in outs:
            try:
                row[name] = ref.numbers(entries, ev, results)
            except (ValueError, RuntimeError) as e:
                row[name] = dict(error=repr(e))
            row[name + "_iters"] = iters
        row["seconds"] = time.perf_counter() - t
        emit(json.dumps(row))
        del ref
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--solves", type=int, default=16)
    ap.add_argument("--control-solves", type=int, default=4)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    readings(args.workload, ints(args.seeds), ints(args.control_seeds),
             args.solves, args.control_solves, args.rehearse,
             emit=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
