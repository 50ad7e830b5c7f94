"""Runs chip_smoke.py's phase 18 (the multi-device layer on one card) alone
on one CUDA card, building the inputs it takes from earlier phases (the
bench's W=512 problem, path 2a's clouds, path 2c's stage-1 map and its
float64 CPU LM, the local float32 M=1000 visual solve), and writes its
results to build/mesh_phase.json.

    python3 scripts/mesh_phase.py [dryrun] [shard-kernels] [w512] [w4096]
                                  [visual] [spatial] [processes]

With no arguments it runs all seven in chip_smoke's order.  It fails, as
chip_smoke.py does, when a check misses its limit or no CUDA device is
available."""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ORDER = ("dryrun", "shard-kernels", "w512", "w4096", "visual", "spatial",
         "processes")


def _bench(torch, np, dev):
    """The bench's W=512 problem, as chip_smoke's main builds it."""
    import chip_smoke as cs
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.map.voxelize import build_voxel_map
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, perturb_poses)

    sc = make_plane_scene(num_frames=cs.FRAMES, points_per_frame=cs.PPF,
                          seed=0)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         cs.VOXEL, eigen_ratios=[cs.RATIO] * 4)
    fa = buckets_to_device(vm, W=cs.FRAMES, dtype=torch.float32, device=dev)
    return (fa, torch.as_tensor(Rp, dtype=torch.float32, device=dev),
            torch.as_tensor(pp, dtype=torch.float32, device=dev), sc.p_true)


def _path_2c(torch, np, results):
    """Path 2c's stage-1 map and the float64 CPU LM's residual on it."""
    import chip_smoke as cs
    from global_lvba_tpu_torch.__main__ import slice_config
    from global_lvba_tpu_torch.factors.padding import buckets_to_device
    from global_lvba_tpu_torch.solver.lm import lm_damping_iter

    W = cs.LARGE_FRAMES
    scene, Rp, pp, vm = cs._large_map(np, W, slice_config("float32"))
    cs.KEEP["2c"] = (vm, Rp, pp, scene.p_true)
    bs64 = buckets_to_device(vm, W=W, dtype=torch.float64, device="cpu")
    lm64 = lm_damping_iter(bs64, torch.as_tensor(Rp), torch.as_tensor(pp),
                           max_iters=cs.LARGE_LM_ITERS)
    results["path_2c"] = dict(stage1_lm=dict(
        residual_float64_cpu=float(lm64.residual)))


def _path_2a(np):
    import chip_smoke as cs
    from global_lvba_tpu_torch.models.synthetic import (
        make_plane_scene, perturb_poses)

    sc = make_plane_scene(num_frames=cs.WINDOW_FRAMES,
                          points_per_frame=cs.WINDOW_PPF, seed=0)
    Ra, pa = perturb_poses(sc.R_true, sc.p_true, 0.003, 0.01, seed=1)
    cs.KEEP["2a"] = (sc.points_body, sc.frame_ids, Ra, pa)


def _m1000(torch, dev, results):
    """The local float32 M=1000 solve ([visual-m1000]'s route and cost)."""
    import chip_smoke as cs
    from global_lvba_tpu_torch.solver import schur

    kind, iters = cs.VISUAL_BENCH[0]
    prob, bp = cs._visual_problem(kind)
    plan = schur.plan_visual(prob, bp.R0, bp.t0, bp.X0, dtype=torch.float32,
                             device=dev)
    schur.run_visual(plan, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = schur.run_visual(plan, iters)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    results["visual_bench"] = {kind: dict(
        route=res.route, cost=res.cost, ms_per_iter=wall / max(res.iters, 1))}


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from global_lvba_tpu_torch import resolve_device
    from global_lvba_tpu_torch.solver import dist_solve

    names = sys.argv[1:] or list(ORDER)
    bad = [n for n in names if n not in ORDER]
    if bad:
        raise SystemExit(f"unknown part {bad}: {', '.join(ORDER)}")
    dev = resolve_device("cuda")
    print(cs._card_line(), flush=True)
    results, paths = {}, {}
    kern = {k: dict(max_abs_err=0.0) for k in (
        "table_select", "soa_agg", "soa_chain", "soa_chain_entries",
        "entry_reduce", "syrk", "syrk_split", "table_select_f64",
        "soa_agg_f64", "soa_chain_entries_f64", "entry_reduce_f64",
        "syrk_f64")}
    t0 = time.time()
    for name in names:
        t1 = time.time()
        if name == "dryrun":
            cs._mesh_dryrun(torch, dev, results, paths)
        elif name == "shard-kernels":
            cs._mesh_shard_kernels(torch, np, dev, kern, results)
        elif name == "w512":
            cs._mesh_w512(torch, np, dev, kern, results, paths,
                          _bench(torch, np, dev))
        elif name == "w4096":
            _path_2c(torch, np, results)
            cs._mesh_w4096(torch, np, dev, kern, results, paths)
        elif name == "visual":
            _m1000(torch, dev, results)
            cs._mesh_visual(torch, np, dev, results)
        elif name == "spatial":
            _path_2a(np)
            cs._mesh_spatial(torch, np, dev, results)
        else:
            cs._mesh_processes(results)
        dist_solve._GRAPHS.clear()
        print(f"[mesh-{name}] {time.time() - t1:.1f} s (inputs included)",
              flush=True)
    results.update(launches_by_path=paths, kernel_max_abs_err=kern)
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "mesh_phase.json").write_text(
        json.dumps(results, indent=1, default=float))
    print(f"all {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
