"""The multi-device dry run (the port's counterpart of the JAX package's
__graft_entry__.dryrun_multichip): every sharded path of the port on an
n-shard mesh, each held to its single-device result, e.g. on eight CPU
shards: dryrun_multichip(8, devices=["cpu"] * 8)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TOL = 1e-8


def _max_diff(a, b) -> float:
    return float((a.to(b.device) - b).abs().max())


def _lidar_problem(dtype, device):
    """The JAX dry run's problem (__graft_entry__._build_problem): a 10-frame
    plane scene, 3,000 points a frame, bucketed, perturbed poses."""
    from ..factors.padding import buckets_to_device
    from ..map.voxelize import build_voxel_map
    from ..models.synthetic import make_plane_scene, perturb_poses

    sc = make_plane_scene(num_frames=10, points_per_frame=3000, seed=0)
    vm = build_voxel_map(sc.points_body, sc.frame_ids, sc.R_true, sc.p_true,
                         voxel_size=1.0, eigen_ratios=(0.2, 0.2, 0.2, 0.2))
    buckets = buckets_to_device(vm, 10, dtype=dtype, device=device)
    Rp, pp = perturb_poses(sc.R_true, sc.p_true, 0.01, 0.03)
    return (buckets, torch.as_tensor(Rp).to(device, dtype),
            torch.as_tensor(pp).to(device, dtype), vm)


def _visual_problem():
    """The JAX dry run's visual problem: a 6-frame joint scene, the
    observations from its ground-truth correspondences, cameras
    perturbed."""
    from ..models.synthetic import make_joint_scene, perturb_poses
    from ..pipeline.depth import camera_world_to_cam
    from ..solver.schur import VisualBAProblem

    js = make_joint_scene(num_frames=6, points_per_frame=2000, seed=0,
                          num_landmarks=300, pair_window=5)
    sc = js.lidar
    Rcw, tcw = camera_world_to_cam(js.Rci, js.tci, sc.R_true[js.image_frame],
                                   sc.p_true[js.image_frame])
    obs_cam, obs_pt, obs_uv = [], [], []
    lm_ids = sorted({int(i) for lm in js.kp_landmark for i in lm})
    remap = {i: k for k, i in enumerate(lm_ids)}
    for m in range(len(js.keypoints)):
        for k in range(js.keypoints[m].shape[0]):
            obs_cam.append(m)
            obs_pt.append(remap[int(js.kp_landmark[m][k])])
            obs_uv.append(js.keypoints[m][k])
    X0 = js.landmarks[lm_ids]
    prob = VisualBAProblem(
        cam=js.cam, obs_cam=np.asarray(obs_cam, np.int32),
        obs_pt=np.asarray(obs_pt, np.int32), obs_uv=np.stack(obs_uv),
        plane_n=np.tile(np.array([[0.0, 0.0, 1.0]]), (X0.shape[0], 1)),
        plane_d=-X0[:, 2].copy(), num_cams=len(js.keypoints),
        num_pts=X0.shape[0])
    Rcw_p, tcw_p = perturb_poses(Rcw, tcw, 0.002, 0.008, seed=3)
    return prob, Rcw_p, tcw_p, X0


def dryrun_multichip(n_devices: int, devices=None,
                     dtype=torch.float64, verbose: bool = True) -> dict:
    """The sharded paths on an n-shard mesh (make_mesh(n, devices=devices):
    the first n CUDA devices without `devices`), each against its
    single-device result on the mesh's first device: the factor-sharded
    LiDAR LM (lu, cg), the GatherPlan LM (gather-plan, single-device, as
    in the JAX dry run), the sharded banded evaluation, the sharded banded
    and compact-banded LMs, the LM on Morton-partitioned buckets
    (morton+cg), the spatial halo exchange, and the visual Schur solve
    (auto, cg, cg_mf).  In float64 every sharded result must lie within
    1e-8 of the local one (AssertionError otherwise).  Returns the
    differences, by check."""
    from ..factors.padding import buckets_to_device
    from ..factors.plane_eigen import (
        banded_cgh, bucket_to_device, build_banded_groups)
    from ..map.voxelize import build_voxel_map
    from ..models.synthetic import make_corridor_scene
    from ..solver.lm import lm_damping_iter
    from ..solver.schur import solve_visual_ba
    from .mesh import make_mesh
    from .shard import (
        banded_cgh_sharded, lm_damping_iter_banded_compact_sharded,
        lm_damping_iter_banded_sharded, lm_damping_iter_sharded)
    from .spatial import (
        distributed_voxel_moments, host_voxel_moments,
        partition_buckets_morton)

    mesh = make_mesh(n_devices, ("factors",), devices=devices)
    dev = mesh.first
    strict = dtype == torch.float64
    out = {}

    def say(msg):
        if verbose:
            print(f"[dryrun_multichip] {msg}", flush=True)

    def check(label, diffs, msg):
        worst = max(diffs)
        out[label] = worst
        if strict:
            assert worst < TOL, f"sharded {label} diverged from local: {msg}"
        say(msg)

    buckets, R, p, vm = _lidar_problem(dtype, dev)
    res_loc = lm_damping_iter(buckets, R, p, max_iters=10)

    def check_lidar(res, label, res_scale=1.0):
        dR, dp = _max_diff(res.R, res_loc.R), _max_diff(res.p, res_loc.p)
        assert torch.isfinite(res.R).all() and torch.isfinite(res.p).all()
        check(label, (dR, dp),
              f"lidar LM[{label}]: n={n_devices} route={res.route} "
              f"iters={res.iters} residual="
              f"{float(res.residual) * res_scale:.6g} (local "
              f"{float(res_loc.residual):.6g}) |dR|={dR:.3g} |dp|={dp:.3g}")

    for solver in ("lu", "cg"):
        check_lidar(lm_damping_iter_sharded(buckets, R, p, mesh, max_iters=10,
                                            reduced_solver=solver), solver)

    # the GatherPlan evaluation (g and Hd through each plan's frame table,
    # the (3V, 6W) Gram operand) on the mesh's first device against the
    # local solve, as the JAX dry run certifies it (a single-device route:
    # its plans are per-bucket data, not mesh communication)
    check_lidar(lm_damping_iter(buckets, R, p, max_iters=10,
                                gather_tables=True), "gather-plan")

    # the banded evaluation sharded, on a span-limited corridor
    Wc = 48
    cor = make_corridor_scene(num_frames=Wc, points_per_frame=800, seed=4)
    vmc = build_voxel_map(cor.points_body, cor.frame_ids, cor.R_true,
                          cor.p_true, voxel_size=1.0,
                          eigen_ratios=(0.2, 0.2, 0.2, 0.2))
    Rc = torch.as_tensor(cor.R_true).to(dev, dtype)
    pc = torch.as_tensor(cor.p_true).to(dev, dtype)
    cbk = buckets_to_device(vmc, Wc, dtype=dtype, device=dev)
    diffs = []
    for fa in cbk:
        bg = build_banded_groups(fa, Wc, block=8)
        if bg.fa.n.shape[0] < 2:
            continue
        r0, g0, Hd0, H0 = banded_cgh(bg, Rc, pc, Wc)
        r1, g1, Hd1, H1 = banded_cgh_sharded(bg, Rc, pc, Wc, mesh)
        diffs += [_max_diff(H1, H0), _max_diff(g1, g0)]
    assert diffs, "corridor fixture produced no banded group stacks"
    check("banded-eval", diffs,
          f"banded eval sharded: n={n_devices} buckets={len(diffs) // 2} "
          f"max |d|={max(diffs):.3g}")

    res_bl = lm_damping_iter(cbk, Rc, pc, max_iters=6, hessian="banded")
    res_bs = lm_damping_iter_banded_sharded(cbk, Rc, pc, mesh, max_iters=6)
    dRb, dpb = _max_diff(res_bs.R, res_bl.R), _max_diff(res_bs.p, res_bl.p)
    check("banded-lm", (dRb, dpb),
          f"banded LM sharded: n={n_devices} residual="
          f"{float(res_bs.residual):.6g} (local {float(res_bl.residual):.6g})"
          f" |dR|={dRb:.3g} |dp|={dpb:.3g}")

    res_cl = lm_damping_iter(cbk, Rc, pc, max_iters=6, hessian="banded",
                             reduced_solver="cg")
    res_cs = lm_damping_iter_banded_compact_sharded(cbk, Rc, pc, mesh,
                                                    max_iters=6, block=8)
    dRc, dpc = _max_diff(res_cs.R, res_cl.R), _max_diff(res_cs.p, res_cl.p)
    check("banded-compact-lm", (dRc, dpc),
          f"banded-compact LM sharded (no (6W)^2 on any device): "
          f"n={n_devices} residual={float(res_cs.residual):.6g} (local "
          f"{float(res_cl.residual):.6g}) |dR|={dRc:.3g} |dp|={dpc:.3g}")

    # Morton-partitioned buckets through the sharded CG: the solution is
    # the local one; the printed residual is rescaled from the padded row
    # count to the local buckets' (their pow2 padding differs)
    part = [bucket_to_device(b, dtype=dtype, device=dev)
            for b in partition_buckets_morton(vm, mesh.n_shards())]
    g_loc = sum(int(fa.n.shape[0]) for fa in buckets)
    n_sh = mesh.n_shards()
    g_part = sum(-(-int(fa.n.shape[0]) // n_sh) * n_sh for fa in part)
    check_lidar(lm_damping_iter_sharded(part, R, p, mesh, max_iters=10,
                                        reduced_solver="cg"),
                "morton+cg", res_scale=g_part / g_loc)

    # the spatial halo exchange against the host binning
    rng = np.random.default_rng(0)
    pts = rng.uniform(-15, 15, size=(8000, 3)).astype(np.float32)
    kk, cc, ss, mm = distributed_voxel_moments(pts, 1.0, mesh,
                                               capacity=2048)
    hk, hc, hs, hm = host_voxel_moments(pts.astype(np.float64), 1.0)
    assert np.array_equal(kk, hk) and np.array_equal(cc, hc)
    assert np.allclose(ss, hs, rtol=1e-5, atol=1e-3)
    out["spatial"] = float(np.abs(ss - hs).max())
    say(f"spatial halo exchange: n={n_devices} voxels={kk.shape[0]} "
        f"== host, max |dsum|={out['spatial']:.3g}")

    prob, Rcw, tcw, X0 = _visual_problem()
    for rs in ("auto", "cg", "cg_mf"):
        prob_rs = dataclasses.replace(prob, reduced_solver=rs)
        vloc = solve_visual_ba(prob_rs, Rcw, tcw, X0, max_iters=10,
                               dtype=dtype, device=dev)
        vres = solve_visual_ba(prob_rs, Rcw, tcw, X0, max_iters=10,
                               dtype=dtype, mesh=mesh)
        assert torch.isfinite(vres.R).all()
        assert vres.cost < vres.cost0, f"visual LM[{rs}] raised the cost"
        dR, dt = _max_diff(vres.R, vloc.R), _max_diff(vres.t, vloc.t)
        check(f"visual-{rs}", (dR, dt),
              f"visual Schur[{rs}]: n={n_devices} route={vres.route} "
              f"obs={prob.obs_cam.shape[0]} cost {vres.cost0:.6g} -> "
              f"{vres.cost:.6g} (local {vloc.cost:.6g}) |dR|={dR:.3g} "
              f"|dt|={dt:.3g}")
    return out

