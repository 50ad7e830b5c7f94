"""LiDAR bundle adjustment pipeline: windowed BA -> anchors -> global BA
(port of global_lvba_tpu.pipeline.lidar_ba).

Replicates the stage structure of runWindowBA / runLidarBA
(src/lvba_system.cpp:204-410):

  1. split the trajectory into windows of `window_ba.size` frames; per
     window voxelize (stage-1 root size, built-in eigen-ratio ladder) and
     LM-solve; skip a window when fewer than 3*win planar voxels exist
     (:259); optionally rigidly re-align the solved window to odometry
     frame 0 (`use_window_ba_rel`, :268-279);
  2. merge each window's clouds into its anchor frame (odometry frame 0 of
     the window), compress with nearest-to-center voxel downsampling
     (`anchor_leaf_size`), and record per-frame anchor-relative poses;
  3. run global BA over the anchors twice (BALM_stage1 / BALM_stage2 voxel
     sizes and eigen ratios, :357-389);
  4. compose anchor ∘ relative to recover all-frame optimized poses
     (:393-404); frames of skipped windows keep their input poses.

The host handles the once-per-stage binning (numpy on the CPU, the
native library's helpers on a CUDA device: map/voxelize.py); all
per-iteration math runs on `device` through factors/plane_eigen.py +
solver/lm.py.  Each solve's
layout comes from the density gate (factors/padding.py): the window
stage's solves (W = window size < 64) are bucketed, with the occupancy
tiers merged into one (V, K_max) bucket per window (merge="always", as in
the JAX package); a global stage is aligned or bucketed per its density.
Each stage's stats add the LM's iteration count and solve time
(`lm_iters`, `lm_s`) to the JAX package's keys.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device, solve_dtype
from ..config import LvbaConfig
from ..factors.padding import buckets_to_device
from ..map.voxelize import build_voxel_map
from ..solver.lm import lm_damping_iter
from .downsample import downsample_nearest_center

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LidarBAResult:
    R_opt: np.ndarray              # (F, 3, 3) all-frame optimized rotations
    p_opt: np.ndarray              # (F, 3)
    anchor_R: np.ndarray           # (A, 3, 3) optimized anchor poses
    anchor_p: np.ndarray           # (A, 3)
    anchor_clouds: List[np.ndarray]
    anchor_index: np.ndarray       # (F,) anchor id per frame, -1 if skipped
    rel_R: np.ndarray              # (F, 3, 3) frame pose relative to anchor
    rel_p: np.ndarray              # (F, 3)
    stats: dict


def _build_vm(pts_body, fids, R, p, voxel_size, eigen_ratios, cfg: LvbaConfig,
              device):
    return build_voxel_map(
        pts_body, fids, R, p, voxel_size,
        eigen_ratios=eigen_ratios,
        min_ps=cfg.solver.min_ps,
        layer_limit=cfg.solver.layer_limit,
        device=device,
    )


def _solve_from_vm(vm, R, p, cfg: LvbaConfig, device, min_voxels: int = 0,
                   merge: str = "auto"):
    """LM-solve one voxel map -> (R, p, num_planes, lm stats)."""
    if vm.num_planes < min_voxels or vm.num_planes == 0:
        return None, None, vm.num_planes, {}
    dtype = solve_dtype(cfg.solver.dtype)
    buckets = buckets_to_device(vm, W=len(R), dtype=dtype, device=device,
                                merge=merge)
    t0 = time.time()
    res = lm_damping_iter(
        buckets,
        torch.as_tensor(np.asarray(R), device=device).to(dtype),
        torch.as_tensor(np.asarray(p), device=device).to(dtype),
        max_iters=cfg.solver.lidar_max_iters,
    )
    R_out = res.R.to("cpu", torch.float64).numpy()
    p_out = res.p.to("cpu", torch.float64).numpy()
    lm = dict(lm_iters=res.iters, lm_s=time.time() - t0, lm_route=res.route)
    return R_out, p_out, vm.num_planes, lm


def _solve_ba(
    pts_body: np.ndarray,
    fids: np.ndarray,
    R: np.ndarray,
    p: np.ndarray,
    voxel_size: float,
    eigen_ratios: Sequence[float],
    cfg: LvbaConfig,
    device,
    min_voxels: int = 0,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int, dict]:
    """Voxelize + LM-solve one BA problem; returns (R, p, num_planes, lm stats)."""
    vm = _build_vm(pts_body, fids, R, p, voxel_size, eigen_ratios, cfg,
                   device)
    return _solve_from_vm(vm, R, p, cfg, device, min_voxels)


def run_window_ba(
    clouds: Sequence[np.ndarray],
    R_full: np.ndarray,
    p_full: np.ndarray,
    cfg: LvbaConfig,
    device="cuda",
):
    """Windowed LiDAR BA. Returns (anchor_poses, anchor_clouds, rel, index, stats)."""
    device = resolve_device(device)
    F = len(clouds)
    wcfg = cfg.window_ba
    window = wcfg.size
    anchor_R: List[np.ndarray] = []
    anchor_p: List[np.ndarray] = []
    anchor_clouds: List[np.ndarray] = []
    anchor_index = np.full(F, -1, dtype=np.int64)
    rel_R = np.tile(np.eye(3), (F, 1, 1))
    rel_p = np.zeros((F, 3))
    stats = {"windows": 0, "skipped": 0, "time_s": 0.0, "lm_iters": 0,
             "lm_s": 0.0}

    if not wcfg.enable:
        for i in range(F):
            anchor_R.append(R_full[i])
            anchor_p.append(p_full[i])
            anchor_clouds.append(clouds[i])
            anchor_index[i] = i
        return (
            np.stack(anchor_R), np.stack(anchor_p), anchor_clouds,
            (rel_R, rel_p), anchor_index, stats,
        )

    t0 = time.time()
    starts = list(range(0, F, window))

    # pipeline staging: the host voxelization of later windows runs on
    # worker threads while window i's LM iterations execute on device
    from concurrent.futures import ThreadPoolExecutor

    def build_for(start):
        end = min(start + window, F)
        pts = np.concatenate([clouds[j] for j in range(start, end)])
        fids = np.concatenate(
            [np.full(clouds[j].shape[0], j - start, dtype=np.int32)
             for j in range(start, end)]
        )
        return _build_vm(
            pts, fids, R_full[start:end], p_full[start:end],
            cfg.BALM_stage1.root_voxel_size, wcfg.eigen_ratio_array, cfg,
            device,
        )

    import os as _os

    # all window builds submitted upfront on a small pool: the numpy
    # binning releases the GIL in its sort/reduce phases, so builds overlap
    # both each other and the device solves
    executor = ThreadPoolExecutor(max_workers=min(4, _os.cpu_count() or 1))
    merge_pool = ThreadPoolExecutor(max_workers=2)
    try:
        merge_futures = []  # (anchor_idx, future) — resolved after the loop
        futures = {start: executor.submit(build_for, start) for start in starts}
        for wi, start in enumerate(starts):
            end = min(start + window, F)
            win = end - start
            if win <= 0:
                break
            stats["windows"] += 1
            R_win = R_full[start:end].copy()
            p_win = p_full[start:end].copy()
            R_odom, p_odom = R_win.copy(), p_win.copy()
            vm = futures.pop(start).result()
            # merge="always": ONE (V_pow2, K_max) bucket per window, the
            # JAX package's choice for the window stage
            R_sol, p_sol, n_planes, lm = _solve_from_vm(
                vm, R_win, p_win, cfg, device,
                min_voxels=cfg.solver.min_window_factor_ratio * win,
                merge="always",
            )
            stats["lm_iters"] += lm.get("lm_iters", 0)
            stats["lm_s"] += lm.get("lm_s", 0.0)
            if R_sol is None:
                stats["skipped"] += 1
                continue

            if wcfg.use_window_ba_rel:
                # rigid re-alignment of the solved window to odometry frame 0
                R_align = R_odom[0] @ R_sol[0].T
                p_align = p_odom[0] - R_align @ p_sol[0]
                R_aligned = np.einsum("ij,fjk->fik", R_align, R_sol)
                p_aligned = np.einsum("ij,fj->fi", R_align, p_sol) + p_align
            else:
                R_aligned, p_aligned = R_odom, p_odom

            aR, ap = R_odom[0], p_odom[0]
            anchor_idx = len(anchor_R)
            rel_R_win = np.einsum("ji,fjk->fik", aR, R_aligned)
            rel_p_win = np.einsum("ji,fj->fi", aR, p_aligned - ap)
            rel_R[start:end] = rel_R_win
            rel_p[start:end] = rel_p_win
            anchor_index[start:end] = anchor_idx

            def merge_win(start=start, win=win, rel_R_win=rel_R_win,
                          rel_p_win=rel_p_win):
                merged = np.concatenate([
                    (rel_R_win[j] @ clouds[start + j].T).T + rel_p_win[j]
                    for j in range(win)
                ]).astype(np.float32)
                return downsample_nearest_center(merged, wcfg.anchor_leaf_size)

            anchor_R.append(aR)
            anchor_p.append(ap)
            # transform+downsample off the critical path: depends only on this
            # window's solution, so it overlaps the next windows' solves
            merge_futures.append(merge_pool.submit(merge_win))

        anchor_clouds.extend(f.result() for f in merge_futures)
    finally:
        # a window whose solve raises leaves no worker behind
        executor.shutdown(wait=True, cancel_futures=True)
        merge_pool.shutdown(wait=True, cancel_futures=True)
    stats["time_s"] = time.time() - t0
    if stats["windows"]:
        log.info(
            "[WindowBA] skipped %d/%d windows (%.2f%%) in %.1fs",
            stats["skipped"], stats["windows"],
            100.0 * stats["skipped"] / stats["windows"], stats["time_s"],
        )
    A = len(anchor_R)
    return (
        np.stack(anchor_R) if A else np.zeros((0, 3, 3)),
        np.stack(anchor_p) if A else np.zeros((0, 3)),
        anchor_clouds,
        (rel_R, rel_p),
        anchor_index,
        stats,
    )


def run_lidar_ba(
    clouds: Sequence[np.ndarray],
    R_full: np.ndarray,
    p_full: np.ndarray,
    cfg: LvbaConfig,
    device="cuda",
) -> LidarBAResult:
    """Full LiDAR BA: window stage + two global anchor stages + composition.
    Runs on `device` (default the card; "cpu" runs the plain path)."""
    device = resolve_device(device)
    F = len(clouds)
    aR, ap, anchor_clouds, (rel_R, rel_p), anchor_index, wstats = run_window_ba(
        clouds, R_full, p_full, cfg, device
    )
    A = aR.shape[0]
    gstats = []
    if A >= 2:
        stages = []
        if cfg.BALM_stage1.enable:
            stages.append(cfg.BALM_stage1)
        stages.append(cfg.BALM_stage2)
        pts = np.concatenate(anchor_clouds)
        fids = np.concatenate(
            [np.full(c.shape[0], j, dtype=np.int32) for j, c in enumerate(anchor_clouds)]
        )
        for si, st in enumerate(stages):
            t0 = time.time()
            R_sol, p_sol, n_planes, lm = _solve_ba(
                pts, fids, aR, ap, st.root_voxel_size, st.eigen_ratio_array,
                cfg, device,
            )
            if R_sol is not None:
                aR, ap = R_sol, p_sol
            gstats.append(
                dict(stage=si + 1, planes=n_planes, time_s=time.time() - t0,
                     **lm)
            )
            log.info("[GlobalBA] stage %d: %d planes, %.1fs", si + 1, n_planes, time.time() - t0)

    # compose anchor ∘ relative -> all-frame optimized trajectory (:393-404)
    R_opt = R_full.copy()
    p_opt = p_full.copy()
    for i in range(F):
        aidx = anchor_index[i]
        if aidx < 0 or aidx >= A:
            continue
        R_opt[i] = aR[aidx] @ rel_R[i]
        p_opt[i] = aR[aidx] @ rel_p[i] + ap[aidx]

    # optional DIRECT all-frame refinement (engine extension, no reference
    # analogue): the composition above freezes intra-window pose error, so
    # one more global solve over ALL frames, initialized from the composed
    # trajectory, removes accumulated odometry drift
    rcfg = cfg.global_refine
    if rcfg.enable and F >= 2:
        pts_all = np.concatenate([np.asarray(c) for c in clouds])
        fids_all = np.concatenate(
            [np.full(len(c), i, dtype=np.int32) for i, c in enumerate(clouds)]
        )
        vs = rcfg.root_voxel_size or cfg.BALM_stage2.root_voxel_size
        for rnd in range(max(1, rcfg.rounds)):
            t0 = time.time()
            R_sol, p_sol, n_planes, lm = _solve_ba(
                pts_all, fids_all, R_opt, p_opt, vs,
                rcfg.eigen_ratio_array, cfg, device,
            )
            if R_sol is not None:
                R_opt, p_opt = R_sol, p_sol
            gstats.append(
                dict(stage=f"refine{rnd + 1}", planes=n_planes,
                     time_s=time.time() - t0, **lm)
            )
            log.info(
                "[GlobalRefine] round %d all-frame W=%d: %d planes, %.1fs",
                rnd + 1, F, n_planes, time.time() - t0,
            )

    return LidarBAResult(
        R_opt=R_opt,
        p_opt=p_opt,
        anchor_R=aR,
        anchor_p=ap,
        anchor_clouds=anchor_clouds,
        anchor_index=anchor_index,
        rel_R=rel_R,
        rel_p=rel_p,
        stats={"window": wstats, "global": gstats},
    )
