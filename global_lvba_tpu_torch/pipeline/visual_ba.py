"""Visual BA with LiDAR assistance, the full stage pipeline (port of
global_lvba_tpu.pipeline.visual_ba).

Replicates runVisualBAWithLidarAssist (src/lvba_system.cpp:144-154) stage
by stage:

  1. world grid map + per-image covisible voxel sets (:1266-1338)
  2. camera poses updated by per-frame LiDAR pose deltas (:412-446)
  3. LiDAR depth maps by z-buffer splatting (:835-919)
  4. feature matches (caller-provided: a COLMAP db or the SIFT frontend)
  5. track building (union-find) + batched 3D fusion (:921-1263)
  6. plane priors: anchor clouds revoxelized at the stage-2 size, each
     track point looked up in the planar hierarchy (:1450-1568)
  7. joint Schur LM over camera poses + track points with reprojection
     and point-to-plane residuals (:1571-1665)
  8. pre/post mean reprojection metrics (:1830-1833)

Stages 1, 2, 5's union-find and 6 run on the host, the depth maps of 3 on
`device` (default the card: one launch of kernels/zbuffer.py over all
images); fusion and the joint solve run on `device`, the solve in
cfg.solver.dtype.  The device also picks the host helpers' path
(native.on_device): the native library on a CUDA device, numpy on the
CPU.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device, solve_dtype
from ..config import LvbaConfig
from ..eval.metrics import mean_reprojection_error
from ..geometry.camera import CameraModel
from ..map.voxelize import build_voxel_map
from ..solver.schur import VisualBAProblem, solve_visual_ba
from ..tracks.build import build_components
from ..tracks.fuse import fuse_tracks
from .depth import (
    build_grid_map,
    camera_world_to_cam,
    render_depth_maps,
    update_camera_poses_from_lidar,
)
from .downsample import downsample_nearest_center

log = logging.getLogger(__name__)


@dataclasses.dataclass
class VisualBAResultFull:
    Rcw: np.ndarray            # (M, 3, 3) optimized world->cam
    tcw: np.ndarray            # (M, 3)
    Rcw_pre: np.ndarray        # before optimization (post LiDAR update)
    tcw_pre: np.ndarray
    Rcw_orig: np.ndarray       # from original (pre-LiDAR) body poses
    tcw_orig: np.ndarray
    points: np.ndarray         # (P, 3) optimized track points
    points_pre: np.ndarray
    track_obs: Tuple[np.ndarray, np.ndarray, np.ndarray]  # cam, pt, uv
    mean_reproj_pre: float
    mean_reproj_post: float
    stats: dict
    # per image: all keypoints (K, 2) and which ended up in used tracks
    keypoints: Optional[list] = None
    used_kp_mask: Optional[list] = None


def build_anchor_plane_lookup(
    clouds: Sequence[np.ndarray],
    R_opt: np.ndarray,
    p_opt: np.ndarray,
    cfg: LvbaConfig,
    device="cpu",
):
    """Anchor-cloud planar map for track plane priors
    (lvba_system.cpp:1461-1507): merge optimized-pose windows into anchor
    frames, compress, voxelize at the stage-2 root size (its host path
    picked by `device`), return the plane lookup."""
    F = len(clouds)
    window = cfg.window_ba.size
    anchor_pts = []
    anchor_fids = []
    aR, ap = [], []
    for start in range(0, F, window):
        end = min(start + window, F)
        a = len(aR)
        R0, p0 = R_opt[start], p_opt[start]
        merged = []
        for j in range(start, end):
            Rr = R0.T @ R_opt[j]
            pr = R0.T @ (p_opt[j] - p0)
            merged.append((Rr @ clouds[j].T).T + pr)
        merged = np.concatenate(merged).astype(np.float32)
        merged = downsample_nearest_center(merged,
                                           cfg.window_ba.anchor_leaf_size)
        anchor_pts.append(merged)
        anchor_fids.append(np.full(merged.shape[0], a, dtype=np.int32))
        aR.append(R0)
        ap.append(p0)
    vm = build_voxel_map(
        np.concatenate(anchor_pts),
        np.concatenate(anchor_fids),
        np.stack(aR),
        np.stack(ap),
        cfg.BALM_stage2.root_voxel_size,
        eigen_ratios=cfg.BALM_stage2.eigen_ratio_array,
        min_ps=cfg.solver.min_ps,
        layer_limit=cfg.solver.layer_limit,
        min_frames=1,  # priors only need the plane geometry
        build_factors=False,  # lookup only: no factor buckets
        device=device,
    )
    return vm.lookup


def run_visual_ba(
    cam: CameraModel,
    clouds: Sequence[np.ndarray],
    lidar_times: np.ndarray,
    R_opt: np.ndarray, p_opt: np.ndarray,       # optimized LiDAR body poses
    R_orig: np.ndarray, p_orig: np.ndarray,     # original LiDAR body poses
    image_times: np.ndarray,
    cam_R: np.ndarray, cam_p: np.ndarray,       # original per-image body poses
    Rci: np.ndarray, tci: np.ndarray,           # camera<-imu extrinsic
    keypoints: Sequence[np.ndarray],            # per image (K, >=2) px coords
    matches: Dict[Tuple[int, int], np.ndarray],
    cfg: LvbaConfig,
    depth_out_dir=None,
    device="cuda",
) -> VisualBAResultFull:
    """The visual stage on `device` (default the card; "cpu" runs the
    plain path).  Track fusion runs in float32 (fuse_tracks' default, as
    in the JAX package), the solve in cfg.solver.dtype.  With
    depth_out_dir, each image's depth map is written there as a 16-bit
    PNG named by its timestamp (<ts>.png, outputs.save_depth_png)."""
    dev = resolve_device(device)
    t_start = time.time()
    stats: dict = {}

    # 1. grid map + covisibility
    gm = build_grid_map(clouds, R_opt, p_opt, device=dev)

    # 2. propagate LiDAR deltas to camera body poses
    cam_R_upd, cam_p_upd = update_camera_poses_from_lidar(
        lidar_times, R_opt, p_opt, R_orig, p_orig, image_times, cam_R, cam_p
    )
    Rcw_pre, tcw_pre = camera_world_to_cam(Rci, tci, cam_R_upd, cam_p_upd)
    Rcw_orig, tcw_orig = camera_world_to_cam(Rci, tci, cam_R, cam_p)

    # 3. depth maps
    t0 = time.time()
    depth_maps = render_depth_maps(
        cam, gm, lidar_times, image_times, Rcw_pre, tcw_pre, device=dev
    )
    stats["depth_s"] = time.time() - t0
    if depth_out_dir is not None:
        # timestamp-named 16-bit depth maps (lvba_system.cpp:907-915)
        from .outputs import save_depth_png

        t0 = time.time()
        dd = Path(depth_out_dir)
        dd.mkdir(parents=True, exist_ok=True)
        for i, t_img in enumerate(image_times):
            save_depth_png(dd / f"{t_img:.6f}.png", depth_maps[i])
        stats["depth_png_s"] = time.time() - t0

    # 4-5. tracks
    t0 = time.time()
    ts = build_components(
        keypoints, matches, obser_thr=cfg.track_fusion.obser_thr, device=dev
    )
    stats.update(ts.stats)
    fr = fuse_tracks(
        cam, ts, depth_maps, Rcw_pre, tcw_pre,
        obser_thr=cfg.track_fusion.obser_thr,
        min_view_angle_deg=cfg.track_fusion.min_view_angle,
        reproj_thr=cfg.track_fusion.reproj_mean_thr,
        device=dev,
    )
    ok = fr.ok.cpu().numpy()
    Xw = fr.Xw.cpu().double().numpy()
    kept_obs = fr.kept_obs.cpu().numpy()
    from_tri = fr.from_tri.cpu().numpy()
    stats["tracks_fused"] = int(ok.sum())
    stats["tri_selected"] = int(from_tri.sum())
    stats["depth_selected"] = int(ok.sum() - from_tri.sum())
    stats["fuse_s"] = time.time() - t0
    log.info(
        "[TrackFilter] kept=%d dropped=%d total=%d depth_selected=%d "
        "tri_selected=%d", stats["tracks_fused"],
        ts.stats["kept_components"] - stats["tracks_fused"],
        ts.stats["kept_components"], stats["depth_selected"],
        stats["tri_selected"],
    )

    # 6. plane priors per fused track point
    t0 = time.time()
    lookup = build_anchor_plane_lookup(clouds, R_opt, p_opt, cfg, device=dev)
    track_ids = np.flatnonzero(ok)
    plane_idx = (lookup.query(Xw[track_ids]) if track_ids.size
                 else np.zeros(0, np.int64))
    has_plane = plane_idx >= 0
    use = track_ids[has_plane]
    stats["tracks_with_plane"] = int(use.size)
    stats["planes_s"] = time.time() - t0

    if use.size == 0:
        raise RuntimeError("no fused tracks with valid plane priors")

    plane_n = lookup.normals[plane_idx[has_plane]]
    plane_d = -np.einsum("pi,pi->p", plane_n,
                         lookup.centers[plane_idx[has_plane]])

    # observation arrays from the kept inlier observations (row-major
    # nonzero keeps the per-track, per-slot order)
    ui, oi = np.nonzero(kept_obs[use])
    obs_cam = ts.obs_img[use[ui], oi].astype(np.int32)
    obs_pt = ui.astype(np.int32)
    obs_uv = ts.obs_uv[use[ui], oi].astype(np.float64)
    # per-image used-keypoint mask (the track-feature imagery)
    kp_used = ts.obs_kp[use[ui], oi]
    used_kp_mask = [np.zeros(k.shape[0], bool) for k in keypoints]
    for m in range(len(keypoints)):
        sel = obs_cam == m
        if np.any(sel):
            used_kp_mask[m][kp_used[sel]] = True
    stats["observations"] = int(obs_cam.shape[0])

    # 7. joint solve
    t0 = time.time()
    prob = VisualBAProblem(
        cam=cam,
        obs_cam=obs_cam,
        obs_pt=obs_pt,
        obs_uv=obs_uv,
        plane_n=plane_n,
        plane_d=plane_d,
        num_cams=len(image_times),
        num_pts=use.size,
        sigma_px=cfg.solver.sigma_px,
        sigma_plane=cfg.solver.sigma_plane,
    )
    X0 = Xw[use]
    res = solve_visual_ba(
        prob, Rcw_pre, tcw_pre, X0, max_iters=cfg.solver.visual_max_iters,
        dtype=solve_dtype(cfg.solver.dtype), device=dev,
    )
    Rcw_post = res.R.cpu().double().numpy()
    tcw_post = res.t.cpu().double().numpy()
    X_post = res.X.cpu().double().numpy()
    stats["solve_s"] = time.time() - t0
    stats["solve_iters"] = int(res.iters)
    stats["solve_route"] = res.route
    stats["cost0"] = float(res.cost0)
    stats["cost"] = float(res.cost)

    # 8. metrics: per-image means of pre (original poses + pre points) and
    # post (optimized poses + optimized points), averaged over images
    pre = mean_reprojection_error(cam, Rcw_orig, tcw_orig, X0, obs_cam,
                                  obs_pt, obs_uv)
    post = mean_reprojection_error(cam, Rcw_post, tcw_post, X_post, obs_cam,
                                   obs_pt, obs_uv)
    stats["time_s"] = time.time() - t_start
    log.info("[visualBA] global mean pre %.3f px post %.3f px", pre, post)

    return VisualBAResultFull(
        Rcw=Rcw_post,
        tcw=tcw_post,
        Rcw_pre=Rcw_pre,
        tcw_pre=tcw_pre,
        Rcw_orig=Rcw_orig,
        tcw_orig=tcw_orig,
        points=X_post,
        points_pre=X0,
        track_obs=(obs_cam, obs_pt, obs_uv),
        mean_reproj_pre=pre,
        mean_reproj_post=post,
        stats=stats,
        keypoints=[np.asarray(k, np.float32) for k in keypoints],
        used_kp_mask=used_kp_mask,
    )
