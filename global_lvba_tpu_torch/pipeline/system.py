"""System orchestrator — the LvbaSystem equivalent (port of
global_lvba_tpu.pipeline.system).

Sequences the full refinement (runFullPipeline, src/lvba_system.cpp:
136-142): dataset load -> global LiDAR BA -> visual BA with LiDAR assist
-> exports, with stage-granular checkpoint/resume: every stage's output
is a deterministic .npz checkpoint in the JAX package's format, so
either package resumes from the other's.  The stages run on `device`
(default the card); loading, checkpoints and exports are host work.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from .. import resolve_device
from ..config import LvbaConfig
from ..frontend.colmap_db import load_colmap_db
from ..io.dataset import Dataset, load_dataset
from ..utils.checkpoint import StageCheckpoint
from ..utils.logging import get_logger, setup_logging
from ..utils.metrics import MetricsRegistry, StageTimer
from .lidar_ba import run_lidar_ba
from .visual_ba import run_visual_ba

log = get_logger("global_lvba_tpu_torch.system")


class LvbaSystem:
    """End-to-end pipeline runner over a Dataset (or in-memory equivalent)."""

    def __init__(
        self,
        cfg: LvbaConfig,
        dataset: Optional[Dataset] = None,
        out_dir: Optional[str] = None,
        resume: bool = True,
        device="cuda",
    ):
        setup_logging()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ds = dataset if dataset is not None else load_dataset(cfg)
        self.out_dir = Path(out_dir) if out_dir else self.ds.root / "lvba_out"
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.ckpt = StageCheckpoint(self.out_dir, enable=True)
        self.resume = resume
        self.metrics = MetricsRegistry()
        self.timer = StageTimer(self.metrics, self.device)
        # pipeline state
        self.R_opt = self.ds.lidar_R.copy()
        self.p_opt = self.ds.lidar_p.copy()
        self.visual_result = None
        self.export_times: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def run_lidar_ba(self):
        """Windowed + two-stage global LiDAR BA (runLidarBA equivalent)."""
        stage = "lidar_ba"
        if self.resume and self.ckpt.has(stage):
            data = self.ckpt.load(stage)
            self.R_opt = data["R_opt"]
            self.p_opt = data["p_opt"]
            log.info("[lidar_ba] resumed from checkpoint")
            return
        with self.timer.stage(stage):
            res = run_lidar_ba(
                self.ds.clouds, self.ds.lidar_R, self.ds.lidar_p, self.cfg,
                device=self.device,
            )
        self.R_opt = res.R_opt
        self.p_opt = res.p_opt
        self.metrics.set("lidar_ba/windows", res.stats["window"]["windows"])
        self.metrics.set("lidar_ba/skipped", res.stats["window"]["skipped"])
        self.ckpt.save(stage, R_opt=self.R_opt, p_opt=self.p_opt)

    # ------------------------------------------------------------------
    def _load_frontend(self):
        """COLMAP db preferred; the built-in SIFT frontend when the db is
        missing or does not cover the images (the reference's
        extractAndMatchFeaturesGPU structure, lvba_system.cpp:687-833)."""
        names = [p.name for p in self.ds.image_paths]
        if self.ds.colmap_db_path is not None:
            out = load_colmap_db(self.ds.colmap_db_path, names)
            if out is not None:
                kps, matches = out
                log.info("[frontend] loaded COLMAP db: %s", self.ds.colmap_db_path)
                return [k[:, :2] for k in kps], matches
            log.warning("[frontend] COLMAP db unusable, falling back to built-in SIFT")
        from .sift_frontend import extract_and_match_sift

        return extract_and_match_sift(
            self.ds, self.cfg, result_dir=self.out_dir / "result",
            device=self.device,
        )

    def run_visual_ba(self):
        stage = "visual_ba"
        if self.resume and self.ckpt.has(stage):
            data = self.ckpt.load(stage)
            # rebuild the result object so export_outputs() and the metrics
            # work after a resume (Rcw_orig follows from the dataset poses)
            from .depth import camera_world_to_cam
            from .visual_ba import VisualBAResultFull

            Rcw_orig, tcw_orig = camera_world_to_cam(
                self.ds.Rci, self.ds.tci, self.ds.cam_R, self.ds.cam_p
            )
            self.visual_result = VisualBAResultFull(
                Rcw=data["Rcw"], tcw=data["tcw"],
                Rcw_pre=data["Rcw_pre"], tcw_pre=data["tcw_pre"],
                Rcw_orig=Rcw_orig, tcw_orig=tcw_orig,
                points=data["points"], points_pre=data["points_pre"],
                track_obs=(data["obs_cam"], data["obs_pt"], data["obs_uv"]),
                mean_reproj_pre=float(data["mean_reproj_pre"]),
                mean_reproj_post=float(data["mean_reproj_post"]),
                stats={"resumed": True},
            )
            self.metrics.set("visual_ba/mean_reproj_pre", self.visual_result.mean_reproj_pre)
            self.metrics.set("visual_ba/mean_reproj_post", self.visual_result.mean_reproj_post)
            log.info("[visual_ba] resumed from checkpoint")
            return self.visual_result
        keypoints, matches = self._load_frontend()
        with self.timer.stage(stage):
            res = run_visual_ba(
                cam=self.ds.cam,
                clouds=self.ds.clouds,
                lidar_times=self.ds.lidar_times,
                R_opt=self.R_opt, p_opt=self.p_opt,
                R_orig=self.ds.lidar_R, p_orig=self.ds.lidar_p,
                image_times=self.ds.image_times,
                cam_R=self.ds.cam_R, cam_p=self.ds.cam_p,
                Rci=self.ds.Rci, tci=self.ds.tci,
                keypoints=keypoints,
                matches=matches,
                cfg=self.cfg,
                depth_out_dir=self.out_dir / "depth",
                device=self.device,
            )
        self.visual_result = res
        self.metrics.set("visual_ba/mean_reproj_pre", res.mean_reproj_pre)
        self.metrics.set("visual_ba/mean_reproj_post", res.mean_reproj_post)
        oc, op, ouv = res.track_obs
        self.ckpt.save(
            stage,
            Rcw=res.Rcw, tcw=res.tcw, Rcw_pre=res.Rcw_pre, tcw_pre=res.tcw_pre,
            points=res.points, points_pre=res.points_pre,
            obs_cam=oc, obs_pt=op, obs_uv=ouv,
            mean_reproj_pre=float(res.mean_reproj_pre),
            mean_reproj_post=float(res.mean_reproj_post),
        )
        return res

    # ------------------------------------------------------------------
    def export_outputs(self, images: Optional[Sequence[np.ndarray]] = None):
        """COLMAP sparse model + colored clouds (colmap_output/enable).

        File set matches the reference (lvba_system.cpp:1945-2137):
        Colmap/sparse/images.txt (optimized poses), Colmap/images/<k>.jpg
        (undistorted), Colmap/colored_merged_{before,after}.pcd
        (original-/optimized-pose colorized clouds, downsampled at
        filter_size_points3D), and Colmap/sparse/points3D.txt derived from
        the downsampled AFTER cloud (:2126-2137) — not from track points.
        Without images only the sparse model (from the track points) and
        the viz track clouds are written.  The images (BGR uint8 at the
        camera's size) go to the stage's device once: one undistort launch
        for all of them, then the JPEG encoder on host threads, and one
        colorize launch for each of the two clouds (their plain versions
        on the CPU).  The host seconds of each part are in export_times.
        """
        if self.visual_result is None or not self.cfg.colmap_output.enable:
            return
        from .downsample import downsample_nearest_center_idx
        from .outputs import colorize_clouds, write_colmap_sparse, write_colored_pcd
        from .viz import export_track_compare

        res = self.visual_result
        cdir = self.out_dir / "Colmap"
        export_track_compare(self.out_dir / "viz", res.points_pre, res.points)
        if images is None:
            # no imagery: emit the sparse model from track points only
            write_colmap_sparse(cdir, res.Rcw, res.tcw, res.points)
            return
        import torch

        from ..io.image import encode_jpeg
        from .outputs import (
            save_reprojection_overlays, save_track_feature_images,
            undistort_images)

        times = self.export_times = {}

        def lap(name, t0):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times[name] = time.perf_counter() - t0
            return time.perf_counter()

        # diagnostic imagery (reproj overlays + tracked-feature images,
        # lvba_system.cpp:1672-1837 / 1340-1420)
        t0 = time.perf_counter()
        oc, op, ouv = res.track_obs
        save_reprojection_overlays(
            self.out_dir / "reproj", self.ds.cam, images,
            oc, op, ouv,
            res.points_pre, res.points,
            res.Rcw_orig, res.tcw_orig, res.Rcw, res.tcw,
        )
        t0 = lap("overlays_s", t0)
        if res.keypoints is not None and res.used_kp_mask is not None:
            save_track_feature_images(
                self.out_dir / "track_features", self.ds.cam, images,
                res.keypoints, res.used_kp_mask,
            )
        t0 = lap("track_images_s", t0)
        stack = torch.from_numpy(np.ascontiguousarray(np.stack(images)))
        stack = stack.to(self.device)
        t0 = lap("upload_s", t0)
        # undistorted images for the COLMAP model (lvba_system.cpp:2026-2030)
        undist = undistort_images(self.ds.cam, stack, self.device)
        t0 = lap("undistort_s", t0)
        undist = undist.cpu().numpy()
        t0 = lap("undistort_copy_s", t0)
        idir = cdir / "images"
        idir.mkdir(parents=True, exist_ok=True)
        for k, data in enumerate(encode_jpeg(undist)):
            (idir / f"{k}.jpg").write_bytes(data)
        t0 = lap("jpeg_s", t0)
        leaf = self.cfg.colmap_output.filter_size_points3D
        colored_after = colorize_clouds(
            self.ds.cam, self.ds.clouds, self.ds.lidar_times,
            self.R_opt, self.p_opt, self.ds.image_times, stack,
            res.Rcw, res.tcw, device=self.device,
        )
        colored_before = colorize_clouds(
            self.ds.cam, self.ds.clouds, self.ds.lidar_times,
            self.ds.lidar_R, self.ds.lidar_p, self.ds.image_times, stack,
            res.Rcw_orig, res.tcw_orig, device=self.device,
        )
        t0 = lap("colorize_s", t0)
        pts3d = res.points
        rgb3d = None
        if colored_after.shape[0]:
            idx = downsample_nearest_center_idx(colored_after[:, :3], leaf)
            down_after = colored_after[idx]
            write_colored_pcd(cdir / "colored_merged_after.pcd", down_after)
            # points3D.txt = the downsampled colored merged cloud
            pts3d = down_after[:, :3]
            rgb3d = down_after[:, 3:6]
        if colored_before.shape[0]:
            idx = downsample_nearest_center_idx(colored_before[:, :3], leaf)
            write_colored_pcd(
                cdir / "colored_merged_before.pcd", colored_before[idx]
            )
        write_colmap_sparse(cdir, res.Rcw, res.tcw, pts3d, points_rgb=rgb3d)
        lap("clouds_s", t0)

    # ------------------------------------------------------------------
    def run_full_pipeline(self, images=None) -> Dict:
        if self.cfg.data_config.enable_lidar_ba:
            self.run_lidar_ba()
        result = {}
        if self.cfg.data_config.enable_visual_ba:
            res = self.run_visual_ba()
            result["mean_reproj_pre"] = res.mean_reproj_pre
            result["mean_reproj_post"] = res.mean_reproj_post
            self.export_outputs(images)
        self.metrics.dump(self.out_dir / "metrics.json")
        result["metrics"] = dict(self.metrics.values)
        return result
