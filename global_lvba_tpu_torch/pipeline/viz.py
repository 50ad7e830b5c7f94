"""Trajectory/cloud visualization exports (the port's own copy of
global_lvba_tpu.pipeline.viz; host numpy) — the file-based analogue of the
reference's ROS publishers (data_show at src/lvba_system.cpp:167-202,
showTracksComparePCL :1839-1878, pubRGBCloud :2154-2173): instead of rviz
topics, downsampled world clouds and trajectory paths are written as PCD
files any viewer can load."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from ..io.pcd import write_pcd
from .downsample import downsample_mean


def export_trajectory_cloud(
    out_dir,
    clouds: Sequence[np.ndarray],
    R: np.ndarray,
    p: np.ndarray,
    leaf: float = 0.05,
    prefix: str = "map",
    align_to_first: bool = True,
):
    """World cloud + trajectory path PCDs (data_show semantics: poses are
    re-expressed relative to frame 0, clouds downsampled at 0.05 m)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    R = np.asarray(R)
    p = np.asarray(p)
    if align_to_first and len(clouds):
        R0t = R[0].T
        p0 = p[0]
        R = np.einsum("ab,fbc->fac", R0t, R)
        p = np.einsum("ab,fb->fa", R0t, (p - p0))
    parts = []
    for i, c in enumerate(clouds):
        w = (R[i] @ c.T).T + p[i]
        parts.append(downsample_mean(w.astype(np.float32), leaf))
    cloud = downsample_mean(np.concatenate(parts), leaf) if parts else np.zeros((0, 3), np.float32)
    write_pcd(out_dir / f"{prefix}_cloud.pcd", cloud)
    write_pcd(out_dir / f"{prefix}_path.pcd", p.astype(np.float32))
    return cloud.shape[0]


def export_track_compare(
    out_dir,
    points_before: np.ndarray,
    points_after: np.ndarray,
):
    """Track points before/after optimization (showTracksComparePCL)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_pcd(out_dir / "tracks_before.pcd", np.asarray(points_before, np.float32))
    write_pcd(out_dir / "tracks_after.pcd", np.asarray(points_after, np.float32))


def launch_viewer(out_dir, block: bool = True) -> bool:
    """OPTIONAL interactive viewer for the exported PCDs — closes the UX
    gap with the reference's live rviz session (rviz_cfg/lv_ba.rviz,
    lvba_system.cpp:117-125) when a display and open3d are available.
    Compute hosts are often headless and open3d is not a dependency, so this
    degrades gracefully: returns False (with a hint) when the viewer
    cannot run; the PCD/PNG exports remain the primary artifact."""
    out_dir = Path(out_dir)
    pcds = sorted(out_dir.rglob("*.pcd"))
    if not pcds:
        print(f"[viewer] no PCD exports under {out_dir}")
        return False
    try:
        import open3d as o3d  # optional; not in the base image
    except ImportError:
        print(
            "[viewer] open3d not installed — open the exports in any PCD "
            "viewer (CloudCompare, pcl_viewer, open3d):\n  "
            + "\n  ".join(str(p) for p in pcds[:8])
        )
        return False
    geoms = []
    for pth in pcds:
        g = o3d.io.read_point_cloud(str(pth))
        if len(g.points):
            geoms.append(g)
    if not geoms:
        return False
    if block:
        o3d.visualization.draw_geometries(geoms)
        return True
    # non-blocking: hand the window to a detached child process so the
    # pipeline continues; success means the viewer process launched
    import subprocess
    import sys

    code = (
        "import sys, open3d as o3d\n"
        "gs = [o3d.io.read_point_cloud(p) for p in sys.argv[1:]]\n"
        "o3d.visualization.draw_geometries([g for g in gs if len(g.points)])\n"
    )
    try:
        subprocess.Popen(
            [sys.executable, "-c", code, *[str(p) for p in pcds]],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        return True
    except OSError as e:
        print(f"[viewer] could not launch viewer process: {e}")
        return False
