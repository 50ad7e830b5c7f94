"""Dataset loader for the reference's on-disk layout; the port's own copy
of global_lvba_tpu.io.dataset (host numpy: the arrays go to the device in
the stages that use them).

Replicates DatasetIO (src/dataset_io.cpp): a dataset
directory holds
  all_image/<timestamp>.png + all_image/image_poses.txt   (TUM, camera/IMU)
  all_pcd_body/<timestamp>.pcd + all_pcd_body/lidar_poses.txt (TUM)
Images are timestamp-named and subsampled by `image_sample_step`; image
poses use the same stride; LiDAR poses/PCDs are loaded densely.
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..config import LvbaConfig
from ..geometry.camera import CameraModel
from .pcd import read_pcd
from .tum import read_tum_poses

_TS_RE = re.compile(r"([0-9]+(?:\.[0-9]+)?)")
_IMG_EXT = {".png", ".jpg", ".jpeg", ".bmp"}


def parse_timestamp(name: str) -> Optional[float]:
    """First numeric token of a file name (utils.hpp:462-477)."""
    m = _TS_RE.search(name)
    return float(m.group(1)) if m else None


@dataclasses.dataclass
class Dataset:
    root: Path
    cam: CameraModel                 # already scaled by resize factor
    image_times: np.ndarray          # (M,)
    image_paths: List[Path]
    cam_R: np.ndarray                # (M, 3, 3) body(IMU)-world poses
    cam_p: np.ndarray
    lidar_times: np.ndarray          # (F,)
    lidar_R: np.ndarray              # (F, 3, 3)
    lidar_p: np.ndarray
    clouds: List[np.ndarray]         # per frame (N_i, 3) float32 body points
    # extrinsics
    Rcl: np.ndarray
    tcl: np.ndarray
    Rci: np.ndarray                  # camera <- imu  (initFromDatasetIO:503-504)
    tci: np.ndarray
    colmap_db_path: Optional[Path]


def load_dataset(cfg: LvbaConfig, root=None, load_clouds: bool = True) -> Dataset:
    root = Path(root if root is not None else cfg.data_config.data_path)
    cm = cfg.cam_model
    cam = CameraModel(
        fx=cm.cam_fx, fy=cm.cam_fy, cx=cm.cam_cx, cy=cm.cam_cy,
        k1=cm.cam_d0, k2=cm.cam_d1, p1=cm.cam_d2, p2=cm.cam_d3,
        width=cm.cam_width, height=cm.cam_height,
    ).scaled(cm.scale)

    # images (dataset_io.cpp:77-131)
    img_dir = root / "all_image"
    entries = []
    for f in sorted(img_dir.iterdir()):
        if f.suffix.lower() not in _IMG_EXT:
            continue
        ts = parse_timestamp(f.name)
        if ts is None:
            continue
        entries.append((ts, f))
    entries.sort(key=lambda e: e[0])
    stride = max(1, cfg.data_config.image_sample_step)
    entries = entries[::stride]
    image_times = np.array([e[0] for e in entries])
    image_paths = [e[1] for e in entries]

    # camera poses: same stride (dataset_io.cpp:197-210)
    _, cam_R, cam_p = read_tum_poses(img_dir / "image_poses.txt", stride=stride)
    if cam_R.shape[0] != len(image_paths):
        raise ValueError(
            f"camera pose count {cam_R.shape[0]} != image count {len(image_paths)}"
        )

    # lidar poses + clouds (dataset_io.cpp:186-300)
    pcd_dir = root / "all_pcd_body"
    _, lidar_R, lidar_p = read_tum_poses(pcd_dir / "lidar_poses.txt", stride=1)
    pcds = []
    for f in sorted(pcd_dir.iterdir()):
        if f.suffix.lower() != ".pcd":
            continue
        ts = parse_timestamp(f.name)
        if ts is None:
            continue
        pcds.append((ts, f))
    pcds.sort(key=lambda e: e[0])
    lidar_times = np.array([e[0] for e in pcds])
    clouds = []
    if load_clouds:
        for _, f in pcds:
            clouds.append(read_pcd(f, fields=("x", "y", "z"))[:, :3])

    n = min(len(pcds), lidar_R.shape[0])
    lidar_times = lidar_times[:n]
    lidar_R = lidar_R[:n]
    lidar_p = lidar_p[:n]
    clouds = clouds[:n] if load_clouds else clouds

    # extrinsic chains (lvba_system.cpp:484-504)
    ex = cfg.extrin_calib
    Rcl = np.asarray(ex.Rcl, dtype=np.float64).reshape(3, 3)
    tcl = np.asarray(ex.Pcl, dtype=np.float64)
    Ril = np.asarray(ex.extrinsic_R, dtype=np.float64).reshape(3, 3)
    til = np.asarray(ex.extrinsic_T, dtype=np.float64)
    Rli = Ril.T
    tli = -Rli @ til
    Rci = Rcl @ Rli
    tci = Rcl @ tli + tcl

    dbp = None
    if cfg.data_config.colmap_db_path:
        dbp = root / cfg.data_config.colmap_db_path

    return Dataset(
        root=root,
        cam=cam,
        image_times=image_times,
        image_paths=image_paths,
        cam_R=cam_R,
        cam_p=cam_p,
        lidar_times=lidar_times,
        lidar_R=lidar_R,
        lidar_p=lidar_p,
        clouds=clouds,
        Rcl=Rcl,
        tcl=tcl,
        Rci=Rci,
        tci=tci,
        colmap_db_path=dbp,
    )
