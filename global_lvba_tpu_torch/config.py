"""Configuration schema — the port's own copy of global_lvba_tpu.config:
same parameter groups, keys and defaults as the reference YAML/ROS-param
config (config/config.yaml, src/dataset_io.cpp:28-66,
src/lvba_system.cpp:127-133), minus ROS."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List

import yaml


@dataclasses.dataclass
class CamConfig:
    cam_width: int = 1280
    cam_height: int = 1024
    scale: float = 0.5
    cam_fx: float = 1293.56944
    cam_fy: float = 1293.3155
    cam_cx: float = 626.91359
    cam_cy: float = 522.799224
    cam_d0: float = -0.076160   # k1
    cam_d1: float = 0.123001    # k2
    cam_d2: float = -0.00113    # p1
    cam_d3: float = 0.000251    # p2


@dataclasses.dataclass
class ExtrinConfig:
    # lidar -> imu
    extrinsic_T: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])
    extrinsic_R: List[float] = dataclasses.field(
        default_factory=lambda: [1, 0, 0, 0, 1, 0, 0, 0, 1]
    )
    # lidar -> camera
    Rcl: List[float] = dataclasses.field(
        default_factory=lambda: [1, 0, 0, 0, 1, 0, 0, 0, 1]
    )
    Pcl: List[float] = dataclasses.field(default_factory=lambda: [0.0, 0.0, 0.0])


@dataclasses.dataclass
class DataConfig:
    data_path: str = "dataset/cbd_new/"
    colmap_db_path: str = ""
    image_sample_step: int = 10
    enable_lidar_ba: bool = True
    enable_visual_ba: bool = True


@dataclasses.dataclass
class WindowBAConfig:
    enable: bool = True
    size: int = 10
    anchor_leaf_size: float = 0.1
    use_window_ba_rel: bool = False
    # the reference window BA runs with the built-in default eigen-ratio
    # ladder (bavoxel.hpp:17) because set_eigen_ratio_array is only called in
    # the global stages
    eigen_ratio_array: List[float] = dataclasses.field(
        default_factory=lambda: [0.3, 0.1, 0.06, 0.03]
    )


@dataclasses.dataclass
class BALMStageConfig:
    enable: bool = True
    root_voxel_size: float = 0.5
    eigen_ratio_array: List[float] = dataclasses.field(
        default_factory=lambda: [0.1, 0.1, 0.1, 0.1]
    )


@dataclasses.dataclass
class GlobalRefineConfig:
    """Engine extension (no reference analogue): an optional DIRECT
    all-frame global BA pass after anchor composition.  The window->anchor
    hierarchy freezes intra-window pose error when it composes
    anchor∘relative (lvba_system.cpp:393-404), which caps how much
    accumulated odometry drift it can remove (measured ~2x on a 48-frame
    loop, tests/test_drift.py); re-solving over ALL frames from the
    composed trajectory recovers ~30x, at a cost the engine affords
    on-chip (dense Gram to W~512, block-banded beyond)."""

    enable: bool = False
    root_voxel_size: float = 0.0       # 0 -> BALM_stage2.root_voxel_size
    # 2 rounds: re-voxelizing with the once-refined poses re-judges the
    # planes and escapes the first solve's basin (measured 0.0013 -> 0.0005
    # on the 48-frame drift loop) — the same reason the reference runs two
    # global stages (lvba_system.cpp:357-389)
    rounds: int = 2
    eigen_ratio_array: List[float] = dataclasses.field(
        default_factory=lambda: [0.1, 0.1, 0.1, 0.1]
    )


@dataclasses.dataclass
class TrackFusionConfig:
    min_view_angle: float = 8.0        # degrees
    reproj_mean_thr: float = 3.0       # px
    obser_thr: int = 3                 # lvba_system.h:139


@dataclasses.dataclass
class ColmapOutputConfig:
    enable: bool = False
    filter_size_points3D: float = 0.01


@dataclasses.dataclass
class SolverConfig:
    """Engine-specific knobs (no reference analogue)."""

    dtype: str = "float32"             # device dtype of the BA kernels
    lidar_max_iters: int = 10          # bavoxel.hpp:686
    visual_max_iters: int = 50         # lvba_system.cpp:1573
    sigma_px: float = 0.5              # lvba_system.cpp:1590
    sigma_plane: float = 0.01          # lvba_system.cpp:1591
    min_ps: int = 15                   # bavoxel.hpp:24
    layer_limit: int = 2               # bavoxel.hpp:13
    min_window_factor_ratio: int = 3   # skip window if < 3*win voxels (:259)
    save_match_images: bool = False    # per-pair match dumps to result/
                                       # (drawAndSaveMatchesGPU,
                                       # lvba_system.cpp:823,1880-1920)


@dataclasses.dataclass
class LvbaConfig:
    cam_model: CamConfig = dataclasses.field(default_factory=CamConfig)
    extrin_calib: ExtrinConfig = dataclasses.field(default_factory=ExtrinConfig)
    data_config: DataConfig = dataclasses.field(default_factory=DataConfig)
    window_ba: WindowBAConfig = dataclasses.field(default_factory=WindowBAConfig)
    BALM_stage1: BALMStageConfig = dataclasses.field(default_factory=BALMStageConfig)
    BALM_stage2: BALMStageConfig = dataclasses.field(
        default_factory=lambda: BALMStageConfig(root_voxel_size=0.5)
    )
    global_refine: GlobalRefineConfig = dataclasses.field(
        default_factory=GlobalRefineConfig
    )
    track_fusion: TrackFusionConfig = dataclasses.field(default_factory=TrackFusionConfig)
    colmap_output: ColmapOutputConfig = dataclasses.field(default_factory=ColmapOutputConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    @staticmethod
    def from_yaml(path) -> "LvbaConfig":
        raw = yaml.safe_load(Path(path).read_text()) or {}
        cfg = LvbaConfig()
        for group_name, group_val in raw.items():
            if not hasattr(cfg, group_name) or not isinstance(group_val, dict):
                continue
            group = getattr(cfg, group_name)
            for k, v in group_val.items():
                if hasattr(group, k):
                    setattr(group, k, v)
        # stage2 voxel size defaults to stage1's when unspecified
        # (dataset_io.cpp:55)
        if "BALM_stage2" not in raw or "root_voxel_size" not in (raw.get("BALM_stage2") or {}):
            cfg.BALM_stage2.root_voxel_size = cfg.BALM_stage1.root_voxel_size
        return cfg
