"""Voxel-grid downsampling (host), matching the reference semantics (the
port's own copy of global_lvba_tpu.pipeline.downsample, reduced to the
anchor-cloud compression the LiDAR pipeline uses):
`downsample_nearest_center` keeps the original point nearest to each
voxel's geometric center (down_sampling_voxel2, tools.hpp:300-359).
"""

from __future__ import annotations

import numpy as np


def _keys(pts: np.ndarray, voxel_size: float) -> np.ndarray:
    c = np.floor(pts / voxel_size).astype(np.int64)
    off = 1 << 20
    c = c + off
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def downsample_nearest_center_idx(pts: np.ndarray, voxel_size: float) -> np.ndarray:
    """Row indices of the per-voxel point nearest each voxel center."""
    if voxel_size < 0.001 or pts.shape[0] == 0:
        return np.arange(pts.shape[0])
    coords = np.floor(pts / voxel_size)
    centers = (coords + 0.5) * voxel_size
    d2 = np.sum((pts - centers) ** 2, axis=1)
    keys = _keys(pts, voxel_size)
    order = np.lexsort((d2, keys))
    sk = keys[order]
    firsts = np.concatenate([[True], sk[1:] != sk[:-1]])
    return order[firsts]


def downsample_nearest_center(pts: np.ndarray, voxel_size: float) -> np.ndarray:
    return pts[downsample_nearest_center_idx(pts, voxel_size)]
