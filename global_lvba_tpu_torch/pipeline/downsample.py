"""Voxel-grid downsampling (host), matching the reference semantics (the
port's own copy of global_lvba_tpu.pipeline.downsample):

- `downsample_mean`: per-voxel centroid (down_sampling_voxel,
  BALM/tools.hpp:250-298); the exports and viz clouds use it.
- `downsample_nearest_center`: keep the original point nearest to each
  voxel's geometric center (down_sampling_voxel2, tools.hpp:300-359) — used
  for anchor-cloud compression.
- `downsample_stride`: every num-th point (down_sampling_serie,
  tools.hpp:361-371).
"""

from __future__ import annotations

import numpy as np


def _keys(pts: np.ndarray, voxel_size: float) -> np.ndarray:
    c = np.floor(pts / voxel_size).astype(np.int64)
    off = 1 << 20
    c = c + off
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def downsample_mean(pts: np.ndarray, voxel_size: float) -> np.ndarray:
    if voxel_size < 0.001 or pts.shape[0] == 0:
        return pts
    keys = _keys(pts, voxel_size)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    sums = np.add.reduceat(pts[order].astype(np.float64), starts, axis=0)
    counts = np.diff(np.append(starts, sk.shape[0]))
    return (sums / counts[:, None]).astype(pts.dtype)


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


def downsample_stride(pts: np.ndarray, num: int) -> np.ndarray:
    return pts[:: max(1, num)]
