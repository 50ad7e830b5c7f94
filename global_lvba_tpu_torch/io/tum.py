"""TUM-format trajectory reader and writer (timestamp tx ty tz qx qy qz
qw); the port's own copy of global_lvba_tpu.io.tum.

Replicates DatasetIO::loadPosesTUM (src/dataset_io.cpp:133-184): '#'
comments skipped, quaternion normalized, every STRIDE-th valid line kept
(offset 0).  write_tum_poses writes the same text as the JAX package's
(%.6f times, %.9f values), so both write byte-equal files."""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np


def _quat_to_R(q: np.ndarray) -> np.ndarray:
    """(…, 4) [qw, qx, qy, qz] (normalized) -> (…, 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - z * w)
    R[..., 0, 2] = 2 * (x * z + y * w)
    R[..., 1, 0] = 2 * (x * y + z * w)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - x * w)
    R[..., 2, 0] = 2 * (x * z - y * w)
    R[..., 2, 1] = 2 * (y * z + x * w)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def read_tum_poses(path, stride: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (times (N,), R (N, 3, 3), p (N, 3))."""
    if stride <= 0:
        raise ValueError("stride must be positive")
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 8:
            continue
        try:
            rows.append([float(v) for v in parts[:8]])
        except ValueError:
            continue
    if not rows:
        raise ValueError(f"no poses parsed from {path}")
    arr = np.asarray(rows, dtype=np.float64)[::stride]
    t = arr[:, 0]
    p = arr[:, 1:4]
    q = arr[:, [7, 4, 5, 6]]  # reorder to (w, x, y, z)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return t, _quat_to_R(q), p


def write_tum_poses(path, times: np.ndarray, R: np.ndarray, p: np.ndarray):
    """Inverse of read_tum_poses (fixtures / exports)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(np.asarray(R)).as_quat()  # (x, y, z, w)
    with open(path, "w") as f:
        for i in range(len(times)):
            f.write(
                f"{times[i]:.6f} {p[i,0]:.9f} {p[i,1]:.9f} {p[i,2]:.9f} "
                f"{q[i,0]:.9f} {q[i,1]:.9f} {q[i,2]:.9f} {q[i,3]:.9f}\n"
            )
