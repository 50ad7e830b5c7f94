"""Plane estimation utilities, host numpy (port of
global_lvba_tpu.map.planes).

`esti_plane` is the reference's 5-point least-squares plane fit
(tools.hpp:477-506): solve A x = -1 for x = n/d, check every point
against |n·p + d|/|n| <= threshold, return the unit normal and offset.
The reference pipeline does not call it; it is part of its public
surface."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def esti_plane(points: np.ndarray, threshold: float = 0.1
               ) -> Optional[Tuple[np.ndarray, float]]:
    """Fit a plane n·x + d = 0 to points (N >= 3, 3).  Returns (n_unit, d),
    or None when any point deviates more than `threshold`."""
    A = np.asarray(points, dtype=np.float64)
    b = -np.ones(A.shape[0])
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    if np.any(np.abs(A @ x + 1.0) > threshold):
        return None
    n = np.linalg.norm(x)
    if n < 1e-12:
        return None
    return x / n, 1.0 / n


def fit_plane_svd(points: np.ndarray) -> Tuple[np.ndarray, float]:
    """Total-least-squares plane through the centroid (min-eigvec normal)."""
    P = np.asarray(points, dtype=np.float64)
    c = P.mean(0)
    _, _, Vt = np.linalg.svd(P - c, full_matrices=False)
    n = Vt[-1]
    return n, -float(n @ c)
