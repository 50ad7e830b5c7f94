"""Robust-statistics and image-preprocessing utilities.

The port's own copy of global_lvba_tpu.utils.robust (host numpy; the
image function's cv2 steps are utils.imgproc's bit-exact copies).
Completes the reference's utils
surface (include/utils.hpp:294-446): `compute_mad`,
`pick_largest_cluster_as_inliers`, `preprocess_low_texture_bgr`.  The
reference pipeline defines but does not call these; they are provided for
API parity and for users who invoke them directly.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .imgproc import (bgr_to_lab, clahe, gaussian_blur_sigma1, lab_to_bgr,
                      upsample_cubic_x2)


def compute_mad(resid: Sequence[float]) -> float:
    """Median absolute deviation with the 1.4826 normal-consistency factor
    (utils.hpp:294-303).  Returns -1.0 for empty input (reference
    convention).  Matches the reference's nth_element median (the element
    at index n//2 of the sorted array, not the midpoint average)."""
    r = np.asarray(resid, np.float64).ravel()
    if r.size == 0:
        return -1.0
    med = np.partition(r, r.size // 2)[r.size // 2]
    d = np.abs(r - med)
    return float(np.partition(d, d.size // 2)[d.size // 2] * 1.4826)


def _all_pairwise_within(pts: np.ndarray, thr: float) -> bool:
    """Bounding-box fast paths + exact pairwise check (utils.hpp:318-350)."""
    if pts.shape[0] <= 1:
        return True
    span = pts.max(axis=0) - pts.min(axis=0)
    if np.any(span > thr):
        return False
    if float(span @ span) <= thr * thr:
        return True
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    return bool(np.all(d2 <= thr * thr))


def pick_largest_cluster_as_inliers(
    points3d: np.ndarray,
    idx_valid: Sequence[int],
    within: float = 0.1,
) -> np.ndarray:
    """Inlier selection among candidate 3-D points (utils.hpp:306-424):

      1. all points pairwise within 0.1 m -> all are inliers;
      2. else 2-means split (far-point init, <=10 iterations); the larger
         cluster wins if internally consistent,
      3. else the smaller cluster if consistent,
      4. else no inliers.

    Returns the selected indices (possibly empty) as int64."""
    points3d = np.asarray(points3d, np.float64)
    ids = np.asarray(list(idx_valid), np.int64)
    if ids.size == 0:
        return ids
    if ids.size == 1:
        return ids
    P = points3d[ids]
    if _all_pairwise_within(P, within):
        return ids

    # k=2 means, far-point initialization (utils.hpp:370-408)
    c0 = P[0]
    far = int(np.argmax(np.sum((P - c0) ** 2, axis=1)))
    c1 = P[far]
    in_a = np.ones(ids.size, bool)
    for _ in range(10):
        d0 = np.sum((P - c0) ** 2, axis=1)
        d1 = np.sum((P - c1) ** 2, axis=1)
        in_a = d0 <= d1
        # keep both clusters non-empty by moving the LAST member across
        # (reference: A.push_back(B.back()) / vice versa)
        if not np.any(in_a):
            in_a[np.flatnonzero(~in_a)[-1]] = True
        elif np.all(in_a):
            in_a[np.flatnonzero(in_a)[-1]] = False
        nc0 = P[in_a].mean(axis=0)
        nc1 = P[~in_a].mean(axis=0)
        shift = np.linalg.norm(nc0 - c0) + np.linalg.norm(nc1 - c1)
        c0, c1 = nc0, nc1
        if shift < 1e-5:
            break
    a_ids, b_ids = ids[in_a], ids[~in_a]
    bigger, smaller = (a_ids, b_ids) if a_ids.size >= b_ids.size else (b_ids, a_ids)
    if bigger.size and _all_pairwise_within(points3d[bigger], within):
        return bigger
    if smaller.size and _all_pairwise_within(points3d[smaller], within):
        return smaller
    return np.zeros((0,), np.int64)


def preprocess_low_texture_bgr(
    bgr: np.ndarray, enable_x2_upsample: bool = False
) -> np.ndarray:
    """CLAHE-on-L + light unsharp mask for low-texture imagery
    (utils.hpp:428-446): optional x2 cubic upsample, CLAHE(clip=2.0,
    tile=8x8) on the Lab L channel, then img*1.5 - blur(sigma=1)*0.5.
    BGR uint8 in and out, bit for bit the cv2 calls of the JAX package's
    copy (utils.imgproc)."""
    img = np.asarray(bgr, np.uint8)
    if enable_x2_upsample:
        img = upsample_cubic_x2(img)
    lab = bgr_to_lab(img)
    lab[..., 0] = clahe(lab[..., 0])
    img = lab_to_bgr(lab)
    blur = gaussian_blur_sigma1(img)
    # cv2.addWeighted(img, 1.5, blur, -0.5, 0): exact in float, then
    # rounded half to even and saturated
    return np.clip(np.rint(img * 1.5 - blur * 0.5), 0, 255).astype(np.uint8)
