"""Batched track 3D fusion: depth-fused and DLT candidates (port of
global_lvba_tpu.tracks.fuse, plain torch on the solve's device).

Replicates the per-component geometry of BuildTracksAndFuse3D
(src/lvba_system.cpp:1005-1263) as padded batched torch over all tracks at
once:

  depth candidate (:1020-1106)
    bilinear LiDAR depth at each observation -> back-projected world point;
    anchor clustering (points within 0.12 m of the first valid one);
    first-per-image dedup; greedy view-angle filter (keep an observation if
    no kept direction yet or its min dot against kept dirs <= cos(8°));
    candidate = mean of kept points, gated by mean reprojection <= 3 px
    over >= obser_thr images;

  triangulation candidate (:1108-1161)
    homogeneous DLT over >= 4 unique images (the smallest eigenvector of
    the 4x4 AᵀA, TriangulateTrackDLT :52-111), view-angle filter seeded by
    the DLT point, re-triangulation over the kept set, same reprojection
    gate;

  selection (:1163-1205): whichever valid candidate has lower mean
  reprojection error.

The greedy view-angle filter is order-dependent; the reference iterates an
unordered_map (unspecified order), here observations are scanned in sorted
(image, keypoint) order: a loop over the K slots, batched over tracks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry.camera import CameraModel, undistort_pixel_to_normalized
from .build import TrackSet


class FuseResult(NamedTuple):
    Xw: torch.Tensor           # (T, 3) fused world points
    ok: torch.Tensor           # (T,) track kept
    kept_obs: torch.Tensor     # (T, Omax) bool, inlier observations
    mean_reproj: torch.Tensor  # (T,)
    from_tri: torch.Tensor     # (T,) bool, True if the DLT candidate won
    tri_candidates: torch.Tensor
    tri_valid: torch.Tensor


def _bilinear_depth_host(depth_maps, img, uv, valid):
    """Per-observation bilinear depth with the reference's validity rules
    (fetch_depth_bilinear, lvba_system.cpp:1020-1056), on the host: the
    depth stack lives there, and fusion needs only the 4 taps around each
    observation."""
    Mh, H, W = depth_maps.shape
    uv = np.asarray(uv, np.float64)
    valid = np.asarray(valid)
    img_s = np.where(valid, np.asarray(img), 0)
    u, v = uv[..., 0], uv[..., 1]
    inb = (u >= 0) & (v >= 0) & (u < W - 1) & (v < H - 1) & valid
    x = np.clip(np.floor(u).astype(np.int32), 0, W - 2)
    y = np.clip(np.floor(v).astype(np.int32), 0, H - 2)
    du = u - x
    dv = v - y
    d00 = depth_maps[img_s, y, x].astype(np.float64)
    d10 = depth_maps[img_s, y, x + 1].astype(np.float64)
    d01 = depth_maps[img_s, y + 1, x].astype(np.float64)
    d11 = depth_maps[img_s, y + 1, x + 1].astype(np.float64)
    pos = (d00 > 0) & (d10 > 0) & (d01 > 0) & (d11 > 0)
    d = (
        (1 - du) * (1 - dv) * d00 + du * (1 - dv) * d10
        + (1 - du) * dv * d01 + du * dv * d11
    )
    return d, inb & pos & (d > 0)


def _project(cam: CameraModel, Rcw, tcw, X):
    """uv and valid for world point(s) X through cameras (broadcast)."""
    Xc = (Rcw @ X[..., None])[..., 0] + tcw
    Z = Xc[..., 2]
    ok = Z > 1e-12
    z = torch.where(ok, Z, torch.ones_like(Z))
    x, y = Xc[..., 0] / z, Xc[..., 1] / z
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return torch.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], -1), ok


def _first_per_image(img, member):
    """(T, O) mask of the first member observation of each image."""
    O = img.shape[-1]
    same = img[..., :, None] == img[..., None, :]
    earlier = torch.tril(torch.ones((O, O), dtype=torch.bool,
                                    device=img.device), diagonal=-1)
    has_earlier = (same & earlier & member[..., None, :]).any(-1)
    return member & ~has_earlier


def _view_angle_filter(dirs, member, cos_thr):
    """Greedy sequential keep-filter over the O slots, batched over tracks:
    keep slot o if member and (no kept yet, or the min over kept dirs of
    dot(dir_o, dir_k) <= cos_thr), lvba_system.cpp:1086-1095."""
    T, O = member.shape
    kept = torch.zeros_like(member)
    inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
    for o in range(O):
        dots = torch.einsum("tkj,tj->tk", dirs, dirs[:, o])
        min_dot = torch.where(kept, dots, inf).amin(-1)
        none_kept = ~kept.any(-1)
        kept[:, o] = member[:, o] & (none_kept | (min_dot <= cos_thr))
    return kept


def _mean_reproj(cam, Rcw_o, tcw_o, uv_obs, member, X, min_count):
    """Mean pixel reprojection error of X (T, 3) over member observations
    (ComputeMeanReproj, lvba_system.cpp:8-50); invalid projections are
    skipped.  Returns (mean, or inf where invalid; count; valid)."""
    uv_hat, ok = _project(cam, Rcw_o, tcw_o, X[:, None, :])
    use = member & ok
    err = torch.linalg.vector_norm(uv_hat - uv_obs, dim=-1)
    cnt = use.sum(-1)
    mean = torch.where(use, err, torch.zeros_like(err)).sum(-1) \
        / cnt.clamp(min=1)
    valid = (cnt >= min_count) & torch.isfinite(mean)
    return torch.where(valid, mean, torch.full_like(mean, math.inf)), cnt, \
        valid


def _dlt(cam, Rcw_o, tcw_o, uv_obs, member):
    """Homogeneous DLT per track (TriangulateTrackDLT,
    lvba_system.cpp:52-111): the smallest eigenvector of the 4x4 AᵀA,
    dehomogenised (its sign cancels).  Returns (X (T, 3), ok)."""
    xy, uok = undistort_pixel_to_normalized(cam, uv_obs)
    use = (member & uok)[..., None]
    P = torch.cat([Rcw_o, tcw_o[..., :, None]], -1)             # (T, O, 3, 4)
    row_u = xy[..., 0:1] * P[..., 2, :] - P[..., 0, :]          # (T, O, 4)
    row_v = xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    row_u = torch.where(use, row_u, torch.zeros_like(row_u))
    row_v = torch.where(use, row_v, torch.zeros_like(row_v))
    AtA = (torch.einsum("toi,toj->tij", row_u, row_u)
           + torch.einsum("toi,toj->tij", row_v, row_v))
    rows = 2 * (member & uok).sum(-1)
    Xh = torch.linalg.eigh(AtA)[1][..., 0]                      # (T, 4)
    wcomp = Xh[:, 3]
    small = wcomp.abs() < 1e-12
    X = Xh[:, 0:3] / torch.where(small, torch.ones_like(wcomp), wcomp)[:, None]
    ok = (rows >= 8) & ~small & torch.isfinite(X).all(-1)
    return X, ok


def _fuse_all(cam: CameraModel, obs_img, obs_uv, obs_valid, d, dvalid,
              Rcw_all, tcw_all, obser_thr: int, min_view_angle_deg: float,
              reproj_thr: float) -> FuseResult:
    cos_thr = math.cos(math.radians(min_view_angle_deg))
    Rcw_o = Rcw_all[obs_img]                              # (T, O, 3, 3)
    tcw_o = tcw_all[obs_img]                              # (T, O, 3)
    Rwc_o = Rcw_o.transpose(-1, -2)
    C_o = -(Rwc_o @ tcw_o[..., None])[..., 0]             # camera centers

    def unit_dirs(V):
        nrm = torch.linalg.vector_norm(V, dim=-1, keepdim=True)
        far = nrm[..., 0] > 1e-6
        return V / torch.where(nrm < 1e-6, torch.ones_like(nrm), nrm), far

    # ---------------- depth-fused candidate ----------------
    xy_n, uok = undistort_pixel_to_normalized(cam, obs_uv)
    Xc = torch.cat([xy_n * d[..., None], d[..., None]], -1)
    Xw_o = (Rwc_o @ (Xc - tcw_o)[..., None])[..., 0]       # cam -> world
    valid = dvalid & uok & obs_valid & (d > 0)
    any_valid = valid.any(-1)
    first = valid.to(torch.uint8).argmax(-1)
    anchor = Xw_o[torch.arange(Xw_o.shape[0], device=d.device), first]
    dist = torch.linalg.vector_norm(Xw_o - anchor[:, None], dim=-1)
    inlier = valid & (dist < 0.12)
    n_valid = valid.sum(-1)
    best = _first_per_image(obs_img, inlier)
    n_img = best.sum(-1)
    Xd = torch.where(best[..., None], Xw_o, torch.zeros_like(Xw_o)).sum(1) \
        / n_img.clamp(min=1)[:, None]
    dirs, dir_ok = unit_dirs(Xw_o - C_o)
    d_kept = _view_angle_filter(dirs, best & dir_ok, cos_thr)
    n_kept = d_kept.sum(-1)
    mean, _, mr_ok = _mean_reproj(cam, Rcw_o, tcw_o, obs_uv, d_kept, Xd,
                                  obser_thr)
    d_ok = ((n_valid >= obser_thr) & (n_img >= obser_thr)
            & (n_kept >= obser_thr) & mr_ok & (mean <= reproj_thr)
            & any_valid)
    d_mean = torch.where(d_ok, mean, torch.full_like(mean, math.inf))

    # ---------------- triangulation candidate ----------------
    unique = _first_per_image(obs_img, obs_valid)
    is_cand = unique.sum(-1) >= 4
    Xseed, seed_ok = _dlt(cam, Rcw_o, tcw_o, obs_uv, unique)
    _, _, seed_mr_ok = _mean_reproj(cam, Rcw_o, tcw_o, obs_uv, unique, Xseed,
                                    4)
    seed_ok = seed_ok & seed_mr_ok
    dirs, dir_ok = unit_dirs(Xseed[:, None, :] - C_o)
    t_kept = _view_angle_filter(dirs, unique & dir_ok, cos_thr)
    n_kept = t_kept.sum(-1)
    Xt, dlt2_ok = _dlt(cam, Rcw_o, tcw_o, obs_uv, t_kept)
    mean, _, mr_ok = _mean_reproj(cam, Rcw_o, tcw_o, obs_uv, t_kept, Xt, 4)
    t_valid = is_cand & seed_ok & (n_kept >= 4) & dlt2_ok & mr_ok
    t_ok = t_valid & (mean <= reproj_thr)
    t_mean = torch.where(t_ok, mean, torch.full_like(mean, math.inf))

    # ---------------- selection (:1163-1205) ----------------
    pick_tri = t_ok & (~d_ok | (t_mean < d_mean))
    ok = t_ok | d_ok
    Xw = torch.where(pick_tri[:, None], Xt, Xd)
    kept = torch.where(pick_tri[:, None], t_kept, d_kept)
    mean = torch.where(pick_tri, t_mean, d_mean)
    # reject zero or non-finite fused points (:1202-1205)
    ok = ok & torch.isfinite(Xw).all(-1) & (
        torch.linalg.vector_norm(Xw, dim=-1) > 1e-12)
    return FuseResult(Xw=Xw, ok=ok, kept_obs=kept & ok[:, None],
                      mean_reproj=mean, from_tri=pick_tri & ok,
                      tri_candidates=is_cand.sum(), tri_valid=t_valid.sum())


def fuse_tracks(
    cam: CameraModel,
    tracks: TrackSet,
    depth_maps: np.ndarray,
    Rcw_all: np.ndarray,
    tcw_all: np.ndarray,
    obser_thr: int = 3,
    min_view_angle_deg: float = 8.0,
    reproj_thr: float = 3.0,
    dtype=torch.float32,
    device="cuda",
) -> FuseResult:
    """Fuse every track on `device` (default the card) in `dtype` (default
    float32, as the JAX package, whatever the solve's dtype)."""
    dev = resolve_device(device)
    d, dvalid = _bilinear_depth_host(np.asarray(depth_maps), tracks.obs_img,
                                     tracks.obs_uv, tracks.obs_valid)

    def fl(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    return _fuse_all(
        cam,
        torch.as_tensor(np.asarray(tracks.obs_img, np.int64)).to(dev),
        fl(tracks.obs_uv),
        torch.as_tensor(np.asarray(tracks.obs_valid, bool)).to(dev),
        fl(d),
        torch.as_tensor(dvalid).to(dev),
        fl(Rcw_all), fl(tcw_all),
        int(obser_thr), float(min_view_angle_deg), float(reproj_thr),
    )
