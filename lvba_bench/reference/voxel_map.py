"""Plain reference of the adaptive planar voxel map (BALM's cut_voxel /
recut / judge_eigen, include/BALM/bavoxel.hpp:278-562, at a fixed depth).

From the body-frame clouds and the binning poses:
  * level 0 bins world points into cubes of `voxel_size`;
  * at each level a voxel with fewer than `min_ps` points is dropped; a
    voxel whose world covariance has λ0 / λ2 <= eigen_ratios[level] is a
    plane; any other voxel is cut into its eight octants (octant bits:
    x, y, z above the voxel's centre) while level < layer_limit, and
    dropped at the last level;
  * a plane is kept when at least `min_frames` frames observe it, with
    each observing frame's point count, body-frame mean and centred
    body-frame scatter.

Written in plain torch on any device and dtype: float64 is the
reference; float32, with `tf32` every product's operands rounded to
TF32 as the tensor cores take them, is the lower-precision control.  Two-pass moments (means first, then centred
sums).  Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .plane_factor import matmul_of

_OFF = 1 << 20          # cell coordinates packed as 3 x 21 bits


class RefMap(NamedTuple):
    """Kept planes and their (plane, frame) entries, sorted by plane then
    frame.  cell: (V, 4) int64 (level, cx, cy, cz), the plane's cube of
    edge voxel_size / 2^level; entries: vox (E,), frame (E,), n (E,),
    mu (E, 3), Pc (E, 3, 3)."""

    cell: torch.Tensor
    vox: torch.Tensor
    frame: torch.Tensor
    n: torch.Tensor
    mu: torch.Tensor
    Pc: torch.Tensor


def _pack(c: torch.Tensor) -> torch.Tensor:
    c = c + _OFF
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def _segment_moments(x: torch.Tensor, seg: torch.Tensor, nseg: int, mm):
    """(count, mean (S, 3), centred scatter (S, 3, 3)) of x's rows by
    segment id, two-pass."""
    dt = x.dtype
    cnt = torch.zeros(nseg, dtype=dt, device=x.device).index_add_(
        0, seg, torch.ones_like(x[:, 0]))
    s = torch.zeros(nseg, 3, dtype=dt, device=x.device).index_add_(0, seg, x)
    mean = s / cnt[:, None]
    d = x - mean[seg]
    outer = mm(d[:, :, None], d[:, None, :])
    scat = torch.zeros(nseg, 3, 3, dtype=dt, device=x.device).index_add_(
        0, seg, outer)
    return cnt, mean, scat


def build_ref_map(points_body, frame_ids, R, p, voxel_size: float,
                  eigen_ratios: Sequence[float], min_ps: int = 15,
                  layer_limit: int = 2, min_frames: int = 2,
                  dtype=torch.float64, device="cpu",
                  tf32: bool = False) -> RefMap:
    """The kept planes of the clouds (points_body (N, 3), frame_ids (N,))
    binned at the poses (R (W, 3, 3), p (W, 3)), in `dtype` on `device`."""
    dev = torch.device(device)
    mm = matmul_of(tf32)
    pts = torch.as_tensor(np.asarray(points_body)).to(dev, dtype)
    fid = torch.as_tensor(np.asarray(frame_ids, np.int64)).to(dev)
    Rt = torch.as_tensor(np.asarray(R, np.float64)).to(dev, dtype)
    pt = torch.as_tensor(np.asarray(p, np.float64)).to(dev, dtype)
    world = mm(Rt[fid], pts[:, :, None])[:, :, 0] + pt[fid]

    active = torch.arange(pts.shape[0], device=dev)
    coords = torch.floor(world / voxel_size).to(torch.int64)
    plane_cells = []
    n_planes = 0
    point_plane = torch.full((pts.shape[0],), -1, dtype=torch.int64,
                             device=dev)
    for level in range(layer_limit + 1):
        if active.numel() == 0:
            break
        ukeys, inv, counts = torch.unique(
            _pack(coords), return_inverse=True, return_counts=True)
        nseg = ukeys.numel()
        cnt, _, scat = _segment_moments(world[active], inv, nseg, mm)
        cov = scat / cnt[:, None, None]
        lam = torch.linalg.eigvalsh(cov)
        ratio = lam[:, 0] / torch.clamp(lam[:, 2], min=1e-300)
        thr = eigen_ratios[min(level, len(eigen_ratios) - 1)]
        big = counts >= min_ps
        is_plane = big & (ratio <= thr)
        cut = big & ~is_plane & (level < layer_limit)

        # planes: ids in order of their packed cell key
        pid_seg = torch.full((nseg,), -1, dtype=torch.int64, device=dev)
        npl = int(is_plane.sum())
        pid_seg[is_plane] = n_planes + torch.arange(npl, device=dev)
        pp = pid_seg[inv]
        hit = pp >= 0
        point_plane[active[hit]] = pp[hit]
        seg_first = torch.full((nseg,), coords.shape[0], dtype=torch.int64,
                               device=dev).scatter_reduce_(
            0, inv, torch.arange(coords.shape[0], device=dev), "amin")
        cells = coords[seg_first[is_plane]]
        plane_cells.append(torch.cat([torch.full_like(cells[:, :1], level),
                                      cells], 1))
        n_planes += npl

        # cut: the child cube of each point, by the octant bits
        sub = cut[inv]
        active = active[sub]
        if active.numel() == 0 or level == layer_limit:
            break
        X = world[active]
        cell = voxel_size / (2 ** level)
        center = torch.floor(X / cell) * cell + cell / 2.0
        bits = (X > center).to(torch.int64)
        coords = coords[sub] * 2 + bits

    # (plane, frame) entries in the body frame
    sel = point_plane >= 0
    W = Rt.shape[0]
    pair = point_plane[sel] * W + fid[sel]
    upair, pinv = torch.unique(pair, return_inverse=True)
    n, mu, Pc = _segment_moments(pts[sel], pinv, upair.numel(), mm)
    vox = upair // W
    frame = upair % W
    nobs = torch.bincount(vox, minlength=n_planes)
    keep_v = nobs >= min_frames
    keep_e = keep_v[vox]
    new_id = torch.cumsum(keep_v.to(torch.int64), 0) - 1
    cell_all = (torch.cat(plane_cells) if plane_cells else
                torch.zeros(0, 4, dtype=torch.int64, device=dev))
    return RefMap(cell=cell_all[keep_v], vox=new_id[vox[keep_e]],
                  frame=frame[keep_e], n=n[keep_e], mu=mu[keep_e],
                  Pc=Pc[keep_e])
