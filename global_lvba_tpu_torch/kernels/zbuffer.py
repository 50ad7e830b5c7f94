"""The depth maps' z-buffer over all images of a visual stage in one launch
(csrc/zbuffer.cu), beside its plain torch version.

It replaces no Pallas kernel: the JAX package rasterizes on the host
(pipeline/depth._zbuffer_host in numpy, or its C++ runtime's
lvba_zbuffer_ranges, global_lvba_tpu/native/lvba_native.cpp:688) because
its TPU sat behind a remote link.  The card holds the grid map's points
once and rasterizes every image from its covisible voxels' CSR ranges:
per point the arithmetic of the C++ zbuf_accum (:634) in its order,
rounded as numpy's _zbuffer_host rounds it (R p as its BLAS's FMA chain,
then + t; every other operation rounded once), and a min per pixel by
atomicMin on Z's bits (Z is positive), so the maps are bitwise
repeatable and bitwise the plain version's.  Bound: operations
(ZBUFFER_OPS a covisible point in front of the camera, ZBUFFER_Z_OPS
one behind it, points_in_front counts them); the bytes that must move
(the points and ranges once, the maps once) take less.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

LAUNCHES = {"zbuffer": 0}
# float32 and float64 operations of a covisible point in front of the
# camera (zbuf_accum's 38, and the float64 product and sum of each of R
# p's three rows' two multiply-adds), and of one behind it (its Z row
# alone); none is fused, so each takes an FMA's issue slot
ZBUFFER_OPS = (38, 12)
ZBUFFER_Z_OPS = (2, 4)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _intrinsics(cam):
    """The camera's 8 intrinsics rounded to float32, as zbuf_cam casts
    them."""
    return [float(np.float32(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy,
                                           cam.k1, cam.k2, cam.p1, cam.p2)]


def zbuffer(points: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
            offsets: torch.Tensor, Rcw: torch.Tensor, tcw: torch.Tensor,
            cam) -> torch.Tensor:
    """Min-depth maps (M, H, W) float32, 0 where no point lands.

    points (N, 3) float32 world points, voxel-grouped; image m rasterizes
    the points points[starts[r] : starts[r] + counts[r]] of its ranges
    r in [offsets[m], offsets[m + 1]) (starts and offsets int64, counts
    int32) through Rcw[m] (3, 3), tcw[m] (3,) (cast to float32) and the
    camera `cam` (fx, fy, cx, cy, k1, k2, p1, p2, width, height)."""
    dev = points.device
    if dev.type == "cpu":
        return zbuffer_plain(points, starts, counts, offsets, Rcw, tcw, cam)
    if dev.type != "cuda":
        raise ValueError(f"zbuffer: unsupported device {dev}")
    M = offsets.shape[0] - 1
    if points.dim() != 2 or points.shape[1] != 3 \
            or points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError("points must be a contiguous (N, 3) float32 tensor")
    for t, dt, what in ((starts, torch.int64, "starts"),
                        (counts, torch.int32, "counts"),
                        (offsets, torch.int64, "offsets")):
        if t.dim() != 1 or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 1-d {dt} tensor "
                             f"on the points' device")
    if starts.shape != counts.shape or M < 0:
        raise ValueError("starts and counts must match; offsets is (M + 1,)")
    if Rcw.shape != (M, 3, 3) or tcw.shape != (M, 3):
        raise ValueError(f"Rcw must be ({M}, 3, 3) and tcw ({M}, 3)")
    H, W = int(cam.height), int(cam.width)
    out = torch.empty((M, H, W), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    cams = torch.cat([Rcw.reshape(M, 9), tcw], dim=1).to(
        device=dev, dtype=torch.float32).contiguous()
    max_ranges = int((offsets[1:] - offsets[:-1]).max())
    launch = build.launcher("zbuffer")
    with torch.cuda.device(dev):
        err = launch(_ptr(points), _ptr(starts), _ptr(counts), _ptr(offsets),
                     M, max_ranges, _ptr(cams), *_intrinsics(cam), W, H,
                     _ptr(out),
                     ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream))
    build.check("zbuffer", err)
    LAUNCHES["zbuffer"] += 1
    return out


def _image_points(points, starts, counts, offsets, m):
    """Image m's covisible points, (n, 3) unbound into px, py, pz (None
    where it has none)."""
    s = starts[offsets[m]:offsets[m + 1]]
    c = counts[offsets[m]:offsets[m + 1]].long()
    if not c.numel():
        return None
    idx = torch.repeat_interleave(s, c) + (
        torch.arange(int(c.sum()), device=points.device)
        - torch.repeat_interleave(torch.cumsum(c, 0) - c, c))
    return points[idx].unbind(1)


def _cams(Rcw, tcw, dev):
    M = Rcw.shape[0]
    return torch.cat([Rcw.reshape(M, 9), tcw], dim=1).to(
        device=dev, dtype=torch.float32)


def _row(R, i, px, py, pz):
    """Row i of R p + t, the host BLAS's chain for R p, then + t; each
    multiply-add a float64 product and sum rounded once (the kernel's
    fma32)."""
    def fma32(a, b, c):
        return (a.double() * b.double() + c.double()).float()

    return fma32(R[3 * i + 2], pz, fma32(R[3 * i + 1], py,
                                         R[3 * i] * px)) + R[9 + i]


def points_in_front(points, starts, counts, offsets, Rcw, tcw) -> int:
    """How many of the images' covisible points pass the Z >= 1e-3 gate
    (the points the kernel projects; the rest cost it their Z row)."""
    cams = _cams(Rcw, tcw, points.device)
    off = offsets.tolist()
    n = 0
    for m in range(len(off) - 1):
        p = _image_points(points, starts, counts, off, m)
        if p is not None:
            n += int((_row(cams[m].unbind(), 2, *p) >= 1e-3).sum())
    return n


def zbuffer_plain(points, starts, counts, offsets, Rcw, tcw,
                  cam) -> torch.Tensor:
    """Plain torch version of zbuffer, an image at a time: elementwise
    float32 ops in zbuf_accum's order, each rounded once but for the fused
    multiply-adds of R p (a float64 product and sum rounded once, as the
    kernel's fma32), then a min per pixel by scatter_reduce_("amin") and
    inf -> 0."""
    dev = points.device
    M = offsets.shape[0] - 1
    H, W = int(cam.height), int(cam.width)
    f32 = torch.float32
    k = torch.tensor(_intrinsics(cam), dtype=f32, device=dev)
    fx, fy, cx, cy, k1, k2, p1, p2 = k.unbind()
    cams = _cams(Rcw, tcw, dev)
    out = torch.full((M, H * W), float("inf"), dtype=f32, device=dev)
    off = offsets.tolist()
    for m in range(M):
        p = _image_points(points, starts, counts, off, m)
        if p is None:
            continue
        R = cams[m].unbind()
        Z = _row(R, 2, *p)
        sel = Z >= 1e-3
        X, Y, Z = _row(R, 0, *p)[sel], _row(R, 1, *p)[sel], Z[sel]
        x, y = X / Z, Y / Z
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        uf, vf = fx * xd + cx, fy * yd + cy
        ok = torch.isfinite(uf) & torch.isfinite(vf)
        ok &= (uf > -1.0) & (uf < W) & (vf > -1.0) & (vf < H)
        u = uf[ok].to(torch.int64)   # truncation toward zero
        v = vf[ok].to(torch.int64)
        out[m].scatter_reduce_(0, v * W + u, Z[ok], "amin")
    out.masked_fill_(~torch.isfinite(out), 0.0)
    return out.reshape(M, H, W)
