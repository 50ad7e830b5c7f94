"""The depth maps' z-buffer over all images of a visual stage in one launch
(csrc/zbuffer.cu), beside its plain torch version.

It replaces no Pallas kernel: the JAX package rasterizes on the host
(pipeline/depth._zbuffer_host in numpy, or its C++ runtime's
lvba_zbuffer_ranges, global_lvba_tpu/native/lvba_native.cpp:688) because
its TPU sat behind a remote link.  The card holds the grid map's points
once and rasterizes every image from its covisible voxels' CSR ranges:
per point the arithmetic of the C++ zbuf_accum (:634) in its order,
rounded as numpy's _zbuffer_host rounds it (R p as its BLAS's FMA chain,
then + t; every other operation rounded once), and a min per pixel on
Z's bits (Z is positive), so the maps are bitwise repeatable and bitwise
the plain version's.

The kernel runs voxel-major: sorted_pairs sorts the (range, image) pairs
by range on the card, with no read back; a block takes CHUNK sorted
pairs and, range by range, its pairs of each range, the range a piece of
at most PIECE points at a time (range_pieces lists the same pieces); it
reads the piece once and walks its pairs' images, skipping an image
whole where the piece's bounding box proves every point behind the
camera (cull_z, the kernel's test operation by operation).  Bound:
operations (ZBUFFER_Z_OPS for each point of a (piece, image) pair the
cull keeps, ZBUFFER_OPS in all for a point in front of the camera;
work() counts them and the bytes the design asks of L2); the bytes that
must move (the points and ranges once, the maps once) take less.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build

LAUNCHES = {"zbuffer": 0}
# float32 and float64 operations of a covisible point in front of the
# camera (zbuf_accum's 38, and the float64 product and sum of each of R
# p's three rows' two multiply-adds), and of one whose pair the cull keeps
# but that lies behind (its Z row alone); none is fused, so each takes an
# FMA's issue slot
ZBUFFER_OPS = (38, 12)
ZBUFFER_Z_OPS = (2, 4)
# the most points of a piece, a block's shared copy, and the sorted pairs
# a block takes (csrc/zbuffer.cu takes them as LVBA_ZBUF_PIECE and
# LVBA_ZBUF_CHUNK)
PIECE = 2048
CHUNK = 128
CULL_MARGIN = 2.0 ** -20
Z_GATE = float(np.float32(1e-3))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _intrinsics(cam):
    """The camera's 8 intrinsics rounded to float32, as zbuf_cam casts
    them."""
    return [float(np.float32(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy,
                                           cam.k1, cam.k2, cam.p1, cam.p2)]


class Transposed(NamedTuple):
    """The (range, image) pairs sorted by range (start, then count), the
    images of a range ascending: range r's pairs are a run that `first`
    opens."""

    start: torch.Tensor    # (P,) int64 the pair's range's first point
    count: torch.Tensor    # (P,) int64 its points
    image: torch.Tensor    # (P,) int32 the image that sees it
    first: torch.Tensor    # (P,) bool the range's first pair


class Pieces(NamedTuple):
    """Each distinct range cut into pieces of at most PIECE points, with
    the run of sorted pairs (Transposed.image) whose images see it."""

    start: torch.Tensor    # (n,) int64
    count: torch.Tensor    # (n,) int32
    pair_lo: torch.Tensor  # (n,) int32
    pair_hi: torch.Tensor  # (n,) int32
    image: torch.Tensor    # (P,) int32 the sorted pairs' images


def sorted_pairs(starts, counts):
    """The images' CSR ranges as (range, image) pairs sorted by one stable
    sort on the range's key, start << 32 | count: the keys (P,) int64 and
    each one's place in the CSR list (P,) int64, on the ranges' device,
    with no read back."""
    return torch.sort((starts << 32) | counts, stable=True)


def pair_images(order, offsets):
    """The image of each place in the images' CSR list (image m owns
    places offsets[m] to offsets[m + 1]): the kernel's binary search."""
    return (torch.searchsorted(offsets, order, right=True) - 1).int()


def transpose_ranges(starts, counts, offsets) -> Transposed:
    """sorted_pairs in the kernel's view: for each distinct range the
    images that see it, ascending."""
    key, order = sorted_pairs(starts, counts)
    first = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    return Transposed(key >> 32, key & 0xFFFFFFFF,
                      pair_images(order, offsets), first)


def range_pieces(tr: Transposed, piece: int = PIECE) -> Pieces:
    """The pieces of tr's distinct ranges, in range order (a range of c
    points gives ceil(c / piece), an empty one none).  Reads one number
    back (how many pieces)."""
    dev = tr.start.device
    P = tr.start.shape[0]
    n_of = torch.where(tr.first, (tr.count + piece - 1) // piece,
                       torch.zeros_like(tr.count))
    n = int(n_of.sum()) if P else 0
    at = torch.repeat_interleave(torch.arange(P, device=dev), n_of,
                                 output_size=n)
    k = torch.arange(n, device=dev) - (torch.cumsum(n_of, 0) - n_of)[at]
    uid = torch.cumsum(tr.first.long(), 0) - 1
    pairs = torch.zeros(P, dtype=torch.int64, device=dev).scatter_add_(
        0, uid, torch.ones(P, dtype=torch.int64, device=dev))
    return Pieces(tr.start[at] + k * piece,
                  torch.clamp(tr.count[at] - k * piece, max=piece).int(),
                  at.int(), (at + pairs[uid[at]]).int(), tr.image)


def _cams(Rcw, tcw, dev):
    M = Rcw.shape[0]
    return torch.cat([Rcw.reshape(M, 9), tcw], dim=1).to(
        device=dev, dtype=torch.float32)


def cull_z(r, t, lo, hi) -> torch.Tensor:
    """True where every point of the box lo..hi (n, 3) float32 fails Z >=
    1e-3 (float32) through the Z row r (n, 3), t (n,) float32: the box's
    largest R2 p + t in float64 (each product exact, summed in this order)
    plus CULL_MARGIN of the sum of the terms' magnitudes stays below the
    gate.  The float32 chain (_row) errs by at most about 4 ulps of that
    sum (each of its four roundings within 2^-24 of it, the float64 sums
    within 2^-53), the margin is 16, so no point that passes is culled.
    csrc/zbuffer.cu's cull_z, operation by operation."""
    r, lo, hi = r.double(), lo.double(), hi.double()
    zmax = t.double()
    mag = zmax.abs()
    for j in range(3):
        a, b = r[:, j] * lo[:, j], r[:, j] * hi[:, j]
        zmax = zmax + torch.fmax(a, b)
        mag = mag + torch.fmax(a.abs(), b.abs())
    return zmax + mag * CULL_MARGIN < Z_GATE


def _piece_boxes(points, pc: Pieces):
    """Each piece's points' bounding box, lo and hi (n, 3) float32 (NaN
    coordinates passed over, as fminf / fmaxf do)."""
    dev = points.device
    n = pc.start.shape[0]
    c = pc.count.long()
    idx = torch.repeat_interleave(pc.start, c) + (
        torch.arange(int(c.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(c, 0) - c, c))
    seg = torch.repeat_interleave(torch.arange(n, device=dev), c)
    q = points[idx]
    ok = ~torch.isnan(q)
    inf = torch.full((n, 3), float("inf"), dtype=points.dtype, device=dev)
    lo = inf.scatter_reduce(0, seg[:, None].expand(-1, 3),
                            torch.where(ok, q, float("inf")), "amin")
    hi = (-inf).scatter_reduce(0, seg[:, None].expand(-1, 3),
                               torch.where(ok, q, float("-inf")), "amax")
    return lo, hi


def cull_pairs(points, pc: Pieces, Rcw, tcw):
    """The kernel's cull, pair by pair: (piece of each (piece, image) pair,
    its image, kept) over the pieces pc of points."""
    dev = points.device
    cams = _cams(Rcw, tcw, dev)
    lo, hi = _piece_boxes(points, pc)
    span = (pc.pair_hi - pc.pair_lo).long()
    piece = torch.repeat_interleave(
        torch.arange(pc.start.shape[0], device=dev), span)
    r = torch.repeat_interleave(pc.pair_lo.long(), span) + (
        torch.arange(int(span.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(span, 0) - span, span))
    img = pc.image[r].long()
    kept = ~cull_z(cams[img, 6:9], cams[img, 11], lo[piece], hi[piece])
    return piece, img, kept


def work(points, starts, counts, offsets, Rcw, tcw, cam) -> dict:
    """What one launch must do on these inputs, for the bound: the
    covisible (point, image) pairs, the points in front, the (piece,
    image) pairs and how many the cull removes, the points of the kept
    pairs (their Z rows), the float32 and float64 operations, the bytes
    that must move (the points and ranges once, the poses, the maps
    once), and the bytes the design asks of L2: the maps' fill, the
    finish's read and write, each range's 16-byte loads once for every
    chunk of CHUNK sorted pairs that holds some of its pairs, each pair's
    key and place, each (piece, pair)'s Z row of the pose in float64, a
    kept pair's whole pose, and a guarded 4-byte read for each point in
    front (an upper bound: points beside the image read nothing; the
    binary search of the offsets is left to L1)."""
    M = offsets.shape[0] - 1
    maps = 4 * M * int(cam.height) * int(cam.width)
    tr = transpose_ranges(starts, counts, offsets)
    pc = range_pieces(tr)
    piece, _, kept = cull_pairs(points, pc, Rcw, tcw)
    kept_points = int(pc.count.long()[piece[kept]].sum())
    covisible = int(counts.long().sum())
    front = points_in_front(points, starts, counts, offsets, Rcw, tcw)
    ops = tuple(z * kept_points + (a - z) * front
                for a, z in zip(ZBUFFER_OPS, ZBUFFER_Z_OPS))
    # the 16-byte loads of a range's pieces, once a chunk that opens it
    f0 = 3 * tr.start
    vec = (f0 + 3 * tr.count + 3) // 4 - f0 // 4
    P = tr.start.shape[0]
    opens = tr.first | (torch.arange(P, device=tr.start.device)
                        % CHUNK == 0)
    n_pairs = int(piece.shape[0])
    n_kept = int(kept.sum())
    return dict(covisible=covisible, in_front=front,
                pieces=int(pc.start.shape[0]), pairs=n_pairs, kept=n_kept,
                culled=n_pairs - n_kept, kept_points=kept_points, ops=ops,
                nbytes=points.shape[0] * 12 + starts.shape[0] * 12
                + offsets.shape[0] * 8 + M * 48 + maps,
                l2_bytes=3 * maps + 16 * int(vec[opens].sum()) + 16 * P
                + 32 * n_pairs + 96 * n_kept + 4 * front)


def zbuffer(points: torch.Tensor, starts: torch.Tensor, counts: torch.Tensor,
            offsets: torch.Tensor, Rcw: torch.Tensor, tcw: torch.Tensor,
            cam, stats: torch.Tensor | None = None) -> torch.Tensor:
    """Min-depth maps (M, H, W) float32, 0 where no point lands.

    points (N, 3) float32 world points, voxel-grouped; image m rasterizes
    the points points[starts[r] : starts[r] + counts[r]] of its ranges
    r in [offsets[m], offsets[m + 1]) (starts and offsets int64, counts
    int32) through Rcw[m] (3, 3), tcw[m] (3,) (cast to float32) and the
    camera `cam` (fx, fy, cx, cy, k1, k2, p1, p2, width, height).  On the
    card a call reads nothing back; `stats`, an int64 (2,) tensor on the
    card, gains the (piece, image) pairs the cull kept and the points in
    them."""
    dev = points.device
    if dev.type == "cpu":
        return zbuffer_plain(points, starts, counts, offsets, Rcw, tcw, cam)
    if dev.type != "cuda":
        raise ValueError(f"zbuffer: unsupported device {dev}")
    M = offsets.shape[0] - 1
    if points.dim() != 2 or points.shape[1] != 3 \
            or points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError("points must be a contiguous (N, 3) float32 tensor")
    if points.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer takes fewer than 2^31 points")
    for t, dt, what in ((starts, torch.int64, "starts"),
                        (counts, torch.int32, "counts"),
                        (offsets, torch.int64, "offsets")):
        if t.dim() != 1 or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous 1-d {dt} tensor "
                             f"on the points' device")
    if starts.shape != counts.shape or M < 0:
        raise ValueError("starts and counts must match; offsets is (M + 1,)")
    if starts.shape[0] >= 2 ** 31:
        raise ValueError("zbuffer takes fewer than 2^31 ranges")
    if Rcw.shape != (M, 3, 3) or tcw.shape != (M, 3):
        raise ValueError(f"Rcw must be ({M}, 3, 3) and tcw ({M}, 3)")
    if stats is not None and (stats.shape != (2,) or stats.dtype
                              != torch.int64 or stats.device != dev):
        raise ValueError("stats must be an int64 (2,) tensor on the card")
    H, W = int(cam.height), int(cam.width)
    out = torch.empty((M, H, W), dtype=torch.float32, device=dev)
    if M == 0:
        return out
    if points.data_ptr() % 16:
        points = points.clone()   # the kernel reads 16 bytes at a time
    # the poses as float64; the kernel rounds them to float32
    R64 = Rcw.to(device=dev, dtype=torch.float64).contiguous()
    t64 = tcw.to(device=dev, dtype=torch.float64).contiguous()
    key, order = sorted_pairs(starts, counts)
    launch = build.launcher("zbuffer")
    with torch.cuda.device(dev):
        err = launch(_ptr(points), points.shape[0], _ptr(key), _ptr(order),
                     _ptr(offsets), key.shape[0], M, _ptr(R64), _ptr(t64),
                     *_intrinsics(cam), W, H, _ptr(out),
                     ctypes.c_void_p(0 if stats is None
                                     else stats.data_ptr()),
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
    (the points the kernel projects)."""
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
