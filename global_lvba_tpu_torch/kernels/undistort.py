"""Undistortion of all images of an export in one launch (csrc/undistort.cu),
beside its plain torch version.

It replaces no Pallas kernel: the JAX package undistorts on the host with
cv2 (global_lvba_tpu/pipeline/outputs.py:292 undistort_image:
initUndistortRectifyMap(K, D, I, K, size, CV_16SC2), then
remap(INTER_LINEAR, BORDER_CONSTANT 0)).  Both halves are integer
fixed point once the map exists, so the port keeps them bit for bit:
  * undistort_map computes cv2's map once per camera and size on the host
    in float64, rounded as cv2's AVX2 build rounds it (its inverse of K,
    the runs of 8 columns, the fused row and pixel multiply-adds): for each
    output pixel its source position through the distortion polynomial,
    times 32 and rounded (cvRound), split into the integer pixel (x >> 5,
    y >> 5, int16) and a 5-bit fraction index ((y & 31) * 32 + (x & 31)).
  * remap_weights is cv2's BilinearTab_i: for each of the 1,024
    fractions the four 15-bit weights (float products of 1 - f and f
    times 32768, rounded, their sum corrected to 1 << 15 on the largest or
    smallest weight).
  * the kernel (one thread an output pixel, its three channels) reads the
    2x2 source pixels, a tap outside the image as 0, and writes
    (sum w_k s_k + (1 << 14)) >> 15 clamped to 0..255: cv2's remapBilinear
    on uint8.
Bound: bytes (the images read and written once, the map and the table
once); nothing to compute worth the name.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

LAUNCHES = {"undistort": 0}
INTER_BITS = 5
INTER_TAB = 1 << INTER_BITS
COEF_BITS = 15

_maps: dict = {}
_tables: dict = {}


def undistort_map(cam, width: int, height: int):
    """cv2.initUndistortRectifyMap(K, (k1, k2, p1, p2, 0), I, K,
    (width, height), CV_16SC2) of the camera: (xy (H, W, 2) int16, frac
    (H, W) int16 fraction index).  Cached per camera and size."""
    key = (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
           float(cam.k1), float(cam.k2), float(cam.p1), float(cam.p2),
           int(width), int(height))
    hit = _maps.get(key)
    if hit is not None:
        return hit
    fx, fy, cx, cy, k1, k2, p1, p2 = key[:8]
    x, y, w = _normalized(fx, fy, cx, cy, int(width), int(height))
    x, y = x * w, y * w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((0.0 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy
    u = _fma(np.full_like(xd, fx), xd, np.full_like(xd, cx))
    v = _fma(np.full_like(yd, fy), yd, np.full_like(yd, cy))
    iu = np.rint(u * INTER_TAB).astype(np.int64)
    iv = np.rint(v * INTER_TAB).astype(np.int64)
    xy = np.stack([iu >> INTER_BITS, iv >> INTER_BITS], axis=-1).astype(
        np.int16)
    frac = ((iv & (INTER_TAB - 1)) * INTER_TAB
            + (iu & (INTER_TAB - 1))).astype(np.int16)
    _maps[key] = (xy, frac)
    return xy, frac


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once, elementwise in float64."""
    from .colorize import fma64

    return fma64(*(torch.from_numpy(np.ascontiguousarray(t, np.float64))
                   for t in (a, b, c))).numpy()


def _normalized(fx, fy, cx, cy, W: int, H: int):
    """cv2's pre-distortion coordinates (x, y) and 1 / w of each output
    pixel as its initUndistortRectifyMap forms them: K's inverse by
    cofactors over the determinant (Matx33d::inv); a row's y = i ir4 + ir5
    fused; x along a row from ir2 in runs of 8 (4 float64 lanes, twice)
    as x0 + k ir0, x0 stepping by 8 ir0, the last W mod 8 columns by
    repeated + ir0."""
    d = 1.0 / (fx * fy - 0.0)
    ir0, ir2 = fy * d, (0.0 * cy - cx * fy) * d
    ir4, ir5 = fx * d, (cx * 0.0 - fx * cy) * d
    ir8 = (fx * fy - 0.0) * d
    row = np.empty(W)
    x0, j = ir2, 0
    while j <= W - 8:
        row[j:j + 8] = x0 + ir0 * np.arange(8, dtype=np.float64)
        x0 += 8 * ir0
        j += 8
    while j < W:
        row[j] = x0
        x0 += ir0
        j += 1
    i = np.arange(H, dtype=np.float64)
    y = _fma(i, np.full(H, ir4), np.full(H, ir5))
    return (np.broadcast_to(row[None, :], (H, W)),
            np.broadcast_to(y[:, None], (H, W)), 1.0 / ir8)


def remap_weights() -> np.ndarray:
    """(1024, 4) int32: cv2's bilinear fixed-point weights (w00, w01, w10,
    w11) of each fraction index fy * 32 + fx."""
    tab = _tables.get("np")
    if tab is not None:
        return tab
    one = np.float32(1.0)
    f = np.arange(INTER_TAB, dtype=np.float32) / np.float32(INTER_TAB)
    lin = np.stack([one - f, f], axis=1)           # (32, 2) float32
    out = np.empty((INTER_TAB * INTER_TAB, 4), dtype=np.int32)
    scale = np.float32(1 << COEF_BITS)
    for a in range(INTER_TAB):          # fy
        for b in range(INTER_TAB):      # fx
            v = (lin[a][:, None] * lin[b][None, :]).astype(np.float32)
            it = np.rint(v * scale).astype(np.int64).reshape(4)
            diff = int(it.sum()) - (1 << COEF_BITS)
            if diff:
                mk = Mk = 0
                for k in range(4):
                    if it[k] < it[mk]:
                        mk = k
                    elif it[k] > it[Mk]:
                        Mk = k
                if diff < 0:
                    it[Mk] -= diff
                else:
                    it[mk] -= diff
            out[a * INTER_TAB + b] = it
    _tables["np"] = out
    return out


def _device_operands(cam, W, H, dev):
    key = (dev, float(cam.fx), float(cam.fy), float(cam.cx),
           float(cam.cy), float(cam.k1), float(cam.k2), float(cam.p1),
           float(cam.p2), W, H)
    hit = _tables.get(key)
    if hit is None:
        xy, frac = undistort_map(cam, W, H)
        hit = (torch.from_numpy(xy).to(dev).contiguous(),
               torch.from_numpy(frac).to(dev).contiguous(),
               torch.from_numpy(remap_weights()).to(dev).contiguous())
        _tables[key] = hit
    return hit


def undistort(images: torch.Tensor, cam) -> torch.Tensor:
    """Undistorted images (N, H, W, 3) uint8 of images (N, H, W, 3) uint8
    (BGR), cv2's remap of cv2's map bit for bit.  CPU tensors take
    undistort_plain; on a CUDA tensor the kernel runs or this raises."""
    dev = images.device
    if dev.type == "cpu":
        return undistort_plain(images, cam)
    if dev.type != "cuda":
        raise ValueError(f"undistort: unsupported device {dev}")
    if images.dim() != 4 or images.shape[3] != 3 \
            or images.dtype != torch.uint8 or not images.is_contiguous():
        raise ValueError("images must be a contiguous (N, H, W, 3) uint8 "
                         "tensor")
    N, H, W = images.shape[:3]
    out = torch.empty_like(images)
    if N == 0:
        return out
    xy, frac, tab = _device_operands(cam, W, H, dev)
    launch = build.launcher("undistort")
    with torch.cuda.device(dev):
        err = launch(ctypes.c_void_p(images.data_ptr()),
                     ctypes.c_void_p(xy.data_ptr()),
                     ctypes.c_void_p(frac.data_ptr()),
                     ctypes.c_void_p(tab.data_ptr()), N, H, W,
                     ctypes.c_void_p(out.data_ptr()),
                     ctypes.c_void_p(torch.cuda.current_stream(dev)
                                     .cuda_stream))
    build.check("undistort", err)
    LAUNCHES["undistort"] += 1
    return out


def undistort_plain(images: torch.Tensor, cam) -> torch.Tensor:
    """Plain torch version of undistort: the same integer arithmetic by
    gathers over the whole stack."""
    H, W = images.shape[1:3]
    xy, frac, tab = _device_operands(cam, W, H, images.device)
    return remap_plain(images, xy, frac, tab)


def remap_plain(images, xy, frac, tab=None) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of uint8 images (N, H, W,
    3) through a CV_16SC2 map (xy (H, W, 2) int16, frac (H, W) fraction
    indices), in torch integer arithmetic."""
    dev = images.device
    N, H, W = images.shape[:3]
    if tab is None:
        tab = torch.from_numpy(remap_weights()).to(dev)
    sx = xy[..., 0].long()
    sy = xy[..., 1].long()
    w = tab.int()[frac.long()]                        # (H, W, 4)
    src = images.int()
    acc = torch.zeros((N, H, W, 3), dtype=torch.int32, device=dev)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        x, y = sx + dx, sy + dy
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        tap = src[:, y.clamp(0, H - 1), x.clamp(0, W - 1)]   # (N, H, W, 3)
        acc += tap * (w[..., k] * inside)[None, :, :, None]
    return ((acc + (1 << (COEF_BITS - 1))) >> COEF_BITS).clamp(0, 255).to(
        torch.uint8)


def undistort_bytes(n: int, H: int, W: int) -> int:
    """The bytes the function must move: the images read and written once,
    the map (6 bytes a pixel) and the weight table once."""
    return 2 * n * H * W * 3 + H * W * 6 + INTER_TAB * INTER_TAB * 16
