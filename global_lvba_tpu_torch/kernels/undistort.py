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
  * remap_plan cuts the output into tiles of TILE_H x TILE_W pixels and
    gives each tile its source box (the rows and bytes its taps touch; one
    box shape a launch, at most MAX_ROWS x MAX_PITCH bytes); a tile whose
    taps need more reads them from global memory.  It lays the map out
    tile by tile.  The plan is made once per camera with the map.
  * the kernel (a block walks the (tile, image) items of its share, the
    map of a tile in registers over a run of images, each image's box
    staged in shared memory by TMA, thread 0 keeping a ring of boxes in
    flight, where W % 16 == 0 and the stack is 16-byte aligned, else
    every tap read from global memory; a thread four neighbouring pixels)
    reads the 2x2 source pixels of each output pixel, a tap outside the
    image as 0, and writes (sum w_k s_k + (1 << 14)) >> 15: cv2's
    remapBilinear on uint8.  The plain version (undistort_plain,
    remap_plain) takes the map alone, never the tile plan.
Bound: bytes (the images read and written once, the map and the table
once); nothing to compute worth the name.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import build

LAUNCHES = {"undistort": 0}
INTER_BITS = 5
INTER_TAB = 1 << INTER_BITS
COEF_BITS = 15
# the kernel's output tile (a warp a row, four pixels a thread) and the cap
# of a staged source box; its byte permutes of a row's six tap bytes into
# dp2a's operands (bytes 0, 3 | 1, 4: channels 0 and 1; bytes 2, 5:
# channel 2).  csrc/undistort.cu takes them as -D flags (build._defines).
TILE_W, TILE_H = 128, 8
MAX_PITCH, MAX_ROWS = 512, 16
SEL01, SEL2 = 0x4130, 0x0052

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


class RemapPlan(NamedTuple):
    """The kernel's operands of one map on one device (remap_plan)."""
    height: int
    width: int
    xy: torch.Tensor        # (T, TILE_H, TILE_W) int32: x | y << 16
    frac: torch.Tensor      # (T, TILE_H, TILE_W) int16
    tiles: torch.Tensor     # (T, 4) int32: start byte, first row, staged, 0
    wtab: torch.Tensor      # (1024, 2) int32: w00 | w01 << 16, w10 | w11 << 16
    pitch: int              # bytes of a box row (a multiple of 16)
    rows: int               # rows of a box
    staged: int             # tiles whose taps are staged; the rest global


def _padded(a, H, W, fill):
    """(H, W) -> (ty, TILE_H, tx, TILE_W) of a's dtype, the ragged edges
    padded with `fill`."""
    ty, tx = -(-H // TILE_H), -(-W // TILE_W)
    out = np.full((ty * TILE_H, tx * TILE_W), fill, dtype=a.dtype)
    out[:H, :W] = a
    return out.reshape(ty, TILE_H, tx, TILE_W)


def _by_tile(a, H, W, fill):
    """(H, W) -> (T, TILE_H, TILE_W), tiles row-major, the ragged edges
    padded with `fill`."""
    t = _padded(np.asarray(a), H, W, fill)
    return t.transpose(0, 2, 1, 3).reshape(-1, TILE_H, TILE_W)


def tile_boxes(xy) -> dict:
    """Each tile's source box over its pixels' taps (x0, x0 + 1) x (y0,
    y0 + 1) of the map xy (H, W, 2) int16: the start byte `start` (x_min *
    3 rounded down to a multiple of 16: TMA takes a box only there), the
    first row `row`, the bytes `need` from the start byte to the last
    tap's end rounded up to 16 and the rows `rows`; `fits` where both are
    within the cap."""
    xy = np.asarray(xy, dtype=np.int16)
    H, W = xy.shape[:2]
    lo, hi = np.iinfo(np.int16).min, np.iinfo(np.int16).max

    def reduce(a, fill, op):
        return op(_padded(a, H, W, fill), axis=(1, 3)).reshape(-1).astype(
            np.int64)

    x_min = reduce(xy[..., 0], hi, np.min)
    x_max = reduce(xy[..., 0], lo, np.max)
    y_min = reduce(xy[..., 1], hi, np.min)
    y_max = reduce(xy[..., 1], lo, np.max)
    start = (x_min * 3) // 16 * 16
    need = ((x_max + 2) * 3 - start + 15) // 16 * 16
    rows = y_max + 2 - y_min
    return dict(start=start, row=y_min, need=need, rows=rows,
                fits=(need <= MAX_PITCH) & (rows <= MAX_ROWS),
                x_min=x_min, y_min=y_min)


def packed_weights() -> np.ndarray:
    """(1024, 2) uint32: remap_weights' rows as two pairs of 16-bit
    weights, (w00 | w01 << 16, w10 | w11 << 16), dp2a's first operand.
    The kernel needs no clamp because each row is non-negative and sums to
    1 << 15; this checks it."""
    tab = remap_weights().astype(np.int64)
    if (tab < 0).any() or (tab.sum(axis=1) != 1 << COEF_BITS).any():
        raise ValueError("the weight table is not non-negative rows that "
                         "sum to 1 << 15")
    return np.stack([tab[:, 0] | tab[:, 1] << 16,
                     tab[:, 2] | tab[:, 3] << 16], axis=1).astype(np.uint32)


def remap_plan(xy, frac, device="cpu") -> RemapPlan:
    """The kernel's operands for the map (xy (H, W, 2) int16, frac (H, W)
    fraction indices) on `device`: the box shape a launch (the largest
    box of the tiles within the cap), each tile's box and whether it is
    staged, the map tile by tile (a ragged tile's padding pixels at its
    box's first tap)."""
    xy = np.ascontiguousarray(xy, dtype=np.int16)
    frac = np.asarray(frac).astype(np.int16)
    H, W = frac.shape
    b = tile_boxes(xy)
    fits = b["fits"]
    pitch = int(b["need"][fits].max()) if fits.any() else 16
    rows = int(b["rows"][fits].max()) if fits.any() else 1
    # (x, y) as one little-endian word x | y << 16, laid out by tile
    inside = _by_tile(np.ones((H, W), bool), H, W, False)
    origin = ((b["x_min"] & 0xFFFF) | (b["y_min"] & 0xFFFF) << 16).astype(
        np.uint32)
    packed = np.where(inside, _by_tile(xy.view(np.uint32)[..., 0], H, W, 0),
                      origin[:, None, None])
    tiles = np.stack([b["start"], b["row"], fits.astype(np.int64),
                      np.zeros_like(b["row"])], axis=1).astype(np.int32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return RemapPlan(
        height=H, width=W, xy=dev(packed.view(np.int32)),
        frac=dev(_by_tile(frac, H, W, 0)), tiles=dev(tiles),
        wtab=dev(packed_weights().view(np.int32)), pitch=pitch, rows=rows,
        staged=int(fits.sum()))


def _cam_key(kind, cam, W: int, H: int, device) -> tuple:
    return (kind, torch.device(device), float(cam.fx), float(cam.fy),
            float(cam.cx), float(cam.cy), float(cam.k1), float(cam.k2),
            float(cam.p1), float(cam.p2), W, H)


def undistort_plan(cam, W: int, H: int, device) -> RemapPlan:
    """remap_plan of the camera's map at W x H on `device`, made once per
    camera, size and device (the map and the plan on the host, one copy
    each to the device) and cached."""
    key = _cam_key("plan", cam, W, H, device)
    hit = _tables.get(key)
    if hit is None:
        hit = _tables[key] = remap_plan(*undistort_map(cam, W, H), device)
    return hit


def _device_operands(cam, W: int, H: int, device):
    """The plain version's operands on `device`: the camera's map at W x H
    (xy (H, W, 2) int16, frac (H, W) int16) and remap_weights (1024, 4)
    int32, copied once per camera, size and device and cached."""
    key = _cam_key("map", cam, W, H, device)
    hit = _tables.get(key)
    if hit is None:
        hit = _tables[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (*undistort_map(cam, W, H), remap_weights()))
    return hit


def staging_route(images: torch.Tensor) -> str:
    """The kernel's route for `images` (N, H, W, 3), as its launcher
    (csrc/undistort.cu lvba_undistort) picks it: "tma" (staged boxes,
    thread 0's TMA loads into a ring) where an image row is a multiple of
    16 bytes (W % 16 == 0) and the stack is 16-byte aligned, else
    "global" (every tap from global memory)."""
    W = images.shape[2]
    return "tma" if W % 16 == 0 and images.data_ptr() % 16 == 0 else "global"


def undistort(images: torch.Tensor, cam) -> torch.Tensor:
    """Undistorted images (N, H, W, 3) uint8 of images (N, H, W, 3) uint8
    (BGR), cv2's remap of cv2's map bit for bit.  CPU tensors take
    undistort_plain; on a CUDA tensor the kernel runs or this raises."""
    dev = images.device
    if dev.type == "cpu":
        return undistort_plain(images, cam)
    _check(images)
    H, W = images.shape[1:3]
    return remap(images, undistort_plan(cam, W, H, dev))


def _check(images):
    if images.device.type != "cuda":
        raise ValueError(f"undistort: unsupported device {images.device}")
    if images.dim() != 4 or images.shape[3] != 3 \
            or images.dtype != torch.uint8 or not images.is_contiguous():
        raise ValueError("images must be a contiguous (N, H, W, 3) uint8 "
                         "tensor")


def remap(images: torch.Tensor, plan: RemapPlan) -> torch.Tensor:
    """cv2.remap(INTER_LINEAR, BORDER_CONSTANT 0) of the uint8 images (N,
    H, W, 3) on the card through the map of `plan` (remap_plan, on the
    images' device): one kernel launch, no read back, no synchronizing
    call.  The plan holds no map for a plain version: CPU tensors take
    remap_plain with the map itself (undistort does so)."""
    _check(images)
    N, H, W = images.shape[:3]
    if (H, W) != (plan.height, plan.width) \
            or plan.xy.device != images.device:
        raise ValueError("the plan is for another image size or device")
    out = torch.empty_like(images)
    if N == 0:
        return out
    launch = build.launcher("undistort")
    dev = images.device
    with torch.cuda.device(dev):
        err = launch(*(ctypes.c_void_p(t.data_ptr()) for t in (
            images, plan.xy, plan.frac, plan.tiles, plan.wtab)), N, H, W,
            plan.pitch, plan.rows, ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    build.check("undistort", err)
    LAUNCHES["undistort"] += 1
    return out


def undistort_plain(images: torch.Tensor, cam) -> torch.Tensor:
    """Plain torch version of undistort: the same integer arithmetic by
    gathers over the whole stack."""
    H, W = images.shape[1:3]
    return remap_plain(images, *_device_operands(cam, W, H, images.device))


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
