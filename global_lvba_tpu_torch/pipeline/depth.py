"""World grid map, per-image covisible voxel sets and LiDAR depth rendering
(port of global_lvba_tpu.pipeline.depth, its numpy path).

Replicates buildGridMapFromOptimized + generateDepthWithVoxel
(src/lvba_system.cpp:835-919, 1266-1338):

  * a 0.5 m world voxel grid over all optimized-pose-transformed LiDAR
    points (voxel -> point list, a sorted CSR over packed keys);
  * per image, the union of voxel sets of LiDAR frames within ±0.5 s of the
    image timestamp selects the covisible points;
  * those points are projected through the distorted pinhole model and
    z-buffered to a min-depth map per integer pixel (Z >= 1e-3 gate).

The stage's device picks the path.  On the CPU all of it is host numpy
(_zbuffer_host rasterizes an image at a time).  On a CUDA device the grid
map's keys come from the native host library (native.on_device), and
render_depth_maps builds each image's covisible CSR ranges on a host
pool, uploads the points once and rasterizes every image in one launch
of the card's z-buffer (kernels/zbuffer.py), where the JAX package runs
its C++ rasterizer on the host.  Either way the maps come back as host numpy
(M, H, W) float32: they feed the host's bilinear depth fetch
(tracks/fuse.py) and the PNG writer.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from .. import native, resolve_device
from ..geometry.camera import CameraModel
from ..map.voxelize import _argsort_keys, pack_voxel_keys
from ..native import runtime

GRID_VOX = 0.5   # lvba_system.cpp:1277
HALF_W = 0.5     # ±0.5 s covisibility window (:1300)


@dataclasses.dataclass
class GridMap:
    """Sorted-CSR world grid: keys (Nv,) ascending; points grouped by voxel."""

    keys: np.ndarray           # (Nv,) int64 sorted unique voxel keys
    starts: np.ndarray         # (Nv,) int64 offsets into points
    counts: np.ndarray         # (Nv,) int64
    points: np.ndarray         # (N, 3) float32 world points, voxel-grouped
    frame_voxel_keys: List[np.ndarray]  # per frame, sorted unique keys


def build_grid_map(
    clouds: Sequence[np.ndarray],
    R: np.ndarray,
    p: np.ndarray,
    voxel: float = GRID_VOX,
    device="cpu",
) -> GridMap:
    """The grid map of the clouds at poses (R, p).  On a CUDA device
    (native.on_device) the voxel keys come from the native library, as
    the JAX package's do from its own; the same keys as numpy's."""
    nat = native.on_device(device)

    def keys_of(w, n_threads):
        if nat:
            return runtime.voxel_keys64(w, voxel, n_threads)
        return pack_voxel_keys(np.floor(w / voxel).astype(np.int64))

    world_all = []
    fkeys = []
    for i, c in enumerate(clouds):
        w = (R[i] @ c.T).T + p[i]
        world_all.append(w.astype(np.float32))
        # one thread a frame: for ~10^4 points, starting threads costs
        # more than they save
        fkeys.append(np.unique(keys_of(w, 1)))
    world = np.concatenate(world_all)
    keys = keys_of(world.astype(np.float64), 0)
    order = _argsort_keys(keys, nat)
    sk = keys[order]
    firsts = np.concatenate([[True], sk[1:] != sk[:-1]])
    starts = np.flatnonzero(firsts)
    counts = np.diff(np.append(starts, sk.shape[0]))
    return GridMap(
        keys=sk[starts],
        starts=starts.astype(np.int64),
        counts=counts.astype(np.int64),
        points=world[order],
        frame_voxel_keys=fkeys,
    )


def covisible_voxels(
    gm: GridMap, lidar_times: np.ndarray, image_time: float,
    half_w: float = HALF_W,
) -> np.ndarray:
    """Union of voxel-key sets of LiDAR frames within ±half_w of the image."""
    lo = np.searchsorted(lidar_times, image_time - half_w, side="left")
    hi = np.searchsorted(lidar_times, image_time + half_w, side="right")
    if hi <= lo:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(gm.frame_voxel_keys[lo:hi]))


def gather_voxel_ranges(
    gm: GridMap, voxel_keys: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR (starts, counts) of the grid-map rows matching the given keys
    (what the card's z-buffer reads in place)."""
    pos = np.searchsorted(gm.keys, voxel_keys)
    ok = pos < gm.keys.shape[0]
    pos = pos[ok]
    hit = gm.keys[pos] == voxel_keys[ok]
    pos = pos[hit]
    return gm.starts[pos], gm.counts[pos]


def gather_voxel_points(gm: GridMap, voxel_keys: np.ndarray) -> np.ndarray:
    """All world points belonging to the given voxel keys (a vectorized
    ragged-range expansion)."""
    starts, counts = gather_voxel_ranges(gm, voxel_keys)
    if starts.size == 0:
        return np.zeros((0, 3), dtype=np.float32)
    total = int(counts.sum())
    ends = np.cumsum(counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - counts, counts)
    idx = np.repeat(starts, counts) + within
    return gm.points[idx]


def _zbuffer_host(cam: CameraModel, Rcw, tcw, pts: np.ndarray) -> np.ndarray:
    """Min-depth z-buffer (H, W) from world points, rasterized on the host
    in float32 (lvba_system.cpp:885-901): the output is a min depth per
    integer pixel, and float32 projection at ~10 m range errs by ~1 um."""
    H, W = cam.height, cam.width
    Xc = pts.astype(np.float32) @ np.asarray(Rcw, np.float32).T + np.asarray(
        tcw, np.float32
    )
    Z = Xc[:, 2]
    sel = Z >= 1e-3
    Xs = Xc[sel]
    Zs = Z[sel]
    x = Xs[:, 0] / Zs
    y = Xs[:, 1] / Zs
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    with np.errstate(invalid="ignore"):
        uu = np.clip(cam.fx * xd + cam.cx, -2**30, 2**30).astype(np.int32)
        vv = np.clip(cam.fy * yd + cam.cy, -2**30, 2**30).astype(np.int32)
    inb = (uu >= 0) & (uu < W) & (vv >= 0) & (vv < H)
    lin = (vv[inb].astype(np.int64) * W + uu[inb])
    z_in = Zs[inb].astype(np.float32)
    depth = np.full(H * W, np.inf, np.float32)
    np.minimum.at(depth, lin, z_in)         # min depth per pixel
    np.place(depth, ~np.isfinite(depth), 0.0)
    return depth.reshape(H, W)


def render_depth_maps(
    cam: CameraModel,
    gm: GridMap,
    lidar_times: np.ndarray,
    image_times: np.ndarray,
    Rcw_all: np.ndarray,
    tcw_all: np.ndarray,
    half_w: float = HALF_W,
    workers: int = 4,
    device="cuda",
) -> np.ndarray:
    """Depth maps (M, H, W) float32 for all images: on the card (the
    default; resolve_device raises where there is none) through its
    z-buffer (_render_zbuffer), with device="cpu" an image at a time
    through _zbuffer_host.  Images are independent; a small thread pool
    overlaps the host work (sorts and ufuncs release the GIL)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return _render_zbuffer(cam, gm, lidar_times, image_times, Rcw_all,
                               tcw_all, half_w, workers, dev)
    M = len(image_times)
    out = np.zeros((M, cam.height, cam.width), dtype=np.float32)

    def one(i):
        vox = covisible_voxels(gm, lidar_times, float(image_times[i]), half_w)
        pts = gather_voxel_points(gm, vox)
        if pts.shape[0]:
            out[i] = _zbuffer_host(cam, Rcw_all[i], tcw_all[i], pts)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(one, range(M)))
    return out


def _render_zbuffer(cam, gm, lidar_times, image_times, Rcw_all, tcw_all,
                    half_w=HALF_W, workers=4, device="cuda") -> np.ndarray:
    """render_depth_maps' card route: the pool builds only the images'
    ranges (image_ranges), the points are uploaded once, one
    kernels/zbuffer.py call rasterizes every image and the maps are
    copied back once (on CPU tensors zbuffer runs its plain version)."""
    import torch

    from ..kernels.zbuffer import zbuffer

    starts, counts, offsets = image_ranges(gm, lidar_times, image_times,
                                           half_w, workers)
    dev = torch.device(device)

    def up(a):
        return torch.as_tensor(a).to(dev)

    maps = zbuffer(up(np.ascontiguousarray(gm.points, np.float32)),
                   up(starts), up(counts), up(offsets),
                   up(np.asarray(Rcw_all, np.float64)),
                   up(np.asarray(tcw_all, np.float64)), cam)
    return maps.cpu().numpy()


def image_ranges(
    gm: GridMap,
    lidar_times: np.ndarray,
    image_times: np.ndarray,
    half_w: float = HALF_W,
    workers: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Every image's covisible grid-map rows as one flat CSR list: starts
    (R,) int64, counts (R,) int32 and offsets (M + 1,) int64 (image m owns
    ranges offsets[m] to offsets[m + 1]), built on a thread pool."""
    def one(i):
        vox = covisible_voxels(gm, lidar_times, float(image_times[i]), half_w)
        return gather_voxel_ranges(gm, vox)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        ranges = list(ex.map(one, range(len(image_times))))
    offsets = np.zeros(len(ranges) + 1, dtype=np.int64)
    np.cumsum([s.shape[0] for s, _ in ranges], out=offsets[1:])
    starts = np.concatenate([np.zeros(0, np.int64)]
                            + [s for s, _ in ranges]).astype(np.int64)
    counts = np.concatenate([np.zeros(0, np.int64)]
                            + [c for _, c in ranges]).astype(np.int32)
    return starts, counts, offsets


def update_camera_poses_from_lidar(
    lidar_times: np.ndarray,
    R_opt: np.ndarray, p_opt: np.ndarray,
    R_orig: np.ndarray, p_orig: np.ndarray,
    image_times: np.ndarray,
    R_cam: np.ndarray, p_cam: np.ndarray,
):
    """Propagate per-frame LiDAR pose deltas to nearest-timestamp camera
    poses (updateCameraPosesFromLidar, lvba_system.cpp:412-446):
    T_cam_new = (T_opt ∘ T_orig⁻¹) ∘ T_cam, nearest LiDAR frame by
    timestamp."""
    M = image_times.shape[0]
    R_out = R_cam.copy()
    p_out = p_cam.copy()
    for i in range(M):
        t = image_times[i]
        idx = np.searchsorted(lidar_times, t)
        if idx >= lidar_times.shape[0]:
            idx = lidar_times.shape[0] - 1
        elif idx > 0:
            if abs(lidar_times[idx - 1] - t) < abs(lidar_times[idx] - t):
                idx = idx - 1
        dR = R_opt[idx] @ R_orig[idx].T
        dp = p_opt[idx] - dR @ p_orig[idx]
        R_out[i] = dR @ R_cam[i]
        p_out[i] = dR @ p_cam[i] + dp
    return R_out, p_out


def camera_world_to_cam(
    Rci: np.ndarray, tci: np.ndarray, R_wi: np.ndarray, p_wi: np.ndarray
):
    """Body(IMU)-world poses -> world->camera extrinsic per image
    (lvba_system.cpp:856-871): Rcw = Rci Rwiᵀ, tcw = -Rcw p_wi + tci."""
    Rcw = np.einsum("ab,mcb->mac", Rci, R_wi)
    tcw = -np.einsum("mab,mb->ma", Rcw, p_wi) + tci
    return Rcw, tcw
