"""Export & diagnostic outputs: depth PNGs, COLMAP sparse model, colored
clouds, reprojection overlays, tracked-feature imagery (the port's own
copy of global_lvba_tpu.pipeline.outputs; host numpy).

Replicates the reference's file outputs:
  * depth/<ts>.png — 16-bit, metric depth x2000 (lvba_system.cpp:907-915)
  * Colmap/sparse/images.txt + points3D.txt + undistorted images/
    (:1945-2031, 2109-2137)
  * colored merged clouds before/after (z-buffer colorization, :2033-2107)
  * reproj/vis_*.png overlays: measured green cross, pre blue dot, post red
    rect, per-image mean errors (:1672-1833)
  * track_features/*.png: all keypoints red, tracked inliers green
    (:1340-1420)

Nothing here needs cv2.  The PNGs are the port's own (io/image.py: zlib,
the native library's row unfilter): the depth maps hold the JAX package's
pixels (clip(depth * 2000, 0, 65535) as uint16, 16-bit grayscale) and
the overlays and track images cv2's drawing (pipeline/draw.py), and read
back as cv2 reads them; the JPEGs are the native encoder's, byte for byte
cv2.imwrite's.  The undistortion and the colorization's z-buffer are
kernels (kernels/undistort.py, kernels/colorize.py): an export's images
go through one launch of each on a CUDA device, through their plain torch
versions on the CPU.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device
from ..geometry.camera import CameraModel
from ..io.image import (_PNG_SIGNATURE, _png_chunk, imread_unchanged,
                        imwrite_jpeg, imwrite_png)
from .draw import Canvas

DEPTH_SCALE = 2000.0  # depth PNG units per metre (lvba_system.cpp:913)


def save_depth_png(path, depth: np.ndarray):
    """16-bit depth PNG, 1 m -> 2000 (lvba_system.cpp:913): one IHDR
    (bit depth 16, grayscale, not interlaced), one IDAT of big-endian
    rows each under filter 0, deflated at level 1 (cv2's default)."""
    vis = np.clip(depth * DEPTH_SCALE, 0, 65535).astype(np.uint16)
    H, W = vis.shape
    rows = np.zeros((H, 1 + 2 * W), dtype=np.uint8)
    rows[:, 1:] = vis.astype(">u2").view(np.uint8).reshape(H, 2 * W)
    ihdr = struct.pack(">IIBBBBB", W, H, 16, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
                + _png_chunk(b"IEND", b""))


def load_depth_png(path, scale: float = DEPTH_SCALE) -> np.ndarray:
    """The image at path as cv2.imread(IMREAD_UNCHANGED) reads it
    (io/image.imread_unchanged: a 16-bit gray PNG such as save_depth_png's
    as (H, W) uint16, other files with their own channels and depth), in
    float32 divided by scale, as the reference's loader.  A missing file
    raises FileNotFoundError and an unreadable one ValueError, where the
    reference fails on cv2's None."""
    return imread_unchanged(path).astype(np.float32) / scale


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3,3) -> (w, x, y, z)."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(np.array(R)).as_quat()  # x, y, z, w
    return np.array([q[3], q[0], q[1], q[2]])


def write_colmap_sparse(
    out_dir,
    Rcw: np.ndarray,
    tcw: np.ndarray,
    points_xyz: np.ndarray,
    points_rgb: Optional[np.ndarray] = None,
    image_names: Optional[Sequence[str]] = None,
):
    """COLMAP text model: sparse/images.txt + points3D.txt
    (lvba_system.cpp:2018-2024, 2126-2137)."""
    sparse = Path(out_dir) / "sparse"
    sparse.mkdir(parents=True, exist_ok=True)
    M = Rcw.shape[0]
    with open(sparse / "images.txt", "w") as f:
        for k in range(M):
            q = _rot_to_quat(Rcw[k])
            t = tcw[k]
            name = image_names[k] if image_names else f"{k}.jpg"
            f.write(
                f"{k} {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f} "
                f"{t[0]:.6f} {t[1]:.6f} {t[2]:.6f} 1 {name}\n"
            )
            f.write("0.0 0.0 -1\n")
    rgb = points_rgb if points_rgb is not None else np.zeros_like(points_xyz)
    with open(sparse / "points3D.txt", "w") as f:
        for i in range(points_xyz.shape[0]):
            x, y, z = points_xyz[i]
            r, g, b = rgb[i].astype(int)
            f.write(f"{i} {x:.6f} {y:.6f} {z:.6f} {r} {g} {b} 0\n")


def colorize_clouds(
    cam: CameraModel,
    clouds: Sequence[np.ndarray],
    lidar_times: np.ndarray,
    R_body: np.ndarray, p_body: np.ndarray,
    image_times: np.ndarray,
    images,          # per image (H, W, 3) BGR uint8, or a (M, H, W, 3) tensor
    Rcw: np.ndarray, tcw: np.ndarray,
    half_w: float = 0.5,
    device="cuda",
) -> np.ndarray:
    """Merged colored world cloud: per image, z-buffer the ±half_w-window
    LiDAR points and take each pixel's nearest point with its image color
    (VisualizeOptComparison, lvba_system.cpp:2033-2069).

    The world transform and the windows are the JAX package's numpy; the
    z-buffer of every image is one colorize launch on `device` (the card
    by default: resolve_device raises where there is none; its plain
    version with device="cpu"), the same rows in the same order.  `images`
    may be a uint8 tensor on `device` already (an export uploads its
    images once).  Returns (N, 6) float32: xyz + rgb (0-255)."""
    import torch

    from ..kernels.colorize import colorize

    dev = resolve_device(device)
    # world-transform every frame ONCE; per image the ±half_w window is a
    # contiguous slice of the concatenated array (lidar_times sorted)
    F = len(clouds)
    world_all = np.concatenate(
        [(R_body[i] @ clouds[i].T).T + p_body[i] for i in range(F)]
    ).astype(np.float64)
    sizes = np.array([c.shape[0] for c in clouds], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    lt = np.asarray(lidar_times)
    it = np.asarray(image_times)
    lo = np.searchsorted(lt, it - half_w, side="left")
    hi = np.searchsorted(lt, it + half_w, side="right")
    lo, hi = offsets[lo], np.where(hi > lo, offsets[hi], offsets[lo])
    if not len(it):
        return np.zeros((0, 6), dtype=np.float32)
    # the concatenated transposes are column-major: the kernel reads rows
    pts = torch.from_numpy(np.ascontiguousarray(world_all)).to(dev)
    m, v, u, pt = colorize(pts, torch.from_numpy(lo).to(dev),
                           torch.from_numpy(hi).to(dev),
                           np.asarray(Rcw, np.float64),
                           np.asarray(tcw, np.float64), cam)
    if torch.is_tensor(images):
        stack = images.to(dev)
    else:
        stack = torch.from_numpy(np.stack(images)).to(dev)
    bgr = stack[m, v, u].cpu().numpy()
    if not bgr.shape[0]:
        return np.zeros((0, 6), dtype=np.float32)
    rgb = bgr[:, ::-1].astype(np.float32)
    return np.concatenate([world_all[pt.cpu().numpy()], rgb],
                          axis=1).astype(np.float32)


def write_colored_pcd(path, cloud_rgb: np.ndarray):
    """Binary PCD with packed rgb float field (PCL convention)."""
    n = cloud_rgb.shape[0]
    xyz = cloud_rgb[:, 0:3].astype(np.float32)
    rgb = cloud_rgb[:, 3:6].astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    packed_f = packed.view(np.float32)
    hdr = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    rec = np.empty((n, 4), dtype=np.float32)
    rec[:, 0:3] = xyz
    rec[:, 3] = packed_f
    with open(path, "wb") as f:
        f.write(hdr.encode("ascii"))
        f.write(np.ascontiguousarray(rec).tobytes())


def draw_reprojection_overlay(
    image: np.ndarray,
    uv_meas: np.ndarray,
    uv_pre: np.ndarray, pre_ok: np.ndarray,
    uv_post: np.ndarray, post_ok: np.ndarray,
    header: str = "",
) -> Tuple[np.ndarray, float, float]:
    """Overlay: measured green cross, pre blue dot, post red rect
    (visualizeProj, lvba_system.cpp:1786-1822), drawn as cv2 draws them
    (pipeline/draw.py). Returns (img, mean_pre, mean_post)."""
    cv = Canvas(image)
    n = uv_meas.shape[0]
    pre_ok = np.asarray(pre_ok, bool)
    post_ok = np.asarray(post_ok, bool)
    m = np.round(uv_meas).astype(int)
    # each observation's marks in cv2's order: the cross, the pre dot, the
    # post rect; one observation's after the one before
    obs = 4 * np.arange(n)
    cv.begin_batch()
    cv.marks(("hline", 5), m, (0, 255, 0), obs)
    cv.marks(("vline", 5), m, (0, 255, 0), obs + 1)
    cv.marks(("dot", 2), np.round(uv_pre[pre_ok]).astype(int),
             (255, 128, 0), obs[pre_ok] + 2)
    cv.marks(("rect", 1), np.round(uv_post[post_ok]).astype(int),
             (0, 0, 255), obs[post_ok] + 3)
    cv.end_batch()
    sum_pre = sum_post = 0.0
    n_pre = n_post = 0
    for i in range(n):
        if pre_ok[i]:
            sum_pre += float(np.linalg.norm(uv_pre[i] - uv_meas[i]))
            n_pre += 1
        if post_ok[i]:
            sum_post += float(np.linalg.norm(uv_post[i] - uv_meas[i]))
            n_post += 1
    mean_pre = sum_pre / n_pre if n_pre else -1.0
    mean_post = sum_post / n_post if n_post else -1.0
    text = f"{header} N={uv_meas.shape[0]} mean_pre={mean_pre:.3f} mean_post={mean_post:.3f}"
    cv.text(text, (12, 24), 0.5, (0, 0, 0), 1)
    return cv.finish(), mean_pre, mean_post


def project_observations(cam: CameraModel, Rcw, tcw, X, obs_cam, obs_pt):
    """Each observation's world point through its camera, in float64 on
    the host (geometry.camera.project_world_to_pixel on CPU tensors):
    returns (uv (N, 2), valid (N,)) as numpy."""
    import torch

    from ..geometry.camera import project_world_to_pixel

    def host(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64))

    ic = torch.as_tensor(np.asarray(obs_cam, dtype=np.int64))
    ip = torch.as_tensor(np.asarray(obs_pt, dtype=np.int64))
    uv, _, ok = project_world_to_pixel(cam, host(Rcw)[ic], host(tcw)[ic],
                                       host(X)[ip])
    return uv.numpy(), ok.numpy()


def save_reprojection_overlays(
    out_dir,
    cam: CameraModel,
    images: Sequence[Optional[np.ndarray]],
    obs_cam: np.ndarray, obs_pt: np.ndarray, obs_uv: np.ndarray,
    X_pre: np.ndarray, X_post: np.ndarray,
    Rcw_pre: np.ndarray, tcw_pre: np.ndarray,
    Rcw_post: np.ndarray, tcw_post: np.ndarray,
    image_names: Optional[Sequence[str]] = None,
) -> Tuple[float, float]:
    """Per-image overlays + global mean pre/post (averaged over images,
    lvba_system.cpp:1830-1833). images entries may be None (blank canvas)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    uv_pre, ok_pre = project_observations(cam, Rcw_pre, tcw_pre, X_pre,
                                          obs_cam, obs_pt)
    uv_post, ok_post = project_observations(cam, Rcw_post, tcw_post, X_post,
                                            obs_cam, obs_pt)
    g_pre = []
    g_post = []
    for k in range(len(images)):
        sel = obs_cam == k
        if not np.any(sel):
            continue
        img = images[k]
        if img is None:
            img = np.full((cam.height, cam.width, 3), 230, dtype=np.uint8)
        name = image_names[k] if image_names else f"vis_{k:08d}.png"
        over, m_pre, m_post = draw_reprojection_overlay(
            img, obs_uv[sel], uv_pre[sel], ok_pre[sel], uv_post[sel], ok_post[sel],
            header=f"img={k}",
        )
        imwrite_png(out_dir / name, over)
        if m_pre >= 0:
            g_pre.append(m_pre)
        if m_post >= 0:
            g_post.append(m_post)
    return (
        float(np.mean(g_pre)) if g_pre else -1.0,
        float(np.mean(g_post)) if g_post else -1.0,
    )


def save_track_feature_images(
    out_dir,
    cam: CameraModel,
    images: Sequence[Optional[np.ndarray]],
    keypoints: Sequence[np.ndarray],
    used_mask: Sequence[np.ndarray],
    image_names: Optional[Sequence[str]] = None,
):
    """All keypoints red, tracked inliers green (saveTrackFeaturesOnImages,
    lvba_system.cpp:1340-1420)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for k in range(len(keypoints)):
        img = images[k]
        if img is None:
            img = np.full((cam.height, cam.width, 3), 230, dtype=np.uint8)
        cv = Canvas(img)
        kps = keypoints[k]
        used = np.asarray(used_mask[k], bool)[:, None]
        cv.marks(("dot", 2), np.round(kps[:, :2]).astype(int),
                 np.where(used, (0, 255, 0), (0, 0, 255)))
        text = f"sift={kps.shape[0]} track={int(np.sum(used_mask[k]))}"
        cv.text(text, (12, 24), 0.6, (255, 255, 255), 2)
        cv.text(text, (12, 24), 0.6, (0, 0, 0), 1)
        name = image_names[k] if image_names else f"{k}.png"
        imwrite_png(out_dir / name, cv.finish())


def undistort_images(cam: CameraModel, images, device="cuda"):
    """The images (M, H, W, 3) BGR uint8 (a stack or a tensor) undistorted
    with the same-intrinsics rectify map in one undistort launch on
    `device` (the card by default: resolve_device raises where there is
    none; its plain version with device="cpu"): a uint8 tensor on
    `device`."""
    import torch

    from ..kernels.undistort import undistort

    dev = resolve_device(device)
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.ascontiguousarray(np.stack(images)))
    return undistort(images.to(dev).contiguous(), cam)


def undistort_image(cam: CameraModel, img: np.ndarray,
                    device="cuda") -> np.ndarray:
    """Undistort with the same-intrinsics rectify map
    (DatasetIO::undistortImage, dataset_io.cpp:15-26): cv2's
    initUndistortRectifyMap + remap(INTER_LINEAR) bit for bit, on
    `device` (as undistort_images)."""
    return undistort_images(cam, img[None], device)[0].cpu().numpy()


def draw_matches(
    img1: np.ndarray, img2: np.ndarray,
    kps1: np.ndarray, kps2: np.ndarray,
    matches: np.ndarray,
    path=None,
) -> np.ndarray:
    """Side-by-side match visualization (drawAndSaveMatchesGPU,
    lvba_system.cpp:1880-1920): random colors, dot + dot + line; written
    as a JPEG when `path` is given."""
    H = max(img1.shape[0], img2.shape[0])
    W = img1.shape[1] + img2.shape[1]
    canvas = np.full((H, W, 3), 20, dtype=np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1] :] = img2
    cv = Canvas(canvas)
    rng = np.random.default_rng(12345)
    off = img1.shape[1]
    for i1, i2 in matches:
        col = tuple(int(c) for c in rng.integers(64, 255, 3))
        p1 = tuple(np.round(kps1[i1][:2]).astype(int))
        p2 = tuple(np.round(kps2[i2][:2]).astype(int) + [off, 0])
        cv.dot(p1, 3, col)
        cv.dot(p2, 3, col)
        cv.line(p1, p2, col)
    canvas = cv.finish()
    if path is not None:
        imwrite_jpeg(path, canvas)
    return canvas
