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

The depth PNGs are written and read with zlib and struct from the
standard library, so the depth maps persist where cv2 is not installed;
the files hold the JAX package's pixels (clip(depth * 2000, 0, 65535) as
uint16, 16-bit grayscale) and read back as cv2 reads them.  The image
writers (overlays, track features, matches, undistorted images) import
cv2 inside, as the JAX package does.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from ..geometry.camera import CameraModel

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
DEPTH_SCALE = 2000.0  # depth PNG units per metre (lvba_system.cpp:913)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


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


def _unfilter_row(ft: int, f: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One PNG scanline's bytes from its filtered bytes (filter types 0-4:
    None, Sub, Up, Average, Paeth) and the reconstructed row before it."""
    if ft == 0:
        return f.copy()
    if ft == 2:
        return ((f.astype(np.uint16) + prior) & 0xFF).astype(np.uint8)
    if ft == 1:
        out = np.empty_like(f)
        for j in range(bpp):
            out[j::bpp] = np.cumsum(f[j::bpp], dtype=np.int64) & 0xFF
        return out
    if ft not in (3, 4):
        raise ValueError(f"PNG filter type {ft} is not one of 0-4")
    fl, pl = f.tolist(), prior.tolist()
    c = [0] * len(fl)
    for x in range(len(fl)):
        a = c[x - bpp] if x >= bpp else 0
        b = pl[x]
        if ft == 3:
            c[x] = (fl[x] + ((a + b) >> 1)) & 0xFF
            continue
        cc = pl[x - bpp] if x >= bpp else 0
        pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
        c[x] = (fl[x] + pred) & 0xFF
    return np.asarray(c, dtype=np.uint8)


def load_depth_png(path) -> np.ndarray:
    """A 16-bit grayscale, non-interlaced PNG (save_depth_png's, or cv2's
    with any of the five row filters) as metres."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth_bits, color, _, _, interlace = hdr
    if (depth_bits, color, interlace) != (16, 0, 0):
        raise ValueError(
            f"{path}: bit depth {depth_bits}, color type {color}, interlace "
            f"{interlace}; a 16-bit grayscale non-interlaced PNG is needed")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    rows = raw[:H * (1 + 2 * W)].reshape(H, 1 + 2 * W)
    out = np.empty((H, 2 * W), dtype=np.uint8)
    prior = np.zeros(2 * W, dtype=np.uint8)
    for y in range(H):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, 2)
    img = out.view(">u2").astype(np.uint16)
    return img.astype(np.float32) / DEPTH_SCALE


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
    images: Sequence[np.ndarray],          # per image (H, W, 3) BGR uint8
    Rcw: np.ndarray, tcw: np.ndarray,
    half_w: float = 0.5,
) -> np.ndarray:
    """Merged colored world cloud: per image, z-buffer the ±half_w-window
    LiDAR points and take each pixel's nearest point with its image color
    (VisualizeOptComparison, lvba_system.cpp:2033-2069).

    Returns (N, 6): xyz + rgb (0-255)."""
    H, W = cam.height, cam.width
    out = []
    # world-transform every frame ONCE; per image the ±half_w window is a
    # contiguous slice of the concatenated array (lidar_times sorted) —
    # the old per-image transform+concat was O(M * window) re-work
    F = len(clouds)
    world_all = np.concatenate(
        [(R_body[i] @ clouds[i].T).T + p_body[i] for i in range(F)]
    ).astype(np.float64)
    sizes = np.array([c.shape[0] for c in clouds], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    lt = np.asarray(lidar_times)
    for k in range(len(image_times)):
        lo = int(np.searchsorted(lt, image_times[k] - half_w, side="left"))
        hi = int(np.searchsorted(lt, image_times[k] + half_w, side="right"))
        if hi <= lo:
            continue
        pts_w = world_all[offsets[lo] : offsets[hi]]
        Xc = pts_w @ Rcw[k].T + tcw[k]
        Z = Xc[:, 2]
        ok = Z > 1e-12
        z = np.where(ok, Z, 1.0)
        x, y = Xc[:, 0] / z, Xc[:, 1] / z
        r2 = x * x + y * y
        radial = 1 + cam.k1 * r2 + cam.k2 * r2 * r2
        xd = x * radial + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
        yd = y * radial + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
        # points far outside the FOV can blow `radial` up to inf/NaN —
        # clip before the int cast (UB otherwise) and drop non-finite
        # coordinates; the in-bounds mask below keeps semantics unchanged
        with np.errstate(invalid="ignore"):
            ok &= np.isfinite(xd) & np.isfinite(yd)
            u = np.round(
                np.clip(cam.fx * np.nan_to_num(xd) + cam.cx, -1, W)
            ).astype(np.int64)
            v = np.round(
                np.clip(cam.fy * np.nan_to_num(yd) + cam.cy, -1, H)
            ).astype(np.int64)
        ok &= (u >= 0) & (u < W) & (v >= 0) & (v < H)
        lin = v * W + u
        # per-pixel argmin depth
        order = np.lexsort((Z, np.where(ok, lin, H * W)))
        lin_s = np.where(ok, lin, H * W)[order]
        firsts = np.concatenate([[True], lin_s[1:] != lin_s[:-1]])
        chosen = order[firsts & (lin_s < H * W)]
        img = images[k]
        bgr = img[v[chosen], u[chosen]]
        rgb = bgr[:, ::-1].astype(np.float32)
        out.append(np.concatenate([pts_w[chosen], rgb], axis=1))
    if not out:
        return np.zeros((0, 6), dtype=np.float32)
    return np.concatenate(out).astype(np.float32)


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
    (visualizeProj, lvba_system.cpp:1786-1822). Returns (img, mean_pre,
    mean_post)."""
    import cv2

    img = image.copy()
    sum_pre = sum_post = 0.0
    n_pre = n_post = 0
    for i in range(uv_meas.shape[0]):
        m = tuple(np.round(uv_meas[i]).astype(int))
        cv2.line(img, (m[0] - 5, m[1]), (m[0] + 5, m[1]), (0, 255, 0), 1, cv2.LINE_AA)
        cv2.line(img, (m[0], m[1] - 5), (m[0], m[1] + 5), (0, 255, 0), 1, cv2.LINE_AA)
        if pre_ok[i]:
            c = tuple(np.round(uv_pre[i]).astype(int))
            cv2.circle(img, c, 2, (255, 128, 0), -1, cv2.LINE_AA)
            sum_pre += float(np.linalg.norm(uv_pre[i] - uv_meas[i]))
            n_pre += 1
        if post_ok[i]:
            c = tuple(np.round(uv_post[i]).astype(int))
            cv2.rectangle(img, (c[0] - 1, c[1] - 1), (c[0] + 1, c[1] + 1), (0, 0, 255), -1)
            sum_post += float(np.linalg.norm(uv_post[i] - uv_meas[i]))
            n_post += 1
    mean_pre = sum_pre / n_pre if n_pre else -1.0
    mean_post = sum_post / n_post if n_post else -1.0
    text = f"{header} N={uv_meas.shape[0]} mean_pre={mean_pre:.3f} mean_post={mean_post:.3f}"
    cv2.putText(img, text, (12, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1, cv2.LINE_AA)
    return img, mean_pre, mean_post


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
    import cv2

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
        cv2.imwrite(str(out_dir / name), over)
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
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for k in range(len(keypoints)):
        img = images[k]
        if img is None:
            img = np.full((cam.height, cam.width, 3), 230, dtype=np.uint8)
        else:
            img = img.copy()
        kps = keypoints[k]
        for i in range(kps.shape[0]):
            c = tuple(np.round(kps[i][:2]).astype(int))
            color = (0, 255, 0) if used_mask[k][i] else (0, 0, 255)
            cv2.circle(img, c, 2, color, -1, cv2.LINE_AA)
        text = f"sift={kps.shape[0]} track={int(np.sum(used_mask[k]))}"
        cv2.putText(img, text, (12, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (255, 255, 255), 2, cv2.LINE_AA)
        cv2.putText(img, text, (12, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 0, 0), 1, cv2.LINE_AA)
        name = image_names[k] if image_names else f"{k}.png"
        cv2.imwrite(str(out_dir / name), img)


def undistort_image(cam: CameraModel, img: np.ndarray) -> np.ndarray:
    """Undistort with the same-intrinsics rectify map
    (DatasetIO::undistortImage, dataset_io.cpp:15-26)."""
    import cv2

    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64)
    D = np.array([cam.k1, cam.k2, cam.p1, cam.p2, 0.0], np.float64)
    m1, m2 = cv2.initUndistortRectifyMap(
        K, D, np.eye(3), K, (img.shape[1], img.shape[0]), cv2.CV_16SC2
    )
    return cv2.remap(img, m1, m2, cv2.INTER_LINEAR)


def draw_matches(
    img1: np.ndarray, img2: np.ndarray,
    kps1: np.ndarray, kps2: np.ndarray,
    matches: np.ndarray,
    path=None,
) -> np.ndarray:
    """Side-by-side match visualization (drawAndSaveMatchesGPU,
    lvba_system.cpp:1880-1920): random colors, dot + dot + line."""
    import cv2

    H = max(img1.shape[0], img2.shape[0])
    W = img1.shape[1] + img2.shape[1]
    canvas = np.full((H, W, 3), 20, dtype=np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1] :] = img2
    rng = np.random.default_rng(12345)
    off = img1.shape[1]
    for i1, i2 in matches:
        col = tuple(int(c) for c in rng.integers(64, 255, 3))
        p1 = tuple(np.round(kps1[i1][:2]).astype(int))
        p2 = tuple(np.round(kps2[i2][:2]).astype(int) + [off, 0])
        cv2.circle(canvas, p1, 3, col, -1, cv2.LINE_AA)
        cv2.circle(canvas, p2, 3, col, -1, cv2.LINE_AA)
        cv2.line(canvas, p1, p2, col, 1, cv2.LINE_AA)
    if path is not None:
        cv2.imwrite(str(path), canvas)
    return canvas
