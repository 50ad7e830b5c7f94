"""Synthetic scenes for tests and benchmarks (the port's own copy of
the plane-scene, corridor, joint LiDAR-visual and textured-render parts of
global_lvba_tpu.models.synthetic, numpy, with the port's camera model, and
the JAX bench's visual solver problems).

The reference repo ships no tests and no benchmark data (SURVEY.md §4/§6);
ground-truth validation therefore runs on generated scenes: a room of
planes observed from a smooth trajectory, with known poses, so BA accuracy
(pose recovery / ATE) is checkable exactly.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np


@dataclasses.dataclass
class PlaneScene:
    points_body: np.ndarray   # (N, 3) f32 — per-point body-frame coords
    frame_ids: np.ndarray     # (N,) i32
    R_true: np.ndarray        # (W, 3, 3) f64
    p_true: np.ndarray        # (W, 3) f64
    planes_n: np.ndarray      # (P, 3) plane unit normals
    planes_d: np.ndarray      # (P,) plane offsets (n·x + d = 0)
    times: np.ndarray         # (W,) f64 frame timestamps


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def _small_rotation(rng, scale):
    w = rng.normal(scale=scale, size=3)
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def make_plane_scene(
    num_frames: int = 10,
    points_per_frame: int = 2000,
    num_planes: int = 6,
    extent: float = 8.0,
    noise: float = 0.005,
    traj_radius: float = 2.0,
    seed: int = 0,
    dt: float = 0.1,
) -> PlaneScene:
    """A box-room of planes scanned from a circular arc trajectory."""
    rng = np.random.default_rng(seed)
    e = extent / 2.0
    # 6 axis-aligned walls of a box, plus extra tilted planes if requested
    normals = [
        np.array([1.0, 0, 0]), np.array([-1.0, 0, 0]),
        np.array([0, 1.0, 0]), np.array([0, -1.0, 0]),
        np.array([0, 0, 1.0]), np.array([0, 0, -1.0]),
    ]
    offsets = [e, e, e, e, e, e]
    for _ in range(max(0, num_planes - 6)):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        normals.append(n)
        offsets.append(rng.uniform(1.0, e))
    normals = np.stack(normals[:num_planes])
    offsets = np.array(offsets[:num_planes])

    R_true = np.zeros((num_frames, 3, 3))
    p_true = np.zeros((num_frames, 3))
    for i in range(num_frames):
        ang = 0.15 * i
        R_true[i] = _rot_z(ang) @ _small_rotation(rng, 0.02)
        p_true[i] = np.array(
            [traj_radius * np.cos(ang) - traj_radius, traj_radius * np.sin(ang), 0.05 * np.sin(0.5 * i)]
        )

    pts_body = []
    fids = []
    per_plane = points_per_frame // num_planes
    for i in range(num_frames):
        pw_all = []
        for pi in range(num_planes):
            n = normals[pi]
            d = offsets[pi]
            # orthonormal basis of the plane
            a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
            t1 = np.cross(n, a); t1 /= np.linalg.norm(t1)
            t2 = np.cross(n, t1)
            uv = rng.uniform(-e, e, size=(per_plane, 2))
            X = (-d) * n[None, :] + uv[:, 0:1] * t1[None, :] + uv[:, 1:2] * t2[None, :]
            pw_all.append(X)
        pw = np.concatenate(pw_all)
        pb = (R_true[i].T @ (pw - p_true[i]).T).T
        pb += rng.normal(scale=noise, size=pb.shape)
        pts_body.append(pb.astype(np.float32))
        fids.append(np.full(pb.shape[0], i, dtype=np.int32))

    return PlaneScene(
        points_body=np.concatenate(pts_body),
        frame_ids=np.concatenate(fids),
        R_true=R_true,
        p_true=p_true,
        planes_n=normals,
        planes_d=offsets,
        times=np.arange(num_frames, dtype=np.float64) * dt,
    )


def make_corridor_scene(
    num_frames: int = 512,
    points_per_frame: int = 2000,
    speed: float = 0.12,
    sensor_range: float = 3.0,
    width: float = 3.0,
    height: float = 2.5,
    noise: float = 0.005,
    seed: int = 0,
    dt: float = 0.1,
) -> PlaneScene:
    """A long corridor scanned by a forward-moving trajectory.

    Each frame only sees the corridor walls/floor/ceiling within
    `sensor_range` of its position, so a voxel is observed by just the
    ~2*sensor_range/speed nearby frames: SPARSE factor coupling
    (K ≪ W), the opposite regime from make_plane_scene's box room where
    every frame couples with every other.  This is the regime of real
    long trajectories; the density gate sends it to the bucketed layout.

    Transverse "bulkhead" planes (door frames / pillars) every
    `bulkhead_every` meters constrain the along-corridor direction —
    without them x-translation is a per-frame gauge freedom and BA
    diverges.  The same numpy random stream as the JAX package's copy, so
    a seed gives the same scene in both."""
    rng = np.random.default_rng(seed)
    bulkhead_every = 2.0
    # 4 corridor planes: walls y = ±width/2, floor z = 0, ceiling z = height
    normals = np.array([
        [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
    ])
    offsets = np.array([-width / 2.0, -width / 2.0, 0.0, height])

    R_true = np.zeros((num_frames, 3, 3))
    p_true = np.zeros((num_frames, 3))
    for i in range(num_frames):
        R_true[i] = _rot_z(0.02 * np.sin(0.11 * i)) @ _small_rotation(rng, 0.01)
        p_true[i] = np.array([
            speed * i, 0.25 * np.sin(0.05 * i), 1.2 + 0.05 * np.sin(0.3 * i)
        ])

    pts_body = []
    fids = []
    per_plane = points_per_frame // 5
    for i in range(num_frames):
        x0 = p_true[i][0]
        xs = rng.uniform(x0 - sensor_range, x0 + sensor_range,
                         size=(4, per_plane))
        pw_all = [
            np.stack([xs[0], np.full(per_plane, width / 2.0),
                      rng.uniform(0, height, per_plane)], axis=1),
            np.stack([xs[1], np.full(per_plane, -width / 2.0),
                      rng.uniform(0, height, per_plane)], axis=1),
            np.stack([xs[2], rng.uniform(-width / 2, width / 2, per_plane),
                      np.zeros(per_plane)], axis=1),
            np.stack([xs[3], rng.uniform(-width / 2, width / 2, per_plane),
                      np.full(per_plane, height)], axis=1),
        ]
        # bulkheads within range: transverse planes spanning the full
        # cross-section (partition walls with doorways, shelving faces)
        b_lo = int(np.ceil((x0 - sensor_range) / bulkhead_every))
        b_hi = int(np.floor((x0 + sensor_range) / bulkhead_every))
        bxs = [b * bulkhead_every for b in range(b_lo, b_hi + 1)]
        if bxs:
            nb = max(1, per_plane // len(bxs))
            for bx in bxs:
                yy = rng.uniform(-width / 2, width / 2, nb)
                zz = rng.uniform(0, height, nb)
                pw_all.append(np.stack([np.full(nb, bx), yy, zz], axis=1))
        pw = np.concatenate(pw_all)
        pb = (R_true[i].T @ (pw - p_true[i]).T).T
        pb += rng.normal(scale=noise, size=pb.shape)
        pts_body.append(pb.astype(np.float32))
        fids.append(np.full(pb.shape[0], i, dtype=np.int32))

    return PlaneScene(
        points_body=np.concatenate(pts_body),
        frame_ids=np.concatenate(fids),
        R_true=R_true,
        p_true=p_true,
        planes_n=normals,
        planes_d=offsets,
        times=np.arange(num_frames, dtype=np.float64) * dt,
    )


def perturb_poses(
    R: np.ndarray, p: np.ndarray, rot_scale: float, trans_scale: float, seed: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply random right-multiplicative rotation + translation noise."""
    rng = np.random.default_rng(seed)
    W = R.shape[0]
    R_out = np.array(R, copy=True)
    p_out = np.array(p, copy=True)
    for i in range(W):
        R_out[i] = R[i] @ _small_rotation(rng, rot_scale)
        p_out[i] = p[i] + rng.normal(scale=trans_scale, size=3)
    return R_out, p_out


def perturb_poses_drift(
    R: np.ndarray, p: np.ndarray, rot_rate: float, trans_rate: float,
    seed: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Odometry-style accumulated drift: each step's relative pose gets a
    small random error that integrates along the trajectory (frame-i error
    grows ~ sqrt(i)), the error model of LIVO odometry input, where global
    BA must remove low-frequency drift rather than i.i.d. jitter
    (perturb_poses)."""
    rng = np.random.default_rng(seed)
    W = R.shape[0]
    R_out = np.array(R, copy=True)
    p_out = np.array(p, copy=True)
    for i in range(1, W):
        R_rel = R[i - 1].T @ R[i]
        p_rel = R[i - 1].T @ (p[i] - p[i - 1])
        R_rel = R_rel @ _small_rotation(rng, rot_rate)
        p_rel = p_rel + rng.normal(scale=trans_rate, size=3)
        R_out[i] = R_out[i - 1] @ R_rel
        p_out[i] = p_out[i - 1] + R_out[i - 1] @ p_rel
    return R_out, p_out


def ate_rmse(p_est: np.ndarray, p_ref: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional SE(3) (Umeyama) alignment."""
    a = np.asarray(p_est, dtype=np.float64)
    b = np.asarray(p_ref, dtype=np.float64)
    if align:
        ca, cb = a.mean(0), b.mean(0)
        A, B = a - ca, b - cb
        U, _, Vt = np.linalg.svd(A.T @ B)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        Rali = (U @ S @ Vt).T
        a = (Rali @ A.T).T + cb
        b = B + cb
    return float(np.sqrt(np.mean(np.sum((a - b) ** 2, axis=1))))


# ---------------------------------------------------------------------------
# Joint LiDAR-visual scene
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JointScene:
    lidar: PlaneScene
    cam: "object"                 # geometry.camera.CameraModel
    image_times: np.ndarray       # (M,)
    image_frame: np.ndarray       # (M,) lidar frame index per image
    keypoints: list               # per image (K_i, 2) float32 pixel coords
    matches: dict                 # {(i, j): (m, 2) int32}
    kp_landmark: list             # per image (K_i,) landmark id (ground truth)
    landmarks: np.ndarray         # (L, 3) world feature points
    Rci: np.ndarray               # camera <- body rotation
    tci: np.ndarray


def make_joint_scene(
    num_frames: int = 30,
    points_per_frame: int = 12000,
    num_landmarks: int = 1500,
    image_stride: int = 1,
    px_noise: float = 0.3,
    cam=None,
    seed: int = 0,
    pair_window: int = 10,
    lidar_noise: float = 0.004,
) -> JointScene:
    """LiDAR plane scene plus camera observations of plane-borne landmarks.

    Cameras sit on the body with a forward-looking extrinsic (z_cam =
    x_body); landmarks are sampled on the scene planes, projected into
    every image, perturbed by px_noise, and matched between image pairs
    within `pair_window`: the reference's input (COLMAP-verified matches
    and per-frame LiDAR clouds)."""
    import torch

    from ..geometry.camera import CameraModel, project_cam_to_pixel

    rng = np.random.default_rng(seed + 100)
    scene = make_plane_scene(
        num_frames=num_frames, points_per_frame=points_per_frame,
        noise=lidar_noise, seed=seed,
    )
    if cam is None:
        # wide FOV (~±47°) so wall-borne landmarks stay visible across frames
        cam = CameraModel(
            fx=110.0, fy=110.0, cx=120.0, cy=96.0,
            k1=-0.05, k2=0.08, p1=-0.001, p2=0.0005, width=240, height=192,
        )
    Rci = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    tci = np.array([0.02, 0.01, -0.01])

    e = 4.0
    L = num_landmarks
    lms = []
    P = scene.planes_n.shape[0]
    for i in range(L):
        k = i % P
        n, d = scene.planes_n[k], scene.planes_d[k]
        a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        t1 = np.cross(n, a); t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        uv = rng.uniform(-e, e, 2)
        lms.append(-d * n + uv[0] * t1 + uv[1] * t2)
    landmarks = np.stack(lms)

    image_frame = np.arange(0, num_frames, image_stride)
    image_times = scene.times[image_frame]
    keypoints = []
    kp_landmark = []
    for fi in image_frame:
        Rcw = Rci @ scene.R_true[fi].T
        tcw = -Rcw @ scene.p_true[fi] + tci
        Xc = (Rcw @ landmarks.T).T + tcw
        uv, Z, valid = project_cam_to_pixel(cam, torch.as_tensor(Xc))
        uv = uv.numpy()
        valid = valid.numpy() & (Z.numpy() > 0.5) & (Z.numpy() < 40.0)
        inb = (
            (uv[:, 0] >= 2) & (uv[:, 0] < cam.width - 2)
            & (uv[:, 1] >= 2) & (uv[:, 1] < cam.height - 2)
        )
        vis = np.flatnonzero(valid & inb)
        perm = rng.permutation(vis.shape[0])
        vis = vis[perm]
        kps = uv[vis] + rng.normal(scale=px_noise, size=(vis.shape[0], 2))
        keypoints.append(kps.astype(np.float32))
        kp_landmark.append(vis.astype(np.int64))

    matches = {}
    M = len(image_frame)
    for i in range(M):
        for j in range(i + 1, min(i + 1 + pair_window, M)):
            li = kp_landmark[i]
            lj = kp_landmark[j]
            common, ia, ja = np.intersect1d(li, lj, return_indices=True)
            if common.shape[0]:
                matches[(i, j)] = np.stack([ia, ja], axis=-1).astype(np.int32)

    return JointScene(
        lidar=scene,
        cam=cam,
        image_times=image_times,
        image_frame=image_frame,
        keypoints=keypoints,
        matches=matches,
        kp_landmark=kp_landmark,
        landmarks=landmarks,
        Rci=Rci,
        tci=tci,
    )


# ---------------------------------------------------------------------------
# The JAX bench's visual solver problems (bench.py:574-684)
# ---------------------------------------------------------------------------


class VisualBenchProblem(NamedTuple):
    cam: "object"            # geometry.camera.CameraModel
    obs_cam: np.ndarray      # (O,) int32
    obs_pt: np.ndarray       # (O,) int32
    obs_uv: np.ndarray       # (O, 2) noisy pixels
    plane_n: np.ndarray      # (P, 3)
    plane_d: np.ndarray      # (P,)
    R_true: np.ndarray       # (M, 3, 3) world->camera
    t_true: np.ndarray       # (M, 3)
    R0: np.ndarray           # perturbed start (camera 0 exact)
    t0: np.ndarray
    X0: np.ndarray           # (P, 3) the true points


def _exp_so3_np(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    K = K / th
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _project_np(cam, Rcw, tcw, X):
    """numpy Brown-Conrady projection of X (O, 3) through (O,) poses."""
    Xc = np.einsum("oij,oj->oi", Rcw, X) + tcw
    Z = Xc[:, 2]
    ok = Z > 1e-8
    z = np.where(ok, Z, 1.0)
    x = Xc[:, 0] / z
    y = Xc[:, 1] / z
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2 * cam.p1 * x * y + cam.p2 * (r2 + 2 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2 * y * y) + 2 * cam.p2 * x * y
    return np.stack([cam.fx * xd + cam.cx, cam.fy * yd + cam.cy], axis=-1), ok


def make_visual_bench_problem(kind: str, num_cams: int = None,
                              seed: int = 0) -> VisualBenchProblem:
    """The JAX bench's visual solver problems, from the same numpy draws:
    "m1000" (bench_visual_m1000: M=1000 cameras, 20k points, 10
    observations a point, 200k in all) and "m200" (bench_visual_m200:
    M=200, 2k points, 20k observations).  Cameras step along x and look
    down z at points 8-12 m away, each point observed by 10 consecutive
    cameras at 0.3 px noise with a z = const plane prior; the start
    perturbs every camera but the first by 0.002 rad and 0.01 m.
    num_cams overrides M (the generator otherwise unchanged)."""
    from ..geometry.camera import CameraModel

    rng = np.random.default_rng(seed)
    M, P, spacing = {"m1000": (1000, 20000, 0.02),
                     "m200": (200, 2000, 0.05)}[kind]
    M = num_cams or M
    k = 10
    cam = CameraModel(fx=400.0, fy=400.0, cx=320.0, cy=240.0,
                      k1=-0.05, k2=0.08, p1=-0.001, p2=0.0005,
                      width=640, height=480)
    Rcw = np.zeros((M, 3, 3))
    tcw = np.zeros((M, 3))
    for m in range(M):
        Rcw[m] = _exp_so3_np(rng.normal(scale=0.05, size=3))
        tcw[m] = [spacing * m, 0.0, 4.0]
    X = rng.uniform(-3, 3, size=(P, 3))
    if kind == "m1000":
        X[:, 0] += rng.uniform(0, 0.02 * M, size=P)
        X[:, 2] = rng.uniform(8, 12, size=P)
        base = rng.integers(0, M - k + 1, size=P)
        obs_pt = np.repeat(np.arange(P, dtype=np.int32), k)
        obs_cam = (base[:, None] + np.arange(k)[None, :]).reshape(-1)
    else:
        X[:, 2] = rng.uniform(8, 12, size=P)
        base = np.array([rng.integers(0, M - k + 1) for _ in range(P)])
        obs_pt = np.repeat(np.arange(P, dtype=np.int32), k)
        obs_cam = (base[:, None] + np.arange(k)[None, :]).reshape(-1)
    obs_cam = obs_cam.astype(np.int32)
    uv, _ = _project_np(cam, Rcw[obs_cam], tcw[obs_cam], X[obs_pt])
    obs_uv = uv + rng.normal(scale=0.3, size=uv.shape)
    pn = np.tile(np.array([[0.0, 0.0, 1.0]]), (P, 1))
    pd = -X[:, 2].copy()
    Rp = Rcw.copy()
    tp = tcw.copy()
    for m in range(1, M):
        Rp[m] = Rcw[m] @ _exp_so3_np(rng.normal(scale=0.002, size=3))
        tp[m] = tcw[m] + rng.normal(scale=0.01, size=3)
    return VisualBenchProblem(cam, obs_cam, obs_pt.astype(np.int32), obs_uv,
                              pn, pd, Rcw, tcw, Rp, tp, X)


# ---------------------------------------------------------------------------
# Textured ray-cast rendering (the SIFT frontend's fixture)
# ---------------------------------------------------------------------------
# Each pixel ray-casts the scene's planes through the full distorted camera
# model and samples a multi-octave value-noise texture at the world hit
# point: high-entropy imagery whose geometry is known exactly.  torch
# float64 on any device, with the same 32-bit lattice hash as the JAX
# package's copy (kept in int64, masked to 32 bits), so a seed gives the
# same image in both.

_MASK32 = 0xFFFFFFFF


def _hash01(ix, iy, iz, seed):
    """Deterministic lattice hash -> [0, 1) (uint32 wrap-around math on
    int64 tensors; int64 wrap keeps the low 32 bits)."""
    import torch

    n = (ix * 374761393 + iy * 668265263 + iz * 2246822519
         + (seed * 974711 & _MASK32)) & _MASK32
    n = ((n ^ (n >> 13)) * 1274126177) & _MASK32
    return ((n ^ (n >> 16)) & 0xFFFFFF).to(torch.float32) / float(1 << 24)


def _value_noise(X, scale, seed):
    """Smooth trilinear value noise over an integer lattice at `scale`."""
    import torch

    Xs = X * scale
    i0 = torch.floor(Xs)
    f = (Xs - i0).to(torch.float32)
    f = f * f * (3.0 - 2.0 * f)                       # smoothstep
    iu = i0.to(torch.int64) & _MASK32
    acc = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    for dx in (0, 1):
        wx = f[..., 0] if dx else 1.0 - f[..., 0]
        for dy in (0, 1):
            wy = f[..., 1] if dy else 1.0 - f[..., 1]
            for dz in (0, 1):
                wz = f[..., 2] if dz else 1.0 - f[..., 2]
                h = _hash01((iu[..., 0] + dx) & _MASK32,
                            (iu[..., 1] + dy) & _MASK32,
                            (iu[..., 2] + dz) & _MASK32, seed)
                acc += wx * wy * wz * h
    return acc


def _multi_octave_noise(X, octaves, base_scale, seed):
    import torch

    acc = torch.zeros(X.shape[:-1], dtype=torch.float32, device=X.device)
    wsum = 0.0
    for o in range(octaves):
        w = 0.5 ** o
        acc += w * _value_noise(X, base_scale * (2.0 ** o), seed + o)
        wsum += w
    return acc / wsum


def render_textured_views(
    scene: PlaneScene,
    cam,
    Rcw: np.ndarray,
    tcw: np.ndarray,
    octaves: int = 5,
    base_scale: float = 4.0,
    seed: int = 0,
    return_depth: bool = False,
    device="cpu",
):
    """Ray-cast grayscale renders (M, H, W) float32 in [0, 1] of the
    scene's planes through the distorted camera model `cam` (a
    geometry.camera.CameraModel), computed on `device` a view at a time;
    numpy arrays back.

    Per-pixel rays come from undistort_pixel_to_normalized (float64), so
    rendered keypoints are consistent with the projection model.  With
    return_depth, also returns the (M, H, W) z-depth of each hit."""
    import torch

    from ..geometry.camera import undistort_pixel_to_normalized

    dev = torch.device(device)
    f64 = torch.float64
    H, W = cam.height, cam.width
    vv, uu = torch.meshgrid(torch.arange(H, dtype=f64, device=dev) + 0.5,
                            torch.arange(W, dtype=f64, device=dev) + 0.5,
                            indexing="ij")
    xy, ok = undistort_pixel_to_normalized(
        cam, torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1))
    d_c = torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)
    n = torch.as_tensor(np.asarray(scene.planes_n, np.float64), device=dev)
    d0 = torch.as_tensor(np.asarray(scene.planes_d, np.float64), device=dev)
    M = len(Rcw)
    imgs = np.zeros((M, H, W), np.float32)
    depths = np.zeros((M, H, W), np.float32) if return_depth else None
    for m in range(M):
        R = torch.as_tensor(np.asarray(Rcw[m], np.float64), device=dev)
        t = torch.as_tensor(np.asarray(tcw[m], np.float64), device=dev)
        C = -R.T @ t
        dw = d_c @ R                                   # Rcwᵀ · d_c per pixel
        tt = -(C @ n.T + d0)[None, :] / (dw @ n.T)     # (N, P)
        tt = torch.where(tt > 1e-6, tt, torch.full_like(tt, float("inf")))
        tmin, pi = tt.min(dim=1)
        hit = torch.isfinite(tmin) & ok
        X = C[None, :] + dw * torch.where(hit, tmin, 0.0)[:, None]
        val = _multi_octave_noise(X, octaves, base_scale, seed)
        # mild per-plane albedo so plane borders carry edges too
        shade = 0.75 + 0.25 * ((pi * 2654435761 & _MASK32) % 97).to(
            torch.float32) / 97.0
        img = torch.where(hit, (0.25 + 0.6 * val) * shade,
                          torch.full_like(val, 0.05))
        imgs[m] = img.reshape(H, W).cpu().numpy()
        if return_depth:
            # d_c has unit z: the ray's t is the z-depth
            depths[m] = torch.where(hit, tmin, 0.0).reshape(H, W).to(
                torch.float32).cpu().numpy()
    if return_depth:
        return imgs, depths
    return imgs


def room_views(num_views: int, step: float = 0.125, distance: float = 2.0):
    """make_plane_scene's box room (walls at +-4 m) seen by a camera moving
    sideways along the x = +4 wall at `distance` from it, `step` metres a
    view, looking at it along the body's x axis (camera <- body Rci, the
    z_cam = x_body extrinsic); the height rises and falls by 0.1 m.  A
    point stays in view over about 2 distance tan(26 deg) of the path,
    and the rays to it turn by about step / distance a view: enough
    parallax for track fusion's 8-degree view-angle rule.  Returns (Rci,
    R_wb (M, 3, 3), C (M, 3) body = camera centres, Rcw, tcw)."""
    Rci = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    k = np.arange(num_views, dtype=np.float64)
    C = np.stack([np.full(num_views, 4.0 - distance),
                  (k - (num_views - 1) / 2) * step, 0.1 * np.sin(k / 3)], 1)
    R_wb = np.stack([_rot_z(0.02 * np.sin(kk / 5)) for kk in k])
    Rcw = np.einsum("ab,mcb->mac", Rci, R_wb)
    tcw = -np.einsum("mab,mb->ma", Rcw, C)
    return Rci, R_wb, C, Rcw, tcw


def _gray_to_bgr(gray: np.ndarray) -> np.ndarray:
    """(..., H, W) renders in [0, 1] as BGR uint8 whose channels are three
    different functions of the render (B: the render, G: its square root,
    R: its square)."""
    g = np.clip(gray, 0.0, 1.0)
    return np.round(np.stack([g, np.sqrt(g), g * g], axis=-1) * 255).astype(
        np.uint8)


def write_room_dataset(root, cam, scale: float, num_views: int,
                       num_frames: int, points_per_frame: int, seed: int = 0,
                       bmp_every: int = 8, texture: float = 16.0,
                       settings=None, device="cpu", step: float = 0.125,
                       jpeg_every: int = 0):
    """The box room as a dataset in the reference's layout with no COLMAP
    db, so the system takes the SIFT frontend from the image files:
      * all_pcd_body/<t>.pcd + lidar_poses.txt: make_plane_scene's frames
        (num_frames x points_per_frame, frame i at 0.1 i s) under
        perturbed odometry (perturb_poses 0.004 rad, 0.01 m);
      * all_image/<t>.png + image_poses.txt: num_views renders of the room
        through `cam` (unscaled) from room_views(num_views, step), view k
        at the time of
        frame round(k F / V) + 0.03 s; BGR via _gray_to_bgr, every
        bmp_every-th view a 24-bit BMP, else every jpeg_every-th a
        baseline JPEG (encode_jpeg: quality 95, 4:2:0; 0 writes none);
        the body poses carry the odometry error of their nearest frame,
        as a LIVO system's would;
      * cfg.yaml: the camera at `scale`, the extrinsic Rci of room_views,
        the COLMAP export on, then `settings` ({group: {field: value}}).
    Returns (config path, the BGR images (V, H, W, 3) before encoding (a
    JPEG view reads back within the codec's loss), the scene, the body
    odometry (R, p) of the frames)."""
    import dataclasses
    from pathlib import Path

    import yaml

    from ..config import LvbaConfig
    from ..io.image import encode_jpeg, imwrite_png
    from ..io.pcd import write_pcd
    from ..io.tum import write_tum_poses

    root = Path(root)
    sc = make_plane_scene(num_frames=num_frames,
                          points_per_frame=points_per_frame, seed=seed)
    R_odom, p_odom = perturb_poses(sc.R_true, sc.p_true, 0.004, 0.01,
                                   seed=seed + 1)
    Rci, R_wb, C, Rcw, tcw = room_views(num_views, step)
    frame = np.round(np.arange(num_views) * num_frames / num_views).astype(
        int).clip(0, num_frames - 1)
    times = sc.times[frame] + 0.03
    # the odometry error of each view's nearest frame: T_odom T_true^-1
    dR = np.einsum("mab,mcb->mac", R_odom[frame], sc.R_true[frame])
    dp = p_odom[frame] - np.einsum("mab,mb->ma", dR, sc.p_true[frame])
    R_img = np.einsum("mab,mbc->mac", dR, R_wb)
    p_img = np.einsum("mab,mb->ma", dR, C) + dp
    gray = render_textured_views(sc, cam, Rcw, tcw, base_scale=texture,
                                 device=device)
    bgr = _gray_to_bgr(gray)
    img_dir, pcd_dir = root / "all_image", root / "all_pcd_body"
    img_dir.mkdir(parents=True, exist_ok=True)
    pcd_dir.mkdir(parents=True, exist_ok=True)
    is_bmp = [bool(bmp_every) and k % bmp_every == bmp_every - 1
              for k in range(num_views)]
    is_jpeg = [bool(jpeg_every) and not is_bmp[k]
               and k % jpeg_every == jpeg_every - 1 for k in range(num_views)]
    jpegs = iter(encode_jpeg(bgr[is_jpeg])) if any(is_jpeg) else None
    for k, t in enumerate(times):
        if is_bmp[k]:
            _write_bmp24(img_dir / f"{t:.6f}.bmp", bgr[k])
        elif is_jpeg[k]:
            (img_dir / f"{t:.6f}.jpg").write_bytes(next(jpegs))
        else:
            imwrite_png(img_dir / f"{t:.6f}.png", bgr[k])
    write_tum_poses(img_dir / "image_poses.txt", times, R_img, p_img)
    for i, t in enumerate(sc.times):
        write_pcd(pcd_dir / f"{t:.6f}.pcd", sc.points_body[sc.frame_ids == i])
    write_tum_poses(pcd_dir / "lidar_poses.txt", sc.times, R_odom, p_odom)
    cfg = LvbaConfig()
    cm = cfg.cam_model
    cm.cam_width, cm.cam_height, cm.scale = cam.width, cam.height, scale
    cm.cam_fx, cm.cam_fy, cm.cam_cx, cm.cam_cy = (
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy))
    cm.cam_d0, cm.cam_d1, cm.cam_d2, cm.cam_d3 = (
        float(cam.k1), float(cam.k2), float(cam.p1), float(cam.p2))
    ex = cfg.extrin_calib
    ex.extrinsic_R = [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0]
    ex.extrinsic_T = [0.0, 0.0, 0.0]
    ex.Rcl = [float(v) for v in Rci.reshape(-1)]
    ex.Pcl = [0.0, 0.0, 0.0]
    dc = cfg.data_config
    dc.data_path, dc.colmap_db_path, dc.image_sample_step = str(root), "", 1
    cfg.colmap_output.enable = True
    for group, vals in (settings or {}).items():
        for k, v in vals.items():
            setattr(getattr(cfg, group), k, v)
    path = root / "cfg.yaml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return path, bgr, sc, (R_odom, p_odom)


def _write_bmp24(path, bgr: np.ndarray):
    """A bottom-up 24-bit BMP (BITMAPINFOHEADER, rows padded to 4 bytes)."""
    import struct

    h, w = bgr.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = bgr.reshape(h, -1)
    head = struct.pack("<2sIHHI", b"BM", 54 + rows.size, 0, 0, 54)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, rows.size, 2835,
                      2835, 0, 0)
    with open(path, "wb") as f:
        f.write(head + dib + rows[::-1].tobytes())
