"""Frozen numpy copies of the port's scene generators
(global_lvba_tpu_torch.models.synthetic: make_plane_scene,
make_corridor_scene, perturb_poses, perturb_poses_drift).

The benchmark generates its traffic from these copies and never from the
program, so a change to the program cannot change what it is measured on.
The same numpy random stream as the originals: a seed gives the same
scene and the same starts bit for bit (tests/test_bench_scenes.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


def make_plane_scene(num_frames: int = 10, points_per_frame: int = 2000,
                     num_planes: int = 6, extent: float = 8.0,
                     noise: float = 0.005, traj_radius: float = 2.0,
                     seed: int = 0, dt: float = 0.1) -> PlaneScene:
    """A box-room of planes scanned from a circular arc trajectory: every
    frame sees every wall, so every pose couples with every other."""
    rng = np.random.default_rng(seed)
    e = extent / 2.0
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
        p_true[i] = np.array([traj_radius * np.cos(ang) - traj_radius,
                              traj_radius * np.sin(ang),
                              0.05 * np.sin(0.5 * i)])

    pts_body = []
    fids = []
    per_plane = points_per_frame // num_planes
    for i in range(num_frames):
        pw_all = []
        for pi in range(num_planes):
            n = normals[pi]
            d = offsets[pi]
            a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
            t1 = np.cross(n, a); t1 /= np.linalg.norm(t1)  # noqa: E702
            t2 = np.cross(n, t1)
            uv = rng.uniform(-e, e, size=(per_plane, 2))
            X = (-d) * n[None, :] + uv[:, 0:1] * t1[None, :] + uv[:, 1:2] * t2[None, :]
            pw_all.append(X)
        pw = np.concatenate(pw_all)
        pb = (R_true[i].T @ (pw - p_true[i]).T).T
        pb += rng.normal(scale=noise, size=pb.shape)
        pts_body.append(pb.astype(np.float32))
        fids.append(np.full(pb.shape[0], i, dtype=np.int32))

    return PlaneScene(points_body=np.concatenate(pts_body),
                      frame_ids=np.concatenate(fids), R_true=R_true,
                      p_true=p_true, planes_n=normals, planes_d=offsets,
                      times=np.arange(num_frames, dtype=np.float64) * dt)


def make_corridor_scene(num_frames: int = 512, points_per_frame: int = 2000,
                        speed: float = 0.12, sensor_range: float = 3.0,
                        width: float = 3.0, height: float = 2.5,
                        noise: float = 0.005, seed: int = 0,
                        dt: float = 0.1) -> PlaneScene:
    """A long corridor scanned by a forward-moving trajectory: each frame
    sees only the walls within `sensor_range`, so a voxel is seen by the
    ~2 sensor_range / speed frames around it and co-visibility is banded.
    Transverse bulkheads every 2 m fix the along-corridor direction."""
    rng = np.random.default_rng(seed)
    bulkhead_every = 2.0
    normals = np.array([
        [0.0, 1.0, 0.0], [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0], [0.0, 0.0, -1.0],
    ])
    offsets = np.array([-width / 2.0, -width / 2.0, 0.0, height])

    R_true = np.zeros((num_frames, 3, 3))
    p_true = np.zeros((num_frames, 3))
    for i in range(num_frames):
        R_true[i] = _rot_z(0.02 * np.sin(0.11 * i)) @ _small_rotation(rng, 0.01)
        p_true[i] = np.array([speed * i, 0.25 * np.sin(0.05 * i),
                              1.2 + 0.05 * np.sin(0.3 * i)])

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

    return PlaneScene(points_body=np.concatenate(pts_body),
                      frame_ids=np.concatenate(fids), R_true=R_true,
                      p_true=p_true, planes_n=normals, planes_d=offsets,
                      times=np.arange(num_frames, dtype=np.float64) * dt)


def perturb_poses(R: np.ndarray, p: np.ndarray, rot_scale: float,
                  trans_scale: float, seed: int = 1
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Right-multiplicative rotation noise and additive translation noise,
    independent per frame."""
    rng = np.random.default_rng(seed)
    W = R.shape[0]
    R_out = np.array(R, copy=True)
    p_out = np.array(p, copy=True)
    for i in range(W):
        R_out[i] = R[i] @ _small_rotation(rng, rot_scale)
        p_out[i] = p[i] + rng.normal(scale=trans_scale, size=3)
    return R_out, p_out


def perturb_poses_drift(R: np.ndarray, p: np.ndarray, rot_rate: float,
                        trans_rate: float, seed: int = 1
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Odometry-style drift: each relative pose gets a small error that
    integrates along the trajectory."""
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


GENERATORS = {"plane": make_plane_scene, "corridor": make_corridor_scene}
PERTURBATIONS = {"iid": perturb_poses, "drift": perturb_poses_drift}
