"""SO(3) operations, batched (port of global_lvba_tpu.geometry.so3).

Rodrigues exponential and trace-based logarithm (reference
tools.hpp:62-112) as branch-free batched torch ops with Taylor guards.
All functions accept arbitrary leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-10


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of v: hat(v) @ x == cross(v, x).  (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map. (..., 3) -> (..., 3, 3).

    R = I + sinc(|w|) * hat(w) + cosc(|w|) * hat(w)^2

    NaN-free under autograd at w == 0: the sqrt in |w| is fed a safe value
    on the Taylor branch, and the series depends only on |w|²."""
    t2 = torch.sum(w * w, dim=-1)
    small = t2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(theta)) / t2_safe
    )
    K = hat(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse of exp_so3. (..., 3, 3) -> (..., 3).

    Antisymmetric part for the axis and acos(trace) for the angle
    (tools.hpp:98-103); angles near pi take the symmetric-part fallback."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    theta = torch.acos(cos_theta)
    K = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    near_zero = torch.abs(theta) < 1e-4
    near_pi = theta > math.pi - 1e-3
    ones = torch.ones_like(theta)
    scale = torch.where(
        near_zero,
        0.5 + theta * theta / 12.0,
        0.5 * theta / torch.where(torch.abs(sin_theta) < _EPS, ones, sin_theta),
    )
    w_generic = scale[..., None] * K

    # near pi: a_i^2 = (R_ii - cos) / (1 - cos); signs from the symmetric
    # off-diagonals s_ij = (1-cos) a_i a_j, overall sign from K
    one_minus_cos = torch.where(near_pi, 1.0 - cos_theta, ones)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    a2 = torch.clamp((diag - cos_theta[..., None]) / one_minus_cos[..., None], 0.0, 1.0)
    a_abs = torch.sqrt(a2)
    s01 = 0.5 * (R[..., 0, 1] + R[..., 1, 0])
    s02 = 0.5 * (R[..., 0, 2] + R[..., 2, 0])
    s12 = 0.5 * (R[..., 1, 2] + R[..., 2, 1])
    idx = torch.argmax(a_abs, dim=-1)
    sx = torch.where(idx == 0, ones, torch.where(idx == 1, torch.sign(s01), torch.sign(s02)))
    sy = torch.where(idx == 0, torch.sign(s01), torch.where(idx == 1, ones, torch.sign(s12)))
    sz = torch.where(idx == 0, torch.sign(s02), torch.where(idx == 1, torch.sign(s12), ones))
    sx = torch.where(sx == 0, ones, sx)
    sy = torch.where(sy == 0, ones, sy)
    sz = torch.where(sz == 0, ones, sz)
    axis = a_abs * torch.stack([sx, sy, sz], dim=-1)
    flip = torch.sum(axis * K, dim=-1) < 0
    axis = torch.where(flip[..., None], -axis, axis)
    w_pi = axis * theta[..., None]

    return torch.where(near_pi[..., None], w_pi, w_generic)


def jr(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3) (tools.hpp:114-128). (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.norm(w, dim=-1)
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(safe) / safe)
    axis = w / safe[..., None]
    b = 1.0 - a
    c = torch.where(small, theta / 2.0 - theta ** 3 / 24.0,
                    (1.0 - torch.cos(safe)) / safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    aaT = axis[..., :, None] * axis[..., None, :]
    return (a[..., None, None] * eye + b[..., None, None] * aaT
            - c[..., None, None] * hat(axis))


def jr_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian (tools.hpp:130-145) of the rotation vector w."""
    theta = torch.linalg.norm(w, dim=-1)
    small = theta < 1e-6
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe / 2.0
    ctt = torch.where(small, 1.0 - theta ** 2 / 12.0, half / torch.tan(half))
    axis = w / safe[..., None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    aaT = axis[..., :, None] * axis[..., None, :]
    return (ctt[..., None, None] * eye + (1.0 - ctt)[..., None, None] * aaT
            + (theta / 2.0)[..., None, None] * hat(axis))


def euler_to_rot(roll: torch.Tensor, pitch: torch.Tensor,
                 yaw: torch.Tensor) -> torch.Tensor:
    """Z-Y-X Euler angles -> rotation matrix, R = Rz(yaw) Ry(pitch) Rx(roll)
    (EulerToRot, utils.hpp:448-458), batched."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr,
                        cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr,
                        sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
