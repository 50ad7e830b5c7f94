"""SE(3) pose update over (R, p) pairs (port of global_lvba_tpu.geometry.se3).

Poses are explicit rotation matrices plus translations, the layout of the
reference's IMUST struct (tools.hpp:147-207) minus the IMU fields.
"""

from __future__ import annotations

import torch

from .so3 import exp_so3


def boxplus_pose(R: torch.Tensor, p: torch.Tensor, dx: torch.Tensor):
    """Right-multiplicative pose update used by the LM solver:
    R <- R @ Exp(dx[0:3]);  p <- p + dx[3:6]  (BALM2::damping_iter,
    bavoxel.hpp:723-727)."""
    dR = exp_so3(dx[..., 0:3])
    return R @ dR, p + dx[..., 3:6]


def compose(Ra: torch.Tensor, pa: torch.Tensor, Rb: torch.Tensor,
            pb: torch.Tensor):
    """(Ra, pa) ∘ (Rb, pb): x -> Ra (Rb x + pb) + pa."""
    return Ra @ Rb, (Ra @ pb[..., None])[..., 0] + pa


def inverse(R: torch.Tensor, p: torch.Tensor):
    """(R, p)⁻¹ = (Rᵀ, −Rᵀ p)."""
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ p[..., None])[..., 0]


def relative(Ra: torch.Tensor, pa: torch.Tensor, Rb: torch.Tensor,
             pb: torch.Tensor):
    """T_a⁻¹ ∘ T_b, the pose of b in a's frame (the anchor-relative
    bookkeeping of the reference window BA, lvba_system.cpp:286-288)."""
    Rat = Ra.transpose(-1, -2)
    return Rat @ Rb, (Rat @ (pb - pa)[..., None])[..., 0]


def apply(R: torch.Tensor, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Transform points x (..., 3) by the pose (R, p)."""
    return (R @ x[..., None])[..., 0] + p
