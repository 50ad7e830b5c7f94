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
