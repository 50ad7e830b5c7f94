"""Plain reference of the LM solve (BALM2::damping_iter,
include/BALM/bavoxel.hpp:662-767) over reference/plane_factor.py.

Nielsen damping (u = 0.01, v = 2; on acceptance u *= max(1/3,
1 − (2q − 1)^3), v = 2; on rejection u *= v, v *= 2), the damped system
(H + u diag(H)) dx = −g solved exactly by LU, the pose update R Exp(dθ),
p + dt, and the stop when |r1 − r2| / r1 < rel_tol.  The residual is
Σ λ0 over the voxels (the average the reference tool divides by changes
no decision).  With the exact Hessian and the exact solve it converges to
the optimum that the program's solve approaches.

Plain torch, imports nothing of the program; `tf32` rounds every
product's operands to TF32 for the control (the damped solve stays a
float32 LU).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import plane_factor as pf


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    K = pf._skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


class RefLM(NamedTuple):
    R: torch.Tensor
    p: torch.Tensor
    iters: int
    cost: float


def lm_solve(m, R0, p0, max_iters: int = 10, rel_tol: float = 1e-6,
             u_init: float = 0.01, v_init: float = 2.0,
             tf32: bool = False) -> RefLM:
    """The LM from (R0, p0) over the map entries m (reference/
    plane_factor.py's tuple), in R0's dtype and device."""
    W = R0.shape[0]
    R, p = R0, p0
    r1, g, H = pf.cost_grad_hess(m, R, p, tf32=tf32)
    u, v = u_init, v_init
    it = 0
    for _ in range(max_iters):
        d = torch.diagonal(H)
        eps = 1e-12 * (1.0 + float(d.abs().max()))
        A = H + torch.diag(u * d + eps)
        dx = torch.linalg.solve(A, -g)
        dxw = dx.reshape(W, 6)
        Rt = R @ exp_so3(dxw[:, :3])
        pt = p + dxw[:, 3:]
        q1 = 0.5 * float(torch.dot(dx, u * d * dx - g))
        r2, g2, H2 = pf.cost_grad_hess(m, Rt, pt, tf32=tf32)
        q = float(r1 - r2)
        conv = abs(q) <= rel_tol * abs(float(r1))
        it += 1
        if q > 0:
            qr = q / q1 if q1 != 0 else 0.0
            u = u * max(1.0 / 3.0, 1.0 - (2.0 * qr - 1.0) ** 3)
            v = 2.0
            R, p, r1, g, H = Rt, pt, r2, g2, H2
        else:
            u, v = u * v, 2.0 * v
        if conv:
            break
    return RefLM(R=R, p=p, iters=it, cost=float(r1))
