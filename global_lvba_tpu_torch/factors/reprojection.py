"""Whitened distorted reprojection and point-to-plane residuals (port of
global_lvba_tpu.factors.reprojection, plain torch).

Residual semantics follow the reference Ceres functors
(include/utils.hpp:51-147):

  * reprojection: world -> camera by (Rcw, tcw); if Z <= 1e-8 the residual
    is identically zero (utils.hpp:78); otherwise Brown-Conrady projection,
    whitened by sigma_px per axis;
  * point-to-plane: r = sqrt((nᵀX + d)² + 1e-12) / sigma (utils.hpp:134-139).

The Jacobians are written out in closed form (reproj_jacobians_expanded);
forward-mode autodiff through torch.func.jacfwd (_reproj_jacobians_jacfwd)
is kept as the oracle the closed form is tested against.  The pose tangent
is the right-multiplicative SO(3) increment R <- R·Exp(δθ) of every solver
here.  A point behind the camera, or a pad slot (R = 0, t = 0, so Z = 0),
gives exactly zero residual and zero Jacobian rows.
"""

from __future__ import annotations

import torch

from ..geometry.camera import CameraModel, distort_normalized
from ..geometry.so3 import exp_so3


def reproj_residual(cam: CameraModel, R: torch.Tensor, t: torch.Tensor,
                    X: torch.Tensor, uv: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """Whitened residual (..., 2) of world points X (..., 3) observed at uv
    (..., 2) through world->camera poses R (..., 3, 3), t (..., 3)."""
    Xc = (R * X[..., None, :]).sum(-1) + t
    Z = Xc[..., 2]
    ok = Z > 1e-8
    z_safe = torch.where(ok, Z, torch.ones_like(Z))
    xyd = distort_normalized(cam, Xc[..., 0:2] / z_safe[..., None])
    u = cam.fx * xyd[..., 0] + cam.cx
    v = cam.fy * xyd[..., 1] + cam.cy
    r = torch.stack([(u - uv[..., 0]) / sigma, (v - uv[..., 1]) / sigma], -1)
    return torch.where(ok[..., None], r, torch.zeros_like(r))


def reproj_residuals_batch(cam, R_all, t_all, X_all, obs_cam, obs_pt, obs_uv,
                           sigma):
    """Residuals (O, 2) of all observations: camera obs_cam, point obs_pt."""
    return reproj_residual(cam, R_all[obs_cam], t_all[obs_cam], X_all[obs_pt],
                           obs_uv, sigma)


def _reproj_jacobians_jacfwd(cam, R, t, X, uv, sigma):
    """(r (N, 2), Jc (N, 2, 6), Jp (N, 2, 3)) by forward-mode autodiff of
    the residual at the local increment (δθ, δt, δX) = 0, vmapped over the
    observations: the oracle of the closed form."""
    zero3 = torch.zeros(3, dtype=R.dtype, device=R.device)

    def one(R_, t_, X_, uv_):
        def f(dth, dt_, dX):
            return reproj_residual(cam, R_ @ exp_so3(dth), t_ + dt_, X_ + dX,
                                   uv_, sigma)

        Jth, Jt, Jx = torch.func.jacfwd(f, argnums=(0, 1, 2))(zero3, zero3,
                                                              zero3)
        return f(zero3, zero3, zero3), torch.cat([Jth, Jt], -1), Jx

    return torch.func.vmap(one)(R, t, X, uv)


def reproj_jacobians_expanded(cam, R, t, X, uv, sigma):
    """Residuals and CLOSED-FORM Jacobians on per-observation inputs
    R (N, 3, 3), t (N, 3), X (N, 3), uv (N, 2): (r (N, 2), Jc (N, 2, 6),
    Jp (N, 2, 3)).

      Xc   = R X + t,      d Xc = [R(-[X]x) | I | R] (dθ, dt, dX)
      xy   = Xc_{0:2}/Z,   dxy/dXc = 1/Z [[1,0,-x],[0,1,-y]]
      dist = Brown-Conrady, J_d (2,2) symmetric
      pix  = f * dist + c, whitened by sigma

    so with G = diag(f)/sigma · J_d · dxy/dXc (2, 3) and GR = G R:
    Jt = G, Jp = GR, Jθ row a = X × GR_a.  The Z <= 1e-8 gate multiplies r
    and every Jacobian row by zero.  The batched 3x3 products are
    broadcast multiplies and sums (a batched matmul of this shape runs as
    many tiny cuBLAS products)."""
    Xc = (R * X[..., None, :]).sum(-1) + t
    Z = Xc[..., 2]
    ok = Z > 1e-8
    zs = torch.where(ok, Z, torch.ones_like(Z))
    x = Xc[..., 0] / zs
    y = Xc[..., 1] / zs
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    u = cam.fx * xd + cam.cx
    v = cam.fy * yd + cam.cy
    okf = ok.to(R.dtype)
    r = torch.stack([(u - uv[..., 0]) / sigma,
                     (v - uv[..., 1]) / sigma], -1) * okf[..., None]

    a = 2.0 * (cam.k1 + 2.0 * cam.k2 * r2)
    dxdx = radial + x * x * a + 2.0 * cam.p1 * y + 6.0 * cam.p2 * x
    dxdy = x * y * a + 2.0 * cam.p1 * x + 2.0 * cam.p2 * y
    dydy = radial + y * y * a + 6.0 * cam.p1 * y + 2.0 * cam.p2 * x
    c0 = okf * cam.fx / (sigma * zs)
    c1 = okf * cam.fy / (sigma * zs)
    G = torch.stack([
        torch.stack([c0 * dxdx, c0 * dxdy, -c0 * (dxdx * x + dxdy * y)], -1),
        torch.stack([c1 * dxdy, c1 * dydy, -c1 * (dxdy * x + dydy * y)], -1),
    ], -2)                                              # (N, 2, 3)
    GR = (G[..., :, :, None] * R[..., None, :, :]).sum(-2)   # (N, 2, 3) = Jp
    Jth = torch.linalg.cross(X[..., None, :].expand_as(GR), GR, dim=-1)
    return r, torch.cat([Jth, G], -1), GR


def reproj_jacobians_batch(cam, R_all, t_all, X_all, obs_cam, obs_pt, obs_uv,
                           sigma):
    """reproj_jacobians_expanded over observations given by index."""
    return reproj_jacobians_expanded(cam, R_all[obs_cam], t_all[obs_cam],
                                     X_all[obs_pt], obs_uv, sigma)


def plane_point_residual(n, d, X, sigma):
    """r = sqrt((nᵀX + d)² + 1e-12)/σ (utils.hpp:134-139), batched over the
    leading axes."""
    e = -((n * X).sum(-1) + d)
    return torch.sqrt(e * e + 1e-12) / sigma


def plane_point_batch(n_all, d_all, X_all, sigma):
    """Residuals (P,) and their Jacobians (P, 3) with respect to X:
    dr/dX = -n · e / (σ · sqrt(e² + 1e-12)), e = -(nᵀX + d)."""
    e = -((n_all * X_all).sum(-1) + d_all)
    s = torch.sqrt(e * e + 1e-12)
    return s / sigma, n_all * (-(e / (s * sigma)))[:, None]
