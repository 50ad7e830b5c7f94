"""Brown-Conrady pinhole camera model (k1, k2, p1, p2), batched (port of
global_lvba_tpu.geometry.camera, plain torch).

Where the reference returns `bool` per point, these return
(value, valid_mask) so they vectorize over any leading shape.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class CameraModel(NamedTuple):
    """Intrinsics + distortion. Mirrors lvba::CameraIntrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 0
    height: int = 0

    def scaled(self, s: float) -> "CameraModel":
        """Intrinsics scaled by a resize factor."""
        return self._replace(
            fx=self.fx * s,
            fy=self.fy * s,
            cx=self.cx * s,
            cy=self.cy * s,
            width=int(round(self.width * s)),
            height=int(round(self.height * s)),
        )


def distort_normalized(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    """Apply Brown-Conrady distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r4
    x_tan = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    y_tan = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([x * radial + x_tan, y * radial + y_tan], dim=-1)


def project_cam_to_pixel(
    cam: CameraModel, Xc: torch.Tensor, z_min: float = 1e-12
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera-frame points (..., 3) -> pixel (..., 2), depth, valid
    (invalid when Z <= z_min or the pixel is not finite)."""
    Z = Xc[..., 2]
    valid = Z > z_min
    z_safe = torch.where(valid, Z, torch.ones_like(Z))
    xy = Xc[..., 0:2] / z_safe[..., None]
    xyd = distort_normalized(cam, xy)
    u = cam.fx * xyd[..., 0] + cam.cx
    v = cam.fy * xyd[..., 1] + cam.cy
    uv = torch.stack([u, v], dim=-1)
    valid = valid & torch.isfinite(uv).all(dim=-1)
    return uv, Z, valid


def project_world_to_pixel(cam, Rcw, tcw, Xw, z_min: float = 1e-12):
    """World points through (Rcw, tcw), then the pinhole model."""
    Xc = (Rcw @ Xw[..., None])[..., 0] + tcw
    return project_cam_to_pixel(cam, Xc, z_min)


def undistort_pixel_to_normalized(
    cam: CameraModel, uv: torch.Tensor, iters: int = 8
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the distortion by fixed-point iteration (8 iterations)."""
    xd = (uv[..., 0] - cam.cx) / cam.fx
    yd = (uv[..., 1] - cam.cy) / cam.fy
    xu, yu = xd, yd
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        r4 = r2 * r2
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r4
        radial = torch.where(radial.abs() < 1e-12,
                             torch.full_like(radial, 1e-12), radial)
        x_tan = 2.0 * cam.p1 * xu * yu + cam.p2 * (r2 + 2.0 * xu * xu)
        y_tan = cam.p1 * (r2 + 2.0 * yu * yu) + 2.0 * cam.p2 * xu * yu
        xu = (xd - x_tan) / radial
        yu = (yd - y_tan) / radial
    out = torch.stack([xu, yu], dim=-1)
    return out, torch.isfinite(out).all(dim=-1)


def back_project_pixel_depth(
    cam: CameraModel, uv: torch.Tensor, depth: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel + metric depth -> camera-frame 3D point."""
    xy, valid = undistort_pixel_to_normalized(cam, uv)
    Xc = torch.cat([xy * depth[..., None], depth[..., None]], dim=-1)
    valid = valid & (depth > 0) & torch.isfinite(Xc).all(dim=-1)
    return Xc, valid


def cam_to_world(Xc, Rcw, tcw):
    """Camera-frame -> world given the world->camera pose."""
    Rwc = Rcw.transpose(-1, -2)
    return (Rwc @ (Xc - tcw)[..., None])[..., 0]


def fetch_depth_bilinear(
    depth_img: torch.Tensor, uv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear depth lookup in depth_img (H, W) at uv (..., 2); invalid
    when out of bounds or when any of the four texels is <= 0."""
    H, W = depth_img.shape
    u, v = uv[..., 0], uv[..., 1]
    inb = (u >= 0) & (v >= 0) & (u < W - 1) & (v < H - 1)
    x = torch.floor(u).to(torch.int64).clamp(0, W - 2)
    y = torch.floor(v).to(torch.int64).clamp(0, H - 2)
    du = u - x
    dv = v - y
    d00 = depth_img[y, x]
    d10 = depth_img[y, x + 1]
    d01 = depth_img[y + 1, x]
    d11 = depth_img[y + 1, x + 1]
    pos = (d00 > 0) & (d10 > 0) & (d01 > 0) & (d11 > 0)
    d = ((1 - du) * (1 - dv) * d00 + du * (1 - dv) * d10
         + (1 - du) * dv * d01 + du * dv * d11)
    return d, inb & pos & (d > 0)
