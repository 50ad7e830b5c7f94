"""Closed-form symmetric 3x3 eigensolve (port of global_lvba_tpu.ops.eigh3):
the batched-matrix form eigh3x3 and the structure-of-arrays form
eigvals3_soa / eigh3_soa.

In the SoA form each argument is a batched plane of one matrix component; everything is
elementwise: the analytic trigonometric eigenvalues plus Cayley-Hamilton
eigenvectors.  Eigenvalues ascend (Eigen's convention).  These are the
plain versions of the eigensolve the CUDA aggregation kernel fuses
(csrc/soa_common.cuh), and its branch choices are the same.
"""

from __future__ import annotations

import math

import torch


def _eigenvalues3(A: torch.Tensor) -> torch.Tensor:
    """Analytic eigenvalues of symmetric (..., 3, 3), ascending (..., 3)."""
    lams = eigvals3_soa(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                        A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    return torch.stack(lams, dim=-1)


def _maxnorm_column(M: torch.Tensor):
    """The column of (..., 3, 3) with the largest norm (the first on a
    tie), and that norm."""
    norms = torch.linalg.norm(M, dim=-2)                       # (..., 3)
    idx = torch.argmax(norms, dim=-1, keepdim=True)
    col = torch.take_along_dim(M, idx[..., None, :], dim=-1)[..., 0]
    return col, torch.take_along_dim(norms, idx, dim=-1)[..., 0]


def _any_orthonormal(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to the unit v: the basis vector least
    aligned with v, orthogonalized."""
    idx = torch.argmin(v.abs(), dim=-1)
    e = torch.eye(3, dtype=v.dtype, device=v.device)[idx]
    u = e - (e * v).sum(-1, keepdim=True) * v
    n = torch.linalg.norm(u, dim=-1, keepdim=True)
    return u / torch.where(n < 1e-30, torch.ones_like(n), n)


def eigh3x3(A: torch.Tensor):
    """Batched closed-form eigh of symmetric (..., 3, 3) matrices -> (lams
    (..., 3) ascending, U (..., 3, 3) with the eigenvectors as columns,
    orthonormal and right-handed): the analytic eigenvalues of the
    max-|entry|-scaled matrix, v2 and v0 the max-norm columns of the
    Cayley-Hamilton products, v1 = v2 × v0."""
    scale = torch.clamp(A.abs().amax(dim=(-2, -1)), min=1e-30)
    As = A / scale[..., None, None]
    As = 0.5 * (As + As.transpose(-1, -2))
    lams = _eigenvalues3(As)
    lam0, lam1, lam2 = lams[..., 0], lams[..., 1], lams[..., 2]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    spread = torch.clamp(lam2 - lam0, min=1e-30)
    # v2 (largest eigenvalue): columns of (A - lam0 I)(A - lam1 I)
    M2 = (As - lam0[..., None, None] * eye) @ (As - lam1[..., None, None] * eye)
    v2, n2 = _maxnorm_column(M2)
    degenerate = (spread < 1e-7) | (n2 < 1e-12)
    v2 = torch.where(degenerate[..., None], eye[:, 2].expand(v2.shape), v2)
    v2 = v2 / torch.linalg.norm(v2, dim=-1, keepdim=True)
    # v0 (smallest): columns of (A - lam1 I)(A - lam2 I); a degenerate
    # lam0 ≈ lam1 collapses the product, so any vector orthogonal to v2
    M0 = (As - lam1[..., None, None] * eye) @ (As - lam2[..., None, None] * eye)
    v0, n0 = _maxnorm_column(M0)
    bad0 = n0 < 1e-12 * torch.clamp(spread, min=1.0)
    v0 = torch.where(bad0[..., None], _any_orthonormal(v2), v0)
    v0 = v0 - (v0 * v2).sum(-1, keepdim=True) * v2
    n0b = torch.linalg.norm(v0, dim=-1, keepdim=True)
    tiny = n0b < 1e-20
    v0 = torch.where(tiny, _any_orthonormal(v2),
                     v0 / torch.where(tiny, torch.ones_like(n0b), n0b))
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    return lams * scale[..., None], torch.stack([v0, v1, v2], dim=-1)


def eigh3x3_reference(A: torch.Tensor):
    """torch.linalg.eigh with eigh3x3's output convention (for testing)."""
    return torch.linalg.eigh(A)


def eigvals3_soa(a00, a01, a02, a11, a12, a22):
    """Analytic eigenvalues from the 6 unique components -> (lam0, lam1, lam2)."""
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    near_scalar = p < 1e-30
    p_safe = torch.where(near_scalar, torch.ones_like(p), p)
    b00, b11, b22 = d0 / p_safe, d1 / p_safe, d2 / p_safe
    b01, b02, b12 = a01 / p_safe, a02 / p_safe, a12 / p_safe
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam2 = q + 2.0 * p * torch.cos(phi)
    lam0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam1 = 3.0 * q - lam2 - lam0
    lam0 = torch.where(near_scalar, q, lam0)
    lam1 = torch.where(near_scalar, q, lam1)
    lam2 = torch.where(near_scalar, q, lam2)
    return lam0, lam1, lam2


def _sym_prod_cols(a00, a01, a02, a11, a12, a22,
                   b00, b01, b02, b11, b12, b22):
    """The 9 entries of C = A @ B for symmetric A, B."""
    c00 = a00 * b00 + a01 * b01 + a02 * b02
    c01 = a00 * b01 + a01 * b11 + a02 * b12
    c02 = a00 * b02 + a01 * b12 + a02 * b22
    c10 = a01 * b00 + a11 * b01 + a12 * b02
    c11 = a01 * b01 + a11 * b11 + a12 * b12
    c12 = a01 * b02 + a11 * b12 + a12 * b22
    c20 = a02 * b00 + a12 * b01 + a22 * b02
    c21 = a02 * b01 + a12 * b11 + a22 * b12
    c22 = a02 * b02 + a12 * b12 + a22 * b22
    return c00, c01, c02, c10, c11, c12, c20, c21, c22


def _pick_max_col(c00, c01, c02, c10, c11, c12, c20, c21, c22):
    """Column of largest norm -> (x, y, z, norm); ties go to the lower column."""
    n0 = c00 * c00 + c10 * c10 + c20 * c20
    n1 = c01 * c01 + c11 * c11 + c21 * c21
    n2 = c02 * c02 + c12 * c12 + c22 * c22
    use1 = (n1 >= n0) & (n1 >= n2)
    use2 = (n2 > n0) & (n2 > n1) & ~use1
    x = torch.where(use1, c01, torch.where(use2, c02, c00))
    y = torch.where(use1, c11, torch.where(use2, c12, c10))
    z = torch.where(use1, c21, torch.where(use2, c22, c20))
    n = torch.sqrt(torch.where(use1, n1, torch.where(use2, n2, n0)))
    return x, y, z, n


def eigh3_soa(a00, a01, a02, a11, a12, a22):
    """Full eigendecomposition -> (lam0, lam1, lam2, v0, v1, v2), each v a
    tuple (x, y, z) of unit eigenvector components, ascending eigenvalues."""
    scale = torch.maximum(
        torch.maximum(torch.maximum(a00.abs(), a11.abs()), a22.abs()),
        torch.maximum(torch.maximum(a01.abs(), a02.abs()), a12.abs()),
    )
    scale = torch.clamp(scale, min=1e-30)
    s00, s01, s02 = a00 / scale, a01 / scale, a02 / scale
    s11, s12, s22 = a11 / scale, a12 / scale, a22 / scale

    lam0, lam1, lam2 = eigvals3_soa(s00, s01, s02, s11, s12, s22)
    spread = torch.clamp(lam2 - lam0, min=1e-30)

    def shifted(lam):
        return s00 - lam, s01, s02, s11 - lam, s12, s22 - lam

    zero = torch.zeros_like(lam0)
    one = torch.ones_like(lam0)

    # v2: max-norm column of (A - lam0 I)(A - lam1 I)
    C = _sym_prod_cols(*shifted(lam0), *shifted(lam1))
    v2x, v2y, v2z, n2 = _pick_max_col(*C)
    degen = (spread < 1e-7) | (n2 < 1e-12)
    v2x = torch.where(degen, zero, v2x)
    v2y = torch.where(degen, zero, v2y)
    v2z = torch.where(degen, one, v2z)
    inv = 1.0 / torch.sqrt(v2x * v2x + v2y * v2y + v2z * v2z)
    v2x, v2y, v2z = v2x * inv, v2y * inv, v2z * inv

    # v0: max-norm column of (A - lam1 I)(A - lam2 I); fallback orthogonal
    C = _sym_prod_cols(*shifted(lam1), *shifted(lam2))
    v0x, v0y, v0z, n0 = _pick_max_col(*C)
    bad0 = n0 < 1e-12 * torch.clamp(spread, min=1.0)
    # fallback: basis vector least aligned with v2, orthogonalized below
    ax, ay, az = v2x.abs(), v2y.abs(), v2z.abs()
    usey = (ay <= ax) & (ay <= az)
    usez = (az < ax) & (az < ay) & ~usey
    fx = torch.where(usey, zero, torch.where(usez, zero, one))
    fy = torch.where(usey, one, zero)
    fz = torch.where(usez, one, zero)
    v0x = torch.where(bad0, fx, v0x)
    v0y = torch.where(bad0, fy, v0y)
    v0z = torch.where(bad0, fz, v0z)
    d = v0x * v2x + v0y * v2y + v0z * v2z
    v0x, v0y, v0z = v0x - d * v2x, v0y - d * v2y, v0z - d * v2z
    nn = torch.sqrt(v0x * v0x + v0y * v0y + v0z * v0z)
    tiny = nn < 1e-20
    nn_safe = torch.where(tiny, one, nn)
    v0x = torch.where(tiny, fx, v0x / nn_safe)
    v0y = torch.where(tiny, fy, v0y / nn_safe)
    v0z = torch.where(tiny, fz, v0z / nn_safe)

    # v1 = v2 x v0
    v1x = v2y * v0z - v2z * v0y
    v1y = v2z * v0x - v2x * v0z
    v1z = v2x * v0y - v2y * v0x

    return (
        lam0 * scale, lam1 * scale, lam2 * scale,
        (v0x, v0y, v0z), (v1x, v1y, v1z), (v2x, v2y, v2z),
    )
