"""Block-Jacobi preconditioned CG for the damped reduced system (port of
global_lvba_tpu.solver.dist_solve, single device: the closed-form block
inverses, the shared PCG loop and solve_damped_cg).

The JAX loop is a fixed-trip fori_loop that freezes its state once
converged; here the loop stops at convergence instead, which returns the
same iterate (the frozen trips change nothing).
"""

from __future__ import annotations

import torch


def _inv3_batched(A: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 3x3 blocks via the adjugate, each
    block normalized by its max |entry| first (tiny damped blocks would
    otherwise underflow the f32 cofactors); inv(s·A') = inv(A')/s."""
    s = torch.amax(A.abs(), dim=(-2, -1), keepdim=True)
    s = torch.where(s == 0, torch.ones_like(s), s)
    A = A / s
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    inv_det = 1.0 / torch.where(det == 0, torch.full_like(det, 1e-30), det)
    r0 = torch.stack([c00, a02 * a21 - a01 * a22, a01 * a12 - a02 * a11], -1)
    r1 = torch.stack([c01, a00 * a22 - a02 * a20, a02 * a10 - a00 * a12], -1)
    r2 = torch.stack([c02, a01 * a20 - a00 * a21, a00 * a11 - a01 * a10], -1)
    return torch.stack([r0, r1, r2], -2) * (inv_det[..., None, None] / s)


def inv_blocks_6x6(D: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched SPD 6x6 blocks by the 2x2-of-3x3
    Schur complement."""
    A = D[..., :3, :3]
    B = D[..., :3, 3:]
    C = D[..., 3:, :3]
    E = D[..., 3:, 3:]
    Ai = _inv3_batched(A)
    CAi = C @ Ai
    S = E - CAi @ B
    Si = _inv3_batched(S)
    AiB = Ai @ B
    TL = Ai + AiB @ (Si @ CAi)
    TR = -(AiB @ Si)
    BL = -(Si @ CAi)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _block_jacobi_inv_damped(A: torch.Tensor, damp: torch.Tensor,
                             bsize: int) -> torch.Tensor:
    """Inverses of the bsize x bsize diagonal blocks of A + diag(damp);
    the damping is added to the extracted blocks, never to A."""
    n = A.shape[0]
    W = n // bsize
    idx = torch.arange(W, device=A.device)
    diag = A.reshape(W, bsize, W, bsize)[idx, :, idx, :]        # (W, b, b)
    eye = torch.eye(bsize, dtype=A.dtype, device=A.device)
    diag = diag + damp.reshape(W, bsize)[:, :, None] * eye
    diag = diag + 1e-30 * eye
    if bsize == 6:
        return inv_blocks_6x6(diag)
    return torch.linalg.inv(diag)


def _pcg(matvec, precond, b: torch.Tensor, max_iters: int, tol: float):
    """Preconditioned CG from x = 0; stops once ||r||/||b|| < tol (the JAX
    loop's done-masked freeze returns the same iterate)."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    b2 = torch.clamp(torch.dot(b, b), min=torch.finfo(b.dtype).tiny)
    for _ in range(max_iters):
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rz / torch.where(denom == 0, torch.ones_like(denom), denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_n = torch.dot(r, z)
        beta = rz_n / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_n
        if bool(torch.dot(r, r) / b2 < tol * tol):
            break
    return x


def solve_damped_cg(
    H: torch.Tensor,
    g: torch.Tensor,
    u: torch.Tensor,
    bsize: int = 6,
    max_iters: int = 256,
    tol: float = 1e-10,
) -> torch.Tensor:
    """Solve (H + u * diag(H)) dx = -g by block-Jacobi preconditioned CG."""
    d = torch.diagonal(H)
    # same epsilon as the LU solve (solver/lm.py): pins exactly-zero rows
    eps = 1e-12 * (1.0 + torch.max(d.abs()))
    damp = u * d + eps

    def matvec(x):
        return H @ x + damp * x

    Minv = _block_jacobi_inv_damped(H, damp, bsize)

    def precond(r):
        W = r.shape[0] // bsize
        return torch.einsum("wab,wb->wa", Minv, r.reshape(W, bsize)).reshape(-1)

    return _pcg(matvec, precond, -g, max_iters, tol)
