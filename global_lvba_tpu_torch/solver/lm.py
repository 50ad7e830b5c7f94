"""Levenberg-Marquardt driver for the LiDAR plane-eigen BA (port of
global_lvba_tpu.solver.lm, the dense-Gram loop on aligned and bucketed
factor arrays).

Replicates BALM2::damping_iter (include/BALM/bavoxel.hpp:662-767):
  * Nielsen damping: u = 0.01, v = 2; on acceptance
    u *= max(1/3, 1 - (2q-1)^3), v = 2; on rejection u *= v, v *= 2;
  * at most `max_iters` outer iterations;
  * AVG_THR convention: residuals and the model decrease are averaged over
    the factor count (bavoxel.hpp:634-635, 730-732);
  * convergence freezes the state when |r1 - r2| / r1 < 1e-6
    (bavoxel.hpp:759-761);
  * free gauge: no pose is fixed, the damping regularizes.
One factor evaluation per iteration, at the trial point.  As in the
reference (global_lvba_tpu/solver/lm.py:311-374), the accepted trial
state is selected on the device (torch.where over R, p, residual, g, H)
and the damped solve reads nothing to the host, so each iteration reads
one value back: `converged`.  The JAX loop is a fixed-trip fori_loop
that freezes the state once converged; this loop stops there instead,
which returns the same poses, residual and `iters` and saves the frozen
trips' evaluations.

Where the JAX package leaves the dense-Gram loop — a bucketed solve at
W >= 1024 (its banded probe and split LM) or reduced_solver="cg_mf" (its
matrix-free rows path) — this port raises NotImplementedError (ROADMAP
A3) and never substitutes the dense loop.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..factors.plane_eigen import (
    AlignedPlaneFactorArrays, PlaneFactorArrays, buckets_frame_table,
    plane_cost_grad_hess_buckets)
from ..geometry.se3 import boxplus_pose
from .dist_solve import solve_damped_cg

# CG trips of the damped solve in the LM loop (solver/lm.py:316-325 of the
# JAX package: twice the measured convergence at W = 512)
LIDAR_CG_ITERS = 48
# the JAX package engages its banded probe on bucketed solves from here
# (solver/lm.py:245)
BANDED_MIN_W = 1024


class LMResult(NamedTuple):
    R: torch.Tensor
    p: torch.Tensor
    iters: int
    residual: torch.Tensor


def _total_cgh(buckets, table, R, p, W):
    """(resid, g (6W,), H (6W, 6W)) over all buckets: one evaluation
    (plane_cost_grad_hess_buckets) through the solve's frame table."""
    resid, g, H = plane_cost_grad_hess_buckets(buckets, R, p, W, table)
    return resid, g.reshape(W * 6), H.reshape(W * 6, W * 6)


def _nielsen_update(res1, res2, q1, u, v, rel_tol):
    """Nielsen trust-region bookkeeping (bavoxel.hpp:744-761): acceptance,
    damping update, convergence."""
    q = res1 - res2
    accept = q > 0
    qr = q / torch.where(q1 == 0, torch.ones_like(q1), q1)
    u_acc = u * torch.clamp(1.0 - (2.0 * qr - 1.0) ** 3, min=1.0 / 3.0)
    u_new = torch.where(accept, u_acc, u * v)
    v_new = torch.where(accept, torch.full_like(v, 2.0), 2.0 * v)
    converged = (res1 - res2).abs() / torch.where(
        res1 == 0, torch.ones_like(res1), res1.abs()) < rel_tol
    return accept, u_new, v_new, converged


def _solve_damped(H, g, u, refine: bool = True):
    """Solve (H + u * diag(H)) dx = -g by LU with one refinement step.
    Frames with no factor observations have exactly-zero rows; the epsilon
    pins them (dx = 0) instead of letting the LU NaN-poison the step."""
    d = torch.diagonal(H)
    eps = 1e-12 * (1.0 + torch.max(d.abs()))
    A = H + torch.diag(u * d + eps)
    # lu_factor_ex: no error check, so no read to the host on the card
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    rhs = -g[:, None]
    dx = torch.linalg.lu_solve(LU, piv, rhs)
    if refine:
        r = rhs - A @ dx
        dx = dx + torch.linalg.lu_solve(LU, piv, r)
    return dx[:, 0]


def lm_damping_iter(
    buckets: Sequence,
    R0: torch.Tensor,
    p0: torch.Tensor,
    max_iters: int = 10,
    u_init: float = 0.01,
    v_init: float = 2.0,
    rel_tol: float = 1e-6,
    reduced_solver: str = "auto",
) -> LMResult:
    """Damped LM over plane-eigen factor arrays (aligned and/or bucketed,
    as buckets_to_device gives them).

    reduced_solver: "lu" (dense LU), "cg" (block-Jacobi PCG, 48 trips) or
    "auto" (CG once 6W >= 1536, else LU).  A bucketed solve builds one
    frame table over all its buckets once (buckets_frame_table) for all
    its evaluations: it reads the buckets' ids to the host there, before
    the first evaluation, and then nothing but one `converged` per
    iteration."""
    kinds = (AlignedPlaneFactorArrays, PlaneFactorArrays)
    if not all(isinstance(fa, kinds) for fa in buckets):
        raise TypeError("buckets must be AlignedPlaneFactorArrays or "
                        "PlaneFactorArrays")
    W = R0.shape[0]
    aligned = any(isinstance(fa, AlignedPlaneFactorArrays) for fa in buckets)
    if reduced_solver == "cg_mf":
        raise NotImplementedError(
            "reduced_solver='cg_mf' (the matrix-free rows path) is not "
            "ported: ROADMAP A3")
    if not aligned and W >= BANDED_MIN_W:
        raise NotImplementedError(
            f"a bucketed solve at W={W} >= {BANDED_MIN_W} takes the banded "
            f"Hessian / split LM in the JAX package, not ported: ROADMAP A3")
    solver = reduced_solver
    if solver == "auto":
        solver = "cg" if 6 * W >= 1536 else "lu"
    if solver not in ("lu", "cg"):
        raise ValueError(f"unknown reduced_solver {reduced_solver!r}")
    g_size = float(max(sum(int(fa.n.shape[0]) for fa in buckets), 1))
    table = (buckets_frame_table(buckets, W) if any(
        isinstance(fa, PlaneFactorArrays) for fa in buckets) else None)

    def cgh(R, p):
        r, g, H = _total_cgh(buckets, table, R, p, W)
        return r / g_size, g, H

    R, p = R0, p0
    res1, g, H = cgh(R, p)
    u = torch.full((), u_init, dtype=R0.dtype, device=R0.device)
    v = torch.full((), v_init, dtype=R0.dtype, device=R0.device)
    it = 0
    for _ in range(max_iters):
        if solver == "cg":
            dx = solve_damped_cg(H, g, u, max_iters=LIDAR_CG_ITERS)
        else:
            dx = _solve_damped(H, g, u)
        R_t, p_t = boxplus_pose(R, p, dx.reshape(W, 6))
        d = torch.diagonal(H)
        q1 = 0.5 * torch.dot(dx, u * d * dx - g) / g_size
        res2, g_t, H_t = cgh(R_t, p_t)
        accept, u, v, converged = _nielsen_update(res1, res2, q1, u, v, rel_tol)
        R, p, res1, g, H = (torch.where(accept, new, old) for new, old in (
            (R_t, R), (p_t, p), (res2, res1), (g_t, g), (H_t, H)))
        it += 1
        if bool(converged):
            break
    return LMResult(R=R, p=p, iters=it, residual=res1)
