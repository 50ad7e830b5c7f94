"""Point-cluster moment algebra, batched (port of
global_lvba_tpu.map.moments).

A point set is summarized by (N, v = Σx, P = Σxxᵀ) and a rigid transform
acts on the moments in closed form (the reference's PointCluster,
tools.hpp:407-466), so a planar factor costs O(#poses), not O(#points).
Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch


def transform_moments(P: torch.Tensor, v: torch.Tensor, n: torch.Tensor,
                      R: torch.Tensor, p: torch.Tensor):
    """Rigid transform of raw moments (tools.hpp:450-456):
    v' = R v + n p,  P' = R P Rᵀ + (R v) pᵀ + p (R v)ᵀ + n p pᵀ.
    Shapes: P (..., 3, 3), v (..., 3), n (...,), R (..., 3, 3), p (..., 3)."""
    Rv = (R @ v[..., None])[..., 0]
    v_out = Rv + n[..., None] * p
    rp = Rv[..., :, None] * p[..., None, :]
    P_out = (R @ P @ R.transpose(-1, -2) + rp + rp.transpose(-1, -2)
             + n[..., None, None] * (p[..., :, None] * p[..., None, :]))
    return P_out, v_out


def cov_from_moments(P: torch.Tensor, v: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """Covariance P/N − v̄v̄ᵀ (tools.hpp:435-439); n == 0 is guarded."""
    n_safe = torch.where(n > 0, n, torch.ones_like(n))
    vbar = v / n_safe[..., None]
    return (P / n_safe[..., None, None]
            - vbar[..., :, None] * vbar[..., None, :])


def merge_moments(Pc: torch.Tensor, mu: torch.Tensor, n: torch.Tensor):
    """Merge centred per-group stats, counts n (..., K), means mu (..., K, 3)
    and scatters Pc (..., K, 3, 3) about them, into the total (N (...,),
    mean (..., 3), S (..., 3, 3)) by the parallel-axis rule, S the scatter
    about the grand mean (cov = S / N): the stable form that avoids the raw
    moments' P/N − v̄v̄ᵀ cancellation far from the origin."""
    N = n.sum(-1)
    N_safe = torch.where(N > 0, N, torch.ones_like(N))
    mu_tot = (n[..., None] * mu).sum(-2) / N_safe[..., None]
    d = mu - mu_tot[..., None, :]
    S = (Pc + n[..., None, None] * (d[..., :, None] * d[..., None, :])).sum(-3)
    return N, mu_tot, S
