"""Plain reference of the BALM plane factor (BALM2: the cost is each
plane voxel's smallest eigenvalue of its world-frame covariance, summed
over voxels), with its exact gradient and Hessian under the LM's pose
update R <- R Exp(dθ), p <- p + dt (per frame, dx = [dθ, dt]).

Per voxel, from each observing frame's count n, body mean μ and centred
body scatter Pc, at the poses (R, p):
    w = R μ + p,  N = Σ n,  c = Σ n w / N,
    C = (1/N) Σ [R Pc Rᵀ + n (w − c)(w − c)ᵀ],  λ0 <= λ1 <= λ2, u_m.
With r = Rᵀ u0, σ = n u0ᵀ(w − c), e = Pc r + σ μ (Σ over the frame's
points of s x, s = u0ᵀ(y − c)):
    gradient   g_θ = (2/N) e × r,   g_t = (2/N) σ u0;
    Hessian    H = (2/N) blockdiag(D_f) − 2 a aᵀ − Σ_m 2/(λm − λ0) b_m b_mᵀ
  where, per frame (Pr = Pc + n μ μᵀ, [r]× the cross matrix, Q_m =
  u_m u0ᵀ + u0 u_mᵀ, axial(M) = (M23 − M32, M31 − M13, M12 − M21)):
    D_θθ = [r]× Pr [r]×ᵀ + ½ (r eᵀ + e rᵀ) − (rᵀe) I,
    D_θt = (n μ × r) u0ᵀ,   D_tt = n u0 u0ᵀ,
    a    = (1/N) [n μ × r ; n u0],
    b_m  = (1/N) [axial(Pc Rᵀ Q_m R) + n μ × (Rᵀ Q_m (w − c)) ; n Q_m (w − c)].
These follow from d²λ0 = u0ᵀ d²C u0 + 2 Σ_m (u_mᵀ dC u0)² / (λ0 − λm).
λm − λ0 is held above 1e-9 |λ2| (a line-like voxel's λ1 ≈ λ0).

Plain torch on any device and dtype: float64 is the reference; the
control runs it in float32, with `tf32` every product's operands rounded
to TF32 as the tensor cores take them (on any device).  Imports nothing of the program.
"""

from __future__ import annotations

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero): what the tensor cores take of a float32 operand."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def matmul_of(tf32: bool):
    """torch.matmul, or with `tf32` its operands rounded to TF32 first."""
    if not tf32:
        return torch.matmul
    return lambda a, b: torch.matmul(tf32_round(a), tf32_round(b))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _mv(mm, M, v):
    return mm(M, v[..., None])[..., 0]


def voxel_stats(m, R, p, tf32: bool = False):
    """Per-voxel aggregation at poses (R, p): (N (V,), c (V, 3), lam (V,
    3), U (V, 3, 3) columns the eigenvectors, w (E, 3) the entries' world
    means).  m: entries (vox, frame, n, mu, Pc) and the voxel count."""
    vox, frame, n, mu, Pc, V = m
    mm = matmul_of(tf32)
    Rf = R[frame]
    w = _mv(mm, Rf, mu) + p[frame]
    dt = mu.dtype
    N = torch.zeros(V, dtype=dt, device=mu.device).index_add_(0, vox, n)
    c = torch.zeros(V, 3, dtype=dt, device=mu.device).index_add_(
        0, vox, n[:, None] * w) / N[:, None]
    d = w - c[vox]
    S = mm(mm(Rf, Pc), Rf.transpose(-1, -2)) \
        + n[:, None, None] * mm(d[:, :, None], d[:, None, :])
    C = torch.zeros(V, 3, 3, dtype=dt, device=mu.device).index_add_(
        0, vox, S) / N[:, None, None]
    C = 0.5 * (C + C.transpose(-1, -2))
    lam, U = torch.linalg.eigh(C)
    return N, c, lam, U, w


def cost(m, R, p, tf32: bool = False):
    """Σ over voxels of λ0."""
    _, _, lam, _, _ = voxel_stats(m, R, p, tf32)
    return lam[:, 0].sum()


def _entry_terms(m, R, p, hessian: bool, tf32: bool = False):
    vox, frame, n, mu, Pc, V = m
    mm = matmul_of(tf32)
    N, c, lam, U, w = voxel_stats(m, R, p, tf32)
    Rf = R[frame]
    u = U[vox, :, 0]
    r = _mv(mm, Rf.transpose(-1, -2), u)
    wc = w - c[vox]
    sigma = n * (u * wc).sum(-1)
    e = _mv(mm, Pc, r) + sigma[:, None] * mu
    iN = (1.0 / N)[vox]
    g = torch.cat([2.0 * iN[:, None] * _cross(e, r),
                   2.0 * (iN * sigma)[:, None] * u], -1)
    out = dict(lam=lam, g=g, N=N)
    if not hessian:
        return out
    E = n.shape[0]
    dt = mu.dtype
    Pr = Pc + n[:, None, None] * mm(mu[:, :, None], mu[:, None, :])
    K = _skew(r)
    eye = torch.eye(3, dtype=dt, device=mu.device)
    Dqq = mm(mm(K, Pr), K.transpose(-1, -2)) \
        + 0.5 * (mm(r[:, :, None], e[:, None, :])
                 + mm(e[:, :, None], r[:, None, :])) \
        - (r * e).sum(-1)[:, None, None] * eye
    nmr = n[:, None] * _cross(mu, r)
    Dqt = mm(nmr[:, :, None], u[:, None, :])
    Dtt = n[:, None, None] * mm(u[:, :, None], u[:, None, :])
    D = torch.zeros(E, 6, 6, dtype=dt, device=mu.device)
    D[:, :3, :3] = Dqq
    D[:, :3, 3:] = Dqt
    D[:, 3:, :3] = Dqt.transpose(-1, -2)
    D[:, 3:, 3:] = Dtt
    D = 2.0 * iN[:, None, None] * D
    rows = [iN[:, None] * torch.cat([nmr, n[:, None] * u], -1)]
    weights = [torch.full((V,), 2.0, dtype=dt, device=mu.device)]
    scale = torch.clamp(lam[:, 2].abs(), min=1e-30)
    for k in (1, 2):
        um = U[vox, :, k]
        Q = mm(um[:, :, None], u[:, None, :])
        Q = Q + Q.transpose(-1, -2)
        A = mm(mm(Pc, Rf.transpose(-1, -2)), mm(Q, Rf))
        ax = torch.stack([A[:, 1, 2] - A[:, 2, 1], A[:, 2, 0] - A[:, 0, 2],
                          A[:, 0, 1] - A[:, 1, 0]], -1)
        Qwc = _mv(mm, Q, wc)
        rot = ax + n[:, None] * _cross(mu, _mv(mm, Rf.transpose(-1, -2), Qwc))
        rows.append(iN[:, None] * torch.cat([rot, n[:, None] * Qwc], -1))
        gap = torch.maximum(lam[:, k] - lam[:, 0], 1e-9 * scale)
        weights.append(2.0 / gap)
    out.update(D=D, rows=rows, weights=weights)
    return out


def cost_grad(m, R, p, tf32: bool = False):
    """(Σ λ0, g (W, 6))."""
    t = _entry_terms(m, R, p, hessian=False, tf32=tf32)
    W = R.shape[0]
    g = torch.zeros(W, 6, dtype=R.dtype, device=R.device).index_add_(
        0, m[1], t["g"])
    return t["lam"][:, 0].sum(), g


def cost_grad_hess(m, R, p, chunk: int = 1024, tf32: bool = False):
    """(Σ λ0, g (6W,), H (6W, 6W)) with the exact Hessian.  The cross-frame
    part −Σ w_v b bᵀ is formed a block of voxels at a time over the block's
    span of frames (voxels sorted by their first frame)."""
    vox, frame, n, mu, Pc, V = m
    W = R.shape[0]
    dt, dev = R.dtype, R.device
    t = _entry_terms(m, R, p, hessian=True, tf32=tf32)
    g = torch.zeros(W, 6, dtype=dt, device=dev).index_add_(0, frame, t["g"])
    Hd = torch.zeros(W, 6, 6, dtype=dt, device=dev).index_add_(
        0, frame, t["D"])
    H = torch.zeros(W, 6, W, 6, dtype=dt, device=dev)
    idx = torch.arange(W, device=dev)
    H[idx, :, idx, :] = Hd
    H = H.reshape(6 * W, 6 * W)
    # entries are sorted by voxel; a voxel's first entry is its first frame
    first = torch.full((V,), W, dtype=torch.int64, device=dev).scatter_reduce_(
        0, vox, frame, "amin")
    last = torch.full((V,), -1, dtype=torch.int64, device=dev).scatter_reduce_(
        0, vox, frame, "amax")
    order = torch.argsort(first)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(V, device=dev)
    erank = rank[vox]
    eorder = torch.argsort(erank)
    bounds = torch.searchsorted(erank[eorder],
                                torch.arange(0, V + chunk, chunk, device=dev))
    first_s, last_s = first[order].cpu(), last[order].cpu()
    b = bounds.cpu().tolist()
    for k in range(0, V, chunk):
        lo_e, hi_e = b[k // chunk], b[k // chunk + 1]
        if hi_e <= lo_e:
            continue
        ev = eorder[lo_e:hi_e]
        f0 = int(first_s[k:k + chunk].min())
        f1 = int(last_s[k:k + chunk].max()) + 1
        span = f1 - f0
        vloc = erank[ev] - k
        nv = min(chunk, V - k)
        cols = (6 * (frame[ev] - f0))[:, None] + torch.arange(6, device=dev)
        blocks = []
        for row, wt in zip(t["rows"], t["weights"]):
            M = torch.zeros(nv, 6 * span, dtype=dt, device=dev)
            sw = torch.sqrt(wt[vox[ev]])
            M[vloc[:, None], cols] = sw[:, None] * row[ev]
            blocks.append(M)
        M = torch.cat(blocks, 0)
        sl = slice(6 * f0, 6 * f1)
        H[sl, sl] -= matmul_of(tf32)(M.T, M)
    return t["lam"][:, 0].sum(), g.reshape(-1), H
