"""Joint visual BA solver: LM with the Schur complement over landmark
blocks (port of global_lvba_tpu.solver.schur, single device).

The replacement for the reference's Ceres DENSE_SCHUR problem
(src/lvba_system.cpp:1571-1643):

  * parameter blocks: M camera poses (6-dof right-multiplicative tangent;
    camera 0 held fixed, :1582-1583) and P track points (3-dof);
  * residuals: whitened distorted reprojection (sigma_px = 0.5 px) and
    whitened point-to-plane (sigma_plane = 0.01 m), no robust loss;
  * each LM iteration: one residual/Jacobian evaluation at the trial point,
    block-diagonal Hpp inversion, the reduced (6M, 6M) camera system
    solved, landmark back-substitution; Nielsen damping.

Routes (_route; the JAX package's solve_visual_ba:740-850, with the same
conditions and byte budgets, so the same problem takes the same route):

  route   taken when                                    reduced solve
  lu      "lu", or auto with 6M < 1024 and Q <= 2^20    pair-scatter S, LU +
                                                        one refinement
  cg      "cg"                                          pair-scatter S,
                                                        256-trip block CG
  tier    cg_mf (auto: 6M >= 1024 or Q > 2^20), every   point-major 48-trip
          point observed, slot blocks within budget,    CG; observations in
          device loop                                   tier layout all solve
  cg_pm   cg_mf otherwise, tiers within budget          point-major 48-trip CG
  cg_mf   cg_mf otherwise                               per-observation
                                                        256-trip CG
(Q = Σ track_len², the observation pairs.)  The pair scatter runs in
chunks of pair_chunk pairs when Q exceeds it.  Every sum by camera, point
or camera pair is a gather and a fixed-order sum through a table built on
the host once per solve: no atomic scatter, so two solves are bitwise
equal.

The LM loop selects the accepted state on the device and reads one value
back an iteration (done, with the costs); it stops at `done` where the JAX
fused loops replay frozen iterations, which returns the same R, t, X,
iters, cost0 and cost.  device_loop=False (or verbose) runs the JAX
package's host-driven loop, reading the costs each iteration.  The JAX
package's environment switches are module constants here: VISUAL_TIER,
PM_ONEHOT_BUDGET and dist_solve.PM_CG_ITERS.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..factors.reprojection import (
    plane_point_batch, reproj_jacobians_batch, reproj_jacobians_expanded)
from ..geometry.camera import CameraModel
from ..geometry.so3 import exp_so3
from .dist_solve import (
    PMTiers, _expand, _inv3_batched, _segsum, _tier_sum, index_table_np,
    pm_tiers,
    solve_damped_cg, solve_schur_cg_mf, solve_schur_cg_mf_sharded,
    solve_schur_cg_pm, solve_schur_cg_pm_tiers, to_device)
from .lm import _select_
from ..parallel.mesh import Mesh, gather_rows, psum, shard_bounds

log = logging.getLogger("global_lvba_tpu_torch.solver")

# the tier route (LVBA_VISUAL_TIER, schur.py:759) and the byte budget of
# the tier-resident coupling blocks and of the pm route's operands
# (LVBA_PM_ONEHOT_BUDGET, :778, :842)
VISUAL_TIER = True
PM_ONEHOT_BUDGET = 4 << 30


@dataclasses.dataclass
class VisualBAProblem:
    cam: CameraModel
    obs_cam: np.ndarray    # (O,) int32
    obs_pt: np.ndarray     # (O,) int32
    obs_uv: np.ndarray     # (O, 2)
    plane_n: np.ndarray    # (P, 3)
    plane_d: np.ndarray    # (P,)
    num_cams: int
    num_pts: int
    sigma_px: float = 0.5
    sigma_plane: float = 0.01
    use_plane: bool = True
    fix_first: bool = True
    # "lu", "cg" (the assembled reduced system), "cg_mf" (matrix-free) or
    # "auto" (_auto_solver)
    reduced_solver: str = "auto"
    # the pair scatter runs in chunks of this many pairs beyond it
    pair_chunk: int = 1 << 18


class VisualBAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    iters: int
    cost0: float
    cost: float
    route: str = ""     # the route the solve took (module docstring)


def _tier_tables(obs_cam: np.ndarray, obs_pt: np.ndarray, num_cams: int):
    """Host tiering: points grouped by track-length class K in {4, 8, 12,
    16, 24, 32, 48, ...} (pow2 and 1.5·pow2 from 16), each class a padded
    (Pv, K) table.  Returns [(pt (Pv,), idx (Pv, K), cam (Pv, K), mask
    (Pv, K)), ...]: idx indexes the flat observations (pad -> O), cam pads
    to num_cams."""
    O = obs_pt.shape[0]
    order = np.argsort(obs_pt, kind="stable")
    spt = obs_pt[order]
    starts = np.flatnonzero(np.concatenate([[True], spt[1:] != spt[:-1]]))
    counts = np.diff(np.append(starts, O))
    out = []
    c = np.maximum(counts, 1)
    p2 = 1 << np.ceil(np.log2(c)).astype(np.int64)
    k34 = 3 * p2 // 4
    kclass = np.maximum(4, np.where((k34 >= c) & (p2 >= 16), k34, p2))
    for K in np.unique(kclass):
        sel = np.flatnonzero(kclass == K)
        K = int(K)
        pos = starts[sel][:, None] + np.arange(K)[None, :]
        mask = np.arange(K)[None, :] < counts[sel][:, None]
        rows = order[np.minimum(pos, O - 1)]
        idx = np.where(mask, rows, O).astype(np.int32)
        cam = np.where(mask, obs_cam[rows], num_cams).astype(np.int32)
        out.append((spt[starts[sel]].astype(np.int32), idx, cam, mask))
    return out


def _build_pairs(obs_pt: np.ndarray, num_pts: int):
    """All ordered observation pairs sharing a point (host, static)."""
    order = np.argsort(obs_pt, kind="stable")
    spt = obs_pt[order]
    starts = np.flatnonzero(np.concatenate([[True], spt[1:] != spt[:-1]]))
    counts = np.diff(np.append(starts, spt.shape[0]))
    pair_a = []
    pair_b = []
    for k in np.unique(counts):
        sel = counts == k
        s = starts[sel]
        grid = np.arange(k)
        a = (s[:, None, None] + grid[None, :, None]) + np.zeros((1, 1, k), dtype=np.int64)
        b = (s[:, None, None] + grid[None, None, :]) + np.zeros((1, k, 1), dtype=np.int64)
        pair_a.append(a.reshape(-1))
        pair_b.append(b.reshape(-1))
    pair_a = order[np.concatenate(pair_a)] if pair_a else np.zeros(0, np.int64)
    pair_b = order[np.concatenate(pair_b)] if pair_b else np.zeros(0, np.int64)
    return pair_a.astype(np.int32), pair_b.astype(np.int32)


def _pair_cells_np(obs_cam, pair_a, pair_b, M: int, chunk: int):
    """The pair scatter's host plan: per chunk of `chunk` pairs [lo, hi),
    its distinct camera-pair cells a·M + b (NC,) and the (NC, Kq) table of
    the chunk's pairs in each cell (pad hi - lo)."""
    out = []
    for lo in range(0, pair_a.shape[0], chunk):
        hi = min(lo + chunk, pair_a.shape[0])
        cell = (obs_cam[pair_a[lo:hi]].astype(np.int64) * M
                + obs_cam[pair_b[lo:hi]])
        cells, inv = np.unique(cell, return_inverse=True)
        out.append((lo, hi, cells, index_table_np(inv, cells.shape[0])))
    return out


def _auto_solver(M: int, pairs_sharded: bool, Q: int = 0) -> str:
    """The JAX package's auto policy (schur.py:551-569): matrix-free once
    6M >= 1024 or Q > 2^20 on one device, LU below."""
    if not pairs_sharded and (Q > (1 << 20) or M * 6 >= 1024):
        return "cg_mf"
    if M * 6 >= 1024:
        return "cg"
    return "lu"


def _route(prob: VisualBAProblem, dtype: torch.dtype, host_loop: bool,
           sharded: bool = False):
    """(route, the tier tables where the route reads them): the JAX
    package's choice (schur.py:740-850) with its byte budgets.  On a mesh
    (sharded) "auto" takes _auto_solver(pairs_sharded=True) and "cg_mf"
    the per-observation matvec, as the JAX package's mesh path does."""
    solver = prob.reduced_solver
    if solver == "auto":
        counts = np.bincount(np.asarray(prob.obs_pt),
                             minlength=prob.num_pts).astype(np.int64)
        Q = int((counts ** 2).sum())
        solver = _auto_solver(prob.num_cams, pairs_sharded=sharded, Q=Q)
        log.info("[visualBA] auto solver=%s M=%d P=%d O=%d Q=%d maxlen=%d",
                 solver, prob.num_cams, prob.num_pts,
                 int(np.asarray(prob.obs_pt).shape[0]), Q,
                 int(counts.max()) if counts.size else 0)
    if solver in ("lu", "cg"):
        return solver, None
    if solver != "cg_mf":
        raise ValueError(f"unknown reduced_solver {prob.reduced_solver!r}")
    if sharded:
        return "cg_mf", None
    itemsize = torch.empty((), dtype=dtype).element_size()
    tt = _tier_tables(np.asarray(prob.obs_cam, np.int32),
                      np.asarray(prob.obs_pt, np.int32), prob.num_cams)
    if VISUAL_TIER and not host_loop:
        covered = sum(int(pt.shape[0]) for pt, _, _, _ in tt)
        tier_bytes = sum(idx.shape[0] * idx.shape[1] * 2 * 18 * itemsize
                         for _, idx, _, _ in tt)
        if covered == prob.num_pts and tier_bytes <= PM_ONEHOT_BUDGET:
            return "tier", tt
    # the JAX package's one-hot selection matrices (M entries a slot) are
    # charged though the port's pm route gathers instead: the same problem
    # takes the same route in both packages
    oh_itemsize = 2 if dtype == torch.float32 else itemsize
    oh_bytes = sum(idx.shape[0] * idx.shape[1]
                   * (oh_itemsize * prob.num_cams + 2 * 18 * itemsize)
                   for _, idx, _, _ in tt)
    if oh_bytes > PM_ONEHOT_BUDGET:
        log.info("[visualBA] pm operands ~%.1f GB exceed budget; using the "
                 "per-observation matvec", oh_bytes / 2**30)
        return "cg_mf", None
    return "cg_pm", tt


class _LinCache(NamedTuple):
    """The u-independent linearization at one state, kept across rejected
    steps.  Flat routes: point blocks (P, ...), coupling blocks (O, 6, 3);
    the tier route: point blocks in tier point order (Pt, ...), coupling
    blocks by slot (S, 6, 3)."""

    g_c: torch.Tensor    # (M, 6)
    g_p: torch.Tensor    # point gradients
    Hcc: torch.Tensor    # (M, 6, 6) undamped
    Hpp: torch.Tensor    # point blocks, undamped (incl. plane terms)
    Wb: torch.Tensor     # camera-point coupling blocks
    cost: torch.Tensor   # 0.5·||r||² at the linearization point


class _Consts(NamedTuple):
    """A solve's device operands.  Flat routes: obs_cam, obs_pt (O,), uv
    (O, 2), cam_table (M, Kc), pt_table (P, Kp), n, d (P, ...); tier:
    tiers and uv (S, 2), n, d in tier point order."""

    uv: torch.Tensor
    n: torch.Tensor
    d: torch.Tensor
    obs_cam: Optional[torch.Tensor] = None
    obs_pt: Optional[torch.Tensor] = None
    cam_table: Optional[torch.Tensor] = None
    pt_table: Optional[torch.Tensor] = None
    tiers: Optional[PMTiers] = None
    pairs: tuple = ()      # ((lo, hi), cells, table) chunks, pair_a, pair_b


def _outer(A, B):
    """Σ_a A[:, a, :]ᵀ B[:, a, :] per row: (N, 2, m), (N, 2, n) -> (N, m, n).
    This and _matmul3 are broadcast multiplies and sums: a batched matmul
    of these shapes runs as many tiny cuBLAS products."""
    return (A[:, :, :, None] * B[:, :, None, :]).sum(1)


def _matmul3(A, B):
    """A (N, m, 3) @ B (N, 3, 3) per row."""
    return (A[:, :, :, None] * B[:, None, :, :]).sum(2)


def _obs_sums(M, r, Jc, Jp, cam_sum, pt_sum) -> _LinCache:
    """_LinCache of per-observation residuals and Jacobians, summed by
    camera (cam_sum) and by point (pt_sum), without the plane priors."""
    return _LinCache(
        g_c=cam_sum((Jc * r[..., None]).sum(1)),
        g_p=pt_sum((Jp * r[..., None]).sum(1)),
        Hcc=cam_sum(_outer(Jc, Jc).reshape(-1, 36)).view(M, 6, 6),
        Hpp=pt_sum(_outer(Jp, Jp).reshape(-1, 9)).view(-1, 3, 3),
        Wb=_outer(Jc, Jp), cost=0.5 * (r * r).sum())


def _with_plane(prob, cache: _LinCache, X, n, d) -> _LinCache:
    """The cache with the plane priors of the points X added."""
    if not prob.use_plane:
        return cache
    rp, Jx = plane_point_batch(n, d, X, prob.sigma_plane)
    return cache._replace(
        cost=cache.cost + 0.5 * (rp * rp).sum(),
        g_p=cache.g_p + rp[:, None] * Jx,
        Hpp=cache.Hpp + Jx[:, :, None] * Jx[:, None, :])


def _reductions(prob, r, Jc, Jp, cam_sum, pt_sum, X, n, d):
    """_LinCache from per-observation residuals and Jacobians, summed by
    camera (cam_sum) and by point (pt_sum), plus the plane priors."""
    return _with_plane(prob, _obs_sums(prob.num_cams, r, Jc, Jp, cam_sum,
                                       pt_sum), X, n, d)


def _linearize(prob, c: _Consts, R, t, X) -> _LinCache:
    """Residual/Jacobian evaluation and the u-independent sums, per
    observation (the flat routes)."""
    r, Jc, Jp = reproj_jacobians_batch(prob.cam, R, t, X, c.obs_cam,
                                       c.obs_pt, c.uv, prob.sigma_px)
    return _reductions(prob, r, Jc, Jp, lambda z: _segsum(z, c.cam_table),
                       lambda z: _segsum(z, c.pt_table), X, c.n, c.d)


def _linearize_tiers(prob, c: _Consts, R, t, Xt) -> _LinCache:
    """The tier route's evaluation: poses and points gathered by slot (a
    pad slot gets R = 0, t = 0, so its Z-gated residual and Jacobians are
    exactly zero), point sums over each tier's K axis."""
    T = c.tiers
    pose = _expand(torch.cat([R.reshape(-1, 9), t], 1), T.cam)
    r, Jc, Jp = reproj_jacobians_expanded(
        prob.cam, pose[:, :9].reshape(-1, 3, 3), pose[:, 9:], Xt[T.pt], c.uv,
        prob.sigma_px)
    return _reductions(prob, r, Jc, Jp, lambda z: _segsum(z, T.cam_table),
                       lambda z: _tier_sum(z, T.dims), Xt, c.n, c.d)


def _damped_blocks(u, Hcc, Hpp):
    """(dHcc, Hpp⁻¹): multiplicative damping on the block diagonals.
    Cameras outside every track have exactly-zero blocks; the epsilon
    1e-12·(1 + max diag) pins them (their reduced rhs is exactly zero, so
    dc = 0), as Ceres leaves residual-less blocks constant.  Singular
    landmark blocks are guarded by 1e-12."""
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    eye3 = torch.eye(3, dtype=Hcc.dtype, device=Hcc.device)
    dHcc = Hcc + u * eye6 * torch.diagonal(Hcc, dim1=-2, dim2=-1)[..., None, :]
    dcc = torch.diagonal(dHcc, dim1=-2, dim2=-1)
    dHcc = dHcc + eye6 * (1e-12 * (1.0 + torch.max(dcc)))
    dHpp = Hpp + u * eye3 * torch.diagonal(Hpp, dim1=-2, dim2=-1)[..., None, :]
    return dHcc, _inv3_batched(dHpp + 1e-12 * eye3)


def _model_decrease(u, Hcc, g_c, dc, Hpp, g_p, dX):
    """q1 = 0.5 dxᵀ(u D dx − g) over the camera and point system."""
    d_cc = torch.diagonal(Hcc, dim1=-2, dim2=-1)
    d_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    return 0.5 * ((dc * (u * d_cc * dc - g_c)).sum()
                  + (dX * (u * d_pp * dX - g_p)).sum())


def _zero_first(b, fix_first: bool):
    return b.index_fill(0, torch.zeros(1, dtype=torch.long, device=b.device),
                        0.0) if fix_first else b


def _schur_matrix(prob, c: _Consts, W, Y, dHcc):
    """The assembled reduced system (6M, 6M): diag(dHcc) − Σ_pairs
    Y_a W_bᵀ, each camera-pair cell the fixed-order sum of its pairs
    through the chunk's cell table; with fix_first, camera 0's rows and
    columns are the identity's."""
    return _schur_finish(prob, _pair_scatter(prob.num_cams, c.pairs, W, Y),
                         dHcc)


def _pair_scatter(M: int, pairs, W, Y):
    """The camera-pair couplings −Σ_pairs Y_a W_bᵀ (M·M, 36) of one pair
    list: chunk by chunk, each cell the fixed-order sum of its pairs."""
    chunks, pa, pb = pairs
    S = W.new_zeros((M * M, 36))
    for (lo, hi), cells, table in chunks:
        blk = -torch.bmm(Y[pa[lo:hi]], W[pb[lo:hi]].transpose(1, 2))
        S.index_copy_(0, cells, S.index_select(0, cells)
                      + _segsum(blk.reshape(-1, 36), table))
    return S


def _schur_finish(prob, S, dHcc):
    """The reduced system (6M, 6M) from the couplings S (M·M, 36) and the
    damped camera blocks; camera 0 held with fix_first."""
    M = prob.num_cams
    S = S.view(M, M, 6, 6)
    diag = torch.arange(M, device=S.device)
    S[diag, diag] = S[diag, diag] + dHcc
    if prob.fix_first:
        S[0, :] = 0.0
        S[:, 0] = 0.0
        S[0, 0] = torch.eye(6, dtype=S.dtype, device=S.device)
    return S.permute(0, 2, 1, 3).reshape(M * 6, M * 6)


def _solve_cached(prob, route: str, c: _Consts, cache: _LinCache, u):
    """Damped assemble, reduced solve and back-substitution from a cached
    linearization (the flat routes).  Returns (dc (M, 6), dX (P, 3), q1)."""
    M = prob.num_cams
    dHcc, Hpp_inv = _damped_blocks(u, cache.Hcc, cache.Hpp)
    W = cache.Wb
    Y = _matmul3(W, Hpp_inv[c.obs_pt])                         # (O, 6, 3)
    yg = (Y * cache.g_p[c.obs_pt][:, None, :]).sum(-1)
    b = _zero_first(_segsum(yg, c.cam_table) - cache.g_c, prob.fix_first)
    if route == "cg_pm":
        dc = solve_schur_cg_pm(dHcc, W, Y, c.tiers, b,
                               fix_first=prob.fix_first)
    elif route == "cg_mf":
        dc = solve_schur_cg_mf(dHcc, W, Y, c.obs_cam, c.obs_pt, b,
                               prob.num_pts, fix_first=prob.fix_first,
                               tables=(c.cam_table, c.pt_table))
    else:
        A = _schur_matrix(prob, c, W, Y, dHcc)
        rhs = b.reshape(M * 6)
        if route == "cg":
            dc = solve_damped_cg(A, -rhs, A.new_zeros(()))
        else:
            LU, piv, _ = torch.linalg.lu_factor_ex(A)
            dc = torch.linalg.lu_solve(LU, piv, rhs[:, None])
            dc = dc + torch.linalg.lu_solve(LU, piv, rhs[:, None] - A @ dc)
        dc = dc.reshape(M, 6)
    wtdc = (W * dc[c.obs_cam][:, :, None]).sum(1)               # (O, 3)
    rhs_p = -cache.g_p - _segsum(wtdc, c.pt_table)
    dX = (Hpp_inv * rhs_p[:, None, :]).sum(-1)
    return dc, dX, _model_decrease(u, cache.Hcc, cache.g_c, dc, cache.Hpp,
                                   cache.g_p, dX)


def _solve_cached_tiers(prob, c: _Consts, cache: _LinCache, u):
    """_solve_cached on the tier layout: Y by slot, the point-major CG on
    slot-resident blocks, back-substitution summed per tier."""
    T = c.tiers
    dHcc, Hpi = _damped_blocks(u, cache.Hcc, cache.Hpp)
    W = cache.Wb
    Y = _matmul3(W, Hpi[T.pt])                                 # (S, 6, 3)
    yg = (Y * cache.g_p[T.pt][:, None, :]).sum(-1)
    b = _zero_first(_segsum(yg, T.cam_table) - cache.g_c, prob.fix_first)
    dc = solve_schur_cg_pm_tiers(dHcc, W, Y, T, b, fix_first=prob.fix_first)
    wtdc = (W * _expand(dc, T.cam)[:, :, None]).sum(1)         # (S, 3)
    rhs_p = -cache.g_p - _tier_sum(wtdc, T.dims)
    dX = (Hpi * rhs_p[:, None, :]).sum(-1)
    return dc, dX, _model_decrease(u, cache.Hcc, cache.g_c, dc, cache.Hpp,
                                   cache.g_p, dX)


def _nielsen_visual(c_prev, c_new, q1, u, v, rel_tol):
    """Visual-LM Nielsen bookkeeping (clipped gain ratio and the damping
    stall guard), on the device: (accept, u_new, v_new, converged,
    stalled)."""
    q = c_prev - c_new
    accept = q > 0
    qr = torch.clamp(q / torch.clamp(q1, min=1e-30), -1e3, 1e3)
    u_acc = u * torch.clamp(1.0 - (2.0 * qr - 1.0) ** 3, min=1.0 / 3.0)
    u_new = torch.where(accept, u_acc, u * v)
    v_new = torch.where(accept, torch.full_like(v, 2.0), 2.0 * v)
    conv = accept & (q.abs() / torch.clamp(c_prev, min=1e-30) < rel_tol)
    stall = (~accept) & (u_new > 1e12)
    return accept, u_new, v_new, conv, stall


class VisualPlan(NamedTuple):
    """A solve's route with its device operands built (plan_visual):
    lin(R, t, X) -> _LinCache, solve(cache, u) -> (dc, dX, q1) on the
    route's point order; X0 in that order; points(X) -> (P, 3)."""

    route: str
    consts: _Consts
    lin: Callable
    solve: Callable
    R0: torch.Tensor
    t0: torch.Tensor
    X0: torch.Tensor
    points: Callable
    host_loop: bool
    verbose: bool


def plan_visual(prob: VisualBAProblem, R0, t0, X0, dtype=None,
                device="cuda", device_loop: bool = True,
                verbose: bool = False, mesh=None,
                shard_axis: str = "factors") -> VisualPlan:
    """The solve's route and its operands on `device`, built once: the
    host tables (by camera, point, tier slot or camera pair) and every
    array copied to the device.  All of a solve's reads to the host happen
    here.  With `mesh` (a parallel.mesh.Mesh) the observations and pairs
    are sharded over `shard_axis` and the plan lives on the mesh's devices
    (_plan_sharded; `device` is not read)."""
    if mesh is not None:
        return _plan_sharded(prob, R0, t0, X0, dtype, device_loop, verbose,
                             mesh, shard_axis)
    dev = resolve_device(device)
    dtype = torch.float32 if dtype is None else dtype
    host_loop = not device_loop or verbose
    route, tt = _route(prob, dtype, host_loop)

    def fl(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    R, t = fl(R0), fl(t0)
    X = fl(X0)
    obs_cam = np.asarray(prob.obs_cam).astype(np.int64)
    obs_pt = np.asarray(prob.obs_pt).astype(np.int64)
    M, P = prob.num_cams, prob.num_pts
    n_all = np.asarray(prob.plane_n, np.float64)
    d_all = np.asarray(prob.plane_d, np.float64)
    if route == "tier":
        tiers = pm_tiers(tt, M, dev)
        pts = np.concatenate([pt for pt, _, _, _ in tt]).astype(np.int64)
        rows = np.concatenate([i.reshape(-1) for _, i, _, _ in tt])
        uvp = np.concatenate([np.asarray(prob.obs_uv, np.float64),
                              np.zeros((1, 2))])
        c = _Consts(uv=fl(uvp[rows]), n=fl(n_all[pts]), d=fl(d_all[pts]),
                    tiers=tiers)
        pts_d = to_device([pts], dev)[0]
        X_all = X

        def points(Xt):
            return X_all.clone().index_copy_(0, pts_d, Xt)

        return VisualPlan(
            route, c, lambda R, t, X: _linearize_tiers(prob, c, R, t, X),
            lambda cache, u: _solve_cached_tiers(prob, c, cache, u),
            R, t, X[pts_d], points, host_loop, verbose)
    ints = [obs_cam, obs_pt, index_table_np(obs_cam, M),
            index_table_np(obs_pt, P)]
    chunks = ()
    if route in ("lu", "cg"):
        pa, pb = _build_pairs(obs_pt, P)
        plan = _pair_cells_np(obs_cam, pa, pb, M, prob.pair_chunk)
        chunks = [(lo, hi) for lo, hi, _, _ in plan]
        ints += [pa.astype(np.int64), pb.astype(np.int64)]
        for _, _, cells, table in plan:
            ints += [cells, table]
    ints = to_device(ints, dev)
    pairs = ()
    if route in ("lu", "cg"):
        cell_ops = ints[6:]
        pairs = (list(zip(chunks, cell_ops[0::2], cell_ops[1::2])),
                 ints[4], ints[5])
    c = _Consts(uv=fl(prob.obs_uv), n=fl(n_all), d=fl(d_all),
                obs_cam=ints[0], obs_pt=ints[1], cam_table=ints[2],
                pt_table=ints[3], pairs=pairs,
                tiers=pm_tiers(tt, M, dev) if route == "cg_pm" else None)
    return VisualPlan(
        route, c, lambda R, t, X: _linearize(prob, c, R, t, X),
        lambda cache, u: _solve_cached(prob, route, c, cache, u),
        R, t, X, lambda X: X, host_loop, verbose)


class _ObsShard(NamedTuple):
    """One shard of a sharded visual solve: its observations' operands on
    its device (consts: obs_cam, obs_pt, uv, cam_table, pt_table and its
    pair chunks, which index the gathered observations) and their weights
    (0 on padded observations)."""

    c: _Consts
    w: torch.Tensor


def _shard_obs(prob, mesh, axis, route, dtype):
    """The observations (and, on the lu / cg routes, the observation
    pairs) padded to the axis's shard count by the JAX package's rule
    (schur.py:862-878: padded pairs point at a zero-weight padded
    observation, a whole shard row added when only the pairs need
    padding) and split into this process's shards."""
    n = mesh.n_shards(axis)
    M, P = prob.num_cams, prob.num_pts
    obs_cam = np.asarray(prob.obs_cam).astype(np.int64)
    obs_pt = np.asarray(prob.obs_pt).astype(np.int64)
    uv = np.asarray(prob.obs_uv, np.float64)
    O = obs_cam.shape[0]
    pa = pb = np.zeros(0, np.int64)
    if route in ("lu", "cg"):
        pa, pb = (x.astype(np.int64) for x in _build_pairs(obs_pt, P))
    Q = pa.shape[0]
    Opad, Qpad = -(-O // n) * n, -(-Q // n) * n
    if Qpad > Q and Opad == O:
        Opad += n
    obs_cam = np.pad(obs_cam, (0, Opad - O))
    obs_pt = np.pad(obs_pt, (0, Opad - O))
    uv = np.pad(uv, ((0, Opad - O), (0, 0)))
    w = np.pad(np.ones(O), (0, Opad - O))
    pad_obs = Opad - 1 if Opad > O else 0
    pa = np.pad(pa, (0, Qpad - Q), constant_values=pad_obs)
    pb = np.pad(pb, (0, Qpad - Q), constant_values=pad_obs)
    obounds, qbounds = shard_bounds(Opad, n), shard_bounds(Qpad, n)
    shards = []
    for gi, dev in zip(mesh.local_shards(axis), mesh.axis_devices(axis)):
        lo, hi = obounds[gi]
        ints = [obs_cam[lo:hi], obs_pt[lo:hi],
                index_table_np(obs_cam[lo:hi], M),
                index_table_np(obs_pt[lo:hi], P)]
        chunks = ()
        if route in ("lu", "cg"):
            qa, qb = pa[slice(*qbounds[gi])], pb[slice(*qbounds[gi])]
            plan = _pair_cells_np(obs_cam, qa, qb, M, prob.pair_chunk)
            chunks = [(a, b) for a, b, _, _ in plan]
            ints += [qa, qb]
            for _, _, cells, table in plan:
                ints += [cells, table]
        ints = to_device(ints, dev)
        pairs = ()
        if route in ("lu", "cg"):
            pairs = (list(zip(chunks, ints[6::2], ints[7::2])), ints[4],
                     ints[5])
        fl = torch.as_tensor(np.concatenate([uv[lo:hi].reshape(-1),
                                             w[lo:hi]])).to(dev, dtype)
        c = _Consts(uv=fl[:2 * (hi - lo)].view(-1, 2), n=None, d=None,
                    obs_cam=ints[0], obs_pt=ints[1], cam_table=ints[2],
                    pt_table=ints[3], pairs=pairs)
        shards.append(_ObsShard(c, fl[2 * (hi - lo):]))
    return shards


def _linearize_sharded(prob, shards, mesh, n, d, R, t, X) -> _LinCache:
    """The flat routes' evaluation on observation shards: each shard's
    weighted residuals and Jacobians summed by camera and point through its
    tables, the sums reduced (mesh.psum); the coupling blocks stay on their
    shards (Wb: a list, one a shard); the plane priors once."""
    parts, wbs = [], []
    for sh in shards:
        c, w = sh.c, sh.w
        dev = w.device
        r, Jc, Jp = reproj_jacobians_batch(
            prob.cam, R.to(dev), t.to(dev), X.to(dev), c.obs_cam, c.obs_pt,
            c.uv, prob.sigma_px)
        r, Jc, Jp = r * w[:, None], Jc * w[:, None, None], \
            Jp * w[:, None, None]
        k = _obs_sums(prob.num_cams, r, Jc, Jp,
                      lambda z, t=c.cam_table: _segsum(z, t),
                      lambda z, t=c.pt_table: _segsum(z, t))
        parts.append((k.g_c, k.g_p, k.Hcc, k.Hpp, k.cost))
        wbs.append(k.Wb)
    g_c, g_p, Hcc, Hpp, cost = psum(parts, mesh)
    return _with_plane(prob, _LinCache(g_c, g_p, Hcc, Hpp, wbs, cost), X, n,
                       d)


def _solve_sharded(prob, route, shards, mesh, axis, cache, u):
    """_solve_cached on observation shards: Y and the reduced rhs per
    shard, reduced; the reduced solve (lu: the couplings of each shard's
    pairs over the gathered W, Y, reduced, then the replicated LU; cg: the
    same S row-sharded over the axis; cg_mf: the sharded matrix-free CG);
    the back-substitution's point sums reduced."""
    M = prob.num_cams
    dHcc, Hpp_inv = _damped_blocks(u, cache.Hcc, cache.Hpp)
    Ys, bs = [], []
    for sh, W in zip(shards, cache.Wb):
        c = sh.c
        Y = _matmul3(W, Hpp_inv.to(W.device)[c.obs_pt])
        gp = cache.g_p.to(W.device)[c.obs_pt]
        Ys.append(Y)
        bs.append(_segsum((Y * gp[:, None, :]).sum(-1), c.cam_table))
    b = _zero_first(psum(bs, mesh) - cache.g_c, prob.fix_first)
    if route == "cg_mf":
        dc = solve_schur_cg_mf_sharded(
            dHcc, [(W, Y, sh.c.obs_cam, sh.c.obs_pt, sh.c.cam_table,
                    sh.c.pt_table) for sh, W, Y in zip(shards, cache.Wb, Ys)],
            b, lambda parts: psum(parts, mesh), fix_first=prob.fix_first,
            graph=not mesh.distributed)
    else:
        Wg, Yg = gather_rows(cache.Wb, mesh), gather_rows(Ys, mesh)
        S = psum([_pair_scatter(M, sh.c.pairs, Wg.to(sh.w.device),
                                Yg.to(sh.w.device)) for sh in shards], mesh)
        A = _schur_finish(prob, S, dHcc)
        rhs = b.reshape(M * 6)
        if route == "cg":
            dc = solve_damped_cg(A, -rhs, A.new_zeros(()),
                                 h_sharding=mesh.axis_devices(axis))
        else:
            LU, piv, _ = torch.linalg.lu_factor_ex(A)
            dc = torch.linalg.lu_solve(LU, piv, rhs[:, None])
            dc = dc + torch.linalg.lu_solve(LU, piv, rhs[:, None] - A @ dc)
        dc = dc.reshape(M, 6)
    wt = psum([_segsum((W * dc.to(W.device)[sh.c.obs_cam][:, :, None]).sum(1),
                       sh.c.pt_table) for sh, W in zip(shards, cache.Wb)],
              mesh)
    dX = (Hpp_inv * (-cache.g_p - wt)[:, None, :]).sum(-1)
    return dc, dX, _model_decrease(u, cache.Hcc, cache.g_c, dc, cache.Hpp,
                                   cache.g_p, dX)


def _plan_sharded(prob, R0, t0, X0, dtype, device_loop, verbose, mesh,
                  axis) -> VisualPlan:
    """The VisualPlan of a solve on a mesh (the JAX package's
    solve_visual_ba(mesh=), schur.py:722-925): observations and pairs
    sharded over `axis`, the per-camera and per-point sums reduced on the
    mesh's first device, where the state lives."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), "
                        f"not {type(mesh).__name__}")
    dtype = torch.float32 if dtype is None else dtype
    host_loop = not device_loop or verbose
    route, _ = _route(prob, dtype, host_loop, sharded=True)
    dev = mesh.first

    def fl(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(dev, dtype)

    shards = _shard_obs(prob, mesh, axis, route, dtype)
    n, d = fl(prob.plane_n), fl(prob.plane_d)
    c = _Consts(uv=None, n=n, d=d)
    return VisualPlan(
        route, c,
        lambda R, t, X: _linearize_sharded(prob, shards, mesh, n, d, R, t, X),
        lambda cache, u: _solve_sharded(prob, route, shards, mesh, axis,
                                        cache, u),
        fl(R0), fl(t0), fl(X0), lambda X: X, host_loop, verbose)


def _step(plan: VisualPlan, R, t, X, cache, u):
    dc, dX, q1 = plan.solve(cache, u)
    R_t = R @ exp_so3(dc[:, 0:3])
    t_t = t + dc[:, 3:6]
    X_t = X + dX
    return R_t, t_t, X_t, plan.lin(R_t, t_t, X_t), q1


def run_visual(plan: VisualPlan, max_iters: int = 50, u_init: float = 1e-3,
               rel_tol: float = 1e-8) -> VisualBAResult:
    """The LM over a plan.  The device loop: one Jacobian evaluation an
    iteration, at the trial point (on acceptance it is the next
    linearization; a rejected step keeps the cached one), the accepted
    state selected on the device, and one read to the host an iteration
    (done, with the costs).  The host loop (plan.host_loop) reads the
    costs and decides on the host, as the JAX package's does."""
    R, t, X = plan.R0.clone(), plan.t0.clone(), plan.X0.clone()
    cache = plan.lin(R, t, X)
    if plan.host_loop:
        return _host_loop(plan, R, t, X, cache, max_iters, u_init, rel_tol)
    cost0 = cache.cost.clone()
    u = torch.full((), u_init, dtype=R.dtype, device=R.device)
    v = torch.full((), 2.0, dtype=R.dtype, device=R.device)
    it = 0
    vals = None
    for _ in range(max_iters):
        R_t, t_t, X_t, cache_t, q1 = _step(plan, R, t, X, cache, u)
        accept, u, v, conv, stall = _nielsen_visual(cache.cost, cache_t.cost,
                                                    q1, u, v, rel_tol)
        _select_(accept, (R_t, t_t, X_t, cache_t), (R, t, X, cache))
        it += 1
        vals = torch.stack([(conv | stall).to(R.dtype), cache.cost,
                            cost0]).tolist()
        if vals[0]:
            break
    if vals is None:
        vals = [0.0] + torch.stack([cache.cost, cost0]).tolist()
    return VisualBAResult(R=R, t=t, X=plan.points(X), iters=it,
                          cost0=vals[2], cost=vals[1], route=plan.route)


def _host_loop(plan: VisualPlan, R, t, X, cache, max_iters, u_init,
               rel_tol) -> VisualBAResult:
    """The JAX package's host-driven loop (schur.py:919-960)."""
    c_prev = float(cache.cost)
    c0 = c_prev
    u, v = u_init, 2.0
    it_done = 0
    for it in range(max_iters):
        ut = torch.tensor(u, dtype=R.dtype, device=R.device)
        R_t, t_t, X_t, cache_t, q1 = _step(plan, R, t, X, cache, ut)
        c_new = float(cache_t.cost)
        q = c_prev - c_new
        it_done = it + 1
        if q > 0:
            R, t, X, cache = R_t, t_t, X_t, cache_t
            qr = min(q / max(float(q1), 1e-300), 1e3)
            u = u * max(1.0 / 3.0, 1.0 - (2.0 * qr - 1.0) ** 3)
            v = 2.0
            if plan.verbose:
                print(f"[visual LM] it={it} cost {c_prev:.6g} -> "
                      f"{c_new:.6g} u={u:.2e}")
            if abs(q) / max(c_prev, 1e-300) < rel_tol:
                c_prev = c_new
                break
            c_prev = c_new
        else:
            if plan.verbose:
                print(f"[visual LM] it={it} REJECT cost {c_prev:.6g} -> "
                      f"{c_new:.6g} q1={float(q1):.3g} u={u:.2e}")
            u *= v
            v *= 2.0
            if u > 1e12:
                break
    return VisualBAResult(R=R, t=t, X=plan.points(X), iters=it_done,
                          cost0=c0, cost=c_prev, route=plan.route)


def solve_visual_ba(
    prob: VisualBAProblem,
    R0: np.ndarray,
    t0: np.ndarray,
    X0: np.ndarray,
    max_iters: int = 50,
    u_init: float = 1e-3,
    rel_tol: float = 1e-8,
    dtype=None,
    verbose: bool = False,
    mesh=None,
    shard_axis: str = "factors",
    device_loop: bool = True,
    device="cuda",
) -> VisualBAResult:
    """LM with Schur steps (Ceres-equivalent semantics) on `device`
    (default the card), in `dtype` (default float32).  The result's
    `route` names the route taken (module docstring).  With `mesh` (the
    JAX package's sharded solve) observations and pairs are sharded over
    `shard_axis`; the route follows _auto_solver(pairs_sharded=True), the
    cg route row-shards S, and the result lies on the mesh's first
    device."""
    plan = plan_visual(prob, R0, t0, X0, dtype=dtype, device=device,
                       device_loop=device_loop, verbose=verbose, mesh=mesh,
                       shard_axis=shard_axis)
    return run_visual(plan, max_iters, u_init, rel_tol)
