"""Levenberg-Marquardt driver for the LiDAR plane-eigen BA (port of
global_lvba_tpu.solver.lm: the dense-Gram loop, the banded loop, the split
LM of large W and the matrix-free rows loop, on aligned and bucketed
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
state is selected on the device (torch.where over every tensor of the
state, written into the state's own buffers) and the damped solve reads
nothing to the host, so each iteration reads one value back: `converged`.  The JAX loops are fixed-trip
fori_loops that freeze the state once converged; this loop stops there
instead, which returns the same poses, residual and `iters` and saves the
frozen trips' evaluations.

Routes (plan_route; the JAX package's lm_damping_iter:136-272):

  route         taken when                       evaluation        solve
  dense         W < SPLIT_W, no banded, no       dense Gram        LU if 6W < 1536,
                cg_mf (_lm_jitted)                                 else 48-trip CG
  gather        gather_tables=True, bucketed,    a GatherPlan      LU if 6W < 1536,
                no banded, any W (never split;   evaluation a      else 48-trip CG
                _lm_jitted with invs)            bucket, summed
  banded        bucketed, W < SPLIT_W or gather  group Grams into  LU or 96-trip CG
                tables, banded (W >= 1024 with   the dense H
                a >= 4x saving, or
                hessian="banded")
                (_lm_banded_jitted)
  split-dense   W >= SPLIT_W without banded      dense Gram        LU or 96-trip CG
                (every aligned solve)
  split-banded  W >= SPLIT_W, bucketed, banded   group Grams, no   96-trip banded CG
                                                 (6W)² H
  rows          reduced_solver="cg_mf",          compact rows      256-trip rows CG
                bucketed (_lm_rows_jitted)

With BANDED_ALIGNED the banded routes build aligned banded groups
(factors.plane_eigen.AlignedBandedGroups: the group forms of kernels 1 and
2 on each group's window of poses) and are named banded-aligned and
split-banded-aligned; the sharded routes (parallel.shard) build
gather-layout groups whatever it says, as the JAX package's do.

The JAX package splits its loop into executables at W >= LVBA_SPLIT_W for
its compiler; this loop is host-driven already, so its split route is the
same loop with the split's evaluation and solve.  The JAX package's
environment switches are module constants here (SPLIT_W, BANDED_ALIGNED
and the trip counts); its LVBA_GATHER_M is lm_damping_iter's
gather_tables.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from ..factors.plane_eigen import (
    KERNEL_STEPS, AlignedPlaneFactorArrays, PlaneFactorArrays, _rows_eval,
    banded_cost, banded_cost_grad_compact, banded_cost_grad_hess,
    banded_plan, build_banded_groups, build_gather_plan, buckets_frame_table,
    plane_cost_grad_hess, plane_cost_grad_hess_buckets, rows_plan)
from ..geometry.se3 import boxplus_pose
from ..utils import profiling
from ..utils.profiling import span
from .dist_solve import (
    solve_damped_cg, solve_damped_cg_banded, solve_damped_cg_rows)

# CG trips of the damped solve on each route (the JAX package's
# LVBA_LIDAR_CG_ITERS default, solver/lm.py:324: twice the measured
# convergence at W = 512; the banded loop's and the split's 96,
# lm.py:430, :609 and dist_solve.py:566; the rows solve's 256,
# dist_solve.py:162)
LIDAR_CG_ITERS = 48
BANDED_CG_ITERS = 96
ROWS_CG_ITERS = 256
# the banded probe engages on bucketed solves from here (lm.py:245), and
# the split LM from SPLIT_W (LVBA_SPLIT_W, lm.py:198)
BANDED_MIN_W = 1024
SPLIT_W = 3072
# the banded routes' groups in the frame-aligned local layout
# (LVBA_BANDED_ALIGNED, lm.py:72-83; off by default, as there)
BANDED_ALIGNED = False


class LMResult(NamedTuple):
    R: torch.Tensor
    p: torch.Tensor
    iters: int
    residual: torch.Tensor
    route: str = ""     # the route the solve took (Route.name)


class Route(NamedTuple):
    """A solve's route: its name, its damped solve's CG trips (0: LU), the
    evaluation cgh(R, p) -> state (residual / factor count, g, ...) and
    the damped solve solve(state, u) -> (dx (6W,), diag(H) (6W,)) it runs,
    and the factor count of the AVG_THR residual."""

    name: str
    trips: int
    cgh: Callable
    solve: Callable
    g_size: float


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


def _gather_cgh(buckets, plans, R, p, W):
    """(resid, g (6W,), H (6W, 6W)) over all buckets, a GatherPlan
    evaluation each (plane_cost_grad_hess(inv=plan)), summed in bucket
    order (the JAX package's _total_cgh with invs)."""
    resid = g = H = None
    for fa, plan in zip(buckets, plans):
        r_, g_, H_ = plane_cost_grad_hess(fa, R, p, W, inv=plan)
        if H is None:
            resid, g, H = r_, g_, H_
        else:
            resid, g = resid + r_, g + g_
            H.add_(H_)
    return resid, g.reshape(W * 6), H.reshape(W * 6, W * 6)


def _dense_solve(solver: str, trips: int):
    """The damped solve of an assembled H: LU or `trips` CG trips."""
    def solve(state, u):
        _, g, H = state
        if solver == "cg":
            dx = solve_damped_cg(H, g, u, max_iters=trips)
        else:
            dx = _solve_damped(H, g, u)
        return dx, torch.diagonal(H)
    return solve


def plan_route(buckets: Sequence, W: int, reduced_solver: str = "auto",
               hessian: str = "auto", gather_tables: bool = False,
               split: bool = None, mesh=None, axis: str = "factors",
               block: int = None) -> Route:
    """The route of a W-frame solve over `buckets` (see the module
    docstring), with the operands it reads built once: a bucketed solve
    reads its buckets' ids and counts to the host here (its frame tables;
    the banded groups and their tables), before its first evaluation.
    gather_tables: a GatherPlan a bucket (the gather route, or banded
    where the probe engages; never split).
    split: None takes the split route at W >= SPLIT_W (but for cg_mf and
    gather tables); True forces it (lm_damping_iter_split).
    mesh: a parallel.mesh.Mesh; the sharded routes of parallel.shard
    (sharded_route: the factor-sharded dense route, the sharded banded
    route, and with split the compact banded route with the pair-window
    solve), their factor arrays or group stacks sharded over `axis`.
    block: the banded groups' frame block (None: the p99 span rule)."""
    kinds = (AlignedPlaneFactorArrays, PlaneFactorArrays)
    if not all(isinstance(fa, kinds) for fa in buckets):
        raise TypeError("buckets must be AlignedPlaneFactorArrays or "
                        "PlaneFactorArrays")
    if hessian not in ("auto", "dense", "banded"):
        raise ValueError(f"unknown hessian {hessian!r}")
    aligned = any(isinstance(fa, AlignedPlaneFactorArrays) for fa in buckets)
    if gather_tables and mesh is not None:
        raise ValueError("gather_tables=True has no sharded route (the JAX "
                         "package's lm_damping_iter_sharded has no such "
                         "option)")
    if aligned:
        # the aligned layout has no frame selection for gather tables,
        # banded groups or the rows path to replace
        if reduced_solver == "cg_mf":
            raise ValueError(
                "reduced_solver='cg_mf' needs bucketed factor arrays; "
                "build them with buckets_to_device (bucketed layout)")
        hessian = "dense"
        gather_tables = False
    if mesh is not None:
        # lazy import: parallel.shard imports this module
        from ..parallel.shard import sharded_route
        return sharded_route(buckets, W, reduced_solver, hessian,
                             bool(split), mesh, axis, block)
    if split is None:
        split = W >= SPLIT_W and reduced_solver != "cg_mf" \
            and not gather_tables
    elif split and reduced_solver == "cg_mf":
        raise ValueError("the split LM does not take reduced_solver='cg_mf'")
    elif split and gather_tables:
        raise ValueError("the split LM does not take gather tables")
    solver = reduced_solver
    if solver == "auto":
        solver = "cg" if 6 * W >= 1536 else "lu"
    if solver not in ("lu", "cg", "cg_mf"):
        raise ValueError(f"unknown reduced_solver {reduced_solver!r}")
    g_size = float(max(sum(int(fa.n.shape[0]) for fa in buckets), 1))

    if solver == "cg_mf":
        plan = rows_plan(buckets, W)
        frames = [fa.frame for fa in buckets]

        def cgh(R, p):
            r, g, Hd, rows = _rows_eval(KERNEL_STEPS, buckets, plan, R, p, W)
            return r / g_size, g, Hd, rows

        def solve(state, u):
            _, g, Hd, rows = state
            return solve_damped_cg_rows(rows, frames, plan.tables, Hd, g, u,
                                        max_iters=ROWS_CG_ITERS)

        return Route("rows", ROWS_CG_ITERS, cgh, solve, g_size)

    groups = None
    sfx = "-aligned" if BANDED_ALIGNED else ""
    if hessian != "dense" and (hessian == "banded" or W >= BANDED_MIN_W):
        groups = [build_banded_groups(fa, W, block, aligned=BANDED_ALIGNED)
                  for fa in buckets]
        banded, dense = banded_cost(groups, buckets, W)
        if hessian != "banded" and banded * 4 > dense:
            groups = None
    if groups is not None and split:
        plan = banded_plan(groups, W)

        def cgh(R, p):
            r, g, Hd, grams, wide = banded_cost_grad_compact(plan, R, p, W)
            return r / g_size, g, Hd, grams, wide

        def solve(state, u):
            _, g, Hd, grams, wide = state
            return solve_damped_cg_banded(grams, wide, plan.offsets, Hd, g,
                                          u, max_iters=BANDED_CG_ITERS,
                                          windows=plan.windows)

        return Route("split-banded" + sfx, BANDED_CG_ITERS, cgh, solve,
                     g_size)
    if groups is not None:
        plan = banded_plan(groups, W)

        def cgh(R, p):
            r, g, H = banded_cost_grad_hess(plan, R, p, W)
            return r / g_size, g.reshape(W * 6), H.reshape(W * 6, W * 6)

        name, trips = "banded" + sfx, BANDED_CG_ITERS
    elif gather_tables:
        plans = [build_gather_plan(fa, W) for fa in buckets]

        def cgh(R, p):
            r, g, H = _gather_cgh(buckets, plans, R, p, W)
            return r / g_size, g, H

        name, trips = "gather", LIDAR_CG_ITERS
    else:
        table = (buckets_frame_table(buckets, W) if any(
            isinstance(fa, PlaneFactorArrays) for fa in buckets) else None)

        def cgh(R, p):
            r, g, H = _total_cgh(buckets, table, R, p, W)
            return r / g_size, g, H

        name = "split-dense" if split else "dense"
        trips = BANDED_CG_ITERS if split else LIDAR_CG_ITERS
    trips = trips if solver == "cg" else 0
    return Route(name, trips, cgh, _dense_solve(solver, trips), g_size)


def _select_(keep, new, old):
    """old = torch.where(keep, new, old) over a state's tensors and lists,
    in place: the state keeps its buffers from one iteration to the next,
    and no third copy of a large state (the W=4096 group Grams: 454 MB)
    is allocated an iteration."""
    if isinstance(new, (list, tuple)):
        for a, b in zip(new, old):
            _select_(keep, a, b)
    else:
        # a sharded state's tensors lie on their shards' devices
        torch.where(keep.to(old.device), new, old, out=old)
    return old


def _run(route: Route, R0, p0, max_iters, u_init, v_init, rel_tol):
    """The Nielsen loop over a route: one evaluation an iteration at the
    trial point, the accepted state selected on the device, one read of
    `converged` an iteration.  Traced: the lm.eval and lm.damped_solve
    spans, and the rejected steps counted on the device (lm.rejects)."""
    W = R0.shape[0]
    dev = R0.device
    R, p = R0, p0
    with span("lm.eval", dev):
        state = route.cgh(R, p)
    u = torch.full((), u_init, dtype=R0.dtype, device=dev)
    v = torch.full((), v_init, dtype=R0.dtype, device=dev)
    it = 0
    for _ in range(max_iters):
        with span("lm.damped_solve", dev):
            dx, d = route.solve(state, u)
        R_t, p_t = boxplus_pose(R, p, dx.reshape(W, 6))
        q1 = 0.5 * torch.dot(dx, u * d * dx - state[1].reshape(-1)) \
            / route.g_size
        with span("lm.eval", dev):
            state_t = route.cgh(R_t, p_t)
        accept, u, v, converged = _nielsen_update(state[0], state_t[0], q1,
                                                  u, v, rel_tol)
        if profiling.enabled():
            profiling.count("lm.rejects", ~accept)
        R, p = torch.where(accept, R_t, R), torch.where(accept, p_t, p)
        state = _select_(accept, state_t, state)
        it += 1
        if bool(converged):
            break
    return LMResult(R=R, p=p, iters=it, residual=state[0], route=route.name)


def lm_damping_iter(
    buckets: Sequence,
    R0: torch.Tensor,
    p0: torch.Tensor,
    max_iters: int = 10,
    u_init: float = 0.01,
    v_init: float = 2.0,
    rel_tol: float = 1e-6,
    reduced_solver: str = "auto",
    gather_tables: bool = False,
    hessian: str = "auto",
) -> LMResult:
    """Damped LM over plane-eigen factor arrays (aligned and/or bucketed,
    as buckets_to_device gives them), on the route plan_route picks.

    reduced_solver: "lu" (dense LU), "cg" (block-Jacobi PCG), "cg_mf"
    (matrix-free CG on compact factor rows, bucketed only) or "auto" (CG
    once 6W >= 1536, else LU).  hessian: "dense" Grams every bucket at
    full width; "banded" groups voxels by observer-span frame block and
    Grams at local width 2B; "auto" takes banded at W >= BANDED_MIN_W when
    the Gram flops drop at least 4x.  At W >= SPLIT_W the split route
    runs (the compact banded solve where banded).  gather_tables: the
    JAX package's GatherPlan evaluation (LVBA_GATHER_M), one plan a
    bucket, never split (bucketed only; an aligned solve ignores it, as
    in the JAX package).  The result's `route` names the route taken."""
    with span("lm.solve", R0.device):
        with span("lm.plan_route", R0.device):
            route = plan_route(buckets, R0.shape[0], reduced_solver,
                               hessian, gather_tables)
        return _run(route, R0, p0, max_iters, u_init, v_init, rel_tol)


def lm_damping_iter_split(
    buckets: Sequence,
    R0: torch.Tensor,
    p0: torch.Tensor,
    max_iters: int = 10,
    u_init: float = 0.01,
    v_init: float = 2.0,
    rel_tol: float = 1e-6,
    reduced_solver: str = "auto",
    hessian: str = "auto",
) -> LMResult:
    """The split LM at any W (the JAX package's lm_damping_iter_split): the
    same Nielsen schedule as lm_damping_iter with the split's evaluation
    and solve, the dense Gram with LU or a 96-trip CG, or, where banded,
    the compact group Grams and solve_damped_cg_banded.  The JAX package
    keeps its Nielsen scalars on the host; here they stay on the device,
    so the two differ by rounding only."""
    with span("lm.solve", R0.device):
        with span("lm.plan_route", R0.device):
            route = plan_route(buckets, R0.shape[0], reduced_solver,
                               hessian, split=True)
        return _run(route, R0, p0, max_iters, u_init, v_init, rel_tol)
