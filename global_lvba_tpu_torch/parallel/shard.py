"""Sharded plane-factor evaluation and the distributed LM (port of
global_lvba_tpu.parallel.shard).

Factor arrays (voxel rows) or banded group stacks are split into equal
contiguous shards over a mesh axis, padded first to a multiple of the
shard count with all-zero rows (n == 0: inert in every kernel).  Each
shard is evaluated on its device by the single-device evaluation (the
same kernels), and the partials go through one reduction, mesh.psum (in
shard order on the mesh's first device; all_reduce across processes).
The reference's divide_thread reduction (bavoxel.hpp:597-639) on
devices.

Routes (sharded_route, built by solver.lm.plan_route(mesh=)):

  route           evaluation                        solve
  sharded-dense   factor rows sharded, (r, g, H)    LU on the first device,
                  reduced (the JAX package's        or a 48-trip CG with H
                  _lm_jitted under GSPMD)           row-sharded over
                                                    "frames" (else the
                                                    factor axis)
  sharded-banded  group stacks sharded, the dense   LU or 96-trip CG
                  H reduced; stragglers replicated  (_lm_banded_jitted)
  sharded-compact group stacks sharded, the Grams   96-trip pair-window
                  kept on their shards; no (6W)²    CG, its G-contraction
                  operand anywhere                  the reduction
                                                    (_lm_banded_compact_
                                                    jitted)

The LM is solver.lm._run: one read to the host an iteration
(`converged`).  The averaged residual of the sharded dense route counts
the padded rows (as the JAX package's does); the banded routes count the
buckets' own rows.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..factors.plane_eigen import (
    KERNEL_STEPS, BandedGroups, BandedHost, BandedPlan, PlaneFactorArrays,
    _banded_eval, add_block_diag, banded_plan, build_banded_groups,
    buckets_frame_table, plane_cost_grad_hess)
from ..solver.dist_solve import (
    _frame_table_np, _pair_aligned, pair_solve, pair_tables,
    solve_damped_cg, to_device)
from ..solver.lm import (
    BANDED_CG_ITERS, LIDAR_CG_ITERS, LMResult, Route, _dense_solve,
    _run, _solve_damped, _total_cgh, plan_route)
from ..utils.profiling import span
from .mesh import Mesh, psum, shard_bounds

log = logging.getLogger("global_lvba_tpu_torch.parallel")


class ShardedArrays(NamedTuple):
    """One bucket sharded over a mesh axis: this process's shards in shard
    order, each factor-array set on its device, and the padded global row
    count (a multiple of the shard count)."""

    shards: list
    rows: int


def _pad_rows_to(fa, mult: int):
    """fa with its voxel rows padded by all-zero rows to a multiple of
    `mult` (aligned or bucketed alike)."""
    V = fa.n.shape[0]
    Vp = -(-V // mult) * mult
    if Vp == V:
        return fa
    return type(fa)(*(torch.cat([x, x.new_zeros((Vp - V,) + x.shape[1:])])
                      for x in fa))


def shard_buckets(buckets: Sequence, mesh: Mesh,
                  axis: str = "factors") -> List[ShardedArrays]:
    """Each bucket's voxel rows padded to a multiple of the axis's global
    shard count and split into equal contiguous shards, this process's
    placed on their devices."""
    n = mesh.n_shards(axis)
    devs = mesh.axis_devices(axis)
    out = []
    for fa in buckets:
        fa = _pad_rows_to(fa, n)
        bounds = shard_bounds(fa.n.shape[0], n)
        shards = [type(fa)(*(x[bounds[i][0]:bounds[i][1]].to(dev)
                             .contiguous() for x in fa))
                  for i, dev in zip(mesh.local_shards(axis), devs)]
        out.append(ShardedArrays(shards, int(fa.n.shape[0])))
    return out


def sharded_cost_grad_hess(fa, R: torch.Tensor, p: torch.Tensor,
                           num_frames: int, mesh: Mesh,
                           axis: str = "factors"):
    """(resid, g (W, 6), H (W, 6, W, 6)) of one factor-array set, its rows
    sharded over `axis`, each shard evaluated on its device and the
    partials reduced (the JAX package's shard_map evaluation with psum)."""
    sh = shard_buckets([fa], mesh, axis)[0]
    return psum([plane_cost_grad_hess(s, R.to(s.n.device),
                                      p.to(s.n.device), num_frames)
                 for s in sh.shards], mesh)


# ---------------------------------------------------------------------------
# Banded group stacks on a mesh
# ---------------------------------------------------------------------------


def pad_banded_group_stack(bg: BandedGroups, n: int) -> BandedGroups:
    """A bucket's group stack padded to a multiple of n groups: padded
    groups carry all-zero factor rows, no live entry and offset 0, so
    their Grams are exact zeros and they add nothing anywhere."""
    G = bg.fa.n.shape[0]
    Gp = -(-G // n) * n
    if Gp == G:
        return bg
    K = bg.fa.n.shape[2]

    def padg(x, fill=0):
        pad = x.new_full((Gp - G,) + tuple(x.shape[1:]), fill)
        return torch.cat([x, pad])

    def padh(a):
        return np.concatenate([a, np.zeros((Gp - G,) + a.shape[1:],
                                           a.dtype)])

    h = bg.host
    return BandedGroups(
        fa=PlaneFactorArrays(*(padg(x) for x in bg.fa)),
        inv=padg(bg.inv, K), offset=padg(bg.offset), wide_fa=bg.wide_fa,
        wide_inv=bg.wide_inv,
        host=BandedHost(padh(h.frame), padh(h.live),
                        tuple(h.offsets) + (0,) * (Gp - G), h.wide_frame,
                        h.wide_live))


def _group_shard(bg: BandedGroups, lo: int, hi: int, dev) -> BandedGroups:
    """Groups [lo, hi) of a padded stack on `dev`, with no stragglers."""
    h = bg.host
    K = bg.fa.n.shape[2]
    wfa = PlaneFactorArrays(*(x[:0].to(dev) for x in bg.wide_fa))
    return BandedGroups(
        fa=PlaneFactorArrays(*(x[lo:hi].to(dev) for x in bg.fa)),
        inv=bg.inv[lo:hi].to(dev), offset=bg.offset[lo:hi].to(dev),
        wide_fa=wfa, wide_inv=bg.wide_inv[:0].to(dev),
        host=BandedHost(h.frame[lo:hi], h.live[lo:hi], h.offsets[lo:hi],
                        np.zeros((0, K), h.wide_frame.dtype),
                        np.zeros((0, K), bool)))


def _straggler_plan(groups, W: int, dev):
    """A BandedPlan of the groups' stragglers alone on `dev` (evaluated
    once, replicated), or None when there are none."""
    wide, frames, lives = [], [], []
    for bg in groups:
        if bg.wide_fa.n.shape[0]:
            wide.append(PlaneFactorArrays(*(x.to(dev) for x in bg.wide_fa)))
            frames.append(bg.host.wide_frame)
            lives.append(bg.host.wide_live)
    if not wide:
        return None
    table = _frame_table_np(np.concatenate([f.reshape(-1) for f in frames]),
                            np.concatenate([v.reshape(-1) for v in lives]),
                            W)
    return BandedPlan([], [], [], [], wide, to_device([table], dev)[0], None)


class _ShardedBanded(NamedTuple):
    """The shard plans of a solve's (or one bucket's) banded groups."""

    devs: list          # this process's shard devices
    plans: list         # a BandedPlan a local shard, every bucket's groups
    wide: BandedPlan    # the stragglers' plan on the first device, or None
    offsets: list       # per local shard, per bucket the window offsets


def _shard_groups(groups, W: int, mesh: Mesh, axis: str) -> _ShardedBanded:
    n = mesh.n_shards(axis)
    padded = [pad_banded_group_stack(bg, n) for bg in groups]
    devs = mesh.axis_devices(axis)
    plans, offsets = [], []
    for i, dev in zip(mesh.local_shards(axis), devs):
        shard = []
        for bg in padded:
            lo, hi = shard_bounds(bg.fa.n.shape[0], n)[i]
            shard.append(_group_shard(bg, lo, hi, dev))
        plans.append(banded_plan(shard, W))
        offsets.append([bg.host.offsets for bg in shard])
    return _ShardedBanded(devs, plans, _straggler_plan(groups, W, mesh.first),
                          offsets)


def _eval_banded(sb: _ShardedBanded, R, p, W: int, mesh: Mesh,
                 compact: bool):
    """One sharded banded evaluation -> (resid, g, Hd, grams per local
    shard, wide (compact) or the dense cross Gram)."""
    parts, grams = [], []
    for dev, plan in zip(sb.devs, sb.plans):
        r, g, Hd, gr, last = _banded_eval(KERNEL_STEPS, plan, R.to(dev),
                                          p.to(dev), W, compact)
        parts.append((r, g, Hd) if compact else (r, g, Hd, last))
        grams.append(gr)
    red = list(psum(parts, mesh))
    wide = []
    if sb.wide is not None:
        r, g, Hd, _, last = _banded_eval(KERNEL_STEPS, sb.wide, R, p, W,
                                         compact)
        red = [a + b for a, b in zip(red, (r, g, Hd) if compact
                                     else (r, g, Hd, last))]
        wide = last if compact else []
    if compact:
        return red[0], red[1], red[2], grams, wide
    return red[0], red[1], red[2], grams, red[3]


def banded_cgh_sharded(bg: BandedGroups, R: torch.Tensor, p: torch.Tensor,
                       W: int, mesh: Mesh, axis: str = "factors"):
    """(resid, g (W, 6), Hd (W, 6, 6), H (6W, 6W) cross part) of one
    bucket's banded groups, the group stack padded and sharded over
    `axis`, the partials reduced, the stragglers evaluated once on the
    first device (the JAX package's banded_cgh_sharded)."""
    sb = _shard_groups([bg], W, mesh, axis)
    r, g, Hd, _, gram = _eval_banded(sb, R.to(mesh.first),
                                     p.to(mesh.first), W, mesh, False)
    return r, g, Hd, gram.neg_()


def banded_cgh_compact_sharded(bg: BandedGroups, R: torch.Tensor,
                               p: torch.Tensor, W: int, mesh: Mesh,
                               axis: str = "factors"):
    """(resid, g, Hd reduced; grams: per local shard its (G/n, 12B, 12B)
    group Grams +AᵀA, on its device, never reduced; wide_M (3Vw, 6W) on
    the first device) of one bucket whose stack pad_banded_group_stack
    padded to the shard count (the JAX package's
    banded_cgh_compact_sharded): no device holds a (6W)² operand."""
    if bg.fa.n.shape[0] % mesh.n_shards(axis):
        raise ValueError("pad the group stack with pad_banded_group_stack "
                         "first")
    sb = _shard_groups([bg], W, mesh, axis)
    r, g, Hd, grams, wide = _eval_banded(sb, R.to(mesh.first),
                                         p.to(mesh.first), W, mesh, True)
    wM = wide[0] if wide else R.new_zeros((0, 6 * W), device=mesh.first)
    return r, g, Hd, [gr[0] for gr in grams], wM


# ---------------------------------------------------------------------------
# The sharded routes and their LMs
# ---------------------------------------------------------------------------


def _dense_route(buckets, W, reduced_solver, mesh: Mesh, axis: str) -> Route:
    solver = reduced_solver
    if solver == "auto":
        solver = "cg" if 6 * W >= 1536 else "lu"
    if solver == "cg_mf":
        # as the JAX package's: the matrix-free solve has no assembled H to
        # shard, so it runs replicated (on the padded rows)
        log.warning("reduced_solver='cg_mf' ignores the mesh (the "
                    "matrix-free solve has no assembled H to row-shard); "
                    "running replicated")
        n = mesh.n_shards(axis)
        return plan_route([type(fa)(*(x.to(mesh.first) for x in
                                      _pad_rows_to(fa, n)))
                           for fa in buckets], W, "cg_mf")
    if solver not in ("lu", "cg"):
        raise ValueError(f"unknown reduced_solver {reduced_solver!r}")
    sb = shard_buckets(buckets, mesh, axis)
    g_size = float(max(sum(s.rows for s in sb), 1))
    local = []
    for i, dev in enumerate(mesh.axis_devices(axis)):
        bs = [s.shards[i] for s in sb]
        bucketed = any(isinstance(fa, PlaneFactorArrays) for fa in bs)
        local.append((dev, bs, buckets_frame_table(bs, W) if bucketed
                      else None))
    frames = ("frames" in mesh.axis_names and axis != "frames")
    row_devs = mesh.axis_devices("frames" if frames else axis)

    def cgh(R, p):
        r, g, H = psum([_total_cgh(bs, tbl, R.to(dev), p.to(dev), W)
                        for dev, bs, tbl in local], mesh)
        return r / g_size, g, H

    def solve(state, u):
        _, g, H = state
        if solver == "cg":
            dx = solve_damped_cg(H, g, u, max_iters=LIDAR_CG_ITERS,
                                 h_sharding=row_devs)
        else:
            dx = _solve_damped(H, g, u)
        return dx, torch.diagonal(H)

    return Route("sharded-dense", LIDAR_CG_ITERS if solver == "cg" else 0,
                 cgh, solve, g_size)


def sharded_route(buckets, W: int, reduced_solver: str, hessian: str,
                  split: bool, mesh: Mesh, axis: str = "factors",
                  block: int = None) -> Route:
    """The sharded route of solver.lm.plan_route(mesh=): hessian "banded"
    takes the banded routes (split: the compact one), anything else the
    factor-sharded dense route."""
    if hessian != "banded":
        return _dense_route(buckets, W, reduced_solver, mesh, axis)
    if not all(isinstance(fa, PlaneFactorArrays) for fa in buckets):
        raise ValueError("the sharded banded routes need bucketed factor "
                         "arrays")
    g_size = float(max(sum(int(fa.n.shape[0]) for fa in buckets), 1))
    groups = [build_banded_groups(fa, W, block) for fa in buckets]
    if split:
        for bg in groups:
            if not _pair_aligned(bg.host.offsets, bg.inv.shape[-1], W):
                raise ValueError(
                    f"group offsets not pair-aligned (W={W}, width="
                    f"{bg.inv.shape[-1]}): pick block with block | W, or "
                    f"use lm_damping_iter_banded_sharded")
    sb = _shard_groups(groups, W, mesh, axis)
    if not split:
        solver = "cg" if reduced_solver == "cg" else "lu"
        trips = BANDED_CG_ITERS if solver == "cg" else 0

        def cgh(R, p):
            r, g, Hd, _, gram = _eval_banded(sb, R, p, W, mesh, False)
            H = add_block_diag(gram.neg_().reshape(W, 6, W, 6), Hd, W)
            return r / g_size, g.reshape(W * 6), H.reshape(W * 6, W * 6)

        return Route("sharded-banded", trips, cgh,
                     _dense_solve(solver, trips), g_size)
    tables = [pair_tables(offs, [d[2] // 2 for d in plan.dims], W, dev)
              for offs, plan, dev in zip(sb.offsets, sb.plans, sb.devs)]

    def cgh(R, p):
        r, g, Hd, grams, wide = _eval_banded(sb, R, p, W, mesh, True)
        return r / g_size, g, Hd, grams, wide

    def solve(state, u):
        _, g, Hd, grams, wide = state
        shards = [[(gr, idx, tbl) for gr, (idx, tbl) in zip(grs, tabs)]
                  for grs, tabs in zip(grams, tables)]
        return pair_solve(shards, wide, Hd, g, u,
                          lambda parts: psum(parts, mesh),
                          max_iters=BANDED_CG_ITERS,
                          graph=not mesh.distributed)

    return Route("sharded-compact", BANDED_CG_ITERS, cgh, solve, g_size)


def _lm(buckets, R0, p0, mesh, max_iters, **route) -> LMResult:
    with span("lm.solve", mesh.first):
        with span("lm.plan_route", mesh.first):
            route = plan_route(buckets, R0.shape[0], mesh=mesh, **route)
        return _run(route, R0.to(mesh.first), p0.to(mesh.first),
                    int(max_iters), 0.01, 2.0, 1e-6)


def lm_damping_iter_sharded(buckets: Sequence, R0: torch.Tensor,
                            p0: torch.Tensor, mesh: Mesh,
                            axis: str = "factors", max_iters: int = 10,
                            reduced_solver: str = "lu") -> LMResult:
    """The LM over factor-sharded buckets (the JAX package's
    lm_damping_iter_sharded): each bucket's rows padded to the shard count
    and sharded over `axis`, (r, g, H) reduced each evaluation; "lu"
    solves on the mesh's first device (a "frames" axis moves no LU
    operand), "cg" runs 48 trips with H row-sharded over "frames" (else
    over `axis`).  The result is on the mesh's first device."""
    return _lm(buckets, R0, p0, mesh, max_iters,
               reduced_solver=reduced_solver, hessian="dense", split=False,
               axis=axis)


def lm_damping_iter_banded_sharded(buckets: Sequence, R0: torch.Tensor,
                                   p0: torch.Tensor, mesh: Mesh,
                                   axis: str = "factors",
                                   max_iters: int = 10,
                                   reduced_solver: str = "lu",
                                   block: int = None) -> LMResult:
    """The banded-Hessian LM with every bucket's group stack sharded over
    the mesh (the JAX package's lm_damping_iter_banded_sharded): the dense
    H from the reduced partials, LU or a 96-trip CG."""
    return _lm(buckets, R0, p0, mesh, max_iters,
               reduced_solver=reduced_solver, hessian="banded", split=False,
               axis=axis, block=block)


def lm_damping_iter_banded_compact_sharded(buckets: Sequence,
                                           R0: torch.Tensor,
                                           p0: torch.Tensor, mesh: Mesh,
                                           axis: str = "factors",
                                           max_iters: int = 10,
                                           block: int = None) -> LMResult:
    """The compact banded LM on a mesh (the JAX package's
    lm_damping_iter_banded_compact_sharded): group stacks sharded, their
    Grams kept on their shards through the 96-trip pair-window CG, whose
    G-contraction is the reduction; no (6W)² operand on any device.  Group
    offsets must be pair-aligned (block | W): raises ValueError
    otherwise."""
    return _lm(buckets, R0, p0, mesh, max_iters, reduced_solver="cg",
               hessian="banded", split=True, axis=axis, block=block)
