"""Batched BALM planar eigenvalue factor: cost, gradient, Gauss-Newton
Hessian (port of global_lvba_tpu.factors.plane_eigen, dense-Gram path).

Same math as VOX_HESS::acc_evaluate2 / evaluate_only_residual
(include/BALM/bavoxel.hpp:68-203) restated as one batched computation:
every vector/matrix component is its own (V, K) plane, the per-voxel 3x3
eigensolve is closed form, and the full cross-pose block Hessian is one
negative Gram -AᵀA over three factor rows per voxel
(B·A_k and √2/N·[w; n·u]).

Two factor layouts, chosen per solve by the density gate
(factors/padding.py):

* frame-ALIGNED (AlignedPlaneFactorArrays, (V, W)): slot k IS frame k, so
  pose channels broadcast over voxels, g/Hd are voxel-axis sums and the
  factor rows already sit in the Gram layout.  Per bucket
    1. soa_agg    aggregation + eigensolve    -> residv (V,), pv (V, 16)
                  (one launch per kernel instance over the
                  evaluation's buckets)
  then per voxel chunk
    2. soa_chain  linearization chain          -> A (3V, 6W), its voxel
                  sums added to the evaluation's g (W, 6), Hd in the
                  same launch
    3. syrk_      gram += AᵀA
* BUCKETED (PlaneFactorArrays, (V, K) slots with a frame id each): once
  per evaluation, over all of its bucketed buckets
    0. table_select        pose table -> per-entry pose rows (V, K, 12),
                           views of one buffer (table_select_buckets)
  then per bucket
    1. soa_agg             on the per-entry pose rows (the same launch)
  then per voxel chunk
    2. soa_chain_entries   rows scattered into A (3V, 6W) at column
                           6·frame (the M expansion, exact: a voxel
                           observes a frame at most once), the 30 unique
                           g/Hd channels per entry -> vals (V·K, 30)
    3. syrk_               gram += AᵀA
  and once per evaluation, over all of its bucketed buckets
    4. entry_reduce        frame segment-sum of vals through the (W, Kf)
                           frame table -> g (W, 6), Hd (W, 6, 6).
  The buckets write one vals buffer, each at its offset, and the frame
  table lists the entries of all of them; it is built on the host once
  per solve (buckets_frame_table) and reused by every evaluation.

An evaluation over a list of buckets (plane_cost_grad_hess_buckets, the
LM's) adds every bucket's AᵀA into one Gram accumulator and negates it
once, and adds the block diagonal once.

Large W (the JAX package's plane_eigen.py:547-967), on the bucketed
layout:
* banded groups (build_banded_groups, banded_plan): a bucket's voxels
  grouped by the frame block their observer span starts in, each group a
  window of 2B frames.  One evaluation is the bucketed pass over the
  flattened group stacks (one select, one soa_agg pass, a chain_entries
  launch a stack at width 2B on the local ids, one entry_reduce) and a
  torch.bmm a stack for the group Grams: into the dense H
  (banded_cost_grad_hess) or kept per group (banded_cost_grad_compact,
  for solver.dist_solve.solve_damped_cg_banded);
* aligned banded groups (build_banded_groups(aligned=True), the JAX
  package's AlignedBandedGroups): each group a dense (Vp, 2B) grid whose
  slot k is frame offset[g] + k.  The select step gathers each stack's
  (G, 2B, 12) pose windows, and one launch a stack of the group forms of
  soa_agg and soa_chain (kernels/soa.py) evaluates it, the chain writing
  each group's sums as (group, slot) rows of the vals buffer, which
  entry_reduce folds by frame with the stragglers' entries; the Grams and
  the solves as above;
* gather plans (GatherPlan, plane_cost_grad_hess(inv=plan)): the JAX
  package's _cgh_gather, a bucket's evaluation reducing g and Hd through
  the plan's frame table, chunked by the (3V, 6W) operand alone;
* compact rows (rows_plan, plane_cost_grad_rows): the chain_entries launch
  at width K on the slot ids writes each entry's three factor rows at
  columns 6k (row-block layout (3V, 6K)), the operand of the matrix-free
  solve (solver.dist_solve.solve_damped_cg_rows); no Gram.

Each step is a CUDA kernel on the card (kernels/) and its plain torch
version on the CPU; each kernel has a float32 and a float64 instance, so
a float64 solve on the card launches kernels too.  The componentwise
functions below (_soa_agg, _soa_eig, _soa_chain) are the transcriptions
of the JAX ones the plain versions are built from.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..kernels import gram as _gram
from ..kernels import selection as _sel
from ..kernels import soa as _soa
from ..ops.eigh3 import eigh3_soa, eigh3x3
from ..solver.dist_solve import (
    _frame_table_np, _safe_frames, _safe_table, _segsum, banded_windows_np,
    rows_cross_diag, rows_matvec, to_device)


class PlaneFactorArrays(NamedTuple):
    """Bucketed factor layout, the device mirror of a PlaneFactorBucket:
    slot k of voxel v holds the moments it observed in frame frame[v, k].
    Padded slots and voxels carry n == 0 and contribute exactly zero."""

    n: torch.Tensor      # (V, K)
    mu: torch.Tensor     # (V, K, 3)
    Pc: torch.Tensor     # (V, K, 3, 3)
    frame: torch.Tensor  # (V, K) int32


class AlignedPlaneFactorArrays(NamedTuple):
    """Frame-aligned dense factor layout: slot k IS frame k.  Cells a voxel
    does not observe carry n == 0 and contribute exactly zero."""

    n: torch.Tensor      # (V, W)
    mu: torch.Tensor     # (V, W, 3)
    Pc: torch.Tensor     # (V, W, 3, 3)


def pose_table(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(W, 12) per-frame pose table: R row-major (9) | p (3)."""
    W = R.shape[0]
    return torch.cat([R.reshape(W, 9), p], dim=1).contiguous()


def _moment_channels(mu: torch.Tensor, Pc: torch.Tensor):
    """Component planes of the moments: mu3 (3,), P6 (6,) of (V, K)."""
    mu3 = (mu[..., 0], mu[..., 1], mu[..., 2])
    P6 = (Pc[..., 0, 0], Pc[..., 0, 1], Pc[..., 0, 2],
          Pc[..., 1, 1], Pc[..., 1, 2], Pc[..., 2, 2])
    return mu3, P6


def bucket_to_device(b, dtype=torch.float32, device="cuda") -> PlaneFactorArrays:
    """PlaneFactorArrays of a host PlaneFactorBucket on `device`."""
    device = resolve_device(device)

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device, dt)

    return PlaneFactorArrays(n=put(b.n, dtype), mu=put(b.mu, dtype),
                             Pc=put(b.Pc, dtype), frame=put(b.frame, torch.int32))


def _pose_channels(poses: torch.Tensor):
    """Per-entry pose planes R9 (9,), p3 (3,) from the pose operand of
    soa_agg: a (W, 12) pose table on the aligned layout (a (1, W)
    broadcast of its columns) or per-entry pose rows (V, K, 12) on the
    bucketed layout (table_select's output)."""
    cols = poses[None] if poses.dim() == 2 else poses
    return (tuple(cols[..., i] for i in range(9)),
            tuple(cols[..., 9 + i] for i in range(3)))


def _soa_agg(n_raw, mu3, P6, R9, p3):
    """Componentwise aggregation: world covariance + per-voxel stats
    (reductions over the trailing frame axis)."""
    mask = (n_raw > 0).to(n_raw.dtype)
    n = n_raw * mask
    m1, m2, m3 = mu3
    P11, P12, P13, P22, P23, P33 = P6
    R11, R12, R13, R21, R22, R23, R31, R32, R33 = R9
    p1, p2, p3_ = p3

    Rm1 = R11 * m1 + R12 * m2 + R13 * m3
    Rm2 = R21 * m1 + R22 * m2 + R23 * m3
    Rm3 = R31 * m1 + R32 * m2 + R33 * m3
    wm1 = Rm1 + p1
    wm2 = Rm2 + p2
    wm3 = Rm3 + p3_

    N = torch.sum(n, dim=-1)
    N_safe = torch.where(N > 0, N, torch.ones_like(N))
    invN = 1.0 / N_safe
    vb1 = torch.sum(n * wm1, dim=-1) * invN
    vb2 = torch.sum(n * wm2, dim=-1) * invN
    vb3 = torch.sum(n * wm3, dim=-1) * invN
    RP11 = R11 * P11 + R12 * P12 + R13 * P13
    RP12 = R11 * P12 + R12 * P22 + R13 * P23
    RP13 = R11 * P13 + R12 * P23 + R13 * P33
    RP21 = R21 * P11 + R22 * P12 + R23 * P13
    RP22 = R21 * P12 + R22 * P22 + R23 * P23
    RP23 = R21 * P13 + R22 * P23 + R23 * P33
    RP31 = R31 * P11 + R32 * P12 + R33 * P13
    RP32 = R31 * P12 + R32 * P22 + R33 * P23
    RP33 = R31 * P13 + R32 * P23 + R33 * P33
    S11e = RP11 * R11 + RP12 * R12 + RP13 * R13
    S12e = RP11 * R21 + RP12 * R22 + RP13 * R23
    S13e = RP11 * R31 + RP12 * R32 + RP13 * R33
    S22e = RP21 * R21 + RP22 * R22 + RP23 * R23
    S23e = RP21 * R31 + RP22 * R32 + RP23 * R33
    S33e = RP31 * R31 + RP32 * R32 + RP33 * R33
    d1 = wm1 - vb1[:, None]
    d2 = wm2 - vb2[:, None]
    d3 = wm3 - vb3[:, None]
    S11 = torch.sum(mask * S11e + n * d1 * d1, dim=-1)
    S12 = torch.sum(mask * S12e + n * d1 * d2, dim=-1)
    S13 = torch.sum(mask * S13e + n * d1 * d3, dim=-1)
    S22 = torch.sum(mask * S22e + n * d2 * d2, dim=-1)
    S23 = torch.sum(mask * S23e + n * d2 * d3, dim=-1)
    S33 = torch.sum(mask * S33e + n * d3 * d3, dim=-1)
    cov6 = (S11 * invN, S12 * invN, S13 * invN,
            S22 * invN, S23 * invN, S33 * invN)
    return mask, n, N, invN, (vb1, vb2, vb3), (Rm1, Rm2, Rm3), (
        RP11, RP12, RP13, RP21, RP22, RP23, RP31, RP32, RP33), cov6


def _soa_eig(cov6, N):
    """Eigendecomposition + factor-row scalings per voxel -> (residv (V,),
    u (3,), B1 (3,), B2 (3,)), B rows = sqrt(2/(λi−λ0))·u_iᵀ."""
    lam0, lam1, lam2, ev0, ev1, ev2 = eigh3_soa(*cov6)
    residv = torch.where(N > 0, lam0, torch.zeros_like(lam0))
    scale = torch.clamp(lam2.abs(), min=1e-20)
    s1 = torch.sqrt(2.0 / torch.maximum(lam1 - lam0, 1e-9 * scale))
    s2 = torch.sqrt(2.0 / torch.maximum(lam2 - lam0, 1e-9 * scale))
    B1 = (s1 * ev1[0], s1 * ev1[1], s1 * ev1[2])
    B2 = (s2 * ev2[0], s2 * ev2[1], s2 * ev2[2])
    return residv, ev0, B1, B2


def _soa_chain(mask, n, invN, vb, Rm, RP, mu3, P6, R9, p3, u, B1, B2):
    """Per-entry linearization chain -> (rows_ch (18,), jjt_ch (6,),
    d36_ch (36,)) channel tuples of (V, K) planes."""
    m1, m2, m3 = mu3
    P11, P12, P13, P22, P23, P33 = P6
    R11, R12, R13, R21, R22, R23, R31, R32, R33 = R9
    p1, p2, p3_ = p3
    vb1, vb2, vb3 = vb
    Rm1, Rm2, Rm3 = Rm
    (RP11, RP12, RP13, RP21, RP22, RP23, RP31, RP32, RP33) = RP
    u1, u2, u3 = u
    B11, B12, B13 = B1
    B21, B22, B23 = B2

    def bc(x):
        return x[:, None]

    u1b, u2b, u3b = bc(u1), bc(u2), bc(u3)
    invNb = bc(invN)

    r1 = R11 * u1b + R21 * u2b + R31 * u3b      # Rᵀu
    r2 = R12 * u1b + R22 * u2b + R32 * u3b
    r3 = R13 * u1b + R23 * u2b + R33 * u3b
    vi1, vi2, vi3 = n * m1, n * m2, n * m3
    w1 = vi2 * r3 - vi3 * r2
    w2 = vi3 * r1 - vi1 * r3
    w3 = vi1 * r2 - vi2 * r1
    t1 = p1 - bc(vb1)
    t2 = p2 - bc(vb2)
    t3 = p3_ - bc(vb3)
    adot = u1b * t1 + u2b * t2 + u3b * t3
    md = m1 * r1 + m2 * r2 + m3 * r3
    Pr1 = P11 * r1 + P12 * r2 + P13 * r3
    Pr2 = P12 * r1 + P22 * r2 + P23 * r3
    Pr3 = P13 * r1 + P23 * r2 + P33 * r3
    c11 = Pr1 + n * m1 * md + adot * vi1
    c12 = Pr2 + n * m2 * md + adot * vi2
    c13 = Pr3 + n * m3 * md + adot * vi3
    cb1 = n * Rm1 + n * t1
    cb2 = n * Rm2 + n * t2
    cb3 = n * Rm3 + n * t3

    T11 = RP11 + n * Rm1 * m1 + t1 * vi1
    T12 = RP12 + n * Rm1 * m2 + t1 * vi2
    T13 = RP13 + n * Rm1 * m3 + t1 * vi3
    T21 = RP21 + n * Rm2 * m1 + t2 * vi1
    T22 = RP22 + n * Rm2 * m2 + t2 * vi2
    T23 = RP23 + n * Rm2 * m3 + t2 * vi3
    T31 = RP31 + n * Rm3 * m1 + t3 * vi1
    T32 = RP32 + n * Rm3 * m2 + t3 * vi2
    T33 = RP33 + n * Rm3 * m3 + t3 * vi3
    H1_11 = T12 * r3 - T13 * r2
    H1_12 = T13 * r1 - T11 * r3
    H1_13 = T11 * r2 - T12 * r1
    H1_21 = T22 * r3 - T23 * r2
    H1_22 = T23 * r1 - T21 * r3
    H1_23 = T21 * r2 - T22 * r1
    H1_31 = T32 * r3 - T33 * r2
    H1_32 = T33 * r1 - T31 * r3
    H1_33 = T31 * r2 - T32 * r1
    Rh_11 = R12 * c13 - R13 * c12
    Rh_12 = R13 * c11 - R11 * c13
    Rh_13 = R11 * c12 - R12 * c11
    Rh_21 = R22 * c13 - R23 * c12
    Rh_22 = R23 * c11 - R21 * c13
    Rh_23 = R21 * c12 - R22 * c11
    Rh_31 = R32 * c13 - R33 * c12
    Rh_32 = R33 * c11 - R31 * c13
    Rh_33 = R31 * c12 - R32 * c11
    sN = invNb * mask
    A11 = (H1_11 - Rh_11) * sN
    A12 = (H1_12 - Rh_12) * sN
    A13 = (H1_13 - Rh_13) * sN
    A21 = (H1_21 - Rh_21) * sN
    A22 = (H1_22 - Rh_22) * sN
    A23 = (H1_23 - Rh_23) * sN
    A31 = (H1_31 - Rh_31) * sN
    A32 = (H1_32 - Rh_32) * sN
    A33 = (H1_33 - Rh_33) * sN
    c2u = cb1 * u1b + cb2 * u2b + cb3 * u3b
    A14 = (cb1 * u1b + c2u) * sN
    A15 = (cb1 * u2b) * sN
    A16 = (cb1 * u3b) * sN
    A24 = (cb2 * u1b) * sN
    A25 = (cb2 * u2b + c2u) * sN
    A26 = (cb2 * u3b) * sN
    A34 = (cb3 * u1b) * sN
    A35 = (cb3 * u2b) * sN
    A36 = (cb3 * u3b + c2u) * sN

    j1 = A11 * u1b + A21 * u2b + A31 * u3b
    j2 = A12 * u1b + A22 * u2b + A32 * u3b
    j3 = A13 * u1b + A23 * u2b + A33 * u3b
    j4 = A14 * u1b + A24 * u2b + A34 * u3b
    j5 = A15 * u1b + A25 * u2b + A35 * u3b
    j6 = A16 * u1b + A26 * u2b + A36 * u3b

    Pi11 = P11 + n * m1 * m1
    Pi12 = P12 + n * m1 * m2
    Pi13 = P13 + n * m1 * m3
    Pi22 = P22 + n * m2 * m2
    Pi23 = P23 + n * m2 * m3
    Pi33 = P33 + n * m3 * m3
    hp11 = -r3 * Pi12 + r2 * Pi13
    hp12 = -r3 * Pi22 + r2 * Pi23
    hp13 = -r3 * Pi23 + r2 * Pi33
    hp21 = r3 * Pi11 - r1 * Pi13
    hp22 = r3 * Pi12 - r1 * Pi23
    hp23 = r3 * Pi13 - r1 * Pi33
    hp31 = -r2 * Pi11 + r1 * Pi12
    hp32 = -r2 * Pi12 + r1 * Pi22
    hp33 = -r2 * Pi13 + r1 * Pi23
    F11 = -hp11
    F12 = -c13 - hp12
    F13 = c12 - hp13
    F21 = c13 - hp21
    F22 = -hp22
    F23 = -c11 - hp23
    F31 = -c12 - hp31
    F32 = c11 - hp32
    F33 = -hp33
    two_sN = 2.0 * invNb * mask
    Dr11 = two_sN * (F12 * r3 - F13 * r2)
    Dr12 = two_sN * (F13 * r1 - F11 * r3) + 0.5 * j3
    Dr13 = two_sN * (F11 * r2 - F12 * r1) - 0.5 * j2
    Dr21 = two_sN * (F22 * r3 - F23 * r2) - 0.5 * j3
    Dr22 = two_sN * (F23 * r1 - F21 * r3)
    Dr23 = two_sN * (F21 * r2 - F22 * r1) + 0.5 * j1
    Dr31 = two_sN * (F32 * r3 - F33 * r2) + 0.5 * j2
    Dr32 = two_sN * (F33 * r1 - F31 * r3) - 0.5 * j1
    Dr33 = two_sN * (F31 * r2 - F32 * r1)
    Drt11 = two_sN * w1 * u1b; Drt12 = two_sN * w1 * u2b; Drt13 = two_sN * w1 * u3b  # noqa: E702
    Drt21 = two_sN * w2 * u1b; Drt22 = two_sN * w2 * u2b; Drt23 = two_sN * w2 * u3b  # noqa: E702
    Drt31 = two_sN * w3 * u1b; Drt32 = two_sN * w3 * u2b; Drt33 = two_sN * w3 * u3b  # noqa: E702
    tn = two_sN * n
    Dt11 = tn * u1b * u1b; Dt12 = tn * u1b * u2b; Dt13 = tn * u1b * u3b  # noqa: E702
    Dt22 = tn * u2b * u2b; Dt23 = tn * u2b * u3b; Dt33 = tn * u3b * u3b  # noqa: E702

    d36_ch = (
        Dr11, Dr12, Dr13, Drt11, Drt12, Drt13,
        Dr21, Dr22, Dr23, Drt21, Drt22, Drt23,
        Dr31, Dr32, Dr33, Drt31, Drt32, Drt33,
        Drt11, Drt21, Drt31, Dt11, Dt12, Dt13,
        Drt12, Drt22, Drt32, Dt12, Dt22, Dt23,
        Drt13, Drt23, Drt33, Dt13, Dt23, Dt33,
    )

    B11b, B12b, B13b = bc(B11), bc(B12), bc(B13)
    B21b, B22b, B23b = bc(B21), bc(B22), bc(B23)
    BA11 = B11b * A11 + B12b * A21 + B13b * A31
    BA12 = B11b * A12 + B12b * A22 + B13b * A32
    BA13 = B11b * A13 + B12b * A23 + B13b * A33
    BA14 = B11b * A14 + B12b * A24 + B13b * A34
    BA15 = B11b * A15 + B12b * A25 + B13b * A35
    BA16 = B11b * A16 + B12b * A26 + B13b * A36
    BA21 = B21b * A11 + B22b * A21 + B23b * A31
    BA22 = B21b * A12 + B22b * A22 + B23b * A32
    BA23 = B21b * A13 + B22b * A23 + B23b * A33
    BA24 = B21b * A14 + B22b * A24 + B23b * A34
    BA25 = B21b * A15 + B22b * A25 + B23b * A35
    BA26 = B21b * A16 + B22b * A26 + B23b * A36
    sq = math.sqrt(2.0) * invNb * mask
    rows_ch = (
        BA11, BA12, BA13, BA14, BA15, BA16,
        BA21, BA22, BA23, BA24, BA25, BA26,
        sq * w1, sq * w2, sq * w3, sq * n * u1b, sq * n * u2b, sq * n * u3b,
    )
    jjt_ch = (j1, j2, j3, j4, j5, j6)
    return rows_ch, jjt_ch, d36_ch


# The 36 diagonal-extras channels (the row-major 6x6 block
# [D_rr, D_rt; D_rtᵀ, D_tt]) repeat 12 entries: D_rt appears transposed in
# the lower-left and D_tt is symmetric.  _D_UNIQUE lists the 24 distinct
# channel positions; _D24_TO_36 rebuilds the row-major 36 from them (exact:
# the voxel reduction is linear per channel).
_D_UNIQUE = tuple(range(18)) + (21, 22, 23, 28, 29, 35)
_D24_TO_36 = np.array(
    list(range(18))
    + [3, 9, 15, 18, 19, 20]
    + [4, 10, 16, 19, 21, 22]
    + [5, 11, 17, 20, 22, 23],
    dtype=np.int64,
)


def voxel_chunks(V: int, W: int, chunk_bytes: int = 256 * 1024 * 1024,
                 K: int = None):
    """(lo, hi) voxel ranges of the chunked evaluation, bounded by
    `chunk_bytes` with the JAX package's per-voxel budget
    (plane_eigen.py:387-391): the (W, 18) factor rows and their
    Gram-layout copy, plus the 60 per-entry output channels on the aligned
    layout (K None) or the (K, W) selection operand on the bucketed one."""
    per_vox_bytes = (W * 18 * 2 + (W * 60 if K is None else K * W)) * 4
    chunk = max(1, min(V, chunk_bytes // per_vox_bytes))
    return [(lo, min(V, lo + chunk)) for lo in range(0, V, chunk)]


def buckets_frame_table(buckets, W: int) -> torch.Tensor:
    """(W, Kf) int32 frame table over the flat entries of the bucketed
    buckets in list order (bucket b's entry (v, k) at Σ_{b' < b} V·K + v·K
    + k: the layout of the evaluation's one vals buffer), on their device;
    the sentinel is the total entry count.  Built on the host from the
    buckets' frame ids and counts (one copy each way per bucket and one to
    the device, once per solve).  The operand of entry_reduce; every
    evaluation of a solve reuses it.  Aligned buckets have no entry in it."""
    bs = [fa for fa in buckets if isinstance(fa, PlaneFactorArrays)]
    if not bs:
        raise ValueError("no bucketed factor arrays to build a frame table "
                         "for")
    frame = np.concatenate([fa.frame.cpu().numpy().reshape(-1) for fa in bs])
    n = np.concatenate([fa.n.cpu().numpy().reshape(-1) for fa in bs])
    tbl = _frame_table_np(frame, n, W)
    return torch.as_tensor(tbl).to(bs[0].n.device)


def frame_gather_table(fa: PlaneFactorArrays, W: int) -> torch.Tensor:
    """(W, Kf) int32 frame table of one bucket: buckets_frame_table of
    [fa].  Kept under the name of its counterpart in the JAX package
    (global_lvba_tpu.factors.plane_eigen.frame_gather_table), which the
    parity tests call beside it."""
    return buckets_frame_table([fa], W)


def segsum_table(z: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Frame-indexed segment sum of flat per-entry values z (VK, C) through
    the frame table: a (W, Kf, C) row gather and a sum over Kf.  The
    sentinel index VK, as any index outside [0, VK), gathers an all-zero
    row."""
    return _segsum(z, _safe_table(tbl, z.shape[0]))


class EvalSteps(NamedTuple):
    """The evaluation steps (see the module docstring)."""

    agg: object
    chain: object
    syrk_: object
    select: object
    chain_entries: object
    reduce: object
    chain_groups: object    # the chain's group form (aligned banded groups)


KERNEL_STEPS = EvalSteps(_soa.soa_agg_buckets, _soa.soa_chain, _gram.syrk_,
                         _sel.table_select_buckets, _soa.soa_chain_entries,
                         _sel.entry_reduce, _soa.soa_chain_groups)
PLAIN_STEPS = EvalSteps(_soa.soa_agg_buckets_plain, _soa.soa_chain_plain,
                        _gram.syrk_plain_, _sel.table_select_buckets_plain,
                        _soa.soa_chain_entries_plain, _sel.entry_reduce_plain,
                        _soa.soa_chain_groups_plain)


def _check_width(fa: AlignedPlaneFactorArrays, W: int):
    if fa.n.shape[1] != W:
        raise ValueError(
            f"aligned bucket width {fa.n.shape[1]} != solve width {W}; "
            f"build it with buckets_to_device(vm, W={W})"
        )


def _pose_operands(steps: EvalSteps, buckets, pose12: torch.Tensor, W: int):
    """soa_agg's pose operand of each bucket: the pose table itself on the
    aligned layout, the selected per-entry rows (V, K, 12) on the bucketed
    one, all of those from one select step over the buckets' ids (views of
    its one buffer)."""
    bs = [fa for fa in buckets if isinstance(fa, PlaneFactorArrays)]
    rows = iter(steps.select([fa.frame.reshape(-1) for fa in bs], pose12)
                if bs else ())
    out = []
    for fa in buckets:
        if isinstance(fa, PlaneFactorArrays):
            out.append(next(rows).view(*fa.n.shape, 12))
        else:
            _check_width(fa, W)
            out.append(pose12)
    return out


def plane_cost(fa, R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sum over voxels of λ_min (evaluate_only_residual, bavoxel.hpp:176-203)."""
    W = R.shape[0]
    poses = _pose_operands(KERNEL_STEPS, [fa], pose_table(R, p), W)
    return _soa.soa_agg(fa.n, fa.mu, fa.Pc, poses[0])[0].sum()


# the JAX package's name of the residual-only SoA evaluation, which
# plane_cost is (kernel 1 on the card)
plane_cost_soa = plane_cost


def plane_cost_aos(fa, R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Sum over voxels of λ_min in the array-of-structs form (the JAX
    package's reference path for tests): the world covariance of each
    voxel by the parallel-axis rule over its entries, then eigh3x3.  An
    aligned bucket's slot k is frame k; an id outside [0, W) reads the
    nearest pose (JAX's clamped gather), and its entry is dead anyway."""
    W = R.shape[0]
    if isinstance(fa, PlaneFactorArrays):
        frame = fa.frame.long().clamp(0, W - 1)
    else:
        frame = torch.arange(fa.n.shape[1], device=R.device).expand(
            fa.n.shape)
    Rk, pk = R[frame], p[frame]                          # (V, K, 3, 3), (V, K, 3)
    m = torch.einsum("vkij,vkj->vki", Rk, fa.mu) + pk
    S = torch.einsum("vkia,vkab,vkjb->vkij", Rk, fa.Pc, Rk)
    N = fa.n.sum(-1)
    N_safe = torch.where(N > 0, N, torch.ones_like(N))
    vbar = (fa.n[..., None] * m).sum(-2) / N_safe[:, None]
    d = m - vbar[:, None, :]
    S_tot = (S + fa.n[..., None, None] * (d[..., :, None] * d[..., None, :])
             ).sum(1)
    lams, _ = eigh3x3(S_tot / N_safe[:, None, None])
    return torch.where(N > 0, lams[..., 0], torch.zeros_like(N)).sum()


def plane_cost_grad_hess(
    fa,
    R: torch.Tensor,
    p: torch.Tensor,
    num_frames: int,
    chunk_bytes: int = 256 * 1024 * 1024,
    tbl: torch.Tensor = None,
    inv=None,
):
    """Total (residual, gradient (W, 6), Hessian (W, 6, W, 6)) of one
    factor-array set, aligned or bucketed: plane_cost_grad_hess_buckets of
    [fa].

    H = diag-blocks(Hd) - Σ_chunks A_cᵀ A_c, chunked over voxels so the
    (3V, 6W) factor rows stay within `chunk_bytes`.  tbl: the bucketed
    layout's frame_gather_table(fa, W), built here when not given (a
    solve builds it once).  inv (the JAX package's option, bucketed
    only): a frame_slot_table(fa, W), which switches nothing here (the
    chain writes its rows at their frame's columns already), or a
    GatherPlan, whose evaluation (the JAX package's _cgh_gather) reduces
    g and Hd through plan.tbl and chunks by the (3V, 6W) operand alone
    (chunk_bytes // (W·18·4·2) voxels).  On CUDA tensors every step is a
    kernel launch (float32 or float64); on CPU tensors the plain versions
    run."""
    if isinstance(inv, GatherPlan):
        return _cost_grad_hess_buckets(KERNEL_STEPS, [fa], R, p, num_frames,
                                       chunk_bytes, inv.tbl, plan_chunks=True)
    return _cost_grad_hess(KERNEL_STEPS, fa, R, p, num_frames, chunk_bytes,
                           tbl)


def plane_cost_grad_hess_buckets(
    buckets,
    R: torch.Tensor,
    p: torch.Tensor,
    num_frames: int,
    table: torch.Tensor = None,
    chunk_bytes: int = 256 * 1024 * 1024,
):
    """Total (residual, gradient (W, 6), Hessian (W, 6, W, 6)) over a list
    of factor-array sets, aligned and bucketed mixed (the sum of their
    plane_cost_grad_hess, the JAX package's solver.lm._total_cgh).

    One Gram accumulator takes every bucket's AᵀA and is negated once; the
    bucketed buckets' per-entry channels go to one vals buffer, summed by
    frame in one entry_reduce through `table`, their
    buckets_frame_table(buckets, W) (built here when not given: a solve
    builds it once, since building it reads the ids to the host); the
    aligned buckets' g and Hd come from their chain's voxel sums, added
    to the evaluation's running ones in the chain's launch."""
    return _cost_grad_hess_buckets(KERNEL_STEPS, buckets, R, p, num_frames,
                                   chunk_bytes, table)


def _cost_grad_hess(steps: EvalSteps, fa, R, p, num_frames: int,
                    chunk_bytes: int = 256 * 1024 * 1024, tbl=None):
    return _cost_grad_hess_buckets(steps, [fa], R, p, num_frames,
                                   chunk_bytes, tbl)


def _cost_grad_hess_buckets(steps: EvalSteps, buckets, R, p, num_frames: int,
                            chunk_bytes: int = 256 * 1024 * 1024,
                            table=None, plan_chunks: bool = False):
    W = num_frames
    pose12 = pose_table(R, p)
    dev, dt = R.device, R.dtype
    gram = torch.zeros((6 * W, 6 * W), dtype=dt, device=dev)
    resid = torch.zeros((), dtype=dt, device=dev)
    g = Hd = None  # the first aligned chain stores its sums, the rest add
    entries = sum(fa.n.numel() for fa in buckets
                  if isinstance(fa, PlaneFactorArrays))
    if entries and table is None:
        table = buckets_frame_table(buckets, W)
    vals = torch.empty((entries, 30), dtype=dt, device=dev)
    poses = _pose_operands(steps, buckets, pose12, W)
    aggs = steps.agg([(fa.n, fa.mu, fa.Pc, ps)
                      for fa, ps in zip(buckets, poses)])
    off = 0
    for fa, ps, (residv, pv) in zip(buckets, poses, aggs):
        resid = resid + residv.sum()
        if isinstance(fa, PlaneFactorArrays):
            VK = fa.n.numel()
            _bucketed_pass(steps, fa, ps, pv, W, gram, chunk_bytes,
                           vals[off:off + VK], 0 if plan_chunks else None)
            off += VK
        else:
            g, Hd = _aligned_pass(steps, fa, pose12, pv, W, gram,
                                  chunk_bytes, g, Hd)
    if g is None:
        g = torch.zeros((W, 6), dtype=dt, device=dev)
        Hd = torch.zeros((W, 6, 6), dtype=dt, device=dev)
    if entries:
        gHd = steps.reduce(vals, table)                         # (W, 30)
        g = g + gHd[:, :6]
        Hd = Hd + gHd[:, 6:][:, _soa.d24_to_36(dev)].reshape(W, 6, 6)
    H = add_block_diag(gram.neg_().reshape(W, 6, W, 6), Hd, W)
    return resid, g, H


def _aligned_pass(steps, fa, pose12, pv, W, gram, chunk_bytes, g, Hd):
    """An aligned bucket with its soa_agg output pv: its voxel sums added
    by the chain, chunk by chunk, to the running g (W, 6) and Hd (W, 6, 6)
    in place (stored by the first chunk when they are None), its AᵀA added
    into gram.  Returns the running g and Hd."""
    for lo, hi in voxel_chunks(fa.n.shape[0], W, chunk_bytes):
        A, g, Hd = steps.chain(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi],
                               pose12, pv[lo:hi], g, Hd)
        steps.syrk_(gram, A)
    return g, Hd


def _bucketed_pass(steps, fa, poses, pv, W, gram, chunk_bytes, vals,
                   chunk_k=None):
    """A bucketed bucket with its per-entry pose rows and soa_agg output
    pv: its AᵀA added into gram, its per-entry g/Hd channels written to
    vals (V·K, 30).  Chunked by voxel_chunks with K = chunk_k (None: the
    bucket's K; 0: the GatherPlan budget, the (3V, 6W) operand alone)."""
    V, K = fa.n.shape
    for lo, hi in voxel_chunks(V, W, chunk_bytes,
                               K=K if chunk_k is None else chunk_k):
        A, _ = steps.chain_entries(fa.n[lo:hi], fa.mu[lo:hi], fa.Pc[lo:hi],
                                   poses[lo:hi], fa.frame[lo:hi], pv[lo:hi],
                                   W, vals[lo * K:hi * K])
        steps.syrk_(gram, A)


def add_block_diag(H: torch.Tensor, Hd: torch.Tensor, W: int) -> torch.Tensor:
    """H (W, 6, W, 6) += diag blocks Hd (W, 6, 6), in place (H's diagonal
    blocks are the only cells touched; every index is distinct)."""
    idx = torch.arange(W, device=H.device)
    H[idx, :, idx, :] += Hd
    return H


# ---------------------------------------------------------------------------
# Block-banded groups (large W) and the matrix-free rows evaluation
# ---------------------------------------------------------------------------
# A voxel's observers are temporally contiguous frames, so its factor rows
# touch a narrow column window of the (6W)² Hessian.  Grouping voxels by
# the frame block their span starts in and Gramming each group at local
# width 2B cuts the Gram's flops by ~(2B/W)² against the dense assembly
# (the JAX package's plane_eigen.py:547-865).


class BandedHost(NamedTuple):
    """The host side of one bucket's BandedGroups or AlignedBandedGroups:
    what a solve's plan (banded_plan) builds its tables from, so nothing
    is read back.  frame and live describe the stack's rows of the
    evaluation's vals: an entry each on the gather layout, a (group,
    slot) sum each on the aligned one."""

    frame: np.ndarray           # (G, Vp, K) global frame ids of the stack;
                                # aligned: (G, 2B) each slot's frame
    live: np.ndarray            # (G, Vp, K) bool, n > 0; aligned: (G, 2B),
                                # a voxel of the group observes the slot
    offsets: tuple              # the G window offsets
    wide_frame: np.ndarray      # (Vw, K)
    wide_live: np.ndarray       # (Vw, K)


class BandedGroups(NamedTuple):
    """Stacked banded groups of one bucket: G groups of equal padded shape
    (Vp voxels of K slots), window g covering frames offset[g] ..
    offset[g] + 2B - 1.  Voxels whose observers span more than two blocks
    are the full-width straggler group (Vw = 0 when there are none)."""

    fa: PlaneFactorArrays       # each leaf (G, Vp, K[, ...]), global ids
    inv: torch.Tensor           # (G, Vp, 2B) int32 local frame-slot table
    offset: torch.Tensor        # (G,) int32 frame offset of each window
    wide_fa: PlaneFactorArrays  # straggler voxels, full width
    wide_inv: torch.Tensor      # (Vw, W) int32
    host: BandedHost


class AlignedBandedGroups(NamedTuple):
    """Banded groups in the frame-aligned local layout (the JAX package's
    AlignedBandedGroups, its LVBA_BANDED_ALIGNED): slot k of group g IS
    frame offset[g] + k, so a group evaluates as an aligned bucket of
    width 2B on its window of poses (the group forms of soa_agg and
    soa_chain) and its Gram operand is its rows.  Stragglers keep the
    gather layout (full width)."""

    fa: AlignedPlaneFactorArrays  # each leaf (G, Vp, 2B[, ...])
    offset: torch.Tensor          # (G,) int32 frame offset of each window
    wide_fa: PlaneFactorArrays    # straggler voxels, full width
    wide_inv: torch.Tensor        # (Vw, W) int32
    host: BandedHost


def group_width(bg) -> int:
    """The local width 2B of a bucket's banded groups, either layout."""
    if isinstance(bg, AlignedBandedGroups):
        return int(bg.fa.n.shape[-1])
    return int(bg.inv.shape[-1])


def _ids_to_host(fa: PlaneFactorArrays):
    """A bucket's (frame ids, live mask) as numpy, in one read."""
    both = torch.stack([fa.frame.to(torch.int32),
                        (fa.n > 0).to(torch.int32)]).cpu().numpy()
    return both[0], both[1].astype(bool)


def _slot_table(frame: torch.Tensor, live: torch.Tensor, off,
                width: int) -> torch.Tensor:
    """(..., V, width) int32 inverse table of voxels (..., V, K), on their
    device with no read to the host: entry (v, w) is the slot k of voxel
    v's observation of frame off + w, or K (the zero pad row) where v does
    not observe it; ids outside the window have no entry.  off: an int, or
    a tensor of one offset per leading index.  A voxel observes a frame at
    most once, so every kept entry has a cell of its own (the rest write
    one spare cell, dropped)."""
    K = frame.shape[-1]
    lead = frame.shape[:-1]
    n = math.prod(lead)
    if torch.is_tensor(off):
        off = off.long().reshape(off.shape + (1,) * (frame.dim() - off.dim()))
    loc = frame.long() - off
    keep = live & (loc >= 0) & (loc < width)
    cell = torch.arange(n, device=frame.device).view(lead + (1,)) * width
    cell = torch.where(keep, cell + loc, n * width)
    k = torch.arange(K, dtype=torch.int32, device=frame.device)
    inv = torch.full((n * width + 1,), K, dtype=torch.int32,
                     device=frame.device)
    inv.scatter_(0, cell.reshape(-1), k.expand(frame.shape).reshape(-1))
    return inv[:-1].view(lead + (width,))


def frame_slot_table(fa: PlaneFactorArrays, W: int) -> torch.Tensor:
    """(V, W) int32 inverse table of a bucket on its device: entry (v, w)
    is the k-slot of voxel v's observation of frame w, or K where v does
    not observe w (each voxel observes a frame at most once)."""
    return _slot_table(fa.frame, fa.n > 0, 0, W)


class GatherPlan(NamedTuple):
    """The gather tables of one bucket (the JAX package's GatherPlan, its
    LVBA_GATHER_M evaluation): `tbl` (W, Kf) the frame table through which
    entry_reduce sums g and Hd (frame_gather_table), `inv` (V, W) the
    frame -> slot table (frame_slot_table).  The JAX package expands its
    factor rows to the (3V, 6W) Gram operand through `inv`; here
    soa_chain_entries writes that operand straight from the frame ids, so
    `inv` is carried for the JAX package's interface and no evaluation
    reads it."""

    inv: torch.Tensor   # (V, W) int32
    tbl: torch.Tensor   # (W, Kf) int32


def build_gather_plan(fa: PlaneFactorArrays, W: int) -> GatherPlan:
    """The GatherPlan of a bucket on its device: the slot table made there,
    the frame table on the host from the bucket's ids and counts (one
    read, one copy)."""
    frame, live = _ids_to_host(fa)
    tbl = to_device([_frame_table_np(frame, live, W)], fa.n.device)[0]
    return GatherPlan(frame_slot_table(fa, W), tbl)


def _banded_layout(frame: np.ndarray, valid: np.ndarray, W: int,
                   block: int = None):
    """The host plan of build_banded_groups, with the JAX package's rules:
    the block is the p99 observer span rounded up to a power of two, at
    least 8 and at most W/2; the width 2B; a group a start block with the
    last window shifted left into range; Vp a power of two, at least 8;
    stragglers (span over two blocks) full width, Vw = 0 when there are
    none.  Returns (groups: voxel index arrays, offsets, Vp, width,
    stragglers: index array, Vw)."""
    any_valid = valid.any(axis=1)
    fmin = np.where(any_valid, np.where(valid, frame, W).min(axis=1), 0)
    fmax = np.where(any_valid, np.where(valid, frame, -1).max(axis=1), 0)
    span = fmax - fmin + 1
    if block is None:
        p99 = (float(np.percentile(span[any_valid], 99))
               if any_valid.any() else 1.0)
        block = 1 << max(int(np.ceil(np.log2(max(p99, 1.0)))), 3)
    block = min(block, max(W // 2, 1))
    width = min(2 * block, W)
    n_blk = (W + block - 1) // block
    start_blk = fmin // block
    wide = (fmax // block - start_blk) > 1
    idxs, offs = [], []
    for s in range(n_blk):
        idx = np.flatnonzero(any_valid & ~wide & (start_blk == s))
        if idx.size:
            idxs.append(idx)
            offs.append(min(s * block, W - width))
    Vp = max(8, 1 << int(np.ceil(np.log2(max(
        [i.size for i in idxs], default=1)))))
    if not idxs:
        idxs, offs = [np.zeros(0, np.int64)], [0]
    wid = np.flatnonzero(any_valid & wide)
    # Vw = 0 without stragglers: a padded empty group would cost a full
    # (6W)² Gram of zeros per evaluation
    Vw = 0 if wid.size == 0 else max(8, 1 << int(np.ceil(np.log2(wid.size))))
    return idxs, offs, Vp, width, wid, Vw


def _gather_voxels(fa: PlaneFactorArrays, idx: torch.Tensor,
                   shape) -> PlaneFactorArrays:
    """fa's voxels idx (an index V picks a zero voxel: padding) as leaves
    of leading shape `shape`."""
    def take(x):
        xp = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        return xp[idx].reshape(tuple(shape) + tuple(x.shape[1:])).contiguous()

    return PlaneFactorArrays(*(take(x) for x in fa))


def _aligned_grid(stack: PlaneFactorArrays, off: torch.Tensor,
                  width: int) -> AlignedPlaneFactorArrays:
    """The dense (G, Vp, width) local grids of a gathered group stack
    (G, Vp, K) on its device: entry (v, k) of group g lands at slot
    frame − off[g]; a dead entry (n == 0) or one outside the window lands
    nowhere (on a spare cell, dropped), so those cells stay zero.  A voxel
    observes a frame at most once: no two entries share a cell."""
    G, Vp, K = stack.n.shape
    dev = stack.n.device
    loc = stack.frame.long() - off.long().view(G, 1, 1)
    keep = (stack.n > 0) & (loc >= 0) & (loc < width)
    spare = G * Vp * width
    cell = torch.arange(G * Vp, device=dev).view(G, Vp, 1) * width + loc
    cell = torch.where(keep, cell, spare).reshape(-1)

    def grid(x):
        tail = tuple(x.shape[3:])
        out = x.new_zeros((spare + 1,) + tail)
        out[cell] = x.reshape((-1,) + tail)
        return out[:-1].view((G, Vp, width) + tail)

    return AlignedPlaneFactorArrays(grid(stack.n), grid(stack.mu),
                                    grid(stack.Pc))


def build_banded_groups(fa: PlaneFactorArrays, W: int, block: int = None,
                        aligned: bool = False):
    """Stacked banded voxel groups of one bucket (the JAX package's
    plane_eigen.build_banded_groups, its rules in _banded_layout).  The
    plan is host numpy from the bucket's frame ids and counts (one read
    to the host), its index arrays go to the bucket's device in one copy,
    and the groups and their slot tables are made there; the host plan is
    kept (`host`).  aligned=True gives AlignedBandedGroups (the JAX
    package's pack_aligned): each group's entries scattered on the device
    into its dense (Vp, 2B) local grid, slot k at frame offset[g] + k; the
    stragglers as on the gather layout."""
    frame, live = _ids_to_host(fa)
    V, K = frame.shape
    idxs, offs, Vp, width, wid, Vw = _banded_layout(frame, live, W, block)
    gidx = np.full((len(idxs), Vp), V, np.int64)
    for g, idx in enumerate(idxs):
        gidx[g, :idx.size] = idx
    widx = np.full(Vw, V, np.int64)
    widx[:wid.size] = wid
    # an index V picks a dead voxel (frame 0, n 0), as _gather_voxels does
    fpad = np.concatenate([frame, np.zeros((1, K), frame.dtype)])
    lpad = np.concatenate([live, np.zeros((1, K), bool)])
    host = BandedHost(fpad[gidx], lpad[gidx], tuple(offs), fpad[widx],
                      lpad[widx])
    gidx_d, widx_d, off_d = to_device(
        [gidx, widx, np.asarray(offs, np.int32)], fa.n.device)
    stack = _gather_voxels(fa, gidx_d, gidx.shape)
    wide = _gather_voxels(fa, widx_d, (Vw,))
    if aligned:
        # the rows of an aligned stack's vals: a (group, slot) sum each, at
        # frame offset[g] + k, live where a voxel of the group observes it
        offs_np = np.asarray(offs, np.int64)
        win = offs_np[:, None] + np.arange(width)
        slot_live = np.zeros(win.shape, bool)
        g_i, v_i, k_i = np.nonzero(host.live)
        slot_live[g_i, host.frame[g_i, v_i, k_i] - offs_np[g_i]] = True
        return AlignedBandedGroups(
            fa=_aligned_grid(stack, off_d, width), offset=off_d,
            wide_fa=wide, wide_inv=_slot_table(wide.frame, wide.n > 0, 0, W),
            host=host._replace(frame=win, live=slot_live))
    return BandedGroups(
        fa=stack, inv=_slot_table(stack.frame, stack.n > 0, off_d, width),
        offset=off_d, wide_fa=wide,
        wide_inv=_slot_table(wide.frame, wide.n > 0, 0, W), host=host)


class BandedPlan(NamedTuple):
    """A solve's banded groups in the form one evaluation and one solve
    read, built once per solve (banded_plan): each bucket's group stack
    flattened to one (G·Vp, K) bucket with its global frame ids (the pose
    selection) and its local ids frame − offset[g] (the chain's columns at
    width 2B), or, for aligned groups, to one (G·Vp, 2B) aligned bucket
    with its window frames offset[g] + k (the pose selection: one
    (G, 2B, 12) window table); the straggler buckets at full width, one
    frame table over all their vals rows, stacks first (entry_reduce),
    and the compact solve's window operands
    (solver.dist_solve.banded_windows)."""

    stacks: list    # PlaneFactorArrays (G·Vp, K) or
                    # AlignedPlaneFactorArrays (G·Vp, 2B) per bucket
    local: list     # (G·Vp, K) int32 local frame ids per bucket, or the
                    # aligned stack's (G·2B,) int32 window frames
    dims: list      # (G, Vp, width) per bucket
    offsets: list   # tuple of G window offsets (host ints) per bucket
    wide: list      # straggler PlaneFactorArrays (Vw > 0 only)
    table: torch.Tensor  # (W, Kf) int32 merged frame table
    windows: tuple  # (wins, slots) of solve_damped_cg_banded


def banded_plan(groups, W: int) -> BandedPlan:
    """The BandedPlan of a solve's BandedGroups (one per bucket), from
    their host plans: the merged frame table and the window operands go to
    the device in one copy, and nothing is read back; the local ids are
    made on the device."""
    stacks, local, dims, offsets, wide = [], [], [], [], []
    frames, lives = [], []
    for bg in groups:
        G, Vp, K = bg.fa.n.shape
        w = group_width(bg)
        flat = tuple(x.reshape((G * Vp,) + tuple(x.shape[2:])) for x in bg.fa)
        if isinstance(bg, AlignedBandedGroups):
            stacks.append(AlignedPlaneFactorArrays(*flat))
            win = bg.offset.view(G, 1) + torch.arange(
                w, dtype=torch.int32, device=bg.offset.device)
            local.append(win.reshape(-1).to(torch.int32))
        else:
            stacks.append(PlaneFactorArrays(*flat))
            loc = bg.fa.frame - bg.offset.view(G, 1, 1)
            local.append(loc.reshape(G * Vp, K).to(torch.int32).contiguous())
        dims.append((G, Vp, w))
        offsets.append(bg.host.offsets)
        frames.append(bg.host.frame)
        lives.append(bg.host.live)
    for bg in groups:
        if bg.wide_fa.n.shape[0]:
            wide.append(bg.wide_fa)
            frames.append(bg.host.wide_frame)
            lives.append(bg.host.wide_live)
    table = _frame_table_np(np.concatenate([f.reshape(-1) for f in frames]),
                            np.concatenate([v.reshape(-1) for v in lives]),
                            W)
    out = to_device([table] + banded_windows_np(
        offsets, [d[2] for d in dims], W), groups[0].fa.n.device)
    return BandedPlan(stacks, local, dims, offsets, wide, out[0],
                      (out[1:-1], out[-1]))


def banded_cost(groups, buckets, W: int):
    """(banded, dense) Gram costs of the JAX package's probe
    (solver/lm.py:246-257): Σ G·Vp·width² + Vw·W² against Σ V·W²."""
    dense = sum(fa.n.shape[0] * W * W for fa in buckets)
    banded = sum(bg.fa.n.shape[0] * bg.fa.n.shape[1] * group_width(bg) ** 2
                 + bg.wide_fa.n.shape[0] * W * W for bg in groups)
    return banded, dense


def _banded_poses(steps: EvalSteps, plan: BandedPlan, pose12: torch.Tensor):
    """The soa_agg pose operand of each stack and straggler bucket, from
    one select step: per-entry rows (V, K, 12) on the gather layout, the
    (G, 2B, 12) window table of an aligned stack."""
    fas = plan.stacks + plan.wide
    ids = [loc.reshape(-1) if isinstance(fa, AlignedPlaneFactorArrays)
           else fa.frame.reshape(-1)
           for fa, loc in zip(plan.stacks, plan.local)]
    ids += [fa.frame.reshape(-1) for fa in plan.wide]
    sel = steps.select(ids, pose12)
    out = []
    for i, (fa, rows) in enumerate(zip(fas, sel)):
        if isinstance(fa, AlignedPlaneFactorArrays):
            G, _, w = plan.dims[i]
            out.append(rows.view(G, w, 12))
        else:
            out.append(rows.view(*fa.n.shape, 12))
    return out


def _vals_rows(fa, dims) -> int:
    """A stack's or straggler bucket's rows of the evaluation's vals: an
    entry each, or a (group, slot) sum each on an aligned stack."""
    if isinstance(fa, AlignedPlaneFactorArrays):
        return dims[0] * dims[2]
    return fa.n.numel()


def _banded_eval(steps: EvalSteps, plan: BandedPlan, R, p, W: int,
                 compact: bool, chunk_bytes: int = 256 * 1024 * 1024):
    """One banded evaluation -> (resid, g (W, 6), Hd (W, 6, 6), grams,
    wide).  One select and one soa_agg pass over every stack and straggler
    bucket; each stack's chain is one chain_entries launch at width 2B on
    its local ids (an aligned stack: one chain_groups launch on its
    windows, writing a (group, slot) row each), whose A (3·G·Vp, 12B) is
    the stacked group operand, and its group Grams +AᵀA (G, 12B, 12B) one
    torch.bmm; one entry_reduce sums g and Hd over the merged table.  With `compact`, the last output
    is the stragglers' full-width A (3Vw, 6W) per straggler bucket; else
    it is the (6W, 6W) Gram accumulator with the stragglers' AᵀA (syrk_,
    chunked as the bucketed pass) and every group's Gram added into its
    window, in group order (overlapping windows, no atomics: bitwise
    repeatable)."""
    pose12 = pose_table(R, p)
    dev, dt = R.device, R.dtype
    fas = plan.stacks + plan.wide
    poses = _banded_poses(steps, plan, pose12)
    aggs = steps.agg([(fa.n, fa.mu, fa.Pc, ps) for fa, ps in zip(fas, poses)])
    resid = torch.zeros((), dtype=dt, device=dev)
    for residv, _ in aggs:
        resid = resid + residv.sum()
    rows = [_vals_rows(fa, d) for fa, d in zip(plan.stacks, plan.dims)]
    vals = torch.empty((sum(rows) + sum(fa.n.numel() for fa in plan.wide),
                        30), dtype=dt, device=dev)
    grams, off = [], 0
    for fa, ps, (_, pv), loc, (G, Vp, w), nr in zip(
            plan.stacks, poses, aggs, plan.local, plan.dims, rows):
        if isinstance(fa, AlignedPlaneFactorArrays):
            A, _ = steps.chain_groups(fa.n, fa.mu, fa.Pc, ps, pv,
                                      vals[off:off + nr])
        else:
            A, _ = steps.chain_entries(fa.n, fa.mu, fa.Pc, ps, loc, pv, w,
                                       vals[off:off + nr])
        A3 = A.view(G, 3 * Vp, 6 * w)
        grams.append(torch.bmm(A3.transpose(1, 2), A3))
        off += nr
    wide = []
    gram = None if compact else torch.zeros((6 * W, 6 * W), dtype=dt,
                                            device=dev)
    n_st = len(plan.stacks)
    for fa, ps, (_, pv) in zip(plan.wide, poses[n_st:], aggs[n_st:]):
        VK = fa.n.numel()
        if compact:
            A, _ = steps.chain_entries(fa.n, fa.mu, fa.Pc, ps, fa.frame, pv,
                                       W, vals[off:off + VK])
            wide.append(A)
        else:
            _bucketed_pass(steps, fa, ps, pv, W, gram, chunk_bytes,
                           vals[off:off + VK])
        off += VK
    gHd = steps.reduce(vals, plan.table)
    g = gHd[:, :6]
    Hd = gHd[:, 6:][:, _soa.d24_to_36(dev)].reshape(W, 6, 6)
    if compact:
        return resid, g, Hd, grams, wide
    for gr, offs, (_, _, w) in zip(grams, plan.offsets, plan.dims):
        for i, o in enumerate(offs):
            gram[6 * o:6 * (o + w), 6 * o:6 * (o + w)] += gr[i]
    return resid, g, Hd, grams, gram


def banded_cost_grad_hess(plan: BandedPlan, R, p, W: int):
    """(residual, gradient (W, 6), Hessian (W, 6, W, 6)) through the banded
    groups (the JAX package's _lm_banded_jitted evaluation): the dense H
    from the group Grams and the stragglers' AᵀA, then the block diagonal."""
    resid, g, Hd, _, H = _banded_eval(KERNEL_STEPS, plan, R, p, W, False)
    return resid, g, add_block_diag(H.neg_().reshape(W, 6, W, 6), Hd, W)


def banded_cost_grad_compact(plan: BandedPlan, R, p, W: int):
    """(residual, g (W, 6), Hd (W, 6, 6), grams, wide) without the (6W)² H
    (the JAX package's _cgh_banded_compact_exec):
    H = diag-blocks(Hd) − Σ windows(grams) − Σ wideᵀ wide, which
    solver.dist_solve.solve_damped_cg_banded applies."""
    return _banded_eval(KERNEL_STEPS, plan, R, p, W, True)


def banded_cgh(bg: BandedGroups, R, p, W: int):
    """(resid, g (W, 6), Hd (W, 6, 6), H (6W, 6W) cross part) of one
    bucket's banded groups and stragglers (the JAX package's
    plane_eigen.banded_cgh)."""
    resid, g, Hd, _, gram = _banded_eval(KERNEL_STEPS, banded_plan([bg], W),
                                         R, p, W, False)
    return resid, g, Hd, gram.neg_()


def banded_cgh_compact(bg: BandedGroups, R, p, W: int):
    """(resid, g (W, 6), Hd (W, 6, 6), grams (G, 12B, 12B), wide_M) of one
    bucket (the JAX package's plane_eigen.banded_cgh_compact): grams hold
    +AᵀA per group; wide_M is the stragglers' A in (3Vw, 6W) row-block
    layout (the JAX package's (Vw, W, 3, 6) M, row (v, r) at column
    6w + c), (0, 6W) without stragglers."""
    resid, g, Hd, grams, wide = _banded_eval(
        KERNEL_STEPS, banded_plan([bg], W), R, p, W, True)
    wM = wide[0] if wide else R.new_zeros((0, 6 * W))
    return resid, g, Hd, grams[0], wM


class RowsPlan(NamedTuple):
    """The rows evaluation's per-solve operands (rows_plan): each bucket's
    slot ids (the chain's columns: frame := slot k, width := K), its own
    frame table (the matvec's segment sums) and the merged table over all
    buckets (entry_reduce)."""

    slots: list          # (V, K) int32 slot ids per bucket
    tables: list         # (W, Kf) int32 frame table per bucket
    table: torch.Tensor  # (W, Kf) int32 merged frame table


def rows_plan(buckets, W: int) -> RowsPlan:
    """The RowsPlan of a solve's buckets: their ids and counts read to the
    host once per bucket, the tables copied to the device in one copy."""
    slots = [torch.arange(fa.n.shape[1], dtype=torch.int32,
                          device=fa.n.device).expand(fa.n.shape).contiguous()
             for fa in buckets]
    ids = [_ids_to_host(fa) for fa in buckets]
    merged = _frame_table_np(np.concatenate([f.reshape(-1) for f, _ in ids]),
                             np.concatenate([v.reshape(-1) for _, v in ids]),
                             W)
    tables = to_device([_frame_table_np(f, v, W) for f, v in ids] + [merged],
                       buckets[0].n.device)
    return RowsPlan(slots, tables[:-1], tables[-1])


def _rows_eval(steps: EvalSteps, buckets, plan: RowsPlan, R, p, W: int):
    """(resid, g (W, 6), Hd (W, 6, 6), rows) over the buckets: the bucketed
    evaluation with each chain_entries launch at width K on the slot ids,
    so its A (3V, 6K) holds entry (v, k)'s three factor rows at columns
    6k..6k+5 (the compact rows in row-block layout, never 6W columns), and
    no Gram."""
    pose12 = pose_table(R, p)
    dev, dt = R.device, R.dtype
    poses = _pose_operands(steps, buckets, pose12, W)
    aggs = steps.agg([(fa.n, fa.mu, fa.Pc, ps)
                      for fa, ps in zip(buckets, poses)])
    resid = torch.zeros((), dtype=dt, device=dev)
    vals = torch.empty((sum(fa.n.numel() for fa in buckets), 30), dtype=dt,
                       device=dev)
    rows, off = [], 0
    for fa, ps, (residv, pv), sl in zip(buckets, poses, aggs, plan.slots):
        resid = resid + residv.sum()
        V, K = fa.n.shape
        A, _ = steps.chain_entries(fa.n, fa.mu, fa.Pc, ps, sl, pv, K,
                                   vals[off:off + V * K])
        rows.append(A)
        off += V * K
    gHd = steps.reduce(vals, plan.table)
    Hd = gHd[:, 6:][:, _soa.d24_to_36(dev)].reshape(W, 6, 6)
    return resid, gHd[:, :6], Hd, rows


def plane_cost_grad_rows(fa: PlaneFactorArrays, R, p, W: int,
                         tbl: torch.Tensor = None):
    """Compact linearization of one bucket for the matrix-free damped solve
    (the JAX package's plane_eigen.plane_cost_grad_rows) -> (resid,
    g (W, 6), Hd (W, 6, 6), rows (3V, 6K)), H = diag-blocks(Hd) − MᵀM
    with M the frame expansion of the rows.  The rows are in row-block
    layout: row (v, r), columns 6k..6k+5 hold the JAX package's
    rows18[v, k, 6r:6r+6].  tbl (the bucket's frame_gather_table) is read
    for g and Hd; built here when not given."""
    plan = rows_plan([fa], W)
    if tbl is not None:
        plan = plan._replace(tables=[tbl], table=tbl)
    resid, g, Hd, rows = _rows_eval(KERNEL_STEPS, [fa], plan, R, p, W)
    return resid, g, Hd, rows[0]


def plane_rows_cross_diag(rows: torch.Tensor, tbl: torch.Tensor, W: int):
    """Per-frame 6x6 diagonal blocks (W, 6, 6) of MᵀM from compact rows
    (3V, 6K) and their frame table (solver.dist_solve.rows_cross_diag)."""
    E = (rows.shape[0] // 3) * (rows.shape[1] // 6)
    return rows_cross_diag(rows, _safe_table(tbl, E)).reshape(W, 6, 6)


def plane_rows_matvec(rows: torch.Tensor, frame: torch.Tensor,
                      tbl: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Cross-term matvec (MᵀM) x from compact rows (3V, 6K), their frame
    ids (V, K) and frame table (solver.dist_solve.rows_matvec).  x (W, 6)
    -> (W, 6); an id outside [0, W) gathers and adds nothing."""
    W = x.shape[0]
    return rows_matvec(rows, _safe_frames(frame, W),
                       _safe_table(tbl, frame.numel()), x)
