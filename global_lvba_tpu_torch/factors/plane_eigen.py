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
from ..ops.eigh3 import eigh3_soa


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


def _frame_table_np(frame: np.ndarray, n: np.ndarray, W: int) -> np.ndarray:
    """(W, Kf) frame-major index table over the FLAT (v, k) entries: row w
    lists every valid entry observing frame w, padded with the sentinel
    index V*K (which gathers an all-zero row).  An entry is valid when it
    is live (n > 0) and its frame id lies in [0, W).  Kf = max entries per
    frame, rounded up to 8."""
    flat_f = frame.reshape(-1).astype(np.int64)
    valid = (n.reshape(-1) > 0) & (flat_f >= 0) & (flat_f < W)
    sel = np.flatnonzero(valid)
    fsel = flat_f[sel]
    order = np.argsort(fsel, kind="stable")
    sel = sel[order]
    fsel = fsel[order]
    counts = np.bincount(fsel, minlength=W)
    Kf = max(int(counts.max()), 1)
    Kf = (Kf + 7) // 8 * 8
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    idx = np.full((W, Kf), flat_f.size, np.int32)
    if fsel.size:
        pos = np.arange(fsel.size) - starts[fsel]
        idx[fsel, pos] = sel.astype(np.int32)
    return idx


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
    E = z.shape[0]
    t = tbl.long()
    t = t.masked_fill((t < 0) | (t >= E), E)
    zpad = torch.cat([z, z.new_zeros((1,) + tuple(z.shape[1:]))])
    return zpad[t].sum(dim=1)


class EvalSteps(NamedTuple):
    """The evaluation steps (see the module docstring)."""

    agg: object
    chain: object
    syrk_: object
    select: object
    chain_entries: object
    reduce: object


KERNEL_STEPS = EvalSteps(_soa.soa_agg_buckets, _soa.soa_chain, _gram.syrk_,
                         _sel.table_select_buckets, _soa.soa_chain_entries,
                         _sel.entry_reduce)
PLAIN_STEPS = EvalSteps(_soa.soa_agg_buckets_plain, _soa.soa_chain_plain,
                        _gram.syrk_plain_, _sel.table_select_buckets_plain,
                        _soa.soa_chain_entries_plain, _sel.entry_reduce_plain)


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


def plane_cost_grad_hess(
    fa,
    R: torch.Tensor,
    p: torch.Tensor,
    num_frames: int,
    chunk_bytes: int = 256 * 1024 * 1024,
    tbl: torch.Tensor = None,
):
    """Total (residual, gradient (W, 6), Hessian (W, 6, W, 6)) of one
    factor-array set, aligned or bucketed: plane_cost_grad_hess_buckets of
    [fa].

    H = diag-blocks(Hd) - Σ_chunks A_cᵀ A_c, chunked over voxels so the
    (3V, 6W) factor rows stay within `chunk_bytes`.  tbl: the bucketed
    layout's frame_gather_table(fa, W), built here when not given (a
    solve builds it once).  On CUDA tensors every step is a kernel
    launch (float32 or float64); on CPU tensors the plain versions run."""
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
                            table=None):
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
                           vals[off:off + VK])
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


def _bucketed_pass(steps, fa, poses, pv, W, gram, chunk_bytes, vals):
    """A bucketed bucket with its per-entry pose rows and soa_agg output
    pv: its AᵀA added into gram, its per-entry g/Hd channels written to
    vals (V·K, 30)."""
    V, K = fa.n.shape
    for lo, hi in voxel_chunks(V, W, chunk_bytes, K=K):
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
