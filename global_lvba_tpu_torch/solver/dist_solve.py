"""Block-Jacobi preconditioned CG for the damped reduced system (port of
global_lvba_tpu.solver.dist_solve, single device: the closed-form block
inverses, the shared PCG loop, and its operators: the assembled H
(solve_damped_cg), the banded groups' Grams (solve_damped_cg_banded), the
compact factor rows (solve_damped_cg_rows) and the visual BA's reduced
camera system (solve_schur_cg_mf, _pm and _pm_tiers)), with the segment
tables and the fixed-order sums through them that the matvecs and the
factor evaluation's frame sums share.

The loop has the reference's form: exactly `max_iters` trips, the state
frozen by torch.where once ||r||/||b|| < tol, and no read to the host.
On CUDA tensors each solve runs its preamble and trips as one CUDA graph
(the counterpart of the reference's single compiled fori_loop), captured
once per operand shapes and replayed per solve; on the CPU the same trips
run eagerly.  Every gather, sum and product of the trips is a fixed-order
op (no atomic scatter), so two solves are bitwise equal.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from ..utils import profiling


# ---------------------------------------------------------------------------
# Segment tables and the fixed-order sums through them (the frame sums of
# the evaluation's plain steps and of the banded and rows matvecs)
# ---------------------------------------------------------------------------


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
    # a stable sort of 16-bit keys is numpy's radix sort (the same order)
    order = np.argsort(fsel.astype(np.uint16) if W <= 1 << 16 else fsel,
                       kind="stable")
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


def to_device(arrays, device):
    """Host integer arrays as tensors of their shapes and dtypes on
    `device`, in one copy (one int32 buffer, split and cast there): a
    solve's index operands cost one synchronizing copy, not one each."""
    flat = np.concatenate([np.asarray(a).reshape(-1).astype(np.int32)
                           for a in arrays])
    buf = torch.as_tensor(flat).to(device)
    out, o = [], 0
    for a in arrays:
        out.append(buf[o:o + a.size].view(a.shape).to(getattr(torch,
                                                              a.dtype.name)))
        o += a.size
    return out


def _safe_table(tbl: torch.Tensor, E: int) -> torch.Tensor:
    """tbl as int64 with every index outside [0, E) set to E (the zero
    row _segsum appends)."""
    t = tbl.long()
    return t.masked_fill((t < 0) | (t >= E), E)


def _segsum(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Segment sum of the rows of z (E, ...) through a _safe_table t (S, C):
    a (S, C, ...) gather and a fixed-order sum over C."""
    zpad = torch.cat([z, z.new_zeros((1,) + tuple(z.shape[1:]))])
    return zpad[t].sum(dim=1)


def _safe_frames(frame: torch.Tensor, W: int) -> torch.Tensor:
    """frame as int64 with every id outside [0, W) set to W."""
    f = frame.long()
    return f.masked_fill((f < 0) | (f >= W), W)


def rows_cross_diag(rows: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-frame 6x6 diagonal blocks (W, 6, 6) of MᵀM from compact rows
    (3V, 6K) through the _safe_table t (W, Kf) of their entries: block w
    sums rows_{vkr}ᵀ rows_{vkr} over the entries of frame w."""
    V, K = rows.shape[0] // 3, rows.shape[1] // 6
    r = rows.view(V, 3, K, 6)
    P = torch.einsum("vrkc,vrkd->vkcd", r, r).reshape(V * K, 36)
    return _segsum(P, t).view(-1, 6, 6)


def rows_matvec(rows: torch.Tensor, fsafe: torch.Tensor, t: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """(MᵀM) x (W, 6) from compact rows (3V, 6K), their _safe_frames fsafe
    (V, K) and _safe_table t: per voxel s_r = Σ_{k,c} rows_{vrkc}
    x[frame_vk, c], then z_vkc = Σ_r rows_{vrkc} s_r summed by frame."""
    V, K = fsafe.shape
    xg = torch.cat([x, x.new_zeros((1, 6))])[fsafe]          # (V, K, 6)
    r = rows.view(V, 3, 6 * K)
    s = torch.bmm(r, xg.reshape(V, 6 * K, 1))                # (V, 3, 1)
    z = torch.bmm(r.transpose(1, 2), s).reshape(V * K, 6)
    return _segsum(z, t)


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
    # inv_ex: no error check, so no read to the host (the blocks are
    # damped SPD, as in the reference's jnp.linalg.inv)
    return torch.linalg.inv_ex(diag)[0]


def _pcg(matvec, precond, b: torch.Tensor, max_iters: int, tol: float):
    """Preconditioned CG from x = 0: exactly `max_iters` trips; once
    ||r||²/||b||² < tol², x, r, p and rz freeze (the reference's
    done-masked fori_loop, global_lvba_tpu/solver/dist_solve.py:117-152).
    Nothing is read to the host.  x, r and p are the rows of one (3, n)
    state, so a trip's freeze is one torch.where: in a CUDA graph the
    count of a trip's small launches (18 beside the matvec's two) sets
    its time.  Each trip writes its done flag into one (max_iters,)
    buffer, from which the traced count of live trips is taken
    (_live_trips)."""
    z = precond(b)
    S = torch.stack([torch.zeros_like(b), b, z])      # x, r, p
    rz = torch.dot(b, z)
    b2 = torch.clamp(torch.dot(b, b), min=torch.finfo(b.dtype).tiny)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    dones = torch.empty(max_iters, dtype=torch.bool, device=b.device)
    for i in range(max_iters):
        x, r, p = S
        Ap = matvec(p)
        denom = torch.dot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        S_n = torch.empty_like(S)
        torch.addcmul(x, alpha, p, out=S_n[0])
        torch.addcmul(r, alpha, Ap, value=-1.0, out=S_n[1])
        z_n = precond(S_n[1])
        rz_n = torch.dot(S_n[1], z_n)
        beta = rz_n / torch.where(rz == 0, 1.0, rz)
        torch.addcmul(z_n, beta, p, out=S_n[2])
        conv = torch.dot(S_n[1], S_n[1]) / b2 < tol * tol
        S = torch.where(done, S, S_n)
        rz = torch.where(done, rz, rz_n)
        done = torch.bitwise_or(done, conv, out=dones[i])
    _live_trips(dones)
    return S[0]


# while a CapturedSolve captures: the list that takes the done buffers of
# the _pcg runs it captures (None otherwise)
_DONES = None


@contextmanager
def _collect_dones():
    """Hand the done buffers of the _pcg runs inside to a list (yielded)
    instead of counting them: a capture counts at each replay."""
    global _DONES
    prev, _DONES = _DONES, []
    try:
        yield _DONES
    finally:
        _DONES = prev


def _live_trips(dones: torch.Tensor):
    """Count a CG run's live trips into cg.live_trips, on the device: the
    first trip and every trip after one that left the state not done.  In
    a capture the buffer goes to the CapturedSolve instead."""
    if _DONES is not None:
        _DONES.append(dones)
    elif profiling.enabled() and dones.numel():
        profiling.count("cg.live_trips", (~dones[:-1]).sum() + 1)


def _damped_cg(H: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
               bsize: int, max_iters: int, tol: float) -> torch.Tensor:
    d = torch.diagonal(H)
    # same epsilon as the LU solve (solver/lm.py): pins exactly-zero rows
    eps = 1e-12 * (1.0 + torch.max(d.abs()))
    damp = u * d + eps

    def matvec(x):
        return torch.addmv(damp * x, H, x)

    Minv = _block_jacobi_inv_damped(H, damp, bsize)

    def precond(r):
        W = r.shape[0] // bsize
        return torch.bmm(Minv, r.reshape(W, bsize, 1)).reshape(-1)

    return _pcg(matvec, precond, -g, max_iters, tol)


def _damping(Dblk: torch.Tensor, u: torch.Tensor):
    """(d (W, 6) = diag(H), damp = u·d + eps, block-Jacobi inverses of the
    damped true 6x6 diagonal blocks) with the LU solve's epsilon (the JAX
    package's solve_damped_cg_banded / _rows preamble)."""
    d = torch.diagonal(Dblk, dim1=1, dim2=2)
    eps = 1e-12 * (1.0 + torch.max(d.abs()))
    damp = u * d + eps
    eye = torch.eye(6, dtype=Dblk.dtype, device=Dblk.device)
    return d, damp, inv_blocks_6x6(Dblk + damp[:, :, None] * eye)


def _block_cg(Hd, g, damp, d, Minv, cross, max_iters: int, tol: float):
    """PCG on (diag-blocks(Hd) − cross + diag(damp)) x = −g, x (W, 6) flat,
    block-Jacobi preconditioned by Minv -> (x (6W,), d (6W,))."""
    W = Hd.shape[0]

    def matvec(xf):
        x = xf.view(W, 6)
        y = torch.bmm(Hd, x.unsqueeze(-1)).squeeze(-1) + damp * x
        return (y - cross(x)).reshape(-1)

    def precond(r):
        return torch.bmm(Minv, r.view(W, 6, 1)).reshape(-1)

    return _pcg(matvec, precond, -g.reshape(-1), max_iters, tol), d.reshape(-1)


def banded_windows_np(offsets_list, widths, W: int):
    """The banded solve's index operands on the host, from the groups'
    offsets (host ints): per bucket the (G, w) frame of each window slot,
    and the (W, C) slot table whose row w lists the flat window slots
    covering frame w (bucket by bucket, group by group, in slot order),
    padded with the sentinel Q = Σ G·w."""
    wins = [np.asarray(offs, np.int64)[:, None] + np.arange(w)
            for offs, w in zip(offsets_list, widths)]
    flat = np.concatenate([f.reshape(-1) for f in wins])
    slots = _frame_table_np(flat, np.ones_like(flat), W).astype(np.int64)
    return wins + [slots]


def banded_windows(offsets_list, widths, W: int, device):
    """(wins, slots): banded_windows_np on `device`, in one copy."""
    out = to_device(banded_windows_np(offsets_list, widths, W), device)
    return out[:-1], out[-1]


def _damped_cg_banded(Hd, g, u, grams, wides, wins, slots, max_iters, tol):
    W = Hd.shape[0]
    dims = [(gr.shape[0], gr.shape[1] // 6) for gr in grams]
    # the groups' 6x6 diagonal blocks, flat by window slot
    ldiag = torch.cat([
        torch.diagonal(gr.view(G, w, 6, w, 6), dim1=1, dim2=3)
        .permute(0, 3, 1, 2).reshape(G * w, 6, 6)
        for gr, (G, w) in zip(grams, dims)])
    Dblk = Hd - _segsum(ldiag, slots)
    for A in wides:
        Aw = A.view(-1, W, 6)
        Dblk = Dblk - torch.einsum("rwc,rwd->wcd", Aw, Aw)
    d, damp, Minv = _damping(Dblk, u)

    def cross(x):
        yg = [torch.bmm(gr, x[win].reshape(G, 6 * w, 1)).reshape(G * w, 6)
              for gr, win, (G, w) in zip(grams, wins, dims)]
        y = _segsum(torch.cat(yg), slots)
        for A in wides:
            y = y + (A.t() @ (A @ x.reshape(-1))).view(W, 6)
        return y

    return _block_cg(Hd, g, damp, d, Minv, cross, max_iters, tol)


def solve_damped_cg_banded(grams_list, wide_list, offsets_list,
                           Hd: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                           max_iters: int = 96, tol: float = 1e-10,
                           windows=None):
    """Damped CG on the banded Hessian, never assembled (the JAX package's
    solve_damped_cg_banded, its unrolled form):
    H = diag-blocks(Hd) − Σ_buckets [windows(grams) + wideᵀ wide].
    grams_list: per bucket the (G, 6w, 6w) group Grams +AᵀA; wide_list:
    the stragglers' A (3Vw, 6W) (none, or Vw = 0, for a bucket without);
    offsets_list: per bucket the G window offsets (host ints).  A matvec
    gathers each window of x, multiplies the stack in one torch.bmm and
    sums the windows' products back by frame through the slot table (a
    gather and a fixed-order sum: no atomic scatter).  The preconditioner
    is block-Jacobi on the true 6x6 diagonal blocks.  `max_iters`
    done-masked trips; on CUDA tensors one replay of a captured graph.
    windows: banded_windows(offsets_list, ...), built here when not given.
    With BANDED_PAIR and pair-aligned offsets, the pair-window form
    (solve_damped_cg_banded_vec, its tables built per call) runs instead.
    Returns (dx (6W,), d (6W,)), d = diag(H)."""
    W = Hd.shape[0]
    if BANDED_PAIR and all(
            _pair_aligned(tuple(offs), gr.shape[1] // 6, W)
            for gr, offs in zip(grams_list, offsets_list)):
        return solve_damped_cg_banded_vec(grams_list, wide_list,
                                          offsets_list, Hd, g, u,
                                          max_iters=max_iters, tol=tol)
    if windows is None:
        windows = banded_windows(offsets_list,
                                 [gr.shape[1] // 6 for gr in grams_list], W,
                                 Hd.device)
    wins, slots = windows
    wides = [A for A in wide_list if A.shape[0]]
    ns, nw = len(grams_list), len(wides)

    def fn(trips, Hd, g, u, *rest):
        return _damped_cg_banded(Hd, g, u, rest[:ns], rest[ns:ns + nw],
                                 rest[ns + nw:-1], rest[-1], trips, tol)

    ops = [Hd, g.reshape(W, 6), u, *grams_list, *wides, *wins, slots]
    return _solve(("banded", tol), fn, ops, max_iters)


# the pair-window form of the banded solve for pair-aligned offsets
# (LVBA_BANDED_PAIR, the JAX package's dist_solve.py:589-600; off by
# default there, by its chip A/B); the sharded compact LM always takes it
BANDED_PAIR = False


def _pair_aligned(offsets, width: int, W: int) -> bool:
    """True when a bucket's group offsets admit the pair-window matvec:
    width is two equal blocks, W tiles into blocks, and every offset sits
    on a block boundary (build_banded_groups gives this whenever
    block | W)."""
    if width % 2:
        return False
    block = width // 2
    if block == 0 or W % block:
        return False
    return all(o % block == 0 and o <= W - width for o in offsets)


def _pair_onehot(offsets, block: int, n_pairs: int) -> np.ndarray:
    """(G,) int64 pair-window row of each group: the column of the one 1
    in each row of the JAX package's (G, n_pairs) selection one-hot (a TPU
    artefact: here the selection is a gather by this index)."""
    p = np.asarray(offsets, np.int64) // block
    if p.size and (p.min() < 0 or p.max() >= n_pairs):
        raise ValueError("group offset outside the pair windows")
    return p


def _pair_fold(x: torch.Tensor, block: int) -> torch.Tensor:
    """x (W, 6) -> all block-pair windows (n_pairs, 2·block·6): row s is
    x[s·block : s·block + 2·block] flattened."""
    xb = x.reshape(x.shape[0] // block, block * 6)
    return torch.cat([xb[:-1], xb[1:]], dim=-1)


def _pair_unfold(yp: torch.Tensor, block: int, W: int,
                 ch: int = 6) -> torch.Tensor:
    """Inverse of _pair_fold: pair-row contributions (n_pairs, 2·block·ch)
    -> (W, ch), each row's halves added to its two blocks (two slice adds,
    no atomics)."""
    nb = W // block
    yb = yp.new_zeros((nb, block * ch))
    yb[:-1] += yp[:, :block * ch]
    yb[1:] += yp[:, block * ch:]
    return yb.reshape(W, ch)


def pair_tables_np(offsets, block: int, W: int):
    """(idx (G,), table (n_pairs, Kq)) of a bucket's pair-aligned groups:
    each group's pair row and, per pair row, its groups in order (the
    fixed-order G-contraction)."""
    n_pairs = W // block - 1
    idx = _pair_onehot(offsets, block, n_pairs)
    return idx, index_table_np(idx, n_pairs)


def pair_tables(offsets_list, blocks, W: int, device):
    """[(idx, table), ...] of pair_tables_np per bucket on `device`, in one
    copy."""
    arrs = []
    for offs, b in zip(offsets_list, blocks):
        arrs += list(pair_tables_np(offs, b, W))
    out = to_device(arrs, device)
    return list(zip(out[0::2], out[1::2]))


def _pair_terms(shard, W: int, x: torch.Tensor = None) -> torch.Tensor:
    """One shard's pair-window terms in frame space on its device: with x
    (W, 6), Σ_buckets unfold(Σ_groups-of-a-pair Gram · window) (W, 6);
    without, the groups' 6x6 diagonal blocks the same way (W, 36).  shard:
    [(grams (G, 6w, 6w), idx (G,), table (n_pairs, Kq)), ...]."""
    out = None
    for gr, idx, tbl in shard:
        G, w = gr.shape[0], gr.shape[1] // 6
        block = w // 2
        if x is None:
            z = torch.diagonal(gr.view(G, w, 6, w, 6), dim1=1, dim2=3)
            z, ch = z.permute(0, 3, 1, 2).reshape(G, w * 36), 36
        else:
            win = _pair_fold(x.to(gr.device), block)[idx]
            z, ch = torch.bmm(gr, win.unsqueeze(-1)).squeeze(-1), 6
        t = _pair_unfold(_segsum(z, tbl), block, W, ch)
        out = t if out is None else out + t
    return out


def _damped_cg_pairs(Hd, g, u, shards, wides, reduce, max_iters, tol):
    """Damped CG on H = diag-blocks(Hd) − Σ pair windows(grams) − Σ wideᵀ
    wide, the group Grams held by shard (each shard's on its device) and
    each shard's terms reduced by `reduce` (a list, one a shard, in shard
    order -> one tensor on Hd's device): the G-contraction."""
    W = Hd.shape[0]
    Dblk = Hd - reduce([_pair_terms(sh, W) for sh in shards]).view(W, 6, 6)
    for A in wides:
        Aw = A.view(-1, W, 6)
        Dblk = Dblk - torch.einsum("rwc,rwd->wcd", Aw, Aw)
    d, damp, Minv = _damping(Dblk, u)

    def cross(x):
        y = reduce([_pair_terms(sh, W, x) for sh in shards])
        for A in wides:
            y = y + (A.t() @ (A @ x.reshape(-1))).view(W, 6)
        return y

    return _block_cg(Hd, g, damp, d, Minv, cross, max_iters, tol)


def pair_solve(shards, wide_list, Hd: torch.Tensor, g: torch.Tensor,
               u: torch.Tensor, reduce, max_iters: int = 96,
               tol: float = 1e-10, graph: bool = True):
    """The pair-window damped CG over shards of group Grams (see
    _damped_cg_pairs): `max_iters` done-masked trips with no read to the
    host; on CUDA tensors of one card one replay of a captured graph (the
    operands are the shards' Grams, indices and tables).  Returns (dx
    (6W,), d (6W,))."""
    W = Hd.shape[0]
    wides = [A for A in wide_list if A.shape[0]]
    dims = tuple(len(sh) for sh in shards)
    flat = [t for sh in shards for piece in sh for t in piece]

    def fn(trips, Hd, g, u, *rest):
        it = iter(rest[:len(flat)])
        sh = [[(next(it), next(it), next(it)) for _ in range(k)]
              for k in dims]
        return _damped_cg_pairs(Hd, g, u, sh, rest[len(flat):], reduce,
                                trips, tol)

    ops = [Hd, g.reshape(W, 6), u, *flat, *wides]
    return _solve(("pairs", dims, tol), fn, ops, max_iters, graph)


def solve_damped_cg_banded_vec(grams_list, wide_list, offsets_list,
                               Hd: torch.Tensor, g: torch.Tensor,
                               u: torch.Tensor, max_iters: int = 96,
                               tol: float = 1e-10, tables=None):
    """The pair-window form of solve_damped_cg_banded (the JAX package's
    solve_damped_cg_banded_vec): every group covers two consecutive frame
    blocks (offsets pair-aligned, _pair_aligned), so a matvec is per
    bucket a gather of the pair windows of x, one torch.bmm over the
    stack and a fixed-order sum of the groups' products by pair row,
    unfolded to frames, with no per-group loop.  The JAX package selects
    and scatters by one-hot matmuls; here by index.  tables:
    pair_tables(offsets_list, blocks, W, device), built here (one copy)
    when not given.  Returns (dx (6W,), d (6W,)), d = diag(H)."""
    W = Hd.shape[0]
    blocks = [gr.shape[1] // 12 for gr in grams_list]
    for gr, offs in zip(grams_list, offsets_list):
        if not _pair_aligned(tuple(offs), gr.shape[1] // 6, W):
            raise ValueError("group offsets not pair-aligned")
    if tables is None:
        tables = pair_tables(offsets_list, blocks, W, Hd.device)
    shard = [(gr, idx, tbl) for gr, (idx, tbl) in zip(grams_list, tables)]
    return pair_solve([shard], wide_list, Hd, g, u, lambda parts: parts[0],
                      max_iters, tol)


def _damped_cg_rows(Hd, g, u, rows, frames, tables, max_iters, tol):
    Dblk = Hd
    for r, t in zip(rows, tables):
        Dblk = Dblk - rows_cross_diag(r, t)
    d, damp, Minv = _damping(Dblk, u)

    def cross(x):
        y = torch.zeros_like(x)
        for r, f, t in zip(rows, frames, tables):
            y = y + rows_matvec(r, f, t, x)
        return y

    return _block_cg(Hd, g, damp, d, Minv, cross, max_iters, tol)


def solve_damped_cg_rows(rows_list, frame_list, tbl_list, Hd: torch.Tensor,
                         g: torch.Tensor, u: torch.Tensor,
                         max_iters: int = 256, tol: float = 1e-10):
    """Matrix-free damped solve (the JAX package's solve_damped_cg_rows):
    H = diag-blocks(Hd) − MᵀM applied straight from the compact factor
    rows, per bucket rows (3V, 6K) (plane_eigen.plane_cost_grad_rows'
    row-block layout), frame ids (V, K) and frame table (W, Kf); never a
    (6W)² product.  `max_iters` done-masked trips; on CUDA tensors one
    replay of a captured graph.  Returns (dx (6W,), d (6W,)), d = diag(H)."""
    W = Hd.shape[0]
    frames = [_safe_frames(f, W) for f in frame_list]
    tables = [_safe_table(t, f.numel()) for t, f in zip(tbl_list, frame_list)]
    nb = len(rows_list)

    def fn(trips, Hd, g, u, *rest):
        return _damped_cg_rows(Hd, g, u, rest[:nb], rest[nb:2 * nb],
                               rest[2 * nb:], trips, tol)

    ops = [Hd, g.reshape(W, 6), u, *rows_list, *frames, *tables]
    return _solve(("rows", tol), fn, ops, max_iters)


class CapturedSolve:
    """A damped solve fn(trips, *operands) for one set of operand shapes on
    one card as a captured CUDA graph.  The graph reads static copies of
    the operands and writes its outputs; a call copies the operands in,
    replays, and returns copies of the outputs.  (A graph that read an
    LM's state where it lies would be captured anew for every LM, at
    ~0.1 s a capture, to save a copy of ~1 ms a solve.)  Capture runs one
    trip first on a side stream (cuBLAS' handle and workspace), then
    captures the preamble and all `max_iters` trips; a capture that fails
    raises.  Traced, a replay counts the captured CG runs' live trips
    from the done buffers the graph writes (launches after the replay,
    none in the graph)."""

    def __init__(self, fn, specs, device: torch.device, max_iters: int):
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            self.inputs = [torch.zeros(shape, dtype=dt, device=device)
                           for shape, dt in specs]
            cur = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side), _collect_dones():
                fn(1, *self.inputs)
            cur.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with _collect_dones() as self.dones, \
                    torch.cuda.graph(self.graph):
                self.out = fn(max_iters, *self.inputs)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, *operands):
        for s, x in zip(self.inputs, operands):
            s.copy_(x)
        self.graph.replay()
        if profiling.enabled():
            for dones in self.dones:
                _live_trips(dones)
        if isinstance(self.out, tuple):
            return tuple(o.clone() for o in self.out)
        return self.out.clone()


# the captured solves, by kind, operand shapes and dtypes, device and trips;
# the oldest is dropped past GRAPH_CACHE_SIZE (each holds copies of its
# operands)
GRAPH_CACHE_SIZE = 4
_GRAPHS: OrderedDict = OrderedDict()


def _captured(key, fn, specs, device, max_iters) -> CapturedSolve:
    """The cached CapturedSolve of `key`, capturing it on the first call."""
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = _GRAPHS[key] = CapturedSolve(fn, specs, device, max_iters)
        profiling.count("cg.graph_captures")
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)
    _GRAPHS.move_to_end(key)
    return graph


def _solve(kind, fn, ops, max_iters: int, graph: bool = True):
    """fn(max_iters, *ops): one replay of its captured graph on CUDA
    tensors of one device; the trips run eagerly on CPU tensors, on
    operands that span several devices (a mesh of several cards) and when
    `graph` is False (a solve that reduces across processes)."""
    dev = ops[0].device
    if (dev.type != "cuda" or not graph
            or any(x.device != dev for x in ops)):
        return fn(max_iters, *ops)
    specs = tuple((tuple(x.shape), x.dtype) for x in ops)
    return _captured((kind, specs, dev, max_iters), fn, specs, dev,
                     max_iters)(*ops)


def cg_graph(n: int, dtype: torch.dtype, device: torch.device,
             bsize: int = 6, max_iters: int = 256,
             tol: float = 1e-10) -> CapturedSolve:
    """The captured damped CG solve (solve_damped_cg) of this shape,
    capturing it on the first call."""
    dev = torch.device(device)
    specs = (((n, n), dtype), ((n,), dtype), ((), dtype))
    return _captured((("dense", bsize, tol), specs, dev, max_iters),
                     lambda trips, H, g, u: _damped_cg(H, g, u, bsize, trips,
                                                       tol),
                     specs, dev, max_iters)


def row_blocks(n: int, bsize: int, parts: int):
    """[(lo, hi), ...]: n rows in `parts` contiguous row blocks of whole
    bsize-row blocks, as equal as they go (the first ones one block
    larger)."""
    sizes = [len(c) for c in np.array_split(np.arange(n // bsize), parts)]
    bounds = np.concatenate([[0], np.cumsum(sizes)]) * bsize
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _damped_cg_sharded(blocks, g, u, bsize: int, max_iters: int,
                       tol: float) -> torch.Tensor:
    """_damped_cg on H held as row blocks (r_j, n), each on its device: a
    matvec sends p to every block's device and gathers the row products
    on g's device; each block inverts its own diagonal blocks."""
    dev = g.device
    bounds, lo = [], 0
    for blk in blocks:
        bounds.append((lo, lo + blk.shape[0]))
        lo += blk.shape[0]
    d = torch.cat([blk[:, a:b].diagonal().to(dev)
                   for blk, (a, b) in zip(blocks, bounds)])
    eps = 1e-12 * (1.0 + torch.max(d.abs()))
    damp = u * d + eps
    damps = [damp[a:b].to(blk.device) for blk, (a, b) in zip(blocks, bounds)]
    Minv = [_block_jacobi_inv_damped(blk[:, a:b], dm, bsize)
            for blk, (a, b), dm in zip(blocks, bounds, damps)]

    def matvec(x):
        return torch.cat([
            torch.addmv(dm * x[a:b].to(blk.device), blk, x.to(blk.device))
            .to(dev) for blk, (a, b), dm in zip(blocks, bounds, damps)])

    def precond(r):
        return torch.cat([
            torch.bmm(mi, r[a:b].to(mi.device).reshape(-1, bsize, 1))
            .reshape(-1).to(dev) for mi, (a, b) in zip(Minv, bounds)])

    return _pcg(matvec, precond, -g, max_iters, tol)


def solve_damped_cg(
    H: torch.Tensor,
    g: torch.Tensor,
    u: torch.Tensor,
    bsize: int = 6,
    max_iters: int = 256,
    tol: float = 1e-10,
    h_sharding=None,
) -> torch.Tensor:
    """Solve (H + u * diag(H)) dx = -g by block-Jacobi preconditioned CG:
    `max_iters` done-masked trips, no read to the host.  On a CUDA tensor
    one replay of the captured graph (cg_graph); on the CPU the trips run
    eagerly.

    h_sharding: a list of devices (the JAX package's row sharding
    P(axis, None) of H): H is split into as many row blocks of whole
    bsize blocks, block j placed on device j, and each matvec evaluates
    its row blocks where they lie (the distributed CG); x, r and p stay
    on H's device.  One graph when every device is H's card."""
    if h_sharding is not None:
        blocks = [H[a:b].to(torch.device(dv)) for (a, b), dv in zip(
            row_blocks(H.shape[0], bsize, len(h_sharding)), h_sharding)]
        nb = len(blocks)

        def fn(trips, *ops):
            return _damped_cg_sharded(ops[:nb], ops[nb], ops[nb + 1], bsize,
                                      trips, tol)

        return _solve(("dense-rows", bsize, tol, nb), fn,
                      [*blocks, g, u.to(H.device)], max_iters)
    if H.device.type == "cuda":
        return cg_graph(H.shape[0], H.dtype, H.device, bsize, max_iters,
                        tol)(H, g, u)
    return _damped_cg(H, g, u, bsize, max_iters, tol)


# ---------------------------------------------------------------------------
# The reduced-camera Schur solves of the visual BA (the JAX package's
# solve_schur_cg_mf / _pm / _pm_tiers).  The JAX package expands and reduces
# by camera through one-hot selection matmuls with a 3-way bf16 split (a TPU
# artefact); here expansion is a row gather and reduction a fixed-order sum
# through a camera table built on the host once per solve.
# ---------------------------------------------------------------------------

# CG trips of the point-major solves (the JAX package's LVBA_PM_CG_ITERS
# default, dist_solve.py:295, :364); the per-observation solve's 256 is its
# signature default (:215)
PM_CG_ITERS = 48


def index_table_np(ids: np.ndarray, num: int) -> np.ndarray:
    """(num, K) int64 table whose row j lists, in order, the flat positions
    of `ids` equal to j; ids outside [0, num) are left out (pad slots), and
    rows pad with ids.size (the zero row _segsum appends)."""
    ids = np.asarray(ids).reshape(-1)
    return _frame_table_np(ids, np.ones(ids.shape, np.int8),
                           num).astype(np.int64)


class PMTiers(NamedTuple):
    """The point-major tier layout of a problem's observations, flat by
    slot: tier i holds points whose track fits K_i, padded to (Pv_i, K_i),
    at slots [Σ_{j<i} Pv_j K_j, ...).  A pad slot has camera M (the zero
    row of a gather) and observation O."""

    dims: tuple              # ((Pv, K), ...) host ints
    idx: torch.Tensor        # (S,) flat observation of each slot, pad -> O
    cam: torch.Tensor        # (S,) camera of each slot, pad -> M
    pt: torch.Tensor         # (S,) tier-point row of each slot, in [0, Pt)
    cam_table: torch.Tensor  # (M, Kc) slots of each camera, pad -> S


def pm_tiers(tables, num_cams: int, device) -> PMTiers:
    """PMTiers on `device` (one copy) from the host tier tables [(pt (Pv,),
    idx (Pv, K), cam (Pv, K), mask), ...] (schur._tier_tables)."""
    dims = tuple((int(i.shape[0]), int(i.shape[1])) for _, i, _, _ in tables)
    idx = np.concatenate([i.reshape(-1) for _, i, _, _ in tables])
    cam = np.concatenate([c.reshape(-1) for _, _, c, _ in tables])
    pt, o = [], 0
    for Pv, K in dims:
        pt.append(np.repeat(np.arange(o, o + Pv), K))
        o += Pv
    arrays = [a.astype(np.int64) for a in (idx, cam, np.concatenate(pt))]
    arrays.append(index_table_np(cam, num_cams))
    return PMTiers(dims, *to_device(arrays, device))


def _tier_sum(z: torch.Tensor, dims) -> torch.Tensor:
    """Per tier point sums over the K axis of slot values z (S, C) ->
    (Pt, C), in tier point order."""
    out, o = [], 0
    for Pv, K in dims:
        out.append(z[o:o + Pv * K].view(Pv, K, -1).sum(dim=1))
        o += Pv * K
    return torch.cat(out)


def _expand(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of x (M, C) at ids, where id M gives a zero row."""
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])[ids]


def _schur_cg(dHcc, cross, b, reduce_obs, fix_first: bool, max_iters: int,
              tol: float) -> torch.Tensor:
    """PCG on S dc = b, S = blockdiag(dHcc) − (camera-pair couplings),
    applied as S x = dHcc x − reduce_obs(x); the preconditioner inverts the
    6x6 diagonal blocks dHcc − cross.  With fix_first, camera 0 is held:
    its row of S x returns x_0 and its block is the identity.  Products
    batched over cameras or observations are broadcast multiplies and
    sums: a batched matmul of these shapes runs as many tiny cuBLAS
    products, several times slower."""
    M = dHcc.shape[0]
    eye = torch.eye(6, dtype=dHcc.dtype, device=dHcc.device)
    first = (torch.arange(M, device=dHcc.device) == 0)[:, None]
    Dblk = dHcc - cross
    if fix_first:
        Dblk = torch.where(first[..., None], eye, Dblk)
    Minv = inv_blocks_6x6(Dblk + 1e-30 * eye)

    def matvec(xf):
        x = xf.view(M, 6)
        xm = x.masked_fill(first, 0.0) if fix_first else x
        y = (dHcc * xm[:, None, :]).sum(-1) - reduce_obs(xm)
        if fix_first:
            y = torch.where(first, x, y)
        return y.reshape(-1)

    def precond(r):
        return (Minv * r.view(M, 1, 6)).sum(-1).reshape(-1)

    return _pcg(matvec, precond, b.reshape(-1), max_iters, tol).view(M, 6)


def _cross_blocks(W, Y, table):
    """Per-camera Σ Y Wᵀ (M, 6, 6) over the observations in `table`."""
    yw = (Y[:, :, None, :] * W[:, None, :, :]).sum(-1).reshape(-1, 36)
    return _segsum(yw, table).view(-1, 6, 6)


def _schur_mf(dHcc, W, Y, b, cam, pt, cam_tbl, pt_tbl, fix_first, max_iters,
              tol):
    def reduce_obs(xm):
        wx = (W * xm[cam][:, :, None]).sum(1)                     # (O, 3)
        tp = _segsum(wx, pt_tbl)                                  # (P, 3)
        yo = (Y * tp[pt][:, None, :]).sum(-1)                     # (O, 6)
        return _segsum(yo, cam_tbl)

    return _schur_cg(dHcc, _cross_blocks(W, Y, cam_tbl), b, reduce_obs,
                     fix_first, max_iters, tol)


def solve_schur_cg_mf(dHcc: torch.Tensor, W: torch.Tensor, Y: torch.Tensor,
                      obs_cam: torch.Tensor, obs_pt: torch.Tensor,
                      b: torch.Tensor, num_pts: int, fix_first: bool = True,
                      max_iters: int = 256, tol: float = 1e-10,
                      tables=None) -> torch.Tensor:
    """Matrix-free reduced-camera solve (the Ceres ITERATIVE_SCHUR
    analogue): S dc = b with S = blockdiag(dHcc) − Σ_pairs Y_a W_bᵀ applied
    per observation, S x = dHcc x − Y · segsum_pt(Wᵀ x), so the
    O(Σ track_len²) pair list is never built.  dHcc (M, 6, 6) damped camera
    blocks; W, Y (O, 6, 3) coupling blocks and Y = W Hpp⁻¹; b (M, 6) with
    row 0 zeroed when fix_first.  The sums by point and by camera run
    through the (P, Kp) and (M, Kc) tables `tables` (index_table_np of
    obs_pt and obs_cam on the device; built here, reading the ids to the
    host, when not given).  `max_iters` done-masked trips; on CUDA tensors
    one replay of a captured graph.  Returns dc (M, 6)."""
    M = dHcc.shape[0]
    if tables is None:
        tables = to_device([index_table_np(obs_cam.cpu().numpy(), M),
                            index_table_np(obs_pt.cpu().numpy(), num_pts)],
                           dHcc.device)
    cam_tbl, pt_tbl = tables

    def fn(trips, dHcc, W, Y, b, cam, pt, cam_tbl, pt_tbl):
        return _schur_mf(dHcc, W, Y, b, cam, pt, cam_tbl, pt_tbl, fix_first,
                         trips, tol)

    ops = [dHcc, W, Y, b, obs_cam.long(), obs_pt.long(), cam_tbl, pt_tbl]
    return _solve(("schur_mf", fix_first, tol), fn, ops, max_iters)


def _schur_mf_sharded(dHcc, b, shards, reduce, fix_first, max_iters, tol):
    """_schur_mf over observation shards [(W, Y, cam, pt, cam_tbl, pt_tbl),
    ...] (each on its device): the point and camera sums of a matvec are
    each shard's table sums, reduced (`reduce`: a list, one a shard ->
    one tensor on dHcc's device)."""
    def reduce_obs(xm):
        tp = reduce([_segsum((W * xm.to(W.device)[cam][:, :, None]).sum(1),
                             ptt) for W, _, cam, _, _, ptt in shards])
        return reduce([_segsum((Y * tp.to(Y.device)[pt][:, None, :]).sum(-1),
                               camt) for _, Y, _, pt, camt, _ in shards])

    cross = reduce([_cross_blocks(W, Y, camt)
                    for W, Y, _, _, camt, _ in shards])
    return _schur_cg(dHcc, cross, b, reduce_obs, fix_first, max_iters, tol)


def solve_schur_cg_mf_sharded(dHcc: torch.Tensor, shards, b: torch.Tensor,
                              reduce, fix_first: bool = True,
                              max_iters: int = 256, tol: float = 1e-10,
                              graph: bool = True) -> torch.Tensor:
    """solve_schur_cg_mf with the observations sharded: shards [(W, Y
    (O_s, 6, 3), obs_cam, obs_pt (O_s,), cam table (M, Kc), point table
    (P, Kp)), ...], each on its device, their sums combined by `reduce`
    (the mesh's psum).  On one card one replay of a captured graph (graph
    False: a reduction across processes, run eagerly).  Returns dc
    (M, 6)."""
    k = len(shards)
    flat = [t for sh in shards for t in sh]

    def fn(trips, dHcc, b, *rest):
        sh = [tuple(rest[6 * i:6 * i + 6]) for i in range(k)]
        return _schur_mf_sharded(dHcc, b, sh, reduce, fix_first, trips, tol)

    return _solve(("schur_mf_sharded", k, fix_first, tol), fn,
                  [dHcc, b, *flat], max_iters, graph)


def _schur_pm(dHcc, Wt, Yt, b, cam, pt, cam_tbl, dims, fix_first, max_iters,
              tol):
    def reduce_obs(xm):
        wx = (Wt * _expand(xm, cam)[:, :, None]).sum(1)          # (S, 3)
        tp = _tier_sum(wx, dims)                                 # (Pt, 3)
        yo = (Yt * tp[pt][:, None, :]).sum(-1)                   # (S, 6)
        return _segsum(yo, cam_tbl)

    return _schur_cg(dHcc, _cross_blocks(Wt, Yt, cam_tbl), b, reduce_obs,
                     fix_first, max_iters, tol)


def solve_schur_cg_pm_tiers(dHcc: torch.Tensor, Wt: torch.Tensor,
                            Yt: torch.Tensor, tiers: PMTiers,
                            b: torch.Tensor, fix_first: bool = True,
                            max_iters: int = None,
                            tol: float = 1e-10) -> torch.Tensor:
    """Point-major CG core on slot-resident coupling blocks Wt, Yt (S, 6, 3)
    in the `tiers` layout (pad slots zero): the point-side sum of a matvec
    is a K-axis sum within each tier, the camera side a gather by slot and
    a fixed-order sum through tiers.cam_table.  The system and the
    preconditioner are those of solve_schur_cg_mf.  `max_iters` (default
    PM_CG_ITERS) done-masked trips; on CUDA tensors one replay of a
    captured graph.  Returns dc (M, 6)."""
    max_iters = PM_CG_ITERS if max_iters is None else max_iters
    dims = tiers.dims

    def fn(trips, dHcc, Wt, Yt, b, cam, pt, cam_tbl):
        return _schur_pm(dHcc, Wt, Yt, b, cam, pt, cam_tbl, dims, fix_first,
                         trips, tol)

    ops = [dHcc, Wt, Yt, b, tiers.cam, tiers.pt, tiers.cam_table]
    return _solve(("schur_pm", dims, fix_first, tol), fn, ops, max_iters)


def solve_schur_cg_pm(dHcc: torch.Tensor, W: torch.Tensor, Y: torch.Tensor,
                      tiers: PMTiers, b: torch.Tensor, fix_first: bool = True,
                      max_iters: int = None,
                      tol: float = 1e-10) -> torch.Tensor:
    """Point-major matrix-free reduced-camera solve: W, Y (O, 6, 3) in flat
    observation order are gathered into the tier slots once (pad slots
    take a zero row), then solve_schur_cg_pm_tiers."""
    zrow = W.new_zeros((1, 6, 3))
    Wt = torch.cat([W, zrow])[tiers.idx]
    Yt = torch.cat([Y, zrow])[tiers.idx]
    return solve_schur_cg_pm_tiers(dHcc, Wt, Yt, tiers, b,
                                   fix_first=fix_first, max_iters=max_iters,
                                   tol=tol)
