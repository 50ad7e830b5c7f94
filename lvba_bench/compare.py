"""The comparison that decides `correct`: what the timed path produced
against the plain float64 reference (reference/), number by number, each
against its cell's limit (limits/<cell>.json).

Numbers (each a worst case, all dimensionless):
  map_err        the voxel map: over the union of both maps' (plane,
                 frame) entries, the largest relative difference of the
                 count, the body mean and the centred scatter (each
                 against the reference entry's largest component), at
                 most 1; an entry or a plane that one side lacks reads 1.  Planes are
                 matched by the cube their world centroid lies in.
  eval_cost_err  the factor evaluation at a start: |Σλ0 − ref| / ref.
  eval_grad_err  its gradient: max |g − ref| / max |ref|.
  solve_cost_gap each judged solve's final poses, costed by the reference:
                 |cost − optimum| / optimum, the optimum the reference
                 LM's converged cost; the largest over the judged solves.
  solve_pose_gap each judged solve's positions against the optimum's
                 after a rigid alignment (the free gauge): RMS in metres,
                 the largest over the judged solves.
  solve_rel_pose_gap  each judged solve's relative positions of
                 consecutive frames against the optimum's (rel_pose_rms):
                 RMS in metres, the largest over the judged solves.
A non-finite number reads inf.  Only the numbers a cell's limits file
names decide `correct`; the others are printed beside them.
"""

from __future__ import annotations

import math

import numpy as np


def program_entries(buckets):
    """The program's voxel map (PlaneFactorBucket list: n, mu, Pc, frame
    host arrays (V, K, ...)) as flat live entries (vox, frame, n, mu,
    Pc), voxels numbered across the buckets."""
    vox, frame, n, mu, Pc = [], [], [], [], []
    off = 0
    for b in buckets:
        live = np.asarray(b.n) > 0
        vi, ki = np.nonzero(live)
        vox.append(vi + off)
        frame.append(np.asarray(b.frame)[vi, ki])
        n.append(np.asarray(b.n)[vi, ki])
        mu.append(np.asarray(b.mu)[vi, ki])
        Pc.append(np.asarray(b.Pc)[vi, ki])
        off += b.n.shape[0]
    cat = np.concatenate
    return (cat(vox).astype(np.int64), cat(frame).astype(np.int64),
            cat(n).astype(np.float64), cat(mu).astype(np.float64),
            cat(Pc).astype(np.float64), off)


def ref_entries(m):
    """A RefMap's entries as host float64 arrays, in program_entries'
    form, and its cells (V, 4)."""
    def h(x, dt=np.float64):
        return x.detach().cpu().numpy().astype(dt)
    return (h(m.vox, np.int64), h(m.frame, np.int64), h(m.n), h(m.mu),
            h(m.Pc), int(m.cell.shape[0])), h(m.cell, np.int64)


def _cell_key(level, c):
    """(level, cx, cy, cz) packed: 18 bits an axis, the level above."""
    c = c + (1 << 17)
    return (level << 54) | (c[..., 0] << 36) | (c[..., 1] << 18) | c[..., 2]


def map_err(entries, R, p, ref, ref_cells, voxel_size, layer_limit):
    """map_err of `entries` (program_entries' form) against the reference
    map (ref_entries' form and cells), the planes located at the binning
    poses (R, p)."""
    vox, frame, n, mu, Pc, V = entries
    rvox, rframe, rn, rmu, rPc, rV = ref
    if V == 0 or rV == 0:
        return 0.0 if V == rV else 1.0
    W = R.shape[0]
    w = np.einsum("eij,ej->ei", R[frame], mu) + p[frame]
    N = np.bincount(vox, weights=n, minlength=V)
    c = np.stack([np.bincount(vox, weights=n * w[:, i], minlength=V)
                  for i in range(3)], 1) / np.maximum(N, 1e-300)[:, None]
    rkeys = _cell_key(ref_cells[:, 0], ref_cells[:, 1:])
    order = np.argsort(rkeys)
    sk = rkeys[order]
    match = np.full(V, -1, np.int64)
    for level in range(layer_limit + 1):
        cc = np.floor(c / (voxel_size / 2 ** level)).astype(np.int64)
        k = _cell_key(np.int64(level), cc)
        pos = np.clip(np.searchsorted(sk, k), 0, sk.size - 1)
        hit = (sk[pos] == k) & (match < 0)
        match[hit] = order[pos[hit]]
    # planes that match none, or one the other side matched twice, read 1
    err = 0.0
    ok_v = match >= 0
    if not ok_v.all() or np.unique(match[ok_v]).size != ok_v.sum() \
            or ok_v.sum() != rV:
        err = 1.0
    e_ok = ok_v[vox]
    key_p = match[vox[e_ok]] * W + frame[e_ok]
    key_r = rvox * W + rframe
    common, ip, ir = np.intersect1d(key_p, key_r, return_indices=True)
    if common.size != key_r.size or common.size != key_p.size \
            or common.size != vox.size:
        err = 1.0
    if common.size == 0:
        return 1.0
    sel = np.flatnonzero(e_ok)[ip]

    def rel(a, b, axes, floor):
        scale = np.maximum(np.abs(b).max(axis=axes), floor)
        return np.abs(a - b).max(axis=axes) / scale

    nr = rn[ir]
    d_n = np.abs(n[sel] - nr) / np.maximum(nr, 1.0)
    d_mu = rel(mu[sel], rmu[ir], 1, 1e-12 * voxel_size)
    # a one-point entry's scatter is 0: its floor is a scatter's scale
    d_pc = rel(Pc[sel], rPc[ir], (1, 2), 1e-12 * nr * voxel_size ** 2)
    worst = float(max(d_n.max(), d_mu.max(), d_pc.max()))
    if not math.isfinite(worst):
        return math.inf
    return min(1.0, max(err, worst))


def rel_err(a, b) -> float:
    """|a − b| / |b| of two scalars."""
    v = abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)
    return v if math.isfinite(v) else math.inf


def max_rel(a, b) -> float:
    """max |a − b| / max |b| of two arrays."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    v = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
    return v if math.isfinite(v) else math.inf


def aligned_rms(p_est, p_ref) -> float:
    """RMS distance (m) of p_est's positions to p_ref's after the rigid
    (Umeyama, no scale) alignment of p_est onto p_ref."""
    a = np.asarray(p_est, np.float64)
    b = np.asarray(p_ref, np.float64)
    if not np.isfinite(a).all():
        return math.inf
    ca, cb = a.mean(0), b.mean(0)
    A, B = a - ca, b - cb
    U, _, Vt = np.linalg.svd(A.T @ B)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    Rali = (U @ S @ Vt).T
    return float(np.sqrt(np.mean(np.sum(((Rali @ A.T).T - B) ** 2, 1))))


def rel_pose_rms(R_est, p_est, R_ref, p_ref) -> float:
    """RMS difference (m) of each frame's position in the previous
    frame's body, R_kᵀ (p_k+1 − p_k), between the two sides: free of the
    gauge, and of the slow bends along a trajectory that the cost hardly
    sees."""
    R, p = np.asarray(R_est, np.float64), np.asarray(p_est, np.float64)
    Ro, po = np.asarray(R_ref, np.float64), np.asarray(p_ref, np.float64)
    if not (np.isfinite(R).all() and np.isfinite(p).all()):
        return math.inf
    t = np.einsum("kji,kj->ki", R[:-1], p[1:] - p[:-1])
    to = np.einsum("kji,kj->ki", Ro[:-1], po[1:] - po[:-1])
    return float(np.sqrt(np.mean(np.sum((t - to) ** 2, 1))))


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]) over the limits' names; a number
    the run could not read counts as failed."""
    rows = []
    ok = True
    for name, limit in limits.items():
        v = numbers.get(name)
        v = math.inf if v is None or not math.isfinite(v) else float(v)
        rows.append((name, v, float(limit)))
        ok = ok and v <= float(limit)
    return ok, rows

