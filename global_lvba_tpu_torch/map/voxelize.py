"""Adaptive planar voxel map as flat sorted arrays (no pointer octree).

The port's own copy of global_lvba_tpu.map.voxelize.  The device of the
stage that builds the map picks the host path (native.on_device): on the
CPU numpy, on a CUDA device the port's native library (native/: the
transform, keys, radix argsort and segment moments in C++), above 2^16
points as in the JAX package, whose native helpers these are.

Re-designs the reference's pointer-based adaptive octree
(cut_voxel / OCTO_TREE_NODE::recut / judge_eigen / tras_opt at
include/BALM/bavoxel.hpp:278-562,799-836) as a fixed-depth
(layer_limit = 2, bavoxel.hpp:13) sequence of masked re-binning rounds over
sorted integer keys:

  level 0: bin points into root voxels of `voxel_size`
  each level: voxels with < min_ps points are discarded (bavoxel.hpp:428);
      planarity is judged on the world-frame covariance eigen-ratio
      λ0/λ2 <= eigen_ratio[level] (bavoxel.hpp:346-352); planar voxels are
      emitted; non-planar voxels at level < 2 subdivide into octants
      (key*8 + octant); non-planar voxels at level 2 are discarded
      (bavoxel.hpp:448-453).

Emitted planar voxels carry per-(voxel, observing-frame) body-frame moment
statistics — count, mean, centered scatter — ready for the batched plane
eigen-factor kernel (factors/plane_eigen.py).  Only voxels seen from >= 2
frames are kept, matching VOX_HESS::push_voxel (bavoxel.hpp:45-54).

The binning itself runs on the host in numpy (it happens once per BA stage,
outside the LM loop — the reference likewise voxelizes once before
damping_iter); the per-iteration hot math consumes the resulting dense
arrays on device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .. import native as _native
from ..native import runtime as _runtime
from ..utils.profiling import traced

_KEY_BITS = 20  # per-axis voxel coordinates in [-2^19, 2^19)
_KEY_OFF = 1 << (_KEY_BITS - 1)
_DEFAULT_EIGEN_RATIOS = (0.3, 0.1, 0.06, 0.03)  # bavoxel.hpp:17
_NATIVE_MIN = 1 << 16  # the JAX package's size gate for its native helpers


def _argsort_keys(keys: np.ndarray, native: bool = False) -> np.ndarray:
    """Stable int64 argsort: with `native`, above _NATIVE_MIN keys, the
    native library's radix sort, else np.argsort(kind="stable"); the two
    give the same permutation."""
    if native and keys.shape[0] > _NATIVE_MIN:
        return _runtime.radix_argsort(keys)
    return np.argsort(keys, kind="stable")


def pack_voxel_keys(coords: np.ndarray) -> np.ndarray:
    """Pack integer voxel coords (N, 3) into int64 keys (N,)."""
    c = coords.astype(np.int64) + _KEY_OFF
    if np.any((c < 0) | (c >= (1 << _KEY_BITS))):
        raise ValueError("voxel coordinates out of packable range")
    return (c[:, 0] << (2 * _KEY_BITS)) | (c[:, 1] << _KEY_BITS) | c[:, 2]


def voxel_coords(points: np.ndarray, voxel_size: float) -> np.ndarray:
    """World points -> integer voxel coords, floor convention.

    The reference uses truncation-after-decrement (bavoxel.hpp:809-812) which
    equals floor except exactly at negative integer boundaries (measure-zero);
    we use floor.
    """
    return np.floor(points / voxel_size).astype(np.int64)


@dataclasses.dataclass
class PlaneFactorBucket:
    """Per-(voxel, frame) body-frame statistics for one occupancy tier.

    All arrays are dense (V, K[, ...]) with zero-count padding; `frame` is 0
    where padded (masked by n == 0 in the kernel).
    """

    n: np.ndarray      # (V, K) float32 — point counts
    mu: np.ndarray     # (V, K, 3) float32 — body-frame means
    Pc: np.ndarray     # (V, K, 3, 3) float32 — body-frame centered scatter
    frame: np.ndarray  # (V, K) int32 — observing frame index


@dataclasses.dataclass
class PlaneLookup:
    """Point -> plane query structure (findCorrespondPoint equivalent,
    bavoxel.hpp:320-333). Per level: sorted PLANE keys (with plane params)
    and sorted subdivided keys for descent."""

    voxel_size: float
    plane_keys: List[np.ndarray]        # per level, sorted int64
    plane_index: List[np.ndarray]       # per level, row into centers/normals
    subdiv_keys: List[np.ndarray]       # per level, sorted int64
    centers: np.ndarray                 # (Vp, 3) float64 world centroid
    normals: np.ndarray                 # (Vp, 3) float64 unit min-eigvec
    eigvals: np.ndarray                 # (Vp, 3) float64 ascending

    def query(self, X: np.ndarray) -> np.ndarray:
        """Vectorized plane lookup for world points X (N, 3).

        Returns plane row index per point (-1 if no planar leaf contains it).
        """
        X = np.asarray(X, dtype=np.float64)
        N = X.shape[0]
        out = np.full(N, -1, dtype=np.int64)
        active = np.arange(N)
        coords = np.floor(X / self.voxel_size).astype(np.int64)
        keys = pack_voxel_keys(coords)
        size = self.voxel_size
        for level in range(len(self.plane_keys)):
            if active.size == 0:
                break
            pk, pi = self.plane_keys[level], self.plane_index[level]
            if pk.size:
                pos = np.searchsorted(pk, keys)
                pos_c = np.clip(pos, 0, pk.size - 1)
                hit = pk[pos_c] == keys
                out[active[hit]] = pi[pos_c[hit]]
            else:
                hit = np.zeros(active.size, dtype=bool)
            sk = self.subdiv_keys[level]
            if sk.size:
                pos = np.searchsorted(sk, keys)
                pos_c = np.clip(pos, 0, sk.size - 1)
                desc = (~hit) & (sk[pos_c] == keys)
            else:
                desc = np.zeros(active.size, dtype=bool)
            # descend: child key = key * 8 + octant wrt this voxel's center
            active = active[desc]
            keys = keys[desc]
            if active.size == 0:
                break
            Xa = X[active]
            # reconstruct voxel center at this level from the key chain:
            # root voxel center + accumulated octant offsets — equivalently,
            # center of the cell containing the point at this level's size.
            cell = size / (2 ** level)
            child_cell = cell / 2.0
            base = np.floor(Xa / cell) * cell
            center = base + cell / 2.0
            oct_bits = (Xa > center).astype(np.int64)
            octant = 4 * oct_bits[:, 0] + 2 * oct_bits[:, 1] + oct_bits[:, 2]
            keys = keys * 8 + octant
        return out


@dataclasses.dataclass
class VoxelMap:
    """Output of build_voxel_map: factor buckets + plane lookup + stats."""

    buckets: List[PlaneFactorBucket]
    lookup: PlaneLookup
    num_planes: int
    num_frames: int
    stats: dict


def _reduceat_moments(
    pts: np.ndarray, sort_idx: np.ndarray, starts: np.ndarray,
    native: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-segment (count, sum, raw second moment) in float64: with
    `native`, above _NATIVE_MIN points, the native library's threaded
    segment sums (each segment in order), else np.add.reduceat (pairwise
    within a segment); the two agree to float64 rounding."""
    counts = np.diff(np.append(starts, sort_idx.shape[0]))
    if native and sort_idx.shape[0] > _NATIVE_MIN:
        s, m = _runtime.bin_moments(pts, sort_idx, starts)
        return counts, s, m
    p = pts[sort_idx].astype(np.float64)
    s = np.add.reduceat(p, starts, axis=0)
    # second moments: Σ x xᵀ as 6 unique entries
    xx = np.empty((p.shape[0], 6), dtype=np.float64)
    xx[:, 0] = p[:, 0] * p[:, 0]
    xx[:, 1] = p[:, 0] * p[:, 1]
    xx[:, 2] = p[:, 0] * p[:, 2]
    xx[:, 3] = p[:, 1] * p[:, 1]
    xx[:, 4] = p[:, 1] * p[:, 2]
    xx[:, 5] = p[:, 2] * p[:, 2]
    m = np.add.reduceat(xx, starts, axis=0)
    return counts, s, m


def _sym6_to_mat(m: np.ndarray) -> np.ndarray:
    """(..., 6) packed upper-tri -> (..., 3, 3) symmetric."""
    out = np.empty(m.shape[:-1] + (3, 3), dtype=m.dtype)
    out[..., 0, 0] = m[..., 0]
    out[..., 0, 1] = out[..., 1, 0] = m[..., 1]
    out[..., 0, 2] = out[..., 2, 0] = m[..., 2]
    out[..., 1, 1] = m[..., 3]
    out[..., 1, 2] = out[..., 2, 1] = m[..., 4]
    out[..., 2, 2] = m[..., 5]
    return out


@traced("map.voxelize")
def build_voxel_map(
    points_body: np.ndarray,
    frame_ids: np.ndarray,
    R: np.ndarray,
    p: np.ndarray,
    voxel_size: float,
    eigen_ratios: Sequence[float] = _DEFAULT_EIGEN_RATIOS,
    min_ps: int = 15,
    layer_limit: int = 2,
    min_frames: int = 2,
    bucket_sizes: Sequence[int] = (4, 8, 16, 32, 64, 128, 256, 512),
    build_factors: bool = True,
    device="cpu",
) -> VoxelMap:
    """Build the adaptive planar voxel map.

    Args:
      points_body: (N, 3) float — per-point body-frame coordinates.
      frame_ids: (N,) int — owning frame per point.
      R, p: (W, 3, 3), (W, 3) — frame poses used for binning & planarity
        (the reference judges with the initial window poses; the factor later
        re-transforms body moments with the *current* LM iterate).
      voxel_size: root voxel edge length.
      eigen_ratios: per-layer planarity thresholds λ0/λ2.
      device: the device of the stage the map is for; a CUDA device takes
        the native host path (the map is host arrays either way).
    """
    native = _native.on_device(device)
    pts = np.asarray(points_body, dtype=np.float64)
    fid = np.asarray(frame_ids, dtype=np.int32)
    R64 = np.asarray(R, dtype=np.float64)
    p64 = np.asarray(p, dtype=np.float64)
    W = R64.shape[0]
    if native and pts.shape[0] > _NATIVE_MIN:
        world = _runtime.transform_points(pts, fid, R64, p64)
        keys = _runtime.voxel_keys64(world, voxel_size)
    else:
        world = np.einsum("nij,nj->ni", R64[fid], pts) + p64[fid]
        keys = pack_voxel_keys(voxel_coords(world, voxel_size))

    # running state: which points are still active; their current-level key
    active = np.arange(pts.shape[0])

    plane_keys: List[np.ndarray] = []
    plane_index: List[np.ndarray] = []
    subdiv_keys: List[np.ndarray] = []
    emit_centers: List[np.ndarray] = []
    emit_normals: List[np.ndarray] = []
    emit_eigvals: List[np.ndarray] = []
    # final per-point plane voxel assignment
    point_plane = np.full(pts.shape[0], -1, dtype=np.int64)
    n_emitted = 0
    stats = {"levels": []}

    for level in range(layer_limit + 1):
        if active.size == 0:
            for _ in range(level, layer_limit + 1):
                plane_keys.append(np.zeros(0, np.int64))
                plane_index.append(np.zeros(0, np.int64))
                subdiv_keys.append(np.zeros(0, np.int64))
            break
        order = _argsort_keys(keys, native)
        skeys = keys[order]
        change = np.empty(skeys.shape[0], dtype=bool)
        change[0] = True
        np.not_equal(skeys[1:], skeys[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        ukeys = skeys[starts]
        counts, sums, moms = _reduceat_moments(world[active], order, starts,
                                               native)

        big = counts >= min_ps
        # covariance & eigen ratio (f64 host; once per stage, not hot)
        cnt = counts.astype(np.float64)[:, None]
        mean = sums / cnt
        P = _sym6_to_mat(moms) / cnt[..., None]
        cov = P - mean[:, :, None] * mean[:, None, :]
        lams, vecs = np.linalg.eigh(cov)
        lam2 = np.maximum(lams[:, 2], 1e-300)
        ratio = lams[:, 0] / lam2
        thr = eigen_ratios[min(level, len(eigen_ratios) - 1)]
        is_plane = big & (ratio <= thr)
        can_subdiv = big & ~is_plane & (level < layer_limit)

        stats["levels"].append(
            dict(level=level, voxels=int(ukeys.size), planes=int(is_plane.sum()),
                 subdiv=int(can_subdiv.sum()), discarded=int((~big).sum()
                 + int((big & ~is_plane & (level >= layer_limit)).sum())))
        )

        # record lookup structure
        pk = ukeys[is_plane]
        pidx = n_emitted + np.arange(pk.size, dtype=np.int64)
        plane_keys.append(pk)
        plane_index.append(pidx)
        subdiv_keys.append(ukeys[can_subdiv])
        emit_centers.append(mean[is_plane])
        emit_normals.append(vecs[is_plane][:, :, 0])
        emit_eigvals.append(lams[is_plane])

        # assign plane ids to points of planar voxels
        seg_of_point = np.searchsorted(ukeys, skeys)  # segment per sorted point
        plane_id_per_seg = np.full(ukeys.size, -1, dtype=np.int64)
        plane_id_per_seg[is_plane] = pidx
        pt_global = active[order]
        pp = plane_id_per_seg[seg_of_point]
        hitmask = pp >= 0
        point_plane[pt_global[hitmask]] = pp[hitmask]
        n_emitted += pk.size

        # subdivide remaining
        sub_per_seg = can_subdiv[seg_of_point]
        nxt_global = pt_global[sub_per_seg]
        nxt_keys = skeys[sub_per_seg]
        if nxt_global.size and level < layer_limit:
            Xa = world[nxt_global]
            cell = voxel_size / (2 ** level)
            base = np.floor(Xa / cell) * cell
            center = base + cell / 2.0
            oct_bits = (Xa > center).astype(np.int64)
            octant = 4 * oct_bits[:, 0] + 2 * oct_bits[:, 1] + oct_bits[:, 2]
            keys = nxt_keys * 8 + octant
            active = nxt_global
        else:
            active = np.zeros(0, dtype=np.int64)
            keys = np.zeros(0, dtype=np.int64)

    centers = np.concatenate(emit_centers) if emit_centers else np.zeros((0, 3))
    normals = np.concatenate(emit_normals) if emit_normals else np.zeros((0, 3))
    eigvals = np.concatenate(emit_eigvals) if emit_eigvals else np.zeros((0, 3))

    lookup = PlaneLookup(
        voxel_size=voxel_size,
        plane_keys=plane_keys,
        plane_index=plane_index,
        subdiv_keys=subdiv_keys,
        centers=centers,
        normals=normals,
        eigvals=eigvals,
    )

    if not build_factors:
        # lookup-only consumers (the visual-stage plane-prior rebuild,
        # lvba_system.cpp:1461-1507) never read the factor buckets: skip
        # the per-(voxel, frame) moment pass + bucket packing — about half
        # the build at anchor scale (~2M points)
        stats["planes_total"] = int(n_emitted)
        stats["planes_kept"] = int(n_emitted)
        return VoxelMap(
            buckets=[],
            lookup=lookup,
            num_planes=n_emitted,
            num_frames=W,
            stats=stats,
        )

    # ---- per-(plane voxel, frame) body-frame stats ----
    sel = point_plane >= 0
    vsel = point_plane[sel]
    fsel = fid[sel].astype(np.int64)
    psel = pts[sel]
    pair = vsel * W + fsel
    order = _argsort_keys(pair, native)
    spair = pair[order]
    if spair.size:
        change = np.empty(spair.shape[0], dtype=bool)
        change[0] = True
        np.not_equal(spair[1:], spair[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        upair = spair[starts]
        cnts, sums, moms = _reduceat_moments(psel, order, starts, native)
        e_vox = upair // W
        e_frm = (upair % W).astype(np.int32)
        e_mu = sums / cnts[:, None]
        Praw = _sym6_to_mat(moms)
        e_Pc = Praw - cnts[:, None, None] * (e_mu[:, :, None] * e_mu[:, None, :])
    else:
        e_vox = np.zeros(0, np.int64)
        e_frm = np.zeros(0, np.int32)
        cnts = np.zeros(0, np.int64)
        e_mu = np.zeros((0, 3))
        e_Pc = np.zeros((0, 3, 3))

    # observing-frame count per voxel; require >= min_frames (push_voxel)
    obs_per_vox = np.bincount(e_vox, minlength=n_emitted)
    keep_vox = obs_per_vox >= min_frames
    stats["planes_total"] = int(n_emitted)
    stats["planes_kept"] = int(keep_vox.sum())

    # bucket voxels by observer count
    buckets: List[PlaneFactorBucket] = []
    kept_ids = np.flatnonzero(keep_vox)
    if kept_ids.size:
        occ = obs_per_vox[kept_ids]
        # entry rows grouped by voxel: e_vox sorted already (pair-sorted)
        entry_start = np.searchsorted(e_vox, kept_ids)
        for K in bucket_sizes:
            lo = 0 if K == bucket_sizes[0] else bucket_sizes[bucket_sizes.index(K) - 1]
            in_b = (occ > lo) & (occ <= K) if K != bucket_sizes[-1] else (occ > lo)
            if K == bucket_sizes[-1]:
                over = occ > K
                if np.any(over):
                    raise ValueError(
                        f"voxel observed by {occ[over].max()} frames exceeds "
                        f"max bucket {K}; raise bucket_sizes"
                    )
            ids_b = kept_ids[in_b]
            if ids_b.size == 0:
                continue
            V = ids_b.size
            occ_b = occ[in_b]
            st_b = entry_start[in_b]
            n_arr = np.zeros((V, K), dtype=np.float32)
            mu_arr = np.zeros((V, K, 3), dtype=np.float32)
            Pc_arr = np.zeros((V, K, 3, 3), dtype=np.float32)
            f_arr = np.zeros((V, K), dtype=np.int32)
            # gather rows: build flat index per slot
            row_idx = st_b[:, None] + np.arange(K)[None, :]
            slot_valid = np.arange(K)[None, :] < occ_b[:, None]
            flat = row_idx[slot_valid]
            n_arr[slot_valid] = cnts[flat].astype(np.float32)
            mu_arr[slot_valid] = e_mu[flat].astype(np.float32)
            Pc_arr[slot_valid] = e_Pc[flat].astype(np.float32)
            f_arr[slot_valid] = e_frm[flat]
            buckets.append(PlaneFactorBucket(n=n_arr, mu=mu_arr, Pc=Pc_arr, frame=f_arr))

    return VoxelMap(
        buckets=buckets,
        lookup=lookup,
        num_planes=int(keep_vox.sum()),
        num_frames=W,
        stats=stats,
    )
