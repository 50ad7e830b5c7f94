"""Device factor arrays from a voxel map (port of
global_lvba_tpu.factors.padding).

With the solve width W known, the density gate of the JAX package picks
the frame-aligned dense layout (one (V, W) array set, slot k == frame k)
when the dense cell count V·W is within 2.5x the bucketed entry count and
W >= 64; otherwise the voxel map's occupancy tiers stay bucketed
(PlaneFactorArrays, (V, K) slots with frame ids), one array set per tier,
or one merged (V, K_max) set with merge="always" (the window stage).  V
is padded to the next power of two; padded voxels and slots have n == 0
and contribute exactly zero.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..map.voxelize import PlaneFactorBucket, VoxelMap
from ..utils.profiling import traced
from .plane_eigen import (
    AlignedPlaneFactorArrays, PlaneFactorArrays, bucket_to_device)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def picks_aligned(vm: VoxelMap, W: int) -> bool:
    """The density gate: dense cells V·W <= 2.5 · bucketed entries, W >= 64
    (the JAX package's defaults)."""
    ratio, min_w = 2.5, 64
    bs = vm.buckets
    dense_cells = sum(b.n.shape[0] for b in bs) * W
    entry_cells = sum(int(np.prod(b.n.shape)) for b in bs)
    return bool(bs) and W >= min_w and dense_cells <= ratio * entry_cells


def pad_bucket(b: PlaneFactorBucket, v_pad: int) -> PlaneFactorBucket:
    """b with zero voxel rows appended up to v_pad voxels."""
    V = b.n.shape[0]
    if v_pad <= V:
        return b
    extra = v_pad - V

    def z(x):
        return np.concatenate([x, np.zeros((extra,) + x.shape[1:], dtype=x.dtype)])

    return PlaneFactorBucket(n=z(b.n), mu=z(b.mu), Pc=z(b.Pc), frame=z(b.frame))


def _pad_k(x: np.ndarray, kmax: int) -> np.ndarray:
    K = x.shape[1]
    if K == kmax:
        return x
    cfg = [(0, 0), (0, kmax - K)] + [(0, 0)] * (x.ndim - 2)
    return np.pad(x, cfg)


@traced("map.upload")
def buckets_to_device(
    vm: VoxelMap, W: int, dtype=torch.float32, device="cuda",
    merge: str = "auto",
) -> list:
    """Device factor arrays of a voxel map for a W-frame solve: one
    [AlignedPlaneFactorArrays] where the density gate picks the aligned
    layout, else [PlaneFactorArrays], one per occupancy tier.
    merge="always" fuses the tiers into ONE (V, K_max) bucket (the window
    stage's choice in the JAX package); "auto" keeps them."""
    if picks_aligned(vm, W):
        return [aligned_to_device(vm.buckets, W, dtype=dtype, device=device)]
    if merge not in ("auto", "always"):
        raise ValueError(f"unknown merge {merge!r}")
    bs = vm.buckets
    if len(bs) > 1 and merge == "always":
        kmax = max(b.n.shape[1] for b in bs)
        bs = [PlaneFactorBucket(
            n=np.concatenate([_pad_k(b.n, kmax) for b in bs]),
            mu=np.concatenate([_pad_k(b.mu, kmax) for b in bs]),
            Pc=np.concatenate([_pad_k(b.Pc, kmax) for b in bs]),
            frame=np.concatenate([_pad_k(b.frame, kmax) for b in bs]),
        )]
    dev = resolve_device(device)
    return [bucket_to_device(pad_bucket(b, _next_pow2(b.n.shape[0])),
                             dtype=dtype, device=dev) for b in bs]


def aligned_to_device(
    bs: Sequence[PlaneFactorBucket], W: int, dtype=torch.float32,
    device="cuda",
) -> AlignedPlaneFactorArrays:
    """Scatter bucketed (V, K) entries into the frame-aligned dense
    (V_total, W) grid: cell (v, f) holds the moments voxel v observed in
    frame f, all other cells zero.  A voxel observes a frame at most once;
    a duplicate (voxel, frame) entry raises instead of being overwritten."""
    Vt = sum(b.n.shape[0] for b in bs)
    Vp = _next_pow2(Vt)
    np_dt = np.dtype(str(dtype).replace("torch.", ""))
    n = np.zeros((Vp, W), dtype=np_dt)
    mu = np.zeros((Vp, W, 3), dtype=np_dt)
    Pc = np.zeros((Vp, W, 3, 3), dtype=np_dt)
    off = 0
    for b in bs:
        V = b.n.shape[0]
        vi, ki = np.nonzero(b.n > 0)
        f = b.frame[vi, ki].astype(np.int64)
        if f.size and (f.min() < 0 or f.max() >= W):
            raise ValueError(
                f"bucket frame ids span [{f.min()}, {f.max()}] outside the "
                f"aligned width W={W}"
            )
        cells = vi.astype(np.int64) * W + f
        if np.unique(cells).size != cells.size:
            raise ValueError("duplicate (voxel, frame) entries in a bucket")
        n[off + vi, f] = b.n[vi, ki]
        mu[off + vi, f] = b.mu[vi, ki]
        Pc[off + vi, f] = b.Pc[vi, ki]
        off += V
    return _to_device(n, mu, Pc, device=device, dtype=dtype)


def _to_device(n, mu, Pc, device, dtype) -> AlignedPlaneFactorArrays:
    """Aligned factor arrays on `device` from host arrays n (V, W),
    mu (V, W, 3), Pc (V, W, 3, 3)."""
    dev = resolve_device(device)

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev, dtype)

    return AlignedPlaneFactorArrays(n=put(n), mu=put(mu), Pc=put(Pc))


def from_jax_arrays(n, mu, Pc, device, dtype, frame=None):
    """Carries the JAX package's factor arrays, handed over as numpy
    (np.asarray of each leaf), into the port's container: aligned without
    `frame`, bucketed (PlaneFactorArrays) with it."""
    if frame is None:
        return _to_device(np.array(n), np.array(mu), np.array(Pc),
                          device=device, dtype=dtype)
    return bucket_to_device(
        PlaneFactorBucket(n=np.array(n), mu=np.array(mu), Pc=np.array(Pc),
                          frame=np.array(frame)),
        dtype=dtype, device=resolve_device(device))
