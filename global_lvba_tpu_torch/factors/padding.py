"""Device factor arrays from a voxel map (port of
global_lvba_tpu.factors.padding, aligned layout).

With the solve width W known, the density gate of the JAX package picks
the frame-aligned dense layout (one (V, W) array set, slot k == frame k)
when the dense cell count V·W is within 2.5x the bucketed entry count and
W >= 64.  This port carries the aligned layout only: where the gate picks
the bucketed layout, it raises.  V is padded to the next
power of two; padded voxels have n == 0 and contribute exactly zero.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..map.voxelize import PlaneFactorBucket, VoxelMap
from .plane_eigen import AlignedPlaneFactorArrays

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


def buckets_to_device(
    vm: VoxelMap, W: int, dtype=torch.float32, device="cuda",
) -> list:
    """[AlignedPlaneFactorArrays] of a voxel map for a W-frame solve, where
    the density gate picks the aligned layout.  The bucketed layout is not
    ported yet: where the gate picks it, this raises NotImplementedError."""
    if picks_aligned(vm, W):
        return [aligned_to_device(vm.buckets, W, dtype=dtype, device=device)]
    raise NotImplementedError("bucketed layout: ROADMAP A, slice 2")


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


def from_jax_arrays(n, mu, Pc, device, dtype) -> AlignedPlaneFactorArrays:
    """Carries the JAX package's aligned factor arrays, handed over as
    numpy (np.asarray of each leaf), into the port's container."""
    return _to_device(np.array(n), np.array(mu), np.array(Pc),
                      device=device, dtype=dtype)
