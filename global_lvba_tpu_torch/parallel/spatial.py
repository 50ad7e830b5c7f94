"""Spatial (Morton-range) map partitions and distributed voxel moments with
a halo ring (port of global_lvba_tpu.parallel.spatial).

  * spatial_partition / partition_buckets_morton: voxels ordered by the
    Morton code of their centroid and split into contiguous ranges, so a
    shard is a compact 3-D region of the map (host numpy);
  * distributed_voxel_moments: points split evenly over the shards
    (arrival order); each shard bins its points into per-voxel moment
    partials (count, Σx, Σxxᵀ: the reference's PointCluster statistics,
    tools.hpp:407-466), and a ring of n − 1 steps passes every shard's
    partial table past every owner, which adds the entries whose Morton
    code falls in its range.  In one process the ring runs over the
    mesh's shards; across processes a shard's table goes to the next rank
    by send/recv.

Morton keys use 10 bits an axis (1024³ root voxels).  On the device they
are int64 with the JAX package's uint32 values; the dead key is
0xFFFFFFFF.  The sums of a bin are fixed-order (torch.segment_reduce over
the key-sorted entries: one sequential or tree sum a segment, no
atomics); counts and the max reduction of a bin's key are order-free.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mesh import Mesh, shard_bounds

_MBITS = 10
_MOFF = 1 << (_MBITS - 1)
DEAD = 0xFFFFFFFF


def _part1by2_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x3FF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
    return x


def morton3(coords: np.ndarray) -> np.ndarray:
    """Integer voxel coords (N, 3) -> 30-bit Morton codes (N,) uint32.
    Coords are offset by 2^(bits-1) so negatives pack; out of range
    raises."""
    c = coords.astype(np.int64) + _MOFF
    if np.any((c < 0) | (c >= (1 << _MBITS))):
        raise ValueError("voxel coordinates out of Morton range (10 bits/axis)")
    return ((_part1by2_np(c[:, 0]) << np.uint64(2))
            | (_part1by2_np(c[:, 1]) << np.uint64(1))
            | _part1by2_np(c[:, 2])).astype(np.uint32)


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3_device(coords: torch.Tensor) -> torch.Tensor:
    """Device morton3 on integer coords (..., 3) -> int64 keys with the
    uint32 codes' values (each axis masked to 10 bits, no range check)."""
    c = coords.long() + _MOFF
    return ((_part1by2(c[..., 0]) << 2) | (_part1by2(c[..., 1]) << 1)
            | _part1by2(c[..., 2]))


# ---------------------------------------------------------------------------
# Factor-bucket spatial partitions (host)
# ---------------------------------------------------------------------------


def spatial_partition(centers: np.ndarray, voxel_size: float,
                      n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """(order, shard_of_voxel): `order` sorts voxels by the Morton code of
    their centroid's root voxel; splitting the sorted list into n_shards
    equal chunks gives each shard one contiguous 3-D region (balanced by
    voxel count)."""
    coords = np.floor(np.asarray(centers) / voxel_size).astype(np.int64)
    codes = morton3(coords)
    order = np.argsort(codes, kind="stable")
    V = order.shape[0]
    shard_of_sorted = np.minimum((np.arange(V) * n_shards) // max(V, 1),
                                 n_shards - 1)
    shard_of_voxel = np.empty(V, dtype=np.int32)
    shard_of_voxel[order] = shard_of_sorted.astype(np.int32)
    return order, shard_of_voxel


def partition_buckets_morton(vm, n_shards: int):
    """Every factor bucket of a VoxelMap with its voxel rows in Morton order
    of their centroids, so rows [i·ceil(V/n), (i+1)·ceil(V/n)) of the
    padded bucket are shard i's region.  The centroid is the count-weighted
    mean of the bucket's per-frame body means: a stable spatial key is all
    the partition needs."""
    from ..map.voxelize import PlaneFactorBucket

    out = []
    for b in vm.buckets:
        w = b.n / np.maximum(b.n.sum(axis=1, keepdims=True), 1e-9)
        cent = np.einsum("vk,vki->vi", w, b.mu)
        order, _ = spatial_partition(cent, 1.0, n_shards)
        out.append(PlaneFactorBucket(n=b.n[order], mu=b.mu[order],
                                     Pc=b.Pc[order], frame=b.frame[order]))
    return out


# ---------------------------------------------------------------------------
# Distributed voxel moments with the halo ring
# ---------------------------------------------------------------------------


def _bin(keys: torch.Tensor, vals: torch.Tensor, capacity: int):
    """Entries (keys (E,), vals (E, 10): count, Σx, Σxxᵀ) reduced by key
    into `capacity` slots, ascending by key -> (slot_key, vals (capacity,
    10)); a slot with no count has the dead key.  Keys beyond `capacity`
    distinct ones are dropped (as jax.ops.segment_sum drops them): the
    caller's count check raises."""
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    seg = (torch.cumsum(first, 0) - 1).clamp(max=capacity)
    lengths = torch.zeros(capacity + 1, dtype=torch.long,
                          device=keys.device).scatter_add_(
        0, seg, torch.ones_like(seg))[:capacity]
    sums = torch.segment_reduce(vals[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)
    slot = torch.full((capacity + 1,), DEAD, dtype=torch.long,
                      device=keys.device).scatter_reduce(
        0, seg, sk, "amax", include_self=False)[:capacity]
    return torch.where(sums[:, 0] > 0, slot, DEAD), sums


def _local_bin(pts: torch.Tensor, keys: torch.Tensor, capacity: int):
    """(slot_key, count, Σx, Σxxᵀ (6,)) of local points by key into
    `capacity` slots sorted by key; empty slots carry the dead key."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    vals = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                        y * y, y * z, z * z], dim=-1)
    slot, sums = _bin(keys, vals, capacity)
    return slot, sums[:, 0], sums[:, 1:4], sums[:, 4:]


def _accumulate(acc, table, owner_of, me: int, capacity: int):
    """acc += the entries of `table` this owner owns: both tables' entries
    re-reduced by key (dead and foreign entries weigh nothing)."""
    a_key, a_vals = acc
    t_key, t_vals = table
    mine = (owner_of(t_key) == me) & (t_key != DEAD)
    keys = torch.cat([a_key, torch.where(mine, t_key, DEAD)])
    vals = torch.cat([a_vals, t_vals * mine[:, None]])
    return _bin(keys, vals, capacity)


def _ring_step(tables, mesh: Mesh):
    """Pass every shard's table to the next global shard: in process a
    shift of the local list; the last local table goes to the next rank
    (send/recv), the first comes from the previous one."""
    if mesh.world == 1:
        return [tables[-1]] + tables[:-1]
    dist = torch.distributed
    key, vals = tables[-1]
    # float64 holds the 32-bit keys exactly
    buf = torch.cat([key.double()[:, None], vals.double()], 1)
    host = dist.get_backend() == "gloo"
    send = buf.cpu() if host else buf
    recv = torch.empty_like(send)
    nxt, prv = (mesh.rank + 1) % mesh.world, (mesh.rank - 1) % mesh.world
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt),
                                     dist.P2POp(dist.irecv, recv, prv)]):
        w.wait()
    recv = recv.to(buf.device)
    dev = tables[0][0].device
    inc = (recv[:, 0].long().to(dev), recv[:, 1:].to(dev, vals.dtype))
    return [inc] + tables[:-1]


def distributed_voxel_moments(points: np.ndarray, voxel_size: float,
                              mesh: Mesh, axis: str = "factors",
                              capacity: int = 4096):
    """Per-voxel moments (keys uint32, count, Σx (3,), Σxxᵀ (6,)) of points
    (N, 3) in arrival order, as host arrays sorted by key, equal to
    host_voxel_moments' binning: the points split evenly over the axis's
    shards, binned per shard on its device, and a ring of n − 1 steps
    hands every partial table to the owner of its keys (owner(key) =
    min(key // ceil(2^30 / n), n − 1)).  The sums are in float32, as the
    JAX package's.  A shard with more than `capacity` distinct voxels
    (local or owned) raises ValueError."""
    n = mesh.n_shards(axis)
    N = points.shape[0]
    Np = -(-N // n) * n
    pts = np.zeros((Np, 3), np.float32)
    pts[:N] = points
    devs = mesh.axis_devices(axis)
    per = -(-(1 << 30) // n)

    def owner_of(k):
        return torch.clamp(torch.div(k, per, rounding_mode="floor"),
                           max=n - 1)

    tables, bounds = [], shard_bounds(Np, n)
    for gi, dev in zip(mesh.local_shards(axis), devs):
        lo, hi = bounds[gi]
        p = torch.from_numpy(pts[lo:hi]).to(dev)
        c = torch.floor(p / voxel_size).long()
        if bool(((c + _MOFF < 0) | (c + _MOFF >= 1 << _MBITS)).any()):
            raise ValueError(
                "voxel coordinates out of Morton range (10 bits/axis)")
        keys = morton3_device(c)
        live = torch.arange(lo, hi, device=dev) < N
        slot, cnt, s, m = _local_bin(p, torch.where(live, keys, DEAD),
                                     capacity)
        tables.append((slot, torch.cat([cnt[:, None], s, m], 1)))
    accs = []
    for i, (gi, dev) in enumerate(zip(mesh.local_shards(axis), devs)):
        zero = (torch.full((capacity,), DEAD, dtype=torch.long, device=dev),
                torch.zeros((capacity, 10), dtype=torch.float32, device=dev))
        accs.append(_accumulate(zero, tables[i], owner_of, gi, capacity))
    for _ in range(n - 1):
        tables = _ring_step(tables, mesh)
        accs = [_accumulate(a, (k.to(dev), v.to(dev)), owner_of, gi,
                            capacity)
                for a, (k, v), gi, dev in zip(accs, tables,
                                              mesh.local_shards(axis), devs)]
    out = torch.cat([torch.cat([k.to(torch.float64)[:, None],
                                v.to(torch.float64)], 1).cpu()
                     for k, v in accs])
    if mesh.world > 1:
        parts = [torch.empty_like(out) for _ in range(mesh.world)]
        torch.distributed.all_gather(parts, out)
        out = torch.cat(parts)
    out = out.numpy()
    kk = out[:, 0].astype(np.int64)
    vals = out[:, 1:].astype(np.float32)
    total = float(vals[:, 0].sum(dtype=np.float64))
    if not np.isclose(total, float(N), rtol=0.0, atol=0.5):
        raise ValueError(
            f"distributed_voxel_moments capacity overflow: accumulated "
            f"{total:.0f} of {N} points — a shard exceeded capacity="
            f"{capacity} unique voxels; raise `capacity`")
    live = kk != DEAD
    order = np.argsort(kk[live], kind="stable")
    v = vals[live][order]
    return (kk[live][order].astype(np.uint32), v[:, 0], v[:, 1:4],
            v[:, 4:])


def host_voxel_moments(points: np.ndarray, voxel_size: float):
    """Single-process reference binning (host numpy, float64 sums)."""
    coords = np.floor(points / voxel_size).astype(np.int64)
    keys = morton3(coords)
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    sp = points[order].astype(np.float64)
    first = np.concatenate([[True], sk[1:] != sk[:-1]])
    starts = np.flatnonzero(first)
    ukeys = sk[starts]
    cnt = np.diff(np.append(starts, sk.shape[0])).astype(np.float64)
    s = np.add.reduceat(sp, starts, axis=0)
    xx = np.stack([sp[:, 0] * sp[:, 0], sp[:, 0] * sp[:, 1],
                   sp[:, 0] * sp[:, 2], sp[:, 1] * sp[:, 1],
                   sp[:, 1] * sp[:, 2], sp[:, 2] * sp[:, 2]], axis=-1)
    m = np.add.reduceat(xx, starts, axis=0)
    return ukeys, cnt, s, m
