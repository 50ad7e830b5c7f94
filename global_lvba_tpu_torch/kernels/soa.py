"""Plane-factor evaluation kernels 1 and 2: per-voxel aggregation with the
fused 3x3 eigensolve, and the per-entry linearization chain.

soa_agg (csrc/soa_agg.cu) replaces the Pallas kernel
global_lvba_tpu/ops/pallas/soa_fused.py:61 `_agg_kernel` and the XLA
eigensolve beside it (`_soa_eig`): CUDA has acosf, so the eigensolve that
the TPU had to split out runs in the same kernel.  Bound: bytes — a dead
cell (n == 0) adds exactly zero, so it needs n of every cell and μ (3),
Pc's upper triangle (6) and the pose row of the live ones (aligned W=512,
one pose table: 15.7 MB of the layout's 54.5 MB); ~150 flops per cell
are far below the card's FLOP/byte balance.  A voxel gets a group of up
to a warp's threads matched to its K (agg_group: every thread on an
entry, several voxels a warp when K is small), each holding up to 16
entries, which load n, then μ, Pc and the pose row of live entries only,
keep their n·(R μ + p) in registers for pass 2 and sum in a fixed
shuffle tree (no atomics, no barrier); each group's first thread runs
its voxel's eigensolve, in parallel with the other groups'.  One launch
takes all of an evaluation's buckets of one kernel instance
(soa_agg_buckets: each bucket's V, K and pose operand in a table passed
by value as the kernel's parameter, with the instance's EPT).

soa_chain (csrc/soa_chain.cu) replaces global_lvba_tpu/ops/pallas/
soa_fused.py:73 `_chain_kernel` and, on the aligned layout, the voxel-axis
g/Hd sums after it (plane_eigen.py:1361-1381), both in one launch.  A block
owns a tile of 32 frames (a lane each) and a run of chain_tile voxels; a
warp stages each voxel's n, μ, Pc and pv spans over the tile in shared
memory with 16-byte cp.async copies (the next two voxels' in flight while
the current one's chain runs), runs the chain of the live cells only,
gathers the voxel's three factor rows over the tile in shared memory and
stores them into the Gram operand A (3V, 6W) with 16-byte stores (every
element: A is torch.empty).  The jjt6 and the 24 distinct diagonal-extras channels
are summed over the voxels in registers, then over the block's warps, and
the last block of a frame tile to arrive adds the tile's block sums in
voxel-block order and writes g (W, 6) and Hd (W, 6, 6) — stored, or added
to the running sums the caller passes (an evaluation's, over its voxel
chunks).  No atomic sum: bitwise repeatable.  Bound: bytes (13 values in
and 18 out per cell; ~560 flops per live cell).

soa_chain_entries (csrc/soa_chain.cu) is the same `_chain_kernel` on its
own, bucketed layout (poses pre-gathered per entry, plane_eigen.py:
1388-1390), and the one-hot M expansion after it (plane_eigen.py:
1485-1489) as an exact store: it writes every element of the Gram operand
A (3V, 6W), each live entry's factor rows at columns 6·frame and zeros
elsewhere (no two entries of a voxel share a frame), and the 30 unique
g/Hd channels per entry for the frame segment-sum (kernels/selection.py).
Bound: bytes — A written once (18·W values a voxel: 172 MB of the W=512
corridor's 218 MB in float32, 0.065 ms), 26 values in and 30 out per
entry.  A block owns chain_entries_tile(V, K) whole voxels: it stages its
entries' inputs in shared memory with coalesced 16-byte loads and runs the
chain once per live entry; then, voxel by voxel, it zero-fills the
voxel's rows of A with 16-byte stores and, behind one barrier, stores its
entries' rows over the zeros while the L2 holds them; its vals rows leave
as one coalesced span.  The wrapper allocates A with torch.empty: nothing
else fills it.

soa_agg's pose operand is a (K, 12) pose table read with voxel stride 0
(aligned: entry (v, k) takes pose k), per-entry pose rows (V, K, 12) with
voxel stride K·12 (bucketed: table_select's output), or a (G, K, 12)
table of pose windows, one a group of V / G voxels (the group form of the
aligned banded groups: voxel v's slot k takes window v // (V / G)'s row
k), so the pose expansion happens in one place and no wrapper reads ids
back to the host.

Group forms (the aligned banded groups of large W, factors/plane_eigen.py
AlignedBandedGroups): a stack of G groups of Vp voxels at local width 2B,
(G·Vp, 2B), each group with its window of poses, a (G, 2B, 12) table
(table_select over the frame ids offset[g] + k).  soa_agg takes it as its
pose operand (above); soa_chain_groups is soa_chain's group form: the
same kernel, its blocks never spanning two groups, each group's sums
written as entry rows (G·2B, 30) in soa_chain_entries' vals layout, for
entry_reduce to fold by frame.  One launch of each per stack.

Each kernel takes float32 or float64 operands (all of one dtype): a
float64 solve launches the kernel's double instance (`<name>_f64`, its
own launch count), the same formulas in the plain float64 version's
arithmetic.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"soa_agg": 0, "soa_chain": 0, "soa_chain_entries": 0,
            "soa_agg_f64": 0, "soa_chain_f64": 0,
            "soa_chain_entries_f64": 0}

AGG_THREADS = 256        # soa_agg_kernel's block (kThreads in soa_agg.cu)
AGG_GROUP = 32           # its threads a voxel at most: a warp's shuffles
AGG_EPT = 16             # its entries a thread a round at most (1-16)
AGG_MAX_BUCKETS = 16     # buckets one launch takes (kMaxBuckets)
CHAIN_FRAME_TILE = 32    # soa_chain_kernel's frames a block (kTile)
# its warps a block per dtype (one block a SM: 128 registers a thread in
# float32, ~220 in float64); kernels/build.py passes them
CHAIN_WARPS = {torch.float32: 16, torch.float64: 8}
# soa_chain_entries' block limits; kernels/build.py passes them to
# soa_chain.cu (kMaxTile, kEntryThreads)
CHAIN_MAX_TILE = 64      # voxels a block
CHAIN_MAX_ENTRIES = 128  # entries a round: the block's threads
_D24_TO_36_ON: dict = {}
_CHAIN_SLOTS_ON: dict = {}
_CHAIN_ARRIVALS_ON: dict = {}


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _check_operands(n, mu, Pc, poses, *more):
    """Shapes of the moments and the pose operand (a (P, 12) table, or
    (G, K, 12) rows: per entry when G == V, windows of a group form
    otherwise); device, dtype (float32 or float64, n's for all) and
    contiguity of every tensor, `more` as (name, tensor) pairs."""
    V, K = n.shape
    if mu.shape != (V, K, 3) or Pc.shape != (V, K, 3, 3) or not (
            (poses.dim() == 2 and poses.shape[1] == 12)
            or (poses.dim() == 3 and poses.shape[1:] == (K, 12))):
        raise ValueError(
            f"bad operand shapes n {tuple(n.shape)} mu {tuple(mu.shape)} "
            f"Pc {tuple(Pc.shape)} poses {tuple(poses.shape)}")
    for name, t in (("n", n), ("mu", mu), ("Pc", Pc), ("poses", poses),
                    *more):
        if t.device != n.device:
            raise ValueError(f"{name} is on {t.device}, n on {n.device}")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: the kernel takes float32 or float64, "
                            f"got {t.dtype}")
        if t.dtype != n.dtype:
            raise TypeError(f"{name} is {t.dtype}, n is {n.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def agg_group(K: int):
    """(log2 G, EPT) of soa_agg_kernel for voxels of K slots: each thread
    holds EPT entries a round, the least power of two that covers K with a
    warp's threads (AGG_GROUP) up to AGG_EPT (K above AGG_GROUP·AGG_EPT
    takes rounds), and each voxel a group of G threads, the least power of
    two with G·EPT >= K up to a warp (AGG_THREADS / G voxels a block; the
    launcher derives G from K and EPT the same way).  So one entry a thread
    up to K = 32: the group's sums then pair entries as the plain version's
    reduction does (four a thread took 0.0101 ms on the corridor against
    0.0182 on an H100, but its voxel means round differently, and the
    corridor's gradient, which cancels, moved 1.4e-4 from the plain
    version's: TOL_EVAL_REL is 1e-4)."""
    ept = 1
    while AGG_GROUP * ept < K and ept < AGG_EPT:
        ept *= 2
    G = 1
    while G * ept < K and G < AGG_GROUP:
        G *= 2
    return G.bit_length() - 1, ept


def soa_agg(n, mu, Pc, poses):
    """Aggregation + eigensolve -> (residv (V,), pv (V, 16)), pv =
    [u(3), B1(3), B2(3), v̄(3), 1/N, 0, 0, 0].

    n (V, K), mu (V, K, 3), Pc (V, K, 3, 3).  poses: the (K, 12) pose table
    on the aligned layout (entry (v, k) takes pose k: voxel stride 0),
    per-entry pose rows (V, K, 12) on the bucketed layout (table_select's
    output: voxel stride K·12), or (G, K, 12) pose windows, G dividing V
    (the group form: voxel v takes window v // (V / G); G == V is the
    per-entry case)."""
    return soa_agg_buckets([(n, mu, Pc, poses)])[0]


def _pose_blocks(poses, V, K):
    """(vstride, vper) of soa_agg's pose operand: voxel v reads block
    v // vper at stride vstride."""
    if poses.dim() == 2:
        if poses.shape[0] != K:
            raise ValueError(f"aligned layout needs K == poses, got {K} != "
                             f"{poses.shape[0]}")
        return 0, 1
    G = poses.shape[0]
    if G < 1 or V % G:
        raise ValueError(f"{G} pose windows do not divide {V} voxels")
    return K * 12, V // G


def soa_agg_buckets(ops):
    """soa_agg of each (n, mu, Pc, poses) of `ops` -> [(residv, pv)], all
    of one dtype and device, each bucket with its own V, K and pose
    operand: one launch per kernel instance the buckets take (agg_group's
    entries a thread, EPT: the corridor's five tiers take two) and per
    AGG_MAX_BUCKETS buckets.  A bucket runs in its own instance whatever
    else is in the launch, so its outputs are bit for bit soa_agg's."""
    if not ops:
        return []
    dev = ops[0][0].device
    if dev.type == "cpu":
        return soa_agg_buckets_plain(ops)
    if dev.type != "cuda":
        raise ValueError(f"soa_agg: unsupported device {dev}")
    dt = ops[0][0].dtype
    name = build.dtype_launcher("soa_agg", dt)
    groups, outs = {}, []
    for n, mu, Pc, poses in ops:
        V, K = n.shape
        _check_operands(n, mu, Pc, poses)
        if n.device != dev or n.dtype != dt:
            raise ValueError("soa_agg: the buckets' operands must share one "
                             "device and dtype")
        vstride, vper = _pose_blocks(poses, V, K)
        residv = torch.empty((V,), dtype=dt, device=dev)
        pv = torch.empty((V, 16), dtype=dt, device=dev)
        outs.append((residv, pv))
        groups.setdefault(agg_group(K)[1], []).append(
            (n, mu, Pc, poses, vstride, vper, V, K, residv, pv))
    launch = build.launcher(name)
    for ept, args in groups.items():
        for i0 in range(0, len(args), AGG_MAX_BUCKETS):
            cols = list(zip(*args[i0:i0 + AGG_MAX_BUCKETS]))
            nb = len(cols[0])
            ptrs = [(ctypes.c_void_p * nb)(*(t.data_ptr() for t in col))
                    for col in cols[:4] + cols[8:]]
            ints = [(ctypes.c_int * nb)(*col) for col in cols[4:8]]
            with torch.cuda.device(dev):
                err = launch(nb, *ptrs[:4], *ints, ept, *ptrs[4:],
                             _stream(dev))
            build.check(name, err)
            LAUNCHES[name] += 1
    return outs


def soa_agg_buckets_plain(ops):
    """Plain torch version of soa_agg_buckets: soa_agg_plain per bucket."""
    return [soa_agg_plain(*o) for o in ops]


def _voxel_poses(poses, V):
    """The pose operand with a leading voxel axis, as _pose_channels reads
    it: the (K, 12) table as it is (broadcast over voxels), (G, K, 12)
    windows repeated to (V, K, 12) (the per-entry rows when G == V)."""
    if poses.dim() == 2 or poses.shape[0] == V:
        return poses
    _pose_blocks(poses, V, poses.shape[1])
    return poses.repeat_interleave(V // poses.shape[0], dim=0)


def soa_agg_plain(n, mu, Pc, poses):
    """Plain torch version of soa_agg: _soa_agg + _soa_eig."""
    from ..factors.plane_eigen import (
        _moment_channels, _pose_channels, _soa_agg, _soa_eig)

    mu3, P6 = _moment_channels(mu, Pc)
    R9, p3 = _pose_channels(_voxel_poses(poses, n.shape[0]))
    _, _, N, invN, vb, _, _, cov6 = _soa_agg(n, mu3, P6, R9, p3)
    residv, u, B1, B2 = _soa_eig(cov6, N)
    zero = torch.zeros_like(invN)
    pv = torch.stack(u + B1 + B2 + vb + (invN, zero, zero, zero), dim=-1)
    return residv, pv


def chain_tile(V: int, W: int, slots: int, warps: int,
               groups: int = 1) -> int:
    """Voxels per block of soa_chain_kernel for V voxels of W frames when
    the card holds `slots` blocks of `warps` warps at once (its SMs times
    the kernel's resident blocks a SM): the grid of ceil(W /
    CHAIN_FRAME_TILE) frame tiles by ceil(V / vt) voxel blocks fills the
    slots about once, each of a block's warps walking the same number of
    voxels, so a warp's staging ring has a run of voxels to overlap and a
    tile's last block has few blocks' sums to add; a multiple of warps, at
    least warps.  The group form: `groups` groups of V voxels each, the
    grid their frame tiles by each group's ceil(V / vt) voxel blocks."""
    tiles = -(-W // CHAIN_FRAME_TILE) * groups
    per_tile = max(1, slots // tiles)
    return warps * max(1, -(-V // (per_tile * warps)))


def _chain_slots(dev, dtype) -> int:
    """The blocks of soa_chain_kernel's `dtype` instance that `dev` holds at
    once: its SMs times the resident blocks a SM the runtime reports for
    the built kernel (its registers and shared memory)."""
    key = (dev, dtype)
    slots = _CHAIN_SLOTS_ON.get(key)
    if slots is None:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = build.launcher("soa_chain_occupancy")(
                int(dtype == torch.float64), ctypes.byref(blocks))
        build.check("soa_chain_occupancy", err)
        if blocks.value < 1:
            raise RuntimeError("soa_chain_kernel does not fit on an SM")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slots = _CHAIN_SLOTS_ON[key] = sms * blocks.value
    return slots


def _chain_arrivals(dev, tiles: int):
    """The aligned chain's arrival counters on `dev`, one a frame tile: made
    zero once; each launch leaves them zero."""
    buf = _CHAIN_ARRIVALS_ON.get(dev)
    if buf is None or buf.numel() < tiles:
        buf = _CHAIN_ARRIVALS_ON[dev] = torch.zeros(
            (max(tiles, 64),), dtype=torch.int32, device=dev)
    return buf


def _check_sums(g, Hd, W, n):
    if (g is None) != (Hd is None):
        raise ValueError("soa_chain: pass both running sums g and Hd, or "
                         "neither")
    if g is None:
        return
    for name, t, shape in (("g", g, (W, 6)), ("Hd", Hd, (W, 6, 6))):
        if t.shape != shape or t.dtype != n.dtype or t.device != n.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor of "
                             f"the operands' dtype on their device")


def soa_chain(n, mu, Pc, pose12, pv, g=None, Hd=None):
    """Linearization chain on the aligned layout -> (A (3V, 6W), g (W, 6),
    Hd (W, 6, 6)): A row (v, r) holds factor row r of voxel v at columns
    6k..6k+5 for every frame k (the Gram operand; H -= AᵀA), g and Hd are
    the voxel sums of the per-entry gradient and diagonal extras.  Given
    the running sums g and Hd, the voxel sums are added to them in place
    and they are returned."""
    if n.device.type == "cpu":
        return soa_chain_plain(n, mu, Pc, pose12, pv, g, Hd)
    if n.device.type != "cuda":
        raise ValueError(f"soa_chain: unsupported device {n.device}")
    _check_operands(n, mu, Pc, pose12)
    V, W = n.shape
    if pose12.dim() != 2 or pose12.shape[0] != W:
        raise ValueError(f"aligned layout needs W == poses, got {W} != "
                         f"{pose12.shape[0]}")
    if pv.shape != (V, 16) or pv.dtype != n.dtype \
            or pv.device != n.device or not pv.is_contiguous():
        raise ValueError("pv must be a contiguous (V, 16) tensor of the "
                         "operands' dtype on their device")
    _check_sums(g, Hd, W, n)
    dev, dt = n.device, n.dtype
    accumulate = g is not None
    if not accumulate:
        g = torch.empty((W, 6), dtype=dt, device=dev)
        Hd = torch.empty((W, 6, 6), dtype=dt, device=dev)
    A = torch.empty((3 * V, 6 * W), dtype=dt, device=dev)
    if V == 0 or W == 0:
        if not accumulate:
            g.zero_()
            Hd.zero_()
        return A, g, Hd
    _chain_launch(n, mu, Pc, pose12, pv, 0, V, A, g, Hd, None, accumulate)
    return A, g, Hd


def _chain_launch(n, mu, Pc, poses, pv, G, Vp, A, g, Hd, vals, accumulate):
    """One launch of soa_chain_kernel: the W-wide form (G = 0: g, Hd) or
    the group form (G groups of Vp voxels: vals)."""
    dev, dt = n.device, n.dtype
    V, W = n.shape
    vt = chain_tile(Vp, W, _chain_slots(dev, dt), CHAIN_WARPS[dt],
                    max(G, 1))
    tiles, nvb = -(-W // CHAIN_FRAME_TILE) * max(G, 1), -(-Vp // vt)
    if max(G, 1) * nvb > 65535:
        raise ValueError(f"too many voxels for one launch: {V}")
    part = torch.empty((tiles * nvb * 30 * CHAIN_FRAME_TILE,), dtype=dt,
                       device=dev)
    name = build.dtype_launcher("soa_chain", dt)
    launch = build.launcher(name)

    def ptr(t):
        return None if t is None else _ptr(t)

    with torch.cuda.device(dev):
        err = launch(_ptr(n), _ptr(mu), _ptr(Pc), _ptr(poses), _ptr(pv),
                     V, W, vt, G, Vp, _ptr(A), ptr(g), ptr(Hd), ptr(vals),
                     int(accumulate), _ptr(part),
                     _ptr(_chain_arrivals(dev, tiles)), _stream(dev))
    build.check(name, err)
    LAUNCHES[name] += 1


def soa_chain_groups(n, mu, Pc, poses, pv, vals=None):
    """soa_chain's group form -> (A (3V, 6W), vals (G·W, 30)) for a stack of
    G groups of Vp = V / G voxels at local width W, n (V, W), poses the
    (G, W, 12) pose windows (group g's slot k takes poses[g, k]).  A is
    the groups' Gram operands stacked (group g's rows 3·g·Vp ..
    3·(g + 1)·Vp); vals row g·W + k holds the sums over group g's voxels
    of slot k's 30 unique g/Hd channels (jjt 6 | the _D_UNIQUE diagonal
    extras 24), soa_chain_entries' layout.  vals, when given, is the
    (G·W, 30) output (a slice of an evaluation's buffer)."""
    V, W = n.shape
    G = poses.shape[0] if poses.dim() == 3 else 0
    if vals is None:
        vals = torch.empty((G * W, 30), dtype=n.dtype, device=n.device)
    if n.device.type == "cpu":
        return soa_chain_groups_plain(n, mu, Pc, poses, pv, vals)
    if n.device.type != "cuda":
        raise ValueError(f"soa_chain_groups: unsupported device {n.device}")
    _check_operands(n, mu, Pc, poses, ("pv", pv), ("vals", vals))
    if poses.shape != (G, W, 12) or G < 1 or V % G:
        raise ValueError(f"poses must be (G, W, 12) windows of G dividing "
                         f"{V} voxels, got {tuple(poses.shape)}")
    if pv.shape != (V, 16) or vals.shape != (G * W, 30):
        raise ValueError(f"pv {tuple(pv.shape)} / vals {tuple(vals.shape)} "
                         f"do not fit {G} groups of {V // G} voxels at "
                         f"width {W}")
    A = torch.empty((3 * V, 6 * W), dtype=n.dtype, device=n.device)
    if V:
        _chain_launch(n, mu, Pc, poses, pv, G, V // G, A, None, None, vals,
                      False)
    else:
        vals.zero_()
    return A, vals


def d24_to_36(device):
    """The 24 -> 36 channel index on `device`, copied there once (a copy
    from host memory on every call would sync the stream)."""
    idx = _D24_TO_36_ON.get(device)
    if idx is None:
        from ..factors.plane_eigen import _D24_TO_36

        idx = _D24_TO_36_ON[device] = torch.as_tensor(_D24_TO_36,
                                                      device=device)
    return idx


def _chain_channels(n, mu, Pc, poses, pv):
    """_soa_chain over every cell of n (V, K) with poses as soa_agg takes
    them -> (rows_ch (18,), jjt_ch (6,), d36_ch (36,)) of (V, K) planes."""
    from ..factors.plane_eigen import (
        _moment_channels, _pose_channels, _soa_agg, _soa_chain)

    mu3, P6 = _moment_channels(mu, Pc)
    R9, p3 = _pose_channels(_voxel_poses(poses, n.shape[0]))
    mask, nm, _, _, _, Rm, RP, _ = _soa_agg(n, mu3, P6, R9, p3)
    u = (pv[:, 0], pv[:, 1], pv[:, 2])
    B1 = (pv[:, 3], pv[:, 4], pv[:, 5])
    B2 = (pv[:, 6], pv[:, 7], pv[:, 8])
    vb = (pv[:, 9], pv[:, 10], pv[:, 11])
    invN = pv[:, 12]
    return _soa_chain(mask, nm, invN, vb, Rm, RP, mu3, P6, R9, p3, u, B1, B2)


def soa_chain_plain(n, mu, Pc, pose12, pv, g=None, Hd=None):
    """Plain torch version of soa_chain: _soa_chain + voxel-axis sums, the
    rows relaid out to the Gram operand (3V, 6W); the sums added in place
    to the running g and Hd when given."""
    V, W = n.shape
    _check_sums(g, Hd, W, n)
    rows_ch, jjt_ch, d36_ch = _chain_channels(n, mu, Pc, pose12, pv)
    gs = torch.stack([c.sum(dim=0) for c in jjt_ch], dim=-1)
    Hds = torch.stack([c.sum(dim=0) for c in d36_ch], dim=-1).reshape(W, 6, 6)
    if g is None:
        g, Hd = gs, Hds
    else:
        g.add_(gs)
        Hd.add_(Hds)
    A = torch.stack(rows_ch, dim=-1).reshape(V, W, 3, 6)
    return A.permute(0, 2, 1, 3).reshape(3 * V, 6 * W), g, Hd


def soa_chain_groups_plain(n, mu, Pc, poses, pv, vals=None):
    """Plain torch version of soa_chain_groups: _soa_chain with each
    voxel's group window, the rows relaid out to (3V, 6W), the 30 unique
    channels summed over each group's voxels."""
    from ..factors.plane_eigen import _D_UNIQUE

    V, W = n.shape
    G = poses.shape[0]
    rows_ch, jjt_ch, d36_ch = _chain_channels(n, mu, Pc, poses, pv)
    uniq = torch.stack(jjt_ch + tuple(d36_ch[i] for i in _D_UNIQUE), dim=-1)
    sums = uniq.reshape(G, V // G, W, 30).sum(dim=1).reshape(G * W, 30)
    if vals is None:
        vals = sums
    else:
        vals.copy_(sums)
    A = torch.stack(rows_ch, dim=-1).reshape(V, W, 3, 6)
    return A.permute(0, 2, 1, 3).reshape(3 * V, 6 * W), vals


def chain_entries_tile(V: int, K: int, sms: int) -> int:
    """Voxels per block of soa_chain_entries_kernel for V voxels of K slots
    on `sms` SMs: the largest power of two up to CHAIN_MAX_TILE whose
    entries fit in CHAIN_MAX_ENTRIES, halved while the launch has fewer
    than two blocks per SM (A's rows, 18·W values a voxel, are most of the
    bytes, and the blocks write them); at least 1."""
    vt = CHAIN_MAX_TILE
    while vt > 1 and vt * K > CHAIN_MAX_ENTRIES:
        vt //= 2
    while vt > 1 and -(-V // vt) < 2 * sms:
        vt //= 2
    return vt


def soa_chain_entries(n, mu, Pc, poses, frame, pv, W, vals=None):
    """Linearization chain on the bucketed layout -> (A (3V, 6W), vals
    (V·K, 30)).  Entry (v, k) writes its three factor rows into A row
    block v at columns 6·frame[v, k] (the M expansion; A is zero
    elsewhere) and its 30 unique g/Hd channels (jjt 6 | the _D_UNIQUE
    diagonal extras 24) into vals row v·K + k.  Dead entries (n == 0)
    write zero channels and no rows; a live entry whose frame id lies
    outside [0, W) writes its channels but no rows (the JAX one-hot drops
    its column likewise).
    poses: per-entry pose rows (V, K, 12); frame (V, K) int32; pv the
    voxels' soa_agg output.  vals, when given, is the (V·K, 30) output
    (a slice of a bucket-wide buffer)."""
    V, K = n.shape
    if vals is None:
        vals = torch.empty((V * K, 30), dtype=n.dtype, device=n.device)
    if n.device.type == "cpu":
        return soa_chain_entries_plain(n, mu, Pc, poses, frame, pv, W, vals)
    if n.device.type != "cuda":
        raise ValueError(f"soa_chain_entries: unsupported device {n.device}")
    if poses.shape != (V, K, 12):
        raise ValueError(f"poses must be (V, K, 12) per-entry rows, got "
                         f"{tuple(poses.shape)}")
    _check_operands(n, mu, Pc, poses, ("pv", pv), ("vals", vals))
    if frame.shape != (V, K) or frame.dtype != torch.int32 \
            or frame.device != n.device or not frame.is_contiguous():
        raise ValueError("frame must be a contiguous (V, K) int32 tensor "
                         "on the operands' device")
    if pv.shape != (V, 16) or vals.shape != (V * K, 30):
        raise ValueError(f"pv {tuple(pv.shape)} / vals {tuple(vals.shape)} "
                         f"do not fit {V} voxels of {K} slots")
    A = torch.empty((3 * V, 6 * W), dtype=n.dtype, device=n.device)
    sms = torch.cuda.get_device_properties(n.device).multi_processor_count
    name = build.dtype_launcher("soa_chain_entries", n.dtype)
    launch = build.launcher(name)
    with torch.cuda.device(n.device):
        err = launch(_ptr(n), _ptr(mu), _ptr(Pc), _ptr(poses), _ptr(frame),
                     _ptr(pv), V, K, W, chain_entries_tile(V, K, sms),
                     _ptr(A), _ptr(vals), _stream(n.device))
    build.check(name, err)
    LAUNCHES[name] += 1
    return A, vals


def soa_chain_entries_plain(n, mu, Pc, poses, frame, pv, W, vals=None):
    """Plain torch version of soa_chain_entries: _soa_chain on every
    entry, the rows scattered into A by index_put_."""
    from ..factors.plane_eigen import _D_UNIQUE

    V, K = n.shape
    rows_ch, jjt_ch, d36_ch = _chain_channels(n, mu, Pc, poses, pv)
    uniq = torch.stack(jjt_ch + tuple(d36_ch[i] for i in _D_UNIQUE), dim=-1)
    if vals is None:
        vals = torch.empty((V * K, 30), dtype=n.dtype, device=n.device)
    vals.copy_(uniq.reshape(V * K, 30))
    f = frame.long()
    vi, ki = torch.nonzero((n > 0) & (f >= 0) & (f < W), as_tuple=True)
    rows = torch.stack(rows_ch, dim=-1).reshape(V, K, 3, 6)
    A = torch.zeros((3 * V, 6 * W), dtype=n.dtype, device=n.device)
    # A row block v, column block f, seen as (V, W, 3, 6): one cell per
    # live entry, never two (a voxel observes a frame at most once)
    A.view(V, 3, W, 6).permute(0, 2, 1, 3).index_put_((vi, f[vi, ki]),
                                                      rows[vi, ki])
    return A, vals
