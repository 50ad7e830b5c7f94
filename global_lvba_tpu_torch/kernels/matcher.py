"""Matcher kernel 6: the running top-2 similarity of descriptor sets.

top2_similarity (csrc/matcher.cu) replaces the Pallas kernel
global_lvba_tpu/ops/pallas/matcher.py:30 `_top2_kernel` (via `_top2_pass`,
:65, and `top2_similarity`, :104) and the dense `jnp.dot` + `lax.top_k` +
column `argmax` of frontend/matching.py:25-50 `match_pair`, which compute
one function: sim = d1·d2ᵀ, −2 wherever a row or a column is invalid; per
row the top-2 values and the argmax column; per column the argmax row.
The (K1, K2) matrix never reaches device memory.  The TPU ran two passes,
the second with the roles swapped; here each product is computed once.

The products run on the tensor cores at 3xTF32 (lo·hi + hi·lo + hi·hi,
split in registers, rounded as cvt.rna as in gram.tf32_split; each k8
step in a fresh accumulator added in fp32), the counterpart of fp32.
The work is cut into equal units (pair, row tile of ROW_TILE, column
range of UNIT_COLS, walked in column tiles of COL_TILE): each writes row
partials (best,
second, index over its columns) and column partials (best row over its
rows), and a second kernel merges them in a fixed order, so the outputs
are bitwise repeatable and a pair's do not depend on the chunk it is in.
Ties go to the lowest index, as argmax and lax.top_k.  A unit computes no
product past the last valid row or column of its pair (extraction ranks
valid slots first) and merges the skipped −2 entries in closed form
(unit_plan mirrors what each unit computes).  Bound: operations, three
TF32 products of 2·D flops per (valid row, valid column).

The TPU's tile-divisibility rule, its bias columns for padded and invalid
slots (D 128 -> 256) and `use_pallas` are gone: the kernel masks the
ragged edges itself and takes the validity masks.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"top2_similarity": 0}
INVALID = -2.0   # below any dot product of unit descriptors
# csrc/matcher.cu's work unit: kBM rows, kUnitCols columns in tiles of kBN
ROW_TILE = 128
COL_TILE = 64
UNIT_COLS = 256


def unit_grid(K1: int, K2: int) -> tuple:
    """(R, C): the row tiles and column ranges of one pair; the kernel
    runs P·R·C units."""
    return -(-K1 // ROW_TILE), -(-K2 // UNIT_COLS)


def unit_plan(rt: int, cu: int, K1: int, K2: int, a_end: int, b_end: int):
    """What unit (rt, cu) of a pair computes, given its valid ends (1 +
    the last valid row / column, 0 if none): None when every entry of
    the unit is −2 (merged in closed form), else (the first columns of
    the column tiles it computes, c_stop, c_hi): the columns [c_stop,
    c_hi) are all −2 and merged in closed form."""
    r_lo, c_lo = rt * ROW_TILE, cu * UNIT_COLS
    c_hi = min(c_lo + UNIT_COLS, K2)
    if r_lo >= a_end or c_lo >= b_end:
        return None
    n_ct = -(-(min(c_hi, b_end) - c_lo) // COL_TILE)
    c_stop = min(c_hi, c_lo + n_ct * COL_TILE)
    return [c_lo + k * COL_TILE for k in range(n_ct)], c_stop, c_hi


def _ptr(t):
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def _operands(d1, d2, v1, v2, ia, ib):
    """Batched views: stacks (N1, K1, D), (N2, K2, D), masks (N, K) or
    None, pair lists (P,); `single` when the caller gave one pair of 2-D
    sets."""
    single = d1.dim() == 2
    if single != (d2.dim() == 2):
        raise ValueError("d1 and d2 must both be 2-D or both 3-D")
    if single:
        if ia is not None or ib is not None:
            raise ValueError("pair lists go with (N, K, D) stacks")
        d1, d2 = d1[None], d2[None]
        v1 = None if v1 is None else v1[None]
        v2 = None if v2 is None else v2[None]
        ia = ib = torch.zeros(1, dtype=torch.int32, device=d1.device)
    elif ia is None or ib is None:
        raise ValueError("(N, K, D) stacks need the pair lists ia, ib")
    return single, d1, d2, v1, v2, ia, ib


def top2_similarity(d1, d2, v1=None, v2=None, ia=None, ib=None):
    """Top-2 similarity of d1 (K1, D) against d2 (K2, D): returns
    (vals (K1, 2), best column (K1,), best row per column (K2,)).

    Batched over pairs: d1 (N1, K1, D) and d2 (N2, K2, D) stacks with pair
    lists ia, ib (P,) give (P, K1, 2), (P, K1), (P, K2) for the pairs
    (d1[ia[p]], d2[ib[p]]).  v1, v2: bool validity masks shaped like the
    sets without D (None: all valid).  Indices are int32.  The kernel
    reads no pair index back to the host: a pair with ia outside [0, N1)
    or ib outside [0, N2) gets NaN values and index -1 there (the plain
    version on the CPU raises IndexError); match_all_pairs checks its
    pairs on the host first."""
    if d1.device.type == "cpu":
        return top2_similarity_plain(d1, d2, v1, v2, ia, ib)
    if d1.device.type != "cuda":
        raise ValueError(f"top2_similarity: unsupported device {d1.device}")
    single, A, B, vA, vB, ia_, ib_ = _operands(d1, d2, v1, v2, ia, ib)
    dev = A.device
    for name, t in (("d1", A), ("d2", B)):
        if t.dtype != torch.float32 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on "
                             f"{dev}")
    K1, D = A.shape[1:]
    K2 = B.shape[1]
    if B.shape[2] != D or K1 < 1 or K2 < 1:
        raise ValueError(f"shapes {tuple(A.shape)} and {tuple(B.shape)}")
    masks = []
    for name, v, t in (("v1", vA, A), ("v2", vB, B)):
        if v is not None:
            if v.dtype != torch.bool or v.shape != t.shape[:2] \
                    or v.device != dev or not v.is_contiguous():
                raise ValueError(f"{name} must be a contiguous bool tensor "
                                 f"shaped {tuple(t.shape[:2])} on {dev}")
            v = v.view(torch.uint8)
        masks.append(v)
    for name, t in (("ia", ia_), ("ib", ib_)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (P,) int32 tensor "
                             f"on {dev}")
    P = ia_.shape[0]
    if ib_.shape[0] != P:
        raise ValueError("ia and ib differ in length")
    vals = torch.empty((P, K1, 2), dtype=torch.float32, device=dev)
    idx = torch.empty((P, K1), dtype=torch.int32, device=dev)
    colarg = torch.empty((P, K2), dtype=torch.int32, device=dev)
    R, C = unit_grid(K1, K2)
    row_val = torch.empty((P, C, K1, 2), dtype=torch.float32, device=dev)
    row_idx = torch.empty((P, C, K1), dtype=torch.int32, device=dev)
    col_val = torch.empty((P, R, K2), dtype=torch.float32, device=dev)
    col_idx = torch.empty((P, R, K2), dtype=torch.int32, device=dev)
    launch = build.launcher("top2_similarity")
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = launch(_ptr(A), _ptr(masks[0]), _ptr(ia_), A.shape[0], _ptr(B),
                     _ptr(masks[1]), _ptr(ib_), B.shape[0], P, K1, K2, D,
                     _ptr(vals), _ptr(idx), _ptr(colarg), _ptr(row_val),
                     _ptr(row_idx), _ptr(col_val), _ptr(col_idx), stream)
    build.check("top2_similarity", err)
    LAUNCHES["top2_similarity"] += 1
    if single:
        return vals[0], idx[0], colarg[0]
    return vals, idx, colarg


def top2_similarity_plain(d1, d2, v1=None, v2=None, ia=None, ib=None):
    """Plain torch version of top2_similarity: the masked similarity
    matrix through torch.bmm, topk(2) for the values, argmax (first index
    on ties) for the row and column winners."""
    single, A, B, vA, vB, ia_, ib_ = _operands(d1, d2, v1, v2, ia, ib)
    if A.device.type == "cpu":   # a negative index would wrap around
        for name, t, n in (("ia", ia_, A.shape[0]), ("ib", ib_, B.shape[0])):
            if t.numel() and (int(t.min()) < 0 or int(t.max()) >= n):
                raise IndexError(f"{name} outside [0, {n})")
    ia_, ib_ = ia_.long(), ib_.long()
    sim = torch.bmm(A[ia_], B[ib_].transpose(1, 2))
    if vA is not None or vB is not None:
        ok = torch.ones_like(sim, dtype=torch.bool)
        if vA is not None:
            ok = ok & vA[ia_][:, :, None]
        if vB is not None:
            ok = ok & vB[ib_][:, None, :]
        sim = torch.where(ok, sim, torch.full_like(sim, INVALID))
    if sim.shape[2] >= 2:
        vals = torch.topk(sim, 2, dim=2).values
    else:
        vals = torch.cat([sim, torch.full_like(sim, float("-inf"))], dim=2)
    idx = torch.argmax(sim, dim=2).to(torch.int32)
    colarg = torch.argmax(sim, dim=1).to(torch.int32)
    if single:
        return vals[0], idx[0], colarg[0]
    return vals, idx, colarg
