"""Selection kernels 4 and 5 of the bucketed layout: the pose-table
expansion to entries and the frame segment-sum of per-entry channels.

table_select (csrc/selection.cu) replaces the Pallas kernel
global_lvba_tpu/ops/pallas/selection.py:44 `_table_select_kernel` (via
`table_select`, :55) and the `R[fa.frame]` gather of the default XLA path
(plane_eigen.py:1013-1016): out[e] = tbl[frame[e]], a zero row for an id
outside [0, P) as the TPU's one-hot gives.  The TPU built a one-hot tile
in VMEM and multiplied three bf16 mantissa splits to keep the selection
exact; here it is a copy, exact by construction.  Bound: bytes (4 B of id
in, 48 B of pose row out per entry, 96 in float64).  One launch takes all
of an evaluation's buckets (table_select_buckets, up to
SELECT_MAX_BUCKETS: each bucket's ids, count and first output row in a
table passed by value) and writes one (ΣE, C) buffer, the buckets' rows
views of it; one thread per 16-byte chunk of an output row, the (P, C)
table read through the read-only path.

entry_reduce (csrc/selection.cu) replaces selection.py:84
`_entry_reduce_kernel` (via `entry_reduce`, :106) and the one-hot g/Hd
contraction of the default path (plane_eigen.py:1475-1484):
out[w, c] = Σ_{e: frame[e] = w} vals[e, c].  The TPU accumulated over a
sequential grid; blocks on the card run in no order, so the kernel reads
the frame-major (W, Kf) table of plane_eigen.frame_gather_table instead:
one block per frame sums that frame's entries in a fixed order and a
fixed tree, with no atomics, so H is bitwise repeatable.  The sentinel
index V·K adds nothing.  Bound: bytes (the live entries' 30 channels, the
W·Kf table, the W·30 output).

Both take float32 or float64 values: float64 launches the kernel's double
instance (`<name>_f64`, its own launch count).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"table_select": 0, "entry_reduce": 0, "table_select_f64": 0,
            "entry_reduce_f64": 0}
SELECT_MAX_BUCKETS = 16   # buckets one table_select launch takes


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def table_select(frame: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Per-entry rows (E, C) of a (P, C) table: row e is tbl[frame[e]],
    zero where frame[e] lies outside [0, P).  frame (E,) int32.  The
    one-bucket case of table_select_buckets."""
    return table_select_buckets([frame], tbl)[0]


def table_select_buckets(frames, tbl: torch.Tensor) -> list:
    """table_select of each bucket's ids frames[i] (E_i,) int32 -> views
    (E_i, C) of one (ΣE, C) buffer, bucket i's rows after bucket i-1's:
    one launch per SELECT_MAX_BUCKETS buckets.  C·itemsize must be a
    multiple of 16 bytes (a pose row: 48 B, 96 in float64) and tbl 16-byte
    aligned."""
    if not frames:
        return []
    dev = frames[0].device
    if dev.type == "cpu":
        return table_select_buckets_plain(frames, tbl)
    if dev.type != "cuda":
        raise ValueError(f"table_select: unsupported device {dev}")
    for f in frames:
        if f.dim() != 1 or f.dtype != torch.int32 or f.device != dev \
                or not f.is_contiguous():
            raise ValueError("each frame must be a contiguous (E,) int32 "
                             "tensor on one device")
    if tbl.dim() != 2 or tbl.device != dev or not tbl.is_contiguous():
        raise ValueError("tbl must be a contiguous (P, C) tensor on the "
                         "frames' device")
    name = build.dtype_launcher("table_select", tbl.dtype)
    P, C = tbl.shape
    if (C * tbl.element_size()) % 16 or tbl.data_ptr() % 16:
        raise ValueError(f"table_select: a row of {C} values must be a "
                         f"multiple of 16 bytes and tbl 16-byte aligned")
    Es = [f.shape[0] for f in frames]
    if sum(Es) * C >= 2 ** 31:
        raise ValueError(f"too many entries for one launch: {sum(Es)}")
    out = torch.empty((sum(Es), C), dtype=tbl.dtype, device=dev)
    launch = build.launcher(name)
    row0 = 0
    for i0 in range(0, len(frames), SELECT_MAX_BUCKETS):
        fs = frames[i0:i0 + SELECT_MAX_BUCKETS]
        es = Es[i0:i0 + SELECT_MAX_BUCKETS]
        nb = len(fs)
        rows = [row0 + sum(es[:i]) for i in range(nb)]
        row0 += sum(es)
        if not sum(es):
            continue  # no entry: the launcher would launch nothing
        with torch.cuda.device(dev):
            err = launch(nb, (ctypes.c_void_p * nb)(*(f.data_ptr()
                                                      for f in fs)),
                         (ctypes.c_int * nb)(*es), (ctypes.c_int * nb)(*rows),
                         _ptr(tbl), P, C, _ptr(out), _stream(dev))
        build.check(name, err)
        LAUNCHES[name] += 1
    return list(out.split(Es))


def table_select_plain(frame: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Plain torch version of table_select."""
    P = tbl.shape[0]
    f = frame.long()
    valid = (f >= 0) & (f < P)
    rows = tbl[f.clamp(0, P - 1)]
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


def table_select_buckets_plain(frames, tbl: torch.Tensor) -> list:
    """Plain torch version of table_select_buckets: table_select_plain of
    the buckets' ids in one, split back into views per bucket."""
    if not frames:
        return []
    out = table_select_plain(torch.cat(list(frames)), tbl)
    return list(out.split([f.shape[0] for f in frames]))


def entry_reduce(vals: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Frame segment-sum (W, C) of per-entry values vals (E, C) through the
    (W, Kf) int32 frame table: out[w] = Σ_j vals[tbl[w, j]], an index
    outside [0, E) (the sentinel E) adding nothing."""
    if vals.device.type == "cpu":
        return entry_reduce_plain(vals, tbl)
    if vals.device.type != "cuda":
        raise ValueError(f"entry_reduce: unsupported device {vals.device}")
    if vals.dim() != 2 or not vals.is_contiguous():
        raise ValueError("vals must be a contiguous (E, C) tensor")
    name = build.dtype_launcher("entry_reduce", vals.dtype)
    if tbl.dim() != 2 or tbl.dtype != torch.int32 \
            or tbl.device != vals.device or not tbl.is_contiguous():
        raise ValueError("tbl must be a contiguous (W, Kf) int32 tensor on "
                         "vals' device")
    E, C = vals.shape
    W, Kf = tbl.shape
    out = torch.empty((W, C), dtype=vals.dtype, device=vals.device)
    launch = build.launcher(name)
    with torch.cuda.device(vals.device):
        err = launch(_ptr(vals), _ptr(tbl), E, C, W, Kf, _ptr(out),
                     _stream(vals.device))
    build.check(name, err)
    LAUNCHES[name] += 1
    return out


def entry_reduce_plain(vals: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Plain torch version of entry_reduce: plane_eigen.segsum_table."""
    from ..factors.plane_eigen import segsum_table

    return segsum_table(vals, tbl)
