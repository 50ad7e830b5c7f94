"""Selection kernels 4 and 5 of the bucketed layout: the pose-table
expansion to entries and the frame segment-sum of per-entry channels.

table_select (csrc/selection.cu) replaces the Pallas kernel
global_lvba_tpu/ops/pallas/selection.py:44 `_table_select_kernel` (via
`table_select`, :55) and the `R[fa.frame]` gather of the default XLA path
(plane_eigen.py:1013-1016): out[e] = tbl[frame[e]], a zero row for an id
outside [0, P) as the TPU's one-hot gives.  The TPU built a one-hot tile
in VMEM and multiplied three bf16 mantissa splits to keep the selection
exact; here it is a copy, exact by construction.  Bound: bytes (4 B of id
in, 48 B of pose row out per entry).  One thread per output float:
neighbouring threads write neighbouring floats and read the same or the
next id; the (P, 12) table is read through the read-only cache.

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


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def table_select(frame: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Per-entry rows (E, C) of a (P, C) table: row e is tbl[frame[e]],
    zero where frame[e] lies outside [0, P).  frame (E,) int32."""
    if frame.device.type == "cpu":
        return table_select_plain(frame, tbl)
    if frame.device.type != "cuda":
        raise ValueError(f"table_select: unsupported device {frame.device}")
    if frame.dim() != 1 or frame.dtype != torch.int32 \
            or not frame.is_contiguous():
        raise ValueError("frame must be a contiguous (E,) int32 tensor")
    if tbl.dim() != 2 or tbl.device != frame.device \
            or not tbl.is_contiguous():
        raise ValueError("tbl must be a contiguous (P, C) tensor on frame's "
                         "device")
    name = build.dtype_launcher("table_select", tbl.dtype)
    E = frame.shape[0]
    P, C = tbl.shape
    out = torch.empty((E, C), dtype=tbl.dtype, device=tbl.device)
    launch = build.launcher(name)
    with torch.cuda.device(tbl.device):
        err = launch(_ptr(frame), _ptr(tbl), E, P, C, _ptr(out),
                     _stream(tbl.device))
    build.check(name, err)
    LAUNCHES[name] += 1
    return out


def table_select_plain(frame: torch.Tensor, tbl: torch.Tensor) -> torch.Tensor:
    """Plain torch version of table_select."""
    P = tbl.shape[0]
    f = frame.long()
    valid = (f >= 0) & (f < P)
    rows = tbl[f.clamp(0, P - 1)]
    return torch.where(valid[:, None], rows, torch.zeros_like(rows))


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
