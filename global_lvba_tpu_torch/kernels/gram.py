"""Gram kernel 3: gram += AᵀA for the factor rows A (Kr, N), N = 6W.

syrk_ (csrc/syrk.cu) replaces the Pallas kernel global_lvba_tpu/ops/
pallas/gram.py:41 `_syrk_kernel` — on the aligned main path the XLA Gram
`H -= Σ_chunks MᵀM` (plane_eigen.py:416-420) it stands for.

Precision: 3xTF32 on the tensor cores, the counterpart of the TPU kernel's
default precision="highest" (fp32-faithful).  Each entry is split as
a = hi + lo, hi = tf32(a), lo = tf32(a − hi), rounded to nearest with ties
away from zero, and AᵀA ≈ loᵀhi + hiᵀlo + hiᵀhi in fp32 accumulators.

Design: two launches.  tf32_split (syrk_split_kernel) reads A once and
writes hi and lo transposed, (Np, Krp), zero-padded to the kernel's tiles
(wgmma takes TF32 operands K-major only; the padding keeps every TMA row
stride a multiple of 16 B).  syrk_kernel computes each 128 x 128 tile of
the lower triangle with wgmma from a TMA ring in shared memory, one block
a tile, the tiles of the last, partial wave in parts of the contraction
(tile_schedule), and writes the tile and its mirror, so the full
symmetric matrix comes out of one launch.  The contraction runs in a fixed
order with no atomics on the sums: the Hessian is bitwise repeatable.

Bound on the card: operations — 3·Kr·N·(N+1) flops at 495 TFLOP/s TF32
(0.35 ms for the W=512 aligned evaluation's 6,144 rows x 3,072 columns),
against the bytes of A once and the gram read and written.

Float64 operands (float64 solves) take one launch of syrk_f64_kernel
instead (the `syrk_f64` launch count), on the fp64 tensor cores:
mma.sync m16n8k4.f64 (DMMA; wgmma has no fp64 form) on the same 128 x 128
lower tiles, 16 warps of 32 x 32 a block, each stage 16 rows of A over the
tile's column panels copied by cp.async straight from A's rows into a
4-stage ring, no split.  The same waves (f64_schedule: tile_schedule over 16-row k-tiles),
the same ordered merge of the tail's parts and the same mirrored epilogue:
exactly symmetric, bitwise repeatable.  Bound: operations — Kr·N·(N+1)
flops at 67 TFLOP/s fp64 on the tensor cores (0.87 ms at 6,144 x 3,072).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"syrk": 0, "syrk_split": 0, "syrk_f64": 0}
TILE = 128     # syrk_kernel's output tile (kBM in csrc/syrk.cu)
KTILE = 32     # its k-tile: one 128-byte row of fp32 (kBK)
F64_KTILE = 16  # syrk_f64_kernel's k-tile: rows of A a stage (k64BK)
MAX_SPLITS = 4


def padded_shape(Kr: int, N: int) -> tuple:
    """(Np, Krp): N padded to TILE, Kr to KTILE — the split's layout."""
    return -(-N // TILE) * TILE, -(-Kr // KTILE) * KTILE


def check_args(gram, A: torch.Tensor) -> tuple:
    """The kernels' argument checks, run before any launch: A (Kr, N) and
    gram (N, N) (None for the split alone) of one dtype, float32 or
    float64, contiguous, on one device.  Returns (Kr, N, Np, Krp)."""
    if A.dim() != 2:
        raise ValueError(f"A must be (Kr, N), got {tuple(A.shape)}")
    Kr, N = A.shape
    if gram is not None and gram.shape != (N, N):
        raise ValueError(f"gram is {tuple(gram.shape)}, A is {tuple(A.shape)}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"A: the kernel takes float32 or float64, got "
                        f"{A.dtype}")
    if gram is not None and gram.dtype != A.dtype:
        raise TypeError(f"gram is {gram.dtype}, A is {A.dtype}: the kernel "
                        f"takes float32 or float64 operands of one dtype")
    for name, t in (("A", A), ("gram", gram)):
        if t is None:
            continue
        if t.device != A.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {A.device}")
    return (Kr, N) + padded_shape(Kr, N)


def tile_schedule(tiles: int, ktiles: int, sms: int) -> tuple:
    """(full, splits): the blocks of syrk_kernel at one block per SM.  The
    first `full` tiles, whole waves of `sms`, take one block each; each tile
    of the last, partial wave takes `splits` blocks over parts of the
    contraction, as many as fill that wave (at most MAX_SPLITS, at most one
    per k-tile)."""
    tail = tiles % sms
    splits = min(sms // tail, MAX_SPLITS, ktiles) if tail else 1
    if splits < 2:
        return tiles, 1
    return tiles - tail, splits


def f64_schedule(Kr: int, N: int, sms: int) -> tuple:
    """(tiles, full, splits) of syrk_f64_kernel on A (Kr, N): the lower
    triangle's TILE x TILE tiles, and tile_schedule over F64_KTILE-row
    k-tiles at one block per SM."""
    nt = -(-N // TILE)
    tiles = nt * (nt + 1) // 2
    return (tiles,) + tile_schedule(tiles, -(-Kr // F64_KTILE), sms)


def _stream(A):
    return ctypes.c_void_p(torch.cuda.current_stream(A.device).cuda_stream)


def _parts(tiles, full, splits, dtype, device):
    """Scratch of the tail's parts and their counters (zeroed; each launch
    leaves its counters 0)."""
    part = torch.empty((max((tiles - full) * splits, 1) * TILE * TILE,),
                       dtype=dtype, device=device)
    count = torch.zeros((max(tiles - full, 1),), dtype=torch.int32,
                        device=device)
    return part, count


def tf32_split(A: torch.Tensor) -> tuple:
    """(hi, lo), each (Np, Krp) float32: A's tf32 split, transposed and
    zero-padded (syrk_split_kernel on a CUDA tensor).  A float32."""
    _split_dtype(A)
    if A.device.type == "cpu":
        return tf32_split_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"tf32_split: unsupported device {A.device}")
    Kr, N, Np, Krp = check_args(None, A)
    hi = torch.empty((Np, Krp), dtype=torch.float32, device=A.device)
    lo = torch.empty_like(hi)
    if Np == 0 or Krp == 0:
        return hi, lo
    launch = build.launcher("syrk_split")
    with torch.cuda.device(A.device):
        err = launch(ctypes.c_void_p(A.data_ptr()), Kr, N, Np, Krp,
                     ctypes.c_void_p(hi.data_ptr()),
                     ctypes.c_void_p(lo.data_ptr()), _stream(A))
    build.check("syrk_split", err)
    LAUNCHES["syrk_split"] += 1
    return hi, lo


def _split_dtype(A: torch.Tensor):
    if A.dtype != torch.float32:
        raise TypeError(f"tf32_split: the split takes float32, got {A.dtype}")


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 view: the magnitude rounded to 10
    explicit mantissa bits, ties away from zero; NaN kept."""
    b = x.view(torch.int32)
    mag = b & 0x7FFFFFFF
    r = ((mag + 0x1000) & -0x2000) | (b & -0x80000000)
    return torch.where(mag > 0x7F800000, b, r).view(torch.float32)


def tf32_split_plain(A: torch.Tensor) -> tuple:
    """Plain torch version of tf32_split."""
    _split_dtype(A)
    Kr, N, Np, Krp = check_args(None, A)
    hi = _tf32_rna(A)
    lo = _tf32_rna(A - hi)
    out = []
    for x in (hi, lo):
        t = A.new_zeros((Np, Krp))
        t[:N, :Kr] = x.T
        out.append(t)
    return tuple(out)


def syrk_(gram: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """gram (N, N) += AᵀA for A (Kr, N), in place; returns gram."""
    if A.device.type == "cpu":
        return syrk_plain_(gram, A)
    if A.device.type != "cuda":
        raise ValueError(f"syrk_: unsupported device {A.device}")
    Kr, N, Np, Krp = check_args(gram, A)
    if Kr == 0 or N == 0:
        return gram
    sms = torch.cuda.get_device_properties(A.device).multi_processor_count
    if A.dtype == torch.float64:
        tiles, full, splits = f64_schedule(Kr, N, sms)
        part, count = _parts(tiles, full, splits, A.dtype, A.device)
        launch = build.launcher("syrk_f64")
        with torch.cuda.device(A.device):
            err = launch(ctypes.c_void_p(A.data_ptr()), Kr, N, full, splits,
                         ctypes.c_void_p(gram.data_ptr()),
                         ctypes.c_void_p(part.data_ptr()),
                         ctypes.c_void_p(count.data_ptr()), _stream(A))
        build.check("syrk_f64", err)
        LAUNCHES["syrk_f64"] += 1
        return gram
    hi, lo = tf32_split(A)
    nt = Np // TILE
    tiles = nt * (nt + 1) // 2
    full, splits = tile_schedule(tiles, Krp // KTILE, sms)
    part, count = _parts(tiles, full, splits, A.dtype, A.device)
    launch = build.launcher("syrk")
    with torch.cuda.device(A.device):
        err = launch(ctypes.c_void_p(hi.data_ptr()),
                     ctypes.c_void_p(lo.data_ptr()), Np, Krp, N, full,
                     splits,
                     ctypes.c_void_p(gram.data_ptr()),
                     ctypes.c_void_p(part.data_ptr()),
                     ctypes.c_void_p(count.data_ptr()), _stream(A))
    build.check("syrk", err)
    LAUNCHES["syrk"] += 1
    return gram


def syrk_plain_(gram: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain torch version of syrk_."""
    return gram.add_(A.T @ A)
