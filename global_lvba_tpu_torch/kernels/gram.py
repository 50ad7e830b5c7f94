"""Gram kernel 3: gram += AᵀA for the factor rows A (Kr, N), N = 6W.

syrk_ (csrc/syrk.cu) replaces the Pallas kernel global_lvba_tpu/ops/
pallas/gram.py:41 `_syrk_kernel` — on the aligned main path the XLA Gram
`H -= Σ_chunks MᵀM` (plane_eigen.py:416-420) it stands for.  One block per
lower-triangle 64x64 output tile loops over the whole contraction in a
fixed order (no split-K, no atomics: the Hessian is bitwise repeatable),
fp32 FMA from shared-memory tiles, and writes its tile and the mirrored
transpose itself, so the full symmetric matrix comes out of one launch.
Bound: operations — Kr·N·(N+1) flops (4095·3072·3073 ≈ 38.7 GFLOP for the
first voxel chunk at W=512) at the card's float32 rate, against ~126 MB of
traffic.  Precision is plain fp32 (no TF32, no tensor cores) in this
version.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = {"syrk": 0}


def syrk_(gram: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """gram (N, N) += AᵀA for A (Kr, N), in place; returns gram."""
    if A.device.type == "cpu":
        return syrk_plain_(gram, A)
    if A.device.type != "cuda":
        raise ValueError(f"syrk_: unsupported device {A.device}")
    Kr, N = A.shape
    if gram.shape != (N, N):
        raise ValueError(f"gram is {tuple(gram.shape)}, A is {tuple(A.shape)}")
    for name, t in (("A", A), ("gram", gram)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if t.device != A.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {A.device}")
    launch = build.launcher("syrk")
    with torch.cuda.device(A.device):
        err = launch(
            ctypes.c_void_p(A.data_ptr()), Kr, N,
            ctypes.c_void_p(gram.data_ptr()),
            ctypes.c_void_p(torch.cuda.current_stream(A.device).cuda_stream))
    build.check("syrk", err)
    LAUNCHES["syrk"] += 1
    return gram


def syrk_plain_(gram: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Plain torch version of syrk_."""
    return gram.add_(A.T @ A)
