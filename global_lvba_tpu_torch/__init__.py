"""global_lvba_tpu_torch — the PyTorch / CUDA port of global_lvba_tpu.

The LiDAR bundle adjustment (BALM plane-eigenvalue factors solved by
Nielsen-damped LM) on one NVIDIA H100, on both factor layouts (frame-
aligned and bucketed), the SIFT frontend (extraction, all-pairs
matching, track components) and the visual stage (depth maps, track
fusion, the joint reprojection + plane-prior Schur LM; plain torch, as
the JAX package runs it in XLA), with hand-written CUDA kernels (csrc/,
built at first use by kernels/build.py): the per-voxel aggregation +
eigensolve, the linearization chain (aligned and per-entry), the Gram
SYRK, the pose-table selection, the frame segment-sum and the matcher's
running top-2 similarity.  The system around them (dataset IO, the
COLMAP db, stage checkpoints, exports and the run / info / view CLI) is
host Python, as in the JAX package.  The JAX
package stays beside it as the reference; this package imports nothing of
it and nothing of JAX.

Layer map (the JAX package's names, so each counterpart is easy to find):
  geometry/  SO(3) exp/log, the pose box-plus of the LM, the camera model
  map/       host numpy voxelization into per-(voxel, frame) moments
  models/    synthetic plane, corridor and joint LiDAR-visual scenes,
             textured renders, pose perturbation, ATE, the JAX bench's
             visual solver problems
  frontend/  SIFT extraction and descriptor matching; the COLMAP db
  ops/       closed-form 3x3 eigensolve (plain torch)
  factors/   aligned and bucketed factor arrays, plane-eigen cost/grad/Hessian;
             reprojection and point-to-plane residuals
  kernels/   CUDA kernel wrappers, their plain versions, the builder
  solver/    damped LM, LU and block-Jacobi PCG reduced solves; the
             visual Schur LM and its reduced-camera CG solves
  io/        PCD (ascii, binary, binary_compressed) and TUM readers and
             writers, load_dataset for the reference's on-disk layout
  pipeline/  window -> anchors -> two-stage global LiDAR BA; the SIFT
             frontend stage (load, extract, match all pairs); depth maps
             and the visual BA stage; LvbaSystem (the stages with a
             checkpoint after each, resumable); the exports (depth PNGs,
             the COLMAP model, colored clouds, overlays) and viz clouds
  tracks/    match-graph components -> padded track arrays; track fusion
  eval/      mean reprojection error, ATE
  utils/     logging, progress bar, stage checkpoints (the JAX package's
             file format), run metrics, robust statistics, torch.profiler
             traces

Device policy: entry points take `device=` and default to "cuda"; the CPU
runs only when a caller asks for it (the parity tests do, in float64).
On the card the solve runs in the config's `solver.dtype` with TF32 off,
float32 or float64, and both go through the CUDA kernels: each LiDAR
kernel has a float and a double instance (the matcher is float32, as its
descriptors are).  A kernel wrapper given a CUDA tensor launches its
kernel or raises; nothing falls back to a plain version.
"""

from __future__ import annotations

__version__ = "0.1.0"


# torch is imported inside the functions: the CLI's `info` and the package
# itself start without it
def resolve_device(device="cuda"):
    """The torch device an entry point runs on.  A CUDA device must exist —
    nothing carries on on the CPU when no card is found.  On CUDA, float32
    matmuls and convolutions are pinned to full float32 (TF32 off): the
    Gauss-Newton Hessian and the damped solve need the full mantissa."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def solve_dtype(name: str):
    """Torch dtype of a `solver.dtype` config string."""
    import torch

    return {"float32": torch.float32, "float64": torch.float64}[name]
