"""The port's native host runtime: lvba_native.cpp, built with g++ at first
use (kernels/build.host_library) and bound with ctypes (runtime.py).

A stage's device picks its host path (on_device): on a CUDA device the
stage's host helpers (voxel keys, the argsort, the segment moments, the
transform, union-find) run through this library; on the CPU they run
their numpy paths, unchanged, so the CPU parity tests compare like with
like.  The depth maps' route follows the device on its own
(pipeline/depth.render_depth_maps), and LZF is always this library's
(io/pcd.py).  There is no switch besides the device, and no fallback: a
library that does not build raises."""

from . import runtime

__all__ = ["on_device", "runtime"]


def on_device(device) -> bool:
    """Whether a stage on `device` takes the native host path: True for a
    CUDA device, False for the CPU."""
    import torch

    return torch.device(device).type == "cuda"
