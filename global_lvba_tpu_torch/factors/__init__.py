from .padding import aligned_to_device, buckets_to_device, from_jax_arrays
from .plane_eigen import (
    AlignedPlaneFactorArrays,
    PlaneFactorArrays,
    buckets_frame_table,
    frame_gather_table,
    plane_cost,
    plane_cost_grad_hess,
    plane_cost_grad_hess_buckets,
)

__all__ = [
    "AlignedPlaneFactorArrays",
    "PlaneFactorArrays",
    "aligned_to_device",
    "buckets_frame_table",
    "buckets_to_device",
    "frame_gather_table",
    "from_jax_arrays",
    "plane_cost",
    "plane_cost_grad_hess",
    "plane_cost_grad_hess_buckets",
]
