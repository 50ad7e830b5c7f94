from .padding import aligned_to_device, buckets_to_device, from_jax_arrays
from .plane_eigen import (
    AlignedPlaneFactorArrays,
    plane_cost,
    plane_cost_grad_hess,
)

__all__ = [
    "AlignedPlaneFactorArrays",
    "aligned_to_device",
    "buckets_to_device",
    "from_jax_arrays",
    "plane_cost",
    "plane_cost_grad_hess",
]
