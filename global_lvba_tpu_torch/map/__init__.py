from .moments import cov_from_moments, merge_moments, transform_moments
from .voxelize import PlaneFactorBucket, PlaneLookup, VoxelMap, build_voxel_map

__all__ = ["PlaneFactorBucket", "PlaneLookup", "VoxelMap", "build_voxel_map",
           "transform_moments", "cov_from_moments", "merge_moments"]
