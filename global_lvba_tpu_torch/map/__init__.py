from .voxelize import PlaneFactorBucket, PlaneLookup, VoxelMap, build_voxel_map

__all__ = ["PlaneFactorBucket", "PlaneLookup", "VoxelMap", "build_voxel_map"]
