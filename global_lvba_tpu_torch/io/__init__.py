from .pcd import read_pcd
from .tum import read_tum_poses
from .dataset import Dataset, load_dataset

__all__ = ["read_pcd", "read_tum_poses", "Dataset", "load_dataset"]
