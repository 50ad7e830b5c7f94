from .so3 import exp_so3, hat, log_so3
from .se3 import boxplus_pose

__all__ = ["exp_so3", "hat", "log_so3", "boxplus_pose"]
