from .so3 import euler_to_rot, exp_so3, hat, jr, jr_inv, log_so3
from .se3 import apply, boxplus_pose, compose, inverse, relative

__all__ = ["exp_so3", "hat", "log_so3", "jr", "jr_inv", "euler_to_rot",
           "boxplus_pose", "compose", "inverse", "relative", "apply"]
