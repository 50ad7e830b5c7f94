"""The multi-device layer (port of global_lvba_tpu.parallel): meshes of
torch devices, the factor-sharded and banded LMs, Morton spatial
partitions with distributed voxel moments, and the multi-chip dry run.
The JAX package's collectives_audit (it reads XLA HLO text) has no
counterpart here."""

from .mesh import Mesh, initialize_distributed, make_mesh, psum
from .shard import (
    lm_damping_iter_banded_compact_sharded, lm_damping_iter_banded_sharded,
    lm_damping_iter_sharded, shard_buckets, sharded_cost_grad_hess)

__all__ = [
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "psum",
    "shard_buckets",
    "sharded_cost_grad_hess",
    "lm_damping_iter_sharded",
    "lm_damping_iter_banded_sharded",
    "lm_damping_iter_banded_compact_sharded",
]
