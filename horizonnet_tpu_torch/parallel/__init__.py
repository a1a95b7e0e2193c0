"""The multi-process layout: a ('data', 'model') mesh of process groups
(mesh.py), tensor-parallel sharding of the conv stacks (sharding.py) and
the multi-process dryrun (dryrun.py)."""

from .mesh import Mesh, init_distributed, make_mesh, shard_batch
from .sharding import gather_state, shard_state, tp_spec

__all__ = ["Mesh", "init_distributed", "make_mesh", "shard_batch",
           "gather_state", "shard_state", "tp_spec"]
