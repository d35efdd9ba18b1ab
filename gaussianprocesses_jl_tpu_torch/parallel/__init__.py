"""The distribution layer on `torch.distributed` (counterpart of
`gaussianprocesses_jl_tpu/parallel/`): process meshes and the
chain-sharded samplers with collective adaptation. The distributed dense
and sparse covariance paths are not ported yet."""
from .chains import (
    ShardedESSResult,
    ShardedHMCResult,
    ShardedSplitHMCResult,
    sharded_ess,
    sharded_hmc,
    sharded_split_hmc,
)
from .mesh import Mesh, initialize_distributed, make_mesh, make_pod_mesh

__all__ = [
    "Mesh",
    "make_mesh",
    "make_pod_mesh",
    "initialize_distributed",
    "sharded_hmc",
    "sharded_split_hmc",
    "sharded_ess",
    "ShardedHMCResult",
    "ShardedSplitHMCResult",
    "ShardedESSResult",
]
