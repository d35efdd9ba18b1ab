"""The distribution layer on `torch.distributed` (counterpart of
`gaussianprocesses_jl_tpu/parallel/`): process meshes, differentiable
collectives, the chain-sharded samplers with collective adaptation, the
distributed dense Cholesky and its covariance strategies, the ring gram,
the observation-sharded FITC and the sharded VI."""
from .chains import (
    ShardedESSResult,
    ShardedHMCResult,
    ShardedSplitHMCResult,
    sharded_ess,
    sharded_hmc,
    sharded_split_hmc,
)
from .cholesky import (
    build_tiles,
    choose_tile_size,
    distributed_chol_solve,
    distributed_cholesky,
    distributed_mll,
    distributed_quad_logdet,
    distributed_solve_lower,
    distributed_solve_upper,
    distributed_unwhiten,
    tile_and_shard,
    untile,
)
from .dense import AmbientFullCovariance, DistributedFullCovariance, DistributedPD
from .gram import ring_gram
from .mesh import Mesh, initialize_distributed, make_mesh, make_pod_mesh

__all__ = [
    "build_tiles",
    "choose_tile_size",
    "distributed_cholesky",
    "distributed_chol_solve",
    "distributed_mll",
    "distributed_quad_logdet",
    "distributed_solve_lower",
    "distributed_solve_upper",
    "distributed_unwhiten",
    "tile_and_shard",
    "untile",
    "DistributedFullCovariance",
    "DistributedPD",
    "AmbientFullCovariance",
    "ring_gram",
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
