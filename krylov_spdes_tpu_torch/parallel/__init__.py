"""Multi-rank layouts of the port over `torch.distributed` (mirrors
krylov_spdes_tpu/parallel)."""

from .multihost import (global_mesh, init_distributed,  # noqa: F401
                        is_coordinator, launch)
from .sharding import (Mesh, all_gather_cat, chain_sharded,  # noqa: F401
                       make_mesh, psum, replicated, shard_dd_plan,
                       shard_schur_operator)
from .schur_sharded import (sharded_schur_matvec,  # noqa: F401
                            sharded_schur_rhs)
