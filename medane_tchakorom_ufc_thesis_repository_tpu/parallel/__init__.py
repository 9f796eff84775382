"""Distribution layer: device meshes, halo exchange, sharded solvers.

The JAX replacement for the reference's entire MPI stack
(SURVEY.md §2.2/§5.8): communicator topology becomes a
``jax.sharding.Mesh`` with axes ``('block', 'intra')``, the sync
``MPI_Sendrecv`` halo becomes ``lax.ppermute``, norm reductions become
``lax.psum`` over mesh axes, and the two-level communicator hierarchy
(block sub-communicators + roots-only communicator) becomes reductions
scoped to ``'intra'`` vs ``('block', 'intra')``.
"""

from medane_tchakorom_ufc_thesis_repository_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.sharded import (  # noqa: F401
    ShardedPoisson2D,
    ShardedPoisson3D,
    sharded_ca_gmres_solve,
    sharded_gmres_solve,
    sharded_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.mgpcg import (  # noqa: F401
    sharded_df_northstar,
    sharded_df_northstar_fused,
    sharded_df_refine,
    sharded_mgpcg_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (  # noqa: F401
    make_tiled_mesh,
    tiled_gmres_solve,
    tiled_gmres_solve_3d,
    tiled_multisplit_solve,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.general import (  # noqa: F401
    ShardedGeneralBSR,
    shard_general_from_coo,
    sharded_general_solve,
)
