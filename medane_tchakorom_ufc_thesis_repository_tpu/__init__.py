"""Two-stage multisplitting sparse linear-algebra framework (JAX/XLA).

A from-scratch JAX/XLA rebuild of the capabilities of
``craftman22/medane_tchakorom_ufc_thesis_repository`` (synchronous and
asynchronous two-stage multisplitting methods with Krylov minimization
acceleration for large sparse systems from 2D/3D Poisson PDEs).

Design stance (not a PETSc port):
  * operators are immutable pytrees (stencil matrix-free, ELL, DIA,
    BSR block-sparse, dense)
  * solvers are pure functions under ``jax.lax.while_loop`` / ``scan``
  * block parallelism is a ``jax.sharding.Mesh`` with axes ``('block','intra')``;
    halo exchange is ``ppermute``, norm reductions are ``psum``
  * device work is plain ``jax.numpy``/``lax`` left to XLA (no
    hand-written kernels); the accelerator is an NVIDIA GPU

Reference layer map: see SURVEY.md at the repo root.
"""

__version__ = "0.1.0"

from medane_tchakorom_ufc_thesis_repository_tpu.core import (  # noqa: F401
    operators,
    poisson,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (  # noqa: F401
    cg,
    cgne,
    gmres,
    lsqr,
    lstsq_normal,
    lstsq_qr,
    minres,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (  # noqa: F401
    ca_gmres,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (  # noqa: F401
    chebyshev,
)
from medane_tchakorom_ufc_thesis_repository_tpu.models import (  # noqa: F401
    am,
    amam,
    multisplit_solve,
    sm,
    smsm,
)
from medane_tchakorom_ufc_thesis_repository_tpu.api import (  # noqa: F401
    PreparedSolver,
    is_symmetric,
    lstsq,
    prepare,
    solve,
)
