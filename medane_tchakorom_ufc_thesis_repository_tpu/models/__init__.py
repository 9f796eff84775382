"""Algorithm drivers — the framework's "models".

Each driver is the JAX rebuild of one reference binary
(SURVEY.md §2.4): SM, AM, SMSM_{LOCAL,SEMI_LOCAL,GLOBAL},
AMAM_{LOCAL,SEMI_LOCAL,GLOBAL}, and the GMRES baseline.
"""

from medane_tchakorom_ufc_thesis_repository_tpu.models.blockops import (  # noqa: F401
    BlockOperator,
    StackedELLOperator,
    StackedStencil2D,
    StackedStencil3D,
    block_poisson2d,
    block_poisson3d,
)
from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (  # noqa: F401
    MultisplitResult,
    multisplit_solve,
    sm,
    am,
    smsm,
    amam,
)
