"""Harness layer: config defaults, CLI, profiling, logging.

The JAX rebuild of the reference's L6 tooling (SURVEY.md §2.6): ``iSolve``
launcher + ``config/default_run_variables`` + PetscLog stage profiling.
"""

from medane_tchakorom_ufc_thesis_repository_tpu.utils.config import (  # noqa: F401
    RunConfig,
    default_config,
)
from medane_tchakorom_ufc_thesis_repository_tpu.utils.profiling import (  # noqa: F401
    PhaseTimer,
)
