"""Device-mesh construction.

The reference derives its topology from ``nprocs`` and ``npb``:
``njacobi_blocks = nprocs / npb`` block sub-communicators of ``npb`` ranks
(``computeDimensionRelatedVariables``, reference ``src/utils/utils.c:652-666``;
``PetscSubcommCreate``, ``synchronous-multisplitting.c:66-73``).  Here the
same two-level structure is a ``Mesh`` with named axes:

* ``'block'``  — Jacobi blocks (the reference's 2 sub-communicators);
  across processes this axis maps across hosts.
* ``'intra'``  — ranks within a block (the reference's ``npb``).

On one host the devices are all-to-all connected (NVLink joins the four
cards of an H100 host), so the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(
    nblocks: int = 2,
    intra: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ``(block, intra)`` mesh from available devices.

    ``intra`` defaults to ``len(devices) // nblocks`` (the analog of
    ``npb = nprocs / njacobi_blocks``).  Device order is kept as given.
    """
    devices = list(jax.devices() if devices is None else devices)
    if intra is None:
        if len(devices) % nblocks:
            raise ValueError(
                f"{len(devices)} devices not divisible by nblocks={nblocks}"
            )
        intra = len(devices) // nblocks
    need = nblocks * intra
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.array(devices[:need]).reshape(nblocks, intra)
    return Mesh(grid, ("block", "intra"))


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize the multi-host JAX runtime (``jax.distributed``) — the
    analog of the reference's ``mpiexec`` fan-out over hostfiles
    (``iSolve:347-401``, ``hostfiles/default``).  Pass the coordinator
    address, process count and process id explicitly.  Call before any
    other JAX API.
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def make_multihost_mesh(nblocks: int = 2, intra: Optional[int] = None) -> Mesh:
    """Mesh over ALL devices of a multi-process run, blocks across hosts.

    Jacobi blocks map to the host axis and 'intra' to devices within a
    host — matching the reference's placement of the two blocks on
    different Grid'5000 sites with npb ranks per site (SURVEY.md §2.5).  ``jax.devices()`` enumerates host-major, so the
    default ordering achieves this when ``nblocks`` divides the host
    count.
    """
    return make_mesh(nblocks=nblocks, intra=intra)
