"""Run configuration: defaults + file + CLI override layering.

Rebuild of the reference's three-tier config system (SURVEY.md §5.6):
``config/default_run_variables`` (defaults) < ``iSolve`` CLI flags <
per-block prefixed PETSc options.  Here one frozen dataclass carries the
whole experiment; overrides layer via ``dataclasses.replace`` from a JSON
file and CLI args.  Per-block inner/outer-solver differences (the
reference's ``inner1_``/``inner2_``/``outer1_``/``outer2_`` prefixes,
``utils.c:512-541``) are ``inner_overrides``/``outer_overrides``: a
length-``nblocks`` list of field-override dicts (JSON:
``"inner_overrides": [{"maxiter": 30}, {"ksp": "cg"}]``; CLI:
``--inner1-maxiter 30 --inner2-ksp cg``), layered on top of the shared
``inner_*``/``outer_*`` base fields.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple, Union

from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
    InnerConfig,
    OuterConfig,
)

ALGORITHMS = (
    "GMRES",
    "CA_GMRES",
    "MGPCG",
    "SM",
    "AM",
    "SMSM_LOCAL",
    "SMSM_SEMI_LOCAL",
    "SMSM_GLOBAL",
    "AMAM_LOCAL",
    "AMAM_SEMI_LOCAL",
    "AMAM_GLOBAL",
)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One experiment.  Field defaults mirror the reference's
    ``config/default_run_variables:17-77`` (ALGORITHM=AM, M=N=1024, S=4,
    RTOL=1e-3, MIN_CONVERGENCE_COUNT=4; inner gmres maxit 20 rtol 1e-3;
    outer rtol tiny with large iteration budget)."""

    alg: str = "AM"
    # problem
    dim: int = 2
    m: int = 1024
    n: int = 1024
    nz: int = 64              # 3D only
    dtype: str = "float32"
    # a user-supplied square sparse matrix instead of the Poisson
    # generators (the create_matrix_sparse AIJ entry point): path to a
    # scipy .npz (save_npz) or MatrixMarket .mtx file; b = A·1.  The
    # split is routed by as_stacked_device_operator (banded→DIA,
    # blockable→BSR, else gather-ELL with a warning).
    matrix: Optional[str] = None
    # whole-system PC for the GMRES baseline on a user matrix — the
    # outer-KSP ``-pc_type`` analog (iSolve:78-83).  'jacobi' = diagonal
    # scaling; 'bjacobi' = PCBJACOBI as batched dense block inverses
    # applied as one einsum (solvers/bjacobi.py).
    pc_type: str = "none"          # none | jacobi | bjacobi | amg
    pc_block_size: int = 64        # bjacobi diagonal-block size
    # decomposition (np/npb analog: nblocks = np/npb)
    nblocks: int = 2
    intra: int = 1            # devices per block (sharded backend)
    ir: int = 1               # row tiles per block (tiled backend)
    ic: int = 1               # column tiles (tiled backend)
    backend: str = "stacked"  # stacked | sharded | tiled | host_async
    # algorithm
    s: int = 4
    rtol: float = 1e-3
    atol: float = 1e-100
    maxiter: int = 10000
    min_convergence_count: int = 4
    staleness: Union[int, Tuple[int, ...]] = 2
    basis_collection: str = "sweep"  # async s-step basis: 'sweep'
                                     # (thesis-faithful) | 'publish'
                                     # (staleness-robust: fresh peer data
                                     # per column; 2824->144 sweeps @ d=4)
    # inner / outer solver knobs
    inner_restart: int = 30
    inner_maxiter: int = 20
    inner_rtol: float = 1e-3
    inner_ksp: str = "gmres"       # iSolve --inner-ksp
    inner_pc: str = "none"         # iSolve --inner-pc-type
    inner_pc_block_size: int = 64  # inner pc='bjacobi' sub-block size
    inner_basis: str = "native"    # Krylov-basis storage: native | bf16
    outer_method: str = "qr"
    outer_maxiter: int = 100
    outer_rtol: float = 1e-12
    # per-block prefixed overrides (inner1_/inner2_/outer1_/outer2_
    # parity): None, or a length-nblocks sequence of field dicts; an
    # empty dict keeps the base config for that block.  Dict keys are
    # the un-prefixed knob names: ksp/restart/maxiter/rtol/pc/basis for
    # inner, method/maxiter/rtol for outer.
    inner_overrides: Optional[Tuple[dict, ...]] = None
    outer_overrides: Optional[Tuple[dict, ...]] = None

    _INNER_KEYS = {
        "restart": "restart", "maxiter": "maxiter", "rtol": "rtol",
        "ksp": "method", "method": "method", "pc": "pc", "basis": "basis",
        "pc_block_size": "pc_block_size",
    }
    _OUTER_KEYS = {"method": "method", "maxiter": "maxiter", "rtol": "rtol"}

    def _base_inner(self) -> InnerConfig:
        return InnerConfig(
            restart=self.inner_restart,
            maxiter=self.inner_maxiter,
            rtol=self.inner_rtol,
            method=self.inner_ksp,
            pc=self.inner_pc,
            pc_block_size=self.inner_pc_block_size,
            basis=self.inner_basis,
        )

    def _base_outer(self) -> OuterConfig:
        return OuterConfig(
            method=self.outer_method,
            maxiter=self.outer_maxiter,
            rtol=self.outer_rtol,
        )

    @staticmethod
    def _apply_overrides(base, overrides, keymap, nblocks, what):
        if overrides is None:
            return base
        if len(overrides) != nblocks:
            raise ValueError(
                f"{what} needs {nblocks} entries, got {len(overrides)}"
            )
        out = []
        for ov in overrides:
            bad = set(ov) - set(keymap)
            if bad:
                raise ValueError(
                    f"unknown {what} keys {sorted(bad)}; "
                    f"choose from {sorted(keymap)}"
                )
            out.append(dataclasses.replace(
                base, **{keymap[k]: v for k, v in ov.items()}
            ))
        return tuple(out)

    def inner_config(self):
        """One ``InnerConfig`` (uniform) or a per-block tuple of them."""
        return self._apply_overrides(
            self._base_inner(), self.inner_overrides, self._INNER_KEYS,
            self.nblocks, "inner_overrides",
        )

    def outer_config(self):
        return self._apply_overrides(
            self._base_outer(), self.outer_overrides, self._OUTER_KEYS,
            self.nblocks, "outer_overrides",
        )

    def validate(self) -> "RunConfig":
        if (self.inner_overrides is not None
                or self.outer_overrides is not None):
            if self.backend != "stacked":
                raise ValueError(
                    "per-block inner/outer overrides run on the stacked "
                    "backend (SPMD backends need uniform static trip "
                    "counts for lockstep collectives)"
                )
            self.inner_config()   # fail loudly on bad keys/length now
            self.outer_config()
        if self.alg not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.alg!r}; choose from {ALGORITHMS}"
            )
        if self.pc_type not in ("none", "jacobi", "bjacobi", "amg"):
            raise ValueError(
                f"unknown pc_type {self.pc_type!r}; "
                "choose from none | jacobi | bjacobi | amg"
            )
        if self.pc_type != "none":
            if self.alg != "GMRES" or self.matrix is None:
                raise ValueError(
                    "--pc-type preconditions the whole-system GMRES "
                    "baseline on a user matrix (--alg GMRES --matrix ...); "
                    "grid problems use --alg MGPCG or --inner-pc-type"
                )
            if self.pc_block_size < 1:
                raise ValueError(
                    f"pc_block_size must be >= 1, got {self.pc_block_size}"
                )
        if self.dim not in (2, 3):
            raise ValueError("dim must be 2 or 3")
        # the split axis is m (grid rows in 2D, nx planes in 3D)
        if self.backend == "tiled":
            if self.m % (self.nblocks * self.ir):
                raise ValueError(
                    f"m={self.m} must divide by nblocks*ir="
                    f"{self.nblocks * self.ir}"
                )
            if self.n % self.ic:
                raise ValueError(f"n={self.n} must divide by ic={self.ic}")
        else:
            denom = self.nblocks * (
                self.intra if self.backend == "sharded" else 1
            )
            if self.m % denom:
                raise ValueError(
                    f"m={self.m} must divide by nblocks*intra={denom}"
                )
        return self

    @property
    def schedule(self) -> str:
        return "async" if self.alg.startswith("A") else "sync"

    @property
    def minimization(self) -> Optional[str]:
        if self.alg.endswith("_LOCAL") and "SEMI" not in self.alg:
            return "local"
        if self.alg.endswith("_SEMI_LOCAL"):
            return "semi_local"
        if self.alg.endswith("_GLOBAL"):
            return "global"
        return None


def default_config(**overrides) -> RunConfig:
    return dataclasses.replace(RunConfig(), **overrides).validate()


def load_config(path: str, **overrides) -> RunConfig:
    """Layer: defaults < JSON file < keyword overrides."""
    with open(path) as f:
        file_vals = json.load(f)
    merged = {**file_vals, **overrides}
    return default_config(**merged)
