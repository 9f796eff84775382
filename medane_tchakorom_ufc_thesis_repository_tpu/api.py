"""One-call solve API for users arriving from scipy / the reference.

The reference's workflow is assemble-AIJ → configure-KSP → KSPSolve
(``create_matrix_sparse`` + ``initializeKSP`` + the drivers,
``src/utils/utils.c:139-155, 511-541``).  ``solve`` collapses that to a
single call on a ``scipy.sparse`` matrix: the pattern is auto-routed to
a device-efficient operator (banded → DIA, blockable → BSR, small
unstructured → dense matvec, else the routed-gather AIJ), the
requested KSP runs as one jitted
program, and preconditioning/spectral bounds are set up automatically
(block-Jacobi batched inverses; Lanczos interval estimation).  Solver
programs are compiled once per (method, pc, tolerances) configuration
and cached — repeated solves at the same shapes (the serving pattern)
skip trace+compile entirely.

    >>> from medane_tchakorom_ufc_thesis_repository_tpu import solve
    >>> x, info = solve(A, b, rtol=1e-8, pc="bjacobi")
    >>> info["converged"], info["iters"], info["rel_residual"]

For multisplitting / multi-chip / multi-process execution use the CLI
(``python -m ...utils.cli``) or the ``models``/``parallel`` APIs.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

__all__ = ["solve", "prepare", "PreparedSolver", "lstsq", "is_symmetric"]


@functools.lru_cache(maxsize=64)
def _jitted_ksp(method: str, pc_kind: str, restart: int, maxiter: int,
                rtol: float, atol: float, nrhs: int = 0):
    """One compiled program per solver configuration; the operator, RHS,
    x0 and PC state travel as pytree ARGUMENTS, so repeated ``solve``
    calls (same shapes/config, any values — the serving pattern) hit the
    jit cache instead of re-tracing + re-compiling every call (the
    ``refine._df_refine_helpers`` pattern; a cold trace+compile costs
    seconds, a warm call milliseconds).

    ``nrhs > 0`` vmaps the solver over RHS columns (``b``/``x0`` of
    shape ``(n, k)``) — the KSPMatSolve analog: all ``k`` systems run
    in ONE jitted program, so the per-column vectors batch into panel
    matmuls instead of paying ``k`` sequential dispatches."""
    import dataclasses

    import jax

    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov

    def run(op, b, x0, pc_op):
        if pc_kind == "none":
            M = None
        elif pc_kind == "jacobi":
            M = lambda v: pc_op * v
        else:  # bjacobi / amg — both are pytrees with a traceable .apply
            M = pc_op.apply
        if method == "cg":
            return krylov.cg(op.mv, b, x0, maxiter=maxiter, rtol=rtol,
                             atol=atol, precond=M,
                             matvec_dot=getattr(op, "mv_dot", None))
        if method == "minres":
            return krylov.minres(op.mv, b, x0, maxiter=maxiter,
                                 rtol=rtol, atol=atol, precond=M)
        if method == "bicgstab":
            return krylov.bicgstab(op.mv, b, x0, maxiter=maxiter,
                                   rtol=rtol, atol=atol, precond=M)
        # RIGHT-preconditioned GMRES: solve (A M) y = b, x = M y — the
        # Givens estimate tracks the true residual (a stiff left PC can
        # leave it orders of magnitude above rtol)
        if M is None:
            return krylov.gmres(op.mv, b, x0, restart=restart,
                                maxiter=maxiter, rtol=rtol, atol=atol)
        res = krylov.gmres(lambda v: op.mv(M(v)), b, restart=restart,
                           maxiter=maxiter, rtol=rtol, atol=atol)
        return dataclasses.replace(res, x=M(res.x))

    if nrhs > 0:
        # columns are independent: vmap over axis 1 of b/x0 (operator and
        # PC broadcast).  Result leaves gain a leading k axis; the caller
        # transposes x back to (n, k).
        return jax.jit(jax.vmap(run, in_axes=(None, 1, 1, None)))
    return jax.jit(run)


@functools.lru_cache(maxsize=64)
def _jitted_lstsq(method: str, maxiter: int, rtol: float, atol: float,
                  n: int):
    import jax

    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lsqr import (
        cgne,
        lsqr as _lsqr,
    )

    fn = _lsqr if method == "lsqr" else cgne

    def run(op, b, x0):
        return fn(op.mv, op.rmv, b, x0, n=n, maxiter=maxiter, rtol=rtol,
                  atol=atol)

    return jax.jit(run)


def is_symmetric(A, *, rtol: float = 1e-12) -> bool:
    """Host-side symmetry check on a scipy matrix: pattern AND values,
    ``max|A - A^T| <= rtol * max|A|`` (exact-zero difference for
    structurally symmetric integer-valued assemblies)."""
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    d = (A - A.T).tocoo()
    if d.nnz == 0:
        return True
    amax = float(np.abs(A.data).max()) if A.nnz else 0.0
    return bool(np.abs(d.data).max() <= rtol * amax)


def _auto_method(A, assume_a: Optional[str]) -> str:
    """Resolve ``method='auto'``.

    ``assume_a`` (the ``scipy.linalg.solve`` convention) is the user's
    certificate: 'pos' → cg, 'sym' → minres, 'gen' → gmres.  Without
    one, a host symmetry check picks minres for symmetric matrices and
    gmres otherwise.  MINRES is chosen over CG for the detected-
    symmetric branch because it is correct for the WHOLE class (CG
    requires positive definiteness, which no cheap host test certifies
    — a positive diagonal does not; a truncated-Lanczos lower bound can
    miss a negative eigenvalue) at essentially CG's per-iteration cost.
    """
    if assume_a is not None:
        return {"pos": "cg", "sym": "minres", "gen": "gmres"}[assume_a]
    return "minres" if is_symmetric(A) else "gmres"


def _auto_pc(A, op, method: str) -> str:
    """'bjacobi' when the routing found exploitable block structure
    (the routed operator is BSR — its measured block size feeds the
    batched inverses); 'jacobi' when the diagonal is fully nonzero;
    else 'none' (a zero diagonal breaks both point and block Jacobi —
    e.g. saddle-point systems).

    For ``minres`` the preconditioner must be SPD even when A is
    indefinite, which neither a nonzero diagonal nor invertible blocks
    certify — auto picks jacobi only on a strictly POSITIVE diagonal
    and never bjacobi (an indefinite M trips minres's breakdown guard
    and the solve would honestly-but-unhelpfully report not-converged).
    """
    d = A.diagonal()
    if method == "minres":
        return "jacobi" if bool((d > 0).all()) else "none"
    if type(op).__name__.startswith("BSR"):
        return "bjacobi"
    if bool((d != 0).all()):
        return "jacobi"
    return "none"


class PreparedSolver:
    """Operator-bound solver handle: the KSPSetOperators-once /
    KSPSolve-many lifecycle (the reference configures its KSPs once in
    ``initializeKSP``, ``utils.c:511-541``, then solves every sweep).

    Routing, preconditioner factorization (bjacobi inverses / the AMG
    hierarchy), and spectral estimation happen ONCE in ``prepare``;
    every ``.solve(b)`` is just the cached jitted program + the host
    residual check: a repeated ``solve(A, b)`` call pays the host setup
    every time, the prepared handle only the solve.
    """

    def __init__(self, *, A, op, pc_op, method, pc, rtol, atol, maxiter,
                 restart, s, dt, bounds=None):
        self._A = A
        self._op = op
        self._pc_op = pc_op
        self._bounds = bounds
        self.method = method
        self.pc = pc
        self._cfg = (rtol, atol, maxiter, restart, s)
        self._dt = dt

    @property
    def operator(self) -> str:
        """Name of the routed device representation."""
        return type(self._op).__name__

    def solve(self, b, x0=None) -> Tuple[np.ndarray, dict]:
        """Solve for one RHS ``(n,)`` or a panel ``(n, k)`` (vmapped,
        the KSPMatSolve analog).  Same return contract as ``api.solve``."""
        import jax.numpy as jnp

        rtol, atol, maxiter, restart, s = self._cfg
        A, op, dt = self._A, self._op, self._dt
        n = A.shape[0]
        b_host = np.asarray(b, np.float64)
        multi = b_host.ndim == 2
        if not multi:
            b_host = b_host.reshape(-1)
        if b_host.shape[0] != n:
            raise ValueError(
                f"b has length {b_host.shape[0]}, matrix is {n}")
        nrhs = b_host.shape[1] if multi else 0

        bj = jnp.asarray(b_host, dt)
        if x0 is not None:
            xj0 = jnp.asarray(np.asarray(x0), dt).reshape(bj.shape)
        elif multi:
            xj0 = jnp.zeros_like(bj)  # vmap needs a mappable x0 argument
        else:
            xj0 = None

        if self.method in ("cg", "minres", "bicgstab", "gmres"):
            run = _jitted_ksp(self.method, self.pc, restart, maxiter,
                              rtol, atol, nrhs=nrhs)
            res = run(op, bj, xj0, self._pc_op)
            x = res.x.T if multi else res.x
        else:  # ca_gmres (bounds estimated once, at prepare time)
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (  # noqa: E501
                ca_gmres,
            )

            if multi:
                raise ValueError(
                    "ca_gmres supports a single RHS (its Newton-basis "
                    "panel cycle does not vmap); use gmres/cg/minres "
                    "for b (n, k)"
                )
            lmin, lmax = self._bounds
            res = ca_gmres(op.mv, bj, xj0, s=s, maxiter=maxiter,
                           rtol=rtol, atol=atol, lmin=lmin, lmax=lmax)
            x = res.x

        x_host = np.asarray(x, np.float64)
        r = b_host - A @ x_host
        bn = np.linalg.norm(b_host, axis=0)
        rn = np.linalg.norm(r, axis=0)
        rel = np.divide(rn, bn, out=np.zeros_like(rn), where=bn > 0)
        info = dict(
            converged=bool(np.asarray(res.converged).all()),
            iters=(np.asarray(res.iters) if multi else int(res.iters)),
            rel_residual=(rel if multi else float(rel)),
            resnorm=(np.asarray(res.resnorm, np.float64) if multi
                     else float(res.resnorm)),
            resnorm0=(np.asarray(res.resnorm0, np.float64) if multi
                      else float(res.resnorm0)),
            operator=type(op).__name__,
            method=self.method,
            pc=self.pc,
        )
        if multi:
            info["converged_per_rhs"] = np.asarray(res.converged)
        return x_host, info


def prepare(A, *, method: str = "gmres", rtol: float = 1e-8,
            atol: float = 0.0, maxiter: int = 10000, restart: int = 30,
            pc: str = "none", pc_block_size: int = 64,
            dtype=None, s: int = 8,
            assume_a: Optional[str] = None) -> PreparedSolver:
    """Route ``A``, build the preconditioner, and return a
    ``PreparedSolver`` whose ``.solve(b)`` reuses all of it — use this
    when the SAME matrix is solved against many right-hand sides (the
    reference's per-sweep KSPSolve pattern; ``solve`` is the one-shot
    convenience over it).

    See ``solve`` for the ``method`` / ``pc`` option semantics
    (including the ``'auto'`` policies).
    """
    import scipy.sparse as sp

    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        from_scipy,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
        block_jacobi_from_scipy,
    )

    if method not in ("auto", "gmres", "cg", "minres", "bicgstab",
                      "ca_gmres"):
        raise ValueError(
            f"method must be auto | gmres | cg | minres | bicgstab | "
            f"ca_gmres, got {method!r}"
        )
    if pc not in ("auto", "none", "jacobi", "bjacobi", "amg"):
        raise ValueError(
            f"pc must be auto | none | jacobi | bjacobi | amg, got {pc!r}"
        )
    if assume_a not in (None, "gen", "sym", "pos"):
        raise ValueError(
            f"assume_a must be gen | sym | pos, got {assume_a!r}"
        )
    A = sp.csr_matrix(A)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"solve needs a square matrix, got {A.shape}")

    if method == "auto":
        method = _auto_method(A, assume_a)

    dt = jnp.float32 if dtype is None else dtype
    op = from_scipy(A, dtype=dt)
    if pc == "auto":
        pc = _auto_pc(A, op, method)
        if pc == "bjacobi":
            pc_block_size = op.bs

    pc_op = None
    if pc == "jacobi":
        d = np.asarray(A.diagonal(), np.float64)
        d[d == 0] = 1.0
        pc_op = jnp.asarray(1.0 / d, dt)
    elif pc == "bjacobi":
        pc_op = block_jacobi_from_scipy(A, bs=pc_block_size, dtype=dt)
    elif pc == "amg":
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.amg import (
            amg_setup,
        )

        pc_op = amg_setup(A, dtype=dt)

    bounds = None
    if method == "ca_gmres":
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.eigest import (  # noqa: E501
            lanczos_bounds,
        )

        if pc_op is not None:
            raise ValueError(
                "ca_gmres does not compose with pc (its Newton shifts "
                "are derived for the unpreconditioned spectrum)"
            )
        bounds = lanczos_bounds(op.mv, A.shape[0], dtype=dt)

    return PreparedSolver(A=A, op=op, pc_op=pc_op, method=method, pc=pc,
                          rtol=rtol, atol=atol, maxiter=maxiter,
                          restart=restart, s=s, dt=dt, bounds=bounds)


def solve(A, b, *, method: str = "gmres", rtol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 10000, restart: int = 30,
          pc: str = "none", pc_block_size: int = 64,
          x0=None, dtype=None, s: int = 8,
          assume_a: Optional[str] = None) -> Tuple[np.ndarray, dict]:
    """Solve ``A x = b`` for a square ``scipy.sparse`` (or dense numpy)
    matrix on the routed device operator (one-shot form of
    ``prepare(A, ...).solve(b)`` — use ``prepare`` to reuse the routing
    and preconditioner across many right-hand sides).

    ``method``: 'gmres' | 'cg' (SPD) | 'minres' (symmetric, possibly
    indefinite) | 'bicgstab' | 'ca_gmres' (SPD, ``s``-step Newton basis
    with a Lanczos-estimated interval) | 'auto' (host symmetry check →
    minres for symmetric, gmres otherwise; ``assume_a`` — the
    ``scipy.linalg.solve`` convention — overrides the check:
    'pos' → cg, 'sym' → minres, 'gen' → gmres).
    ``pc``: 'none' | 'jacobi' | 'bjacobi' | 'amg' | 'auto' — 'bjacobi'
    factors ``pc_block_size``-sized diagonal blocks as batched dense
    inverses; 'amg' builds a smoothed-aggregation hierarchy
    (``solvers/amg.py``, the PCGAMG analog — O(n) iterations for SPD
    diffusion-class systems); 'auto' picks bjacobi on block-routed
    (BSR) operators at the ROUTED block size, jacobi on a nonzero
    diagonal, none otherwise (amg stays opt-in: its setup cost only
    amortizes on hard SPD systems).  gmres/bicgstab compose on the
    RIGHT (the convergence test always sees the TRUE residual);
    cg/minres use the standard SPD-M composition with the test on
    ``||r||_2`` / ``||r||_M`` respectively.

    ``b`` may be a matrix ``(n, k)`` — k independent right-hand sides
    solved in ONE jitted vmapped program (the KSPMatSolve analog; the
    basis/vector ops batch into panel matmuls).  ``info`` fields
    then hold per-column numpy arrays, plus scalar ``converged`` =
    all-columns.

    Returns ``(x, info)`` with ``x`` as float64 numpy and ``info``
    carrying ``converged`` / ``iters`` / ``rel_residual`` (measured on
    the host against the INPUT matrix) / ``operator`` (the routed
    representation).
    """
    prep = prepare(A, method=method, rtol=rtol, atol=atol,
                   maxiter=maxiter, restart=restart, pc=pc,
                   pc_block_size=pc_block_size, dtype=dtype, s=s,
                   assume_a=assume_a)
    return prep.solve(b, x0=x0)


def lstsq(A, b, *, method: str = "lsqr", rtol: float = 1e-8,
          atol: float = 0.0, maxiter: int = 10000,
          x0=None, dtype=None) -> Tuple[np.ndarray, dict]:
    """``min_x ||A x - b||_2`` for a rectangular (or square inconsistent)
    ``scipy.sparse`` / numpy matrix on the routed device operator — the
    one-call form of the reference's least-squares outer stage
    (``outer_solver_lsqr`` ``src/utils/utils.c:998-1020``,
    ``outer_solver_cgne`` ``utils.c:1022-1043``) lifted from the
    tall-skinny ``R = A S`` panels to arbitrary user systems.

    ``method``: 'lsqr' (Golub-Kahan, the numerically robust default) |
    'cgne' (CG on the normal equations — faster per iteration, squares
    the condition number) | 'qr' (direct tall-skinny Householder QR on
    the densified operator — exact, for sizes a dense panel fits).

    Iterative methods stop on the Paige-Saunders rules: ``||r|| ≤
    max(rtol·||b||, atol)`` (consistent systems) or ``||A^T r|| ≤
    rtol·||A^T b||`` (the least-squares optimality measure — the only
    test that can fire when ``min ||r|| > 0``).

    Returns ``(x, info)`` with ``info['rel_opt'] = ||A^T r|| / ||A^T b||``
    (host f64, measured against the INPUT matrix) as the optimality
    certificate alongside ``rel_residual``.
    """
    import scipy.sparse as sp

    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        from_scipy,
    )

    if method not in ("lsqr", "cgne", "qr"):
        raise ValueError(f"method must be lsqr | cgne | qr, got {method!r}")
    A = sp.csr_matrix(A)
    m, n = A.shape
    b_host = np.asarray(b, np.float64).reshape(-1)
    if b_host.shape[0] != m:
        raise ValueError(f"b has length {b_host.shape[0]}, matrix is "
                         f"{m}x{n}")

    dt = jnp.float32 if dtype is None else dtype
    op = from_scipy(A, dtype=dt)
    bj = jnp.asarray(b_host, dt)
    xj0 = None if x0 is None else jnp.asarray(np.asarray(x0), dt)

    if method == "qr":
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lstsq import (
            lstsq_qr,
        )

        if m < n:
            raise ValueError(
                f"method='qr' needs m >= n (tall Householder QR), got "
                f"{m}x{n}; use 'lsqr' for underdetermined systems"
            )
        if m * n > 64 * 1024 * 1024:
            raise ValueError(
                f"method='qr' densifies the operator ({m}x{n} = "
                f"{m * n} entries); use 'lsqr' at this size"
            )
        x = lstsq_qr(op.to_dense(), bj)
        iters, converged = 0, True
        resnorm = resnorm0 = None
    else:
        run = _jitted_lstsq(method, maxiter, rtol, atol, n)
        res = run(op, bj, xj0)
        x = res.x
        iters, converged = int(res.iters), bool(res.converged)
        resnorm, resnorm0 = float(res.resnorm), float(res.resnorm0)

    x_host = np.asarray(x, np.float64)
    r = b_host - A @ x_host
    atr = A.T @ r
    atb = A.T @ b_host
    bn = np.linalg.norm(b_host)
    atbn = np.linalg.norm(atb)
    info = dict(
        converged=converged,
        iters=iters,
        rel_residual=float(np.linalg.norm(r) / bn) if bn > 0 else 0.0,
        rel_opt=float(np.linalg.norm(atr) / atbn) if atbn > 0 else 0.0,
        operator=type(op).__name__,
        method=method,
    )
    if resnorm is not None:
        info["resnorm"], info["resnorm0"] = resnorm, resnorm0
        # lsqr's estimates live on the ||r|| scale; cgne runs CG on
        # A^T A x = A^T b, so its resnorm is ||A^T r|| — NOT comparable
        # across methods.  rel_residual / rel_opt above are always
        # host-f64 against the input matrix and ARE comparable.
        info["resnorm_scale"] = (
            "residual" if method == "lsqr" else "normal_equation"
        )
    return x_host, info
