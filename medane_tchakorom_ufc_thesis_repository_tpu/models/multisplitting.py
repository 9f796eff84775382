"""Two-stage multisplitting solvers with optional s-step Krylov minimization.

One unified, fully-jittable driver (``multisplit_solve``) covers all eight
reference algorithm binaries (SURVEY.md §2.4):

=================  ==========  ============  ====================
reference binary   schedule    minimization  termination
=================  ==========  ============  ====================
SM                 sync        none          global true-residual
AM                 async       none          persistence counters
SMSM_LOCAL         sync        'local'       per-block handshake
SMSM_SEMI_LOCAL    sync        'semi_local'  per-block handshake
SMSM_GLOBAL        sync        'global'      outer LS residual
AMAM_LOCAL         async       'local'       persistence counters
AMAM_SEMI_LOCAL    async       'semi_local'  persistence counters
AMAM_GLOBAL        async       'global'      persistence counters
=================  ==========  ============  ====================

Design (not a PETSc port)
-------------------------
* Block state is stacked ``(nblocks, block_size)``; the whole outer loop is
  one ``lax.while_loop`` whose body runs ``s`` inner sweeps with
  ``lax.fori_loop`` — everything compiles to a single XLA program, no
  per-iteration host round-trips (the reference pays an MPI_Sendrecv +
  Allreduce every sweep, ``synchronous-multisplitting.c:170-206``).
* The per-block inner GMRES solves are ``vmap``-ed — both blocks' KSPSolves
  (reference ``inner_solver``, ``utils.c:950-970``) run as one batched
  program on the device instead of two processes.
* "Asynchronous" execution is emulated with *bounded staleness*: each
  block publishes its iterate to peers every ``staleness[b]`` sweeps, so
  peers compute with data up to ``staleness-1`` sweeps old — the
  mathematical content of totally-asynchronous iterations (chaotic
  relaxation) under a deterministic, compilable schedule.  ``staleness=1``
  recovers the synchronous exchange.  (The reference's genuinely
  nondeterministic message arrival, ``comm.c:6-77``, is not reproducible
  in SPMD; the multi-host backend in ``parallel/`` adds a host-driven
  async mode.)
* Async termination (the reference's decentralized Alg-5.15 protocol,
  ``conv_detection_prime.c:11-249``) is emulated deterministically: a
  per-block counter of *consecutive* cycles with the local residual under
  threshold, all blocks required to hold for ``min_convergence_count``
  cycles (the reference's ``-min_convergence_count`` flag, and the
  pseudo-period persistence requirement of the protocol).
* Minimization replaces the reference's iterative outer KSP on ``R = A·S``
  (``outer_solver*``, ``utils.c:972-1128``) with one fused tall-skinny
  least-squares: Gram/Cholesky or TSQR on an ``(n, s)`` panel — s is 4-30,
  so this is a single matmul + tiny factorization instead of an LSQR
  iteration per digit.  Iterative LSQR/CGNE remain available for parity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from medane_tchakorom_ufc_thesis_repository_tpu.models.blockops import BlockOperator
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lsqr import (
    cgne as _cgne_fn,
    lsqr as _lsqr_fn,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lstsq import (
    lstsq_normal,
    lstsq_qr,
)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InnerConfig:
    """Inner (per-block) Krylov solve — the analog of the reference's
    ``inner1_``/``inner2_``-prefixed KSP (gmres, maxit 20, rtol 1e-3,
    pc none; ``config/default_run_variables:36-44``).

    ``method``: 'gmres' | 'cg' | 'bicgstab' | 'chebyshev' | 'ca_gmres'
    (the iSolve ``--inner-ksp`` choice; A_ii is SPD for Poisson so CG is
    admissible; bicgstab is the nonsymmetric short-recurrence KSPBCGS
    analog).
    ``pc``: 'none' | 'jacobi' | 'bjacobi' | 'mg' — the data-parallel
    subset of PETSc's ``-inner_pc_type`` (sequential PCs like ILU/SOR
    don't map to SPMD hardware).  'jacobi' = left diagonal scaling;
    'bjacobi' = PCBJACOBI as batched dense inverses of each A_ii's
    ``pc_block_size``-sized diagonal sub-blocks, applied as one einsum
    (``solvers/bjacobi.py``; sparse-family stacked operators
    — ELL/DIA/BSR — stencil strips use 'mg' instead); 'mg' = geometric
    multigrid V-cycle on the strip's diagonal block (PCMG analog,
    ``solvers/multigrid.py``).  With method='cg' jacobi scales and
    bjacobi/mg enter as true-residual PCG preconditioners; with
    method='gmres' all are PETSc-default left preconditioning (inner
    solves warm-start from x_b, which left PC composes with directly).
    """

    restart: int = 30
    maxiter: int = 20
    rtol: float = 1e-3
    atol: float = 0.0
    orthog: str = "cgs2"
    method: str = "gmres"
    pc: str = "none"
    pc_block_size: int = 64   # 'bjacobi' diagonal-sub-block size
    basis: str = "native"   # 'native' | 'bf16' Krylov-basis storage;
                            # bf16 halves orthogonalization bandwidth
    # spectral bounds for method='chebyshev' (optional; analytic bounds
    # are derived for the stencil operators when omitted)
    eig_min: Optional[float] = None
    eig_max: Optional[float] = None

    def basis_dtype(self):
        if self.basis == "native":
            return None
        if self.basis == "bf16":
            import jax.numpy as _jnp

            return _jnp.bfloat16
        raise ValueError(f"unknown basis {self.basis!r}")


@dataclasses.dataclass(frozen=True)
class OuterConfig:
    """Outer (minimization) least-squares solve — the analog of the
    ``outer1_``/``outer2_`` KSP (``default_run_variables:54-66``).

    ``method``: 'qr' (TSQR direct — the default), 'normal'
    (Gram+Cholesky), 'lsqr', 'cgne' (iterative, reference parity).
    """

    method: str = "qr"
    maxiter: int = 100
    rtol: float = 1e-12
    atol: float = 0.0
    damping: float = 0.0
    alpha_average: bool = False  # the reference's *_modify alpha exchange


@dataclasses.dataclass(frozen=True)
class MultisplitResult:
    """Stacked solver output (analog of the reference's final printouts:
    iteration counts, final residual norm, error vs exact solution)."""

    x: jax.Array             # (nblocks, block_size)
    sweeps: jax.Array        # total multisplitting sweeps (int32)
    cycles: jax.Array        # outer cycles (minimization rounds)
    inner_iters: jax.Array   # total inner Krylov iterations, all blocks
    rnorm: jax.Array         # last measured global residual norm
    rnorm0: jax.Array        # reference norm for the convergence test
    local_rnorms: jax.Array  # (nblocks,) last per-block residual norms
    outer_rnorm: jax.Array   # last outer LS residual (global minimization)
    converged: jax.Array     # bool
    history: Optional[jax.Array] = None  # (max_cycles,) per-cycle rnorms
                                         # (inf where unreached); the analog
                                         # of the reference's per-iteration
                                         # norm printouts
    # async runs only: True means the returned x was re-verified on the
    # TRUE (staleness-free) coupling — ||b - A x|| <= rtol*||b|| holds
    # exactly.  None on sync paths (they already measure the true
    # residual every cycle).
    certified: Optional[jax.Array] = None
    tail_sweeps: Optional[jax.Array] = None   # sync sweeps the tail ran


jax.tree_util.register_dataclass(
    MultisplitResult,
    data_fields=[
        "x", "sweeps", "cycles", "inner_iters", "rnorm", "rnorm0",
        "local_rnorms", "outer_rnorm", "converged", "history",
        "certified", "tail_sweeps",
    ],
    meta_fields=[],
)


# ---------------------------------------------------------------------------
# Inner solve (vmapped per-block GMRES)
# ---------------------------------------------------------------------------

def _per_block(cfg, nb: int, what: str):
    """Normalize a config that may be uniform or per-block.

    Returns ``(uniform_cfg, None)`` when one config applies to every
    block, or ``(None, tuple_of_nb_configs)`` when blocks differ — the
    analog of the reference's ``inner1_``/``inner2_`` (and
    ``outer1_``/``outer2_``) per-rank KSP prefixes
    (``utils.c:512-541``, ``iSolve:118-194``)."""
    if isinstance(cfg, (list, tuple)):
        if len(cfg) != nb:
            raise ValueError(
                f"per-block {what} needs {nb} entries, got {len(cfg)}"
            )
        if all(c == cfg[0] for c in cfg[1:]):
            return cfg[0], None
        return None, tuple(cfg)
    return cfg, None


def _make_inner(op: BlockOperator, cfg):
    """Batched per-block Krylov solve: the two (or N) concurrent per-block
    KSPSolves of the reference become one vmapped solve.

    ``cfg`` may be a single ``InnerConfig`` (vmapped batched solve) or a
    length-``nblocks`` sequence of them (per-block ``inner1_``/``inner2_``
    parity): differing configs unroll into one compiled solve per block —
    each block gets its own trip counts/method, exactly like the
    reference's independently-configured per-rank KSPs."""
    uniform, per_block = _per_block(cfg, op.nblocks, "InnerConfig")
    if per_block is not None:
        solves = [_make_single_inner(op, c) for c in per_block]
        binvs = [_bjacobi_inner_inv(op, c, only_block=bidx)
                 for bidx, c in enumerate(per_block)]
        args = getattr(op, "diag_mv_args", None)

        def run(rhs, x):
            results = []
            for bidx, solve_one in enumerate(solves):
                a = (None if args is None
                     else jax.tree_util.tree_map(lambda t: t[bidx], args))
                results.append(solve_one(a, binvs[bidx], rhs[bidx],
                                         x[bidx]))
            return jax.tree_util.tree_map(
                lambda *leaves: jnp.stack(leaves), *results
            )

        return run
    solve_one = _make_single_inner(op, uniform)
    binv = _bjacobi_inner_inv(op, uniform)
    args = getattr(op, "diag_mv_args", None)
    in_axes = (None if args is None else 0,
               None if binv is None else 0, 0, 0)
    vsolve = jax.vmap(solve_one, in_axes=in_axes)
    return lambda rhs, x: vsolve(args, binv, rhs, x)


def _bjacobi_inner_inv(op: BlockOperator, cfg: InnerConfig,
                       only_block: Optional[int] = None):
    """``(nblocks, nbb, p, p)`` batched inverses of every A_ii's diagonal
    sub-blocks for ``pc='bjacobi'`` (None for other PCs).  Host-side
    one-time setup via the operator's ``diag_coo_np`` hook + the shared
    f64/pinv factorization in ``solvers.bjacobi``.

    ``only_block``: factor just that block's ``(nbb, p, p)`` stack (the
    per-block ``inner1_``/``inner2_`` path — factoring all blocks per
    config would cost O(nblocks²) setup)."""
    if cfg.pc != "bjacobi":
        return None
    coo_fn = getattr(op, "diag_coo_np", None)
    if coo_fn is None:
        raise ValueError(
            "pc='bjacobi' needs a sparse-family stacked operator "
            f"(ELL/DIA/BSR), got {type(op).__name__}; stencil strips "
            "use pc='mg'"
        )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
        block_jacobi_from_coo,
    )

    coos = coo_fn()
    if only_block is not None:
        r, c, v = coos[only_block]
        return block_jacobi_from_coo(r, c, v, op.block_size,
                                     bs=cfg.pc_block_size,
                                     dtype=op.dtype).inv_blocks
    invs = [
        block_jacobi_from_coo(r, c, v, op.block_size,
                              bs=cfg.pc_block_size,
                              dtype=op.dtype).inv_blocks
        for (r, c, v) in coos
    ]
    return jnp.stack(invs)


def _make_single_inner(op: BlockOperator, cfg: InnerConfig):
    """Build the one-block solve ``(args_b, binv_b, rhs_b, x_b) ->
    KrylovResult`` for one ``InnerConfig`` (vmapped for the uniform
    path, called directly per block for ``inner1_``/``inner2_``-style
    configs).  ``binv_b`` carries this block's bjacobi sub-block
    inverses (None unless ``pc='bjacobi'``)."""
    if cfg.method not in ("gmres", "cg", "bicgstab", "chebyshev",
                          "ca_gmres"):
        raise ValueError(f"unknown inner method {cfg.method!r}")
    if cfg.pc not in ("none", "jacobi", "bjacobi", "mg"):
        raise ValueError(f"unknown inner pc {cfg.pc!r}")

    mg_M = None
    if cfg.pc == "mg":
        # geometric multigrid on the strip's diagonal block (A_ii is a
        # Dirichlet Poisson operator on the strip rectangle) — PCMG-style
        # inner preconditioning.  Requires a stencil-family stacked op.
        diag_op_fn = getattr(op, "diag_stencil_op", None)
        if diag_op_fn is None:
            raise ValueError(
                "pc='mg' needs a stencil-family block operator "
                f"(got {type(op).__name__})"
            )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
            mg_preconditioner,
        )

        mg_M = mg_preconditioner(diag_op_fn())

    cheb_bounds = None
    if cfg.method in ("chebyshev", "ca_gmres"):
        # both need the spectral interval (Chebyshev iteration /
        # Newton-basis shifts)
        if cfg.pc != "none":
            raise ValueError(
                f"{cfg.method} inner solve does not compose with pc"
            )
        if cfg.eig_min is not None and cfg.eig_max is not None:
            cheb_bounds = (cfg.eig_min, cfg.eig_max)
        else:
            bounds_fn = getattr(op, "diag_eig_bounds", None)
            if bounds_fn is not None:
                cheb_bounds = bounds_fn()
            else:
                # user (AIJ) matrices carry no analytic bounds — estimate
                # each A_ii's interval by Lanczos (the PETSc
                # -ksp_chebyshev_esteig analog) and take the union: a
                # wider interval only slows Chebyshev, never diverges it.
                # ONE jitted program vmapped over blocks (per-block jit
                # closures would recompile nblocks times — CLAUDE.md's
                # cached-jit rule)
                from medane_tchakorom_ufc_thesis_repository_tpu.solvers.eigest import (  # noqa: E501
                    bounds_from_coeffs,
                    lanczos_coeffs,
                )

                args = getattr(op, "diag_mv_args", None)
                if args is None:
                    raise ValueError(
                        f"{cfg.method} needs InnerConfig.eig_min/eig_max, "
                        "analytic diag_eig_bounds(), or per-block "
                        "diag_mv_args for Lanczos estimation"
                    )
                import numpy as _np

                bs_ = op.block_size
                m_ = max(1, min(30, bs_))
                rng = _np.random.default_rng(7)
                v0 = rng.standard_normal(bs_)
                v0s = jnp.asarray(
                    _np.tile(v0 / _np.linalg.norm(v0), (op.nblocks, 1)),
                    op.dtype,
                )
                coeffs = jax.jit(jax.vmap(
                    lambda a, v: lanczos_coeffs(
                        lambda u: op.single_diag_mv(a, u), v, m_,
                    )
                ))(args, v0s)
                eps_ = float(jnp.finfo(op.dtype).eps)
                per = [
                    bounds_from_coeffs(coeffs[0][b], coeffs[1][b], eps=eps_)
                    for b in range(op.nblocks)
                ]
                cheb_bounds = (min(p[0] for p in per),
                               max(p[1] for p in per))

    def solve_one(a, binv_b, rhs_b, x_b):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
            BlockJacobi,
        )

        mv = lambda v: op.single_diag_mv(a, v)
        bj_M = (BlockJacobi(inv_blocks=binv_b, n=rhs_b.shape[0]).apply
                if cfg.pc == "bjacobi" else None)
        if cfg.pc == "jacobi":
            # left diagonal preconditioning: solve (D^-1 A) x = D^-1 b;
            # convergence tested in the preconditioned norm (PETSc default)
            dinv = 1.0 / op.single_diag_vector(a, rhs_b.shape[0])
            base = mv
            mv = lambda v: dinv * base(v)
            rhs_b = dinv * rhs_b
        elif cfg.pc == "bjacobi" and cfg.method == "gmres":
            # left block-Jacobi for GMRES (PETSc-default left PC; inner
            # solves warm-start from x_b, which left PC composes with
            # directly — the happy-breakdown test in krylov.py compares
            # against ||A v_j|| so a strong PC cannot trigger false
            # convergence); CG takes bj_M as a true-residual PCG precond
            base = mv
            mv = lambda v: bj_M(base(v))
            rhs_b = bj_M(rhs_b)
        elif cfg.pc == "mg" and cfg.method == "gmres":
            # left V-cycle preconditioning for GMRES (PETSc-default left
            # PC semantics: convergence in the preconditioned norm);
            # CG instead takes mg_M as a true-residual PCG preconditioner
            base = mv
            mv = lambda v: mg_M(base(v))
            rhs_b = mg_M(rhs_b)
        if cfg.method == "chebyshev":
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
                chebyshev,
            )

            return chebyshev(
                mv, rhs_b, x_b,
                lmin=cheb_bounds[0], lmax=cheb_bounds[1],
                maxiter=cfg.maxiter,
            )
        if cfg.method == "cg":
            return krylov.cg(
                mv, rhs_b, x_b,
                maxiter=cfg.maxiter, rtol=cfg.rtol, atol=cfg.atol,
                precond=mg_M if mg_M is not None else bj_M,
            )
        if cfg.method == "bicgstab":
            # nonsymmetric short-recurrence inner (PETSc KSPBCGS analog);
            # bjacobi/mg enter as RIGHT preconditioners (true-residual
            # test), jacobi is already folded into mv/rhs above
            return krylov.bicgstab(
                mv, rhs_b, x_b,
                maxiter=cfg.maxiter, rtol=cfg.rtol, atol=cfg.atol,
                precond=mg_M if mg_M is not None else bj_M,
            )
        if cfg.method == "ca_gmres":
            # communication-avoiding inner: Newton basis over the block
            # spectrum, one panel LS per cfg.restart matvecs
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
                ca_gmres,
            )

            # reductions='single' (Gram algebra, no panel QR): vmapped
            # tall-skinny QR lowers to a serialized Householder loop;
            # the one-Gram cycle is matmul-shaped and f32-safe at inner
            # accuracy for s <= ~8
            return ca_gmres(
                mv, rhs_b, x_b, s=cfg.restart, maxiter=cfg.maxiter,
                rtol=cfg.rtol, atol=cfg.atol,
                lmin=cheb_bounds[0], lmax=cheb_bounds[1],
                reductions="single",
            )
        return krylov.gmres(
            mv, rhs_b, x_b,
            restart=cfg.restart, maxiter=cfg.maxiter,
            rtol=cfg.rtol, atol=cfg.atol, orthog=cfg.orthog,
            basis_dtype=cfg.basis_dtype(),
        )

    return solve_one


# ---------------------------------------------------------------------------
# Tall-skinny least squares dispatch
# ---------------------------------------------------------------------------

def _solve_ls(R, rhs, cfg: OuterConfig):
    """argmin_a ||rhs - R a|| for one panel ``R (rows, s)``."""
    if cfg.method == "qr":
        return lstsq_qr(R, rhs)
    if cfg.method == "normal":
        return lstsq_normal(R, rhs, l2=cfg.damping)
    if cfg.method == "lsqr":
        res = _lsqr_fn(
            lambda a: jnp.matmul(R, a, precision="highest"),
            lambda u: jnp.matmul(R.T, u, precision="highest"),
            rhs, n=R.shape[1],
            maxiter=cfg.maxiter, rtol=cfg.rtol, atol=cfg.atol,
        )
        return res.x
    if cfg.method == "cgne":
        res = _cgne_fn(
            lambda a: jnp.matmul(R, a, precision="highest"),
            lambda u: jnp.matmul(R.T, u, precision="highest"),
            rhs, n=R.shape[1],
            maxiter=cfg.maxiter, rtol=cfg.rtol, atol=cfg.atol,
        )
        return res.x
    raise ValueError(f"unknown outer method {cfg.method!r}")


# ---------------------------------------------------------------------------
# Main driver
# ---------------------------------------------------------------------------

def multisplit_solve(
    op: BlockOperator,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    schedule: str = "sync",
    staleness: Union[int, Sequence[int]] = 1,
    minimization: Optional[str] = None,
    s: int = 4,
    inner: InnerConfig = InnerConfig(),
    outer: OuterConfig = OuterConfig(),
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    record_history: bool = False,
    rnorm0: Optional[jax.Array] = None,
    basis_collection: str = "sweep",
) -> MultisplitResult:
    """Solve ``A x = b`` by (a)synchronous two-stage block multisplitting.

    Parameters mirror the reference's CLI surface (``iSolve`` /
    ``-m -n -s -npb -rtol -min_convergence_count`` plus the prefixed
    inner/outer KSP options).  ``b`` and the returned ``x`` are stacked
    ``(nblocks, block_size)``.

    ``basis_collection`` (async minimization only): ``'sweep'`` records a
    basis column every sweep (thesis-faithful — at staleness d the
    within-cycle columns differ only in self-block directions because the
    coupling RHS is frozen between publishes, which is why AMAM at d=4
    needs ~6x AM's sweeps); ``'publish'`` records columns only at
    publish boundaries, so every column embeds genuinely new peer data
    — one cycle then spans ``s * max(staleness)`` sweeps.
    """
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    is_async = schedule == "async"
    nb, bs = op.nblocks, op.block_size
    dtype = b.dtype
    if b.shape != (nb, bs):
        raise ValueError(f"b must be ({nb}, {bs}), got {b.shape}")
    if minimization is None:
        s = 1  # one sweep per convergence check, as in SM/AM

    stal = jnp.asarray(
        np.broadcast_to(np.asarray(staleness, np.int32), (nb,)).copy()
    )
    if not is_async and not bool(np.all(np.asarray(staleness) == 1)):
        raise ValueError("sync schedule requires staleness == 1")

    inner_solve = _make_inner(op, inner)
    outer_u, outer_pb = _per_block(outer, nb, "OuterConfig")
    if outer_pb is not None:
        if minimization == "global":
            raise ValueError(
                "per-block OuterConfig applies to 'local'/'semi_local' "
                "scopes (the global minimization is one shared LS solve)"
            )
        if len({c.alpha_average for c in outer_pb}) != 1:
            raise ValueError(
                "alpha_average must agree across per-block OuterConfigs"
            )
    outer = outer_u if outer_pb is None else outer_pb[0]

    if x0 is None:
        x0 = jnp.zeros((nb, bs), dtype)
    x_vis0 = x0
    rhs0 = b - op.coupling_mv(x_vis0)

    if rnorm0 is None:
        # the reference's UIRNorm semantics: reference norm = initial
        # residual at entry; pass rnorm0 explicitly to pin it elsewhere
        # (e.g. ||b|| when resuming from a checkpoint)
        r0_rows = b - op.full_mv(x0)
        rnorm0 = jnp.sqrt(jnp.sum(r0_rows * r0_rows))
    else:
        rnorm0 = jnp.asarray(rnorm0, dtype)
    tol_global = jnp.maximum(rtol * rnorm0, atol)
    # per-block threshold: rtol/sqrt(nb) * ||r0|| (the reference's
    # rtol/sqrt(2) test, `...-local.c:267`, generalized to nb blocks)
    tol_local = jnp.maximum(rtol / jnp.sqrt(jnp.asarray(float(nb), dtype)) * rnorm0, atol)

    if basis_collection not in ("sweep", "publish"):
        raise ValueError(f"unknown basis_collection {basis_collection!r}")
    collect_publish = (
        basis_collection == "publish" and is_async and minimization is not None
    )
    # sweeps per outer cycle: 'publish' collection needs s publish events
    # from the slowest-publishing block
    spc = s * int(np.asarray(staleness).max()) if collect_publish else s

    def publish(x, x_vis, sweep_count):
        done = (sweep_count % stal) == 0
        return jnp.where(done[:, None], x, x_vis)

    def sweep_body(i, carry):
        x, x_vis, rhs, sweeps, inner_total, S, pub, pub_counts = carry
        res = inner_solve(rhs, x)
        x = res.x
        inner_total = inner_total + jnp.sum(res.iters).astype(jnp.int32)
        sweeps = sweeps + 1
        published = (sweeps % stal) == 0            # (nb,) this sweep?
        pub = jnp.logical_or(pub, published)
        x_vis = publish(x, x_vis, sweeps)
        rhs = b - op.coupling_mv(x_vis)
        if collect_publish:
            # record a column only when this block publishes: columns
            # then embed fresh peer data instead of s near-collinear
            # frozen-RHS iterates (slots cycle, keeping the newest s)
            slot = pub_counts % s                   # (nb,)
            oh = (jnp.arange(s)[:, None] == slot[None, :]) & published[None, :]
            S = jnp.where(oh[:, :, None], x[None], S)
            pub_counts = pub_counts + published.astype(jnp.int32)
        else:
            S = S.at[i].set(x)
        return (x, x_vis, rhs, sweeps, inner_total, S, pub, pub_counts)

    def minimize(S, x, x_vis, rhs, sweeps):
        """One outer minimization: basis S (s, nb, bs) -> combined x."""
        # R columns: 'local' uses A_ii * S_i (reference `...-local.c:256`),
        # 'semi_local'/'global' use the full row strips A_i * S
        # (`...-semi-local.c:319`, `...-global.c:325`).
        if minimization == "local":
            Rcols = jax.vmap(op.diag_mv)(S)          # (s, nb, bs)
            target = rhs                              # b_i - A_ij x_j (frozen)
        else:
            Rcols = jax.vmap(op.full_mv)(S)          # (s, nb, bs)
            target = b
        Rb = jnp.moveaxis(Rcols, 0, -1)              # (nb, bs, s)
        Sb = jnp.moveaxis(S, 0, -1)                  # (nb, bs, s)

        if minimization == "global":
            Rf = Rb.reshape(nb * bs, s)
            alpha = _solve_ls(Rf, target.reshape(-1), outer)   # (s,)
            out_r = target.reshape(-1) - jnp.matmul(
                Rf, alpha, precision="highest")
            outer_rnorm = jnp.sqrt(jnp.sum(out_r * out_r))
            x_new = jnp.einsum("bns,s->bn", Sb, alpha,
                               precision="highest")
        else:
            if outer_pb is not None:
                # inner1_/outer2_-style per-block LS solvers, unrolled
                alpha = jnp.stack([
                    _solve_ls(Rb[i], target[i], outer_pb[i])
                    for i in range(nb)
                ])
            else:
                alpha = jax.vmap(
                    lambda Rr, t: _solve_ls(Rr, t, outer)
                )(Rb, target)
            if outer.alpha_average:
                alpha = jnp.broadcast_to(
                    jnp.mean(alpha, axis=0, keepdims=True), alpha.shape
                )
            out_r = target - jnp.einsum("bns,bs->bn", Rb, alpha,
                                        precision="highest")
            outer_rnorm = jnp.sqrt(jnp.sum(out_r * out_r))
            x_new = jnp.einsum("bns,bs->bn", Sb, alpha,
                               precision="highest")

        x_vis = publish(x_new, x_vis, sweeps)
        rhs = b - op.coupling_mv(x_vis)
        return x_new, x_vis, rhs, outer_rnorm

    def cycle(carry):
        (x, x_vis, rhs, sweeps, cycles, inner_total,
         conv_count, rnorm, local_rnorms, outer_rnorm, converged, hist) = carry

        S0 = jnp.zeros((s, nb, bs), dtype)
        pub0 = jnp.zeros((nb,), bool)
        pc0 = jnp.zeros((nb,), jnp.int32)
        x, x_vis, rhs, sweeps, inner_total, S, pub, _ = lax.fori_loop(
            0, spc, sweep_body,
            (x, x_vis, rhs, sweeps, inner_total, S0, pub0, pc0)
        )

        if minimization is not None:
            x, x_vis, rhs, outer_rnorm = minimize(S, x, x_vis, rhs, sweeps)

        # convergence measurement — local residual rows r_i = rhs - A_ii x_i
        # (with sync exchange this equals the true global residual rows,
        # exactly the reference's MatResidual test,
        # `synchronous-multisplitting.c:186-201`)
        local_r = rhs - op.diag_mv(x)
        local_sq = jnp.sum(local_r * local_r, axis=1)
        local_rnorms = jnp.sqrt(local_sq)
        rnorm = jnp.sqrt(jnp.sum(local_sq))
        if record_history:
            hist = hist.at[cycles].set(rnorm)
        cycles = cycles + 1

        if is_async:
            # pseudo-period gate (Alg-5.15): only count an under-threshold
            # cycle toward termination when every block published fresh
            # data during it — residuals measured against stale halos are
            # not evidence of global convergence
            under = local_rnorms <= tol_local
            all_pub = jnp.all(pub)
            conv_count = jnp.where(
                ~under, 0,
                jnp.where(all_pub, conv_count + 1, conv_count),
            )
            converged = jnp.all(conv_count >= min_convergence_count)
        elif minimization == "global":
            converged = outer_rnorm <= tol_global
        elif minimization is not None:
            converged = jnp.all(local_rnorms <= tol_local)
        else:
            converged = rnorm <= tol_global

        return (x, x_vis, rhs, sweeps, cycles, inner_total,
                conv_count, rnorm, local_rnorms, outer_rnorm, converged, hist)

    def cond(carry):
        sweeps = carry[3]
        converged = carry[10]
        return jnp.logical_and(~converged, sweeps < maxiter)

    max_cycles = -(-maxiter // s) if record_history else 1
    hist0 = jnp.full((max_cycles,), jnp.inf, dtype)
    init = (
        x0, x_vis0, rhs0,
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32),
        jnp.zeros((nb,), jnp.int32),
        rnorm0, jnp.full((nb,), jnp.inf, dtype),
        jnp.asarray(jnp.inf, dtype),
        rnorm0 <= tol_global,
        hist0,
    )
    (x, _, _, sweeps, cycles, inner_total, _, rnorm, local_rnorms,
     outer_rnorm, converged, hist) = lax.while_loop(cond, cycle, init)

    certified = tail_sweeps = None
    if is_async:
        # Post-termination lockstep certification (the on-device analog
        # of net_async._certification_tail / host_async._sync_certify):
        # async cycles measure residuals against the staleness-schedule
        # view x_vis, so the returned stack's TRUE merged residual can
        # exceed rtol*||b|| by ~(1+||A_ic||*||A_ii^-1||).  A short
        # synchronous tail (publish every sweep) on the true coupling
        # closes the bound exactly; typically 0 sweeps, still one jitted
        # program.
        cert_max = jnp.int32(64)

        def true_resid(x_c):
            rhs_t = b - op.coupling_mv(x_c)
            local_r = rhs_t - op.diag_mv(x_c)
            lsq = jnp.sum(local_r * local_r, axis=1)
            return (jnp.all(jnp.sqrt(lsq) <= tol_local),
                    jnp.sqrt(lsq), jnp.sqrt(jnp.sum(lsq)))

        ok0, lr0, rn0 = true_resid(x)
        # only certify protocol-converged runs (skip the tail otherwise)
        skip = ~converged

        def cert_cond(c):
            _x, rounds, ok, _lr, _rn = c
            return jnp.logical_and(~ok, rounds < cert_max)

        def cert_body(c):
            x_c, rounds, _ok, _lr, _rn = c
            rhs_t = b - op.coupling_mv(x_c)
            res = inner_solve(rhs_t, x_c)
            ok_n, lr_n, rn_n = true_resid(res.x)
            return (res.x, rounds + jnp.int32(1), ok_n, lr_n, rn_n)

        x, tail_sweeps, cert_ok, lr_t, rn_t = lax.while_loop(
            cert_cond, cert_body,
            (x, jnp.int32(0), jnp.logical_or(ok0, skip), lr0, rn0),
        )
        certified = jnp.logical_and(converged, cert_ok)
        # report the TRUE residuals for the returned iterate
        rnorm = jnp.where(converged, rn_t, rnorm)
        local_rnorms = jnp.where(converged, lr_t, local_rnorms)
        sweeps = sweeps + tail_sweeps
        converged = jnp.logical_and(converged, cert_ok)

    return MultisplitResult(
        x=x, sweeps=sweeps, cycles=cycles, inner_iters=inner_total,
        rnorm=rnorm, rnorm0=rnorm0, local_rnorms=local_rnorms,
        outer_rnorm=outer_rnorm, converged=converged,
        history=hist if record_history else None,
        certified=certified, tail_sweeps=tail_sweeps,
    )


# ---------------------------------------------------------------------------
# Named entry points (one per reference binary)
# ---------------------------------------------------------------------------

def sm(op, b, **kw):
    """Synchronous multisplitting (reference SM,
    ``src/synchronous-multisplitting/synchronous-multisplitting.c``)."""
    return multisplit_solve(op, b, schedule="sync", minimization=None, **kw)


def am(op, b, *, staleness=2, **kw):
    """Asynchronous multisplitting under bounded staleness (reference AM,
    ``src/asynchronous-multisplitting/asynchronous-multisplitting_prime.c``)."""
    return multisplit_solve(
        op, b, schedule="async", staleness=staleness, minimization=None, **kw
    )


def smsm(op, b, *, scope: str = "global", s: int = 4, **kw):
    """Synchronous multisplitting + synchronous minimization
    (reference SMSM_{LOCAL,SEMI_LOCAL,GLOBAL})."""
    return multisplit_solve(
        op, b, schedule="sync", minimization=_scope(scope), s=s, **kw
    )


def amam(op, b, *, scope: str = "global", s: int = 4, staleness=2, **kw):
    """Asynchronous multisplitting + asynchronous minimization
    (reference AMAM_{LOCAL,SEMI_LOCAL,GLOBAL})."""
    return multisplit_solve(
        op, b, schedule="async", staleness=staleness,
        minimization=_scope(scope), s=s, **kw
    )


def _scope(scope: str) -> str:
    aliases = {
        "local": "local",
        "semi_local": "semi_local",
        "semi-local": "semi_local",
        "semilocal": "semi_local",
        "global": "global",
    }
    if scope not in aliases:
        raise ValueError(f"unknown minimization scope {scope!r}")
    return aliases[scope]
