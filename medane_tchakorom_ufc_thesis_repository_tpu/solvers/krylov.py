"""Krylov solvers as pure JAX functions: restarted GMRES(m) and CG.

These replace the PETSc KSP objects the reference configures in
``initializeKSP`` (reference ``src/utils/utils.c:512-541``) and drives in
``inner_solver`` (``utils.c:950-970``) and the ``gmres_solution`` baseline
(``src/gmres_solution/gmres_solution.c:58-91``).

Design notes
------------
* The reference's measured hotspot is GMRES orthogonalization — PETSc
  ``VecMDot``/``VecMAXPY`` (SURVEY.md §3, flamegraph).  Here the whole
  Gram-Schmidt step is two matmuls against the stacked basis
  ``V (m+1, n)``: ``h = V @ w`` and ``w -= V.T @ h`` — classical
  Gram-Schmidt (PETSc's default orthogonalization), which XLA hands to
  cuBLAS.  Zero-initialized unused basis rows make masking implicit.
* Every inner product and basis contraction is pinned to
  ``Precision.HIGHEST``: an unpinned f32 contraction may run in TF32 on
  the GPU and skew the recurrences and the convergence tests.
* Everything is fixed-shape: ``lax.while_loop`` over restart cycles,
  ``lax.fori_loop`` over Arnoldi steps, masked updates after convergence —
  so the solver jits once and also batches with ``vmap`` over a leading
  block axis (the single-device analog of the reference's two concurrent
  per-block KSPSolves).
* Convergence matches PETSc's default test with UIRNorm (used by
  ``inner_solver``): stop when ``||r_k|| <= max(rtol * ||r_0||, atol)``
  where ``r_0 = b - A x_0`` (warm start aware).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST


def _vdot(a, b):
    """Inner product at full f32 precision.  An unpinned f32 contraction
    may run in TF32 on the GPU (about three decimal digits), which skews
    every recurrence coefficient and convergence test built on it."""
    return jnp.vdot(a, b, precision=HIGHEST)


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solver output pytree (the analog of KSPGetIterationNumber /
    KSPGetResidualNorm / KSPGetConvergedReason)."""

    x: jax.Array
    iters: jax.Array       # int32, total matvecs consumed
    resnorm: jax.Array     # final (estimated) residual norm
    resnorm0: jax.Array    # initial residual norm used by the test
    converged: jax.Array   # bool


jax.tree_util.register_dataclass(
    KrylovResult,
    data_fields=["x", "iters", "resnorm", "resnorm0", "converged"],
    meta_fields=[],
)


def _tol(rtol, atol, rnorm0):
    return jnp.maximum(rtol * rnorm0, atol)


def make_reducer(axis_name=None):
    """Return a ``psum``-over-mesh-axes reducer (identity when unsharded).

    This is what makes every solver in this module *distribution-agnostic*:
    called under ``shard_map`` with ``axis_name=('intra',)`` (or
    ``('block', 'intra')`` for global solves) all dot products and norms
    become cross-device reductions — the analog of PETSc's VecDot/VecNorm
    being MPI collectives over the block sub-communicator (reference
    ``src/utils/utils.c:560-573``).
    """
    if axis_name is None:
        return lambda v: v
    return lambda v: lax.psum(v, axis_name)


# ---------------------------------------------------------------------------
# GMRES(m)
# ---------------------------------------------------------------------------

def gmres(
    matvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    restart: int = 30,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0: Optional[jax.Array] = None,
    orthog: str = "cgs2",
    axis_name=None,
    fixed_cycles: bool = False,
    stag_tol: float = 0.0,
    basis_dtype=None,
    divtol: float = 1e5,
) -> KrylovResult:
    """Restarted GMRES with classical Gram-Schmidt + Givens least squares.

    ``rnorm0`` optionally pins the convergence-test reference norm (the
    reference pins it to the global ``||r_0||`` in the multisplitting
    loops); default is ``||b - A x0||`` at entry.

    ``orthog``: ``"cgs"`` = single-pass classical Gram-Schmidt (PETSc's
    default, fine in f64); ``"cgs2"`` = two-pass CGS (default — needed for
    a trustworthy Givens residual estimate in f32/bf16; still pure
    matmuls).

    ``axis_name``: mesh axis name(s) to ``psum`` reductions over — pass
    when calling under ``shard_map`` with ``b``/``x`` row-sharded.  The
    Arnoldi/Givens small state stays replicated on every device.

    ``basis_dtype``: storage dtype for the Krylov basis V (default: the
    problem dtype).  ``jnp.bfloat16`` halves the orthogonalization
    bandwidth — the measured GMRES hotspot — while the Gram-Schmidt
    products and all recurrences stay in the problem dtype; CGS2's
    second pass absorbs the extra rounding.  Iteration counts typically
    match f32 storage at rtol >= ~1e-5.
    """
    if orthog not in ("cgs", "cgs2"):
        raise ValueError(f"unknown orthog {orthog!r}")
    n = b.shape[0]
    dtype = b.dtype
    # a cycle's Arnoldi steps run unconditionally (masked when done), so a
    # restart longer than the iteration budget would burn matmuls on
    # frozen state — clamp (PETSc's dynamic loop has no such waste).
    # Floor of 1 keeps maxiter=0 a graceful no-op (zero-width H would
    # fail to trace).
    m = max(1, min(restart, maxiter))
    # x0 = 0 => r0 = b EXACTLY: skip the initial matvec (a full memory
    # pass on large grids)
    x0_zero = x0 is None
    if x0 is None:
        x0 = jnp.zeros_like(b)

    vdtype = dtype if basis_dtype is None else basis_dtype
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)
    psum = make_reducer(axis_name)

    def pnorm(v):
        return jnp.sqrt(psum(jnp.sum(v * v)))

    r0 = b if x0_zero else b - matvec(x0)
    beta0 = pnorm(r0)
    rnorm0_ = beta0 if rnorm0 is None else jnp.asarray(rnorm0, dtype)
    tol = _tol(jnp.asarray(rtol, dtype), jnp.asarray(atol, dtype), rnorm0_)

    def cycle(carry):
        x, iters, rnorm, converged, beta_prev, diverged = carry
        r = b - matvec(x)
        beta = pnorm(r)
        if stag_tol > 0.0:
            # true-residual stagnation between restart cycles — the analog
            # of the reference's custom KSP test `MyConvergeTest`
            # (src/utils/utils.c:1130-1140): stop when a full restart cycle
            # improves the true residual by less than a relative stag_tol
            # (solver at its precision floor).  Like the reference's test,
            # stagnation is reported as converged.
            stagnated = beta > beta_prev * (1.0 - stag_tol)
            converged = jnp.logical_or(converged, stagnated)
        if divtol > 0.0:
            # divergence cutoff (PETSc KSPConvergedDefault divtol 1e5):
            # stop iterating on explosion; reported as NOT converged
            # (separate flag so the result stays honest)
            diverged = jnp.logical_or(diverged, beta > divtol * rnorm0_)

        V = jnp.zeros((m + 1, n), vdtype)
        V = V.at[0].set(jnp.where(beta > 0, r / beta, r).astype(vdtype))
        H = jnp.zeros((m + 1, m), dtype)      # Hessenberg (rotated in place)
        # cs=1/sn=0 makes unapplied rotation slots the identity, so the
        # rotation chain below can be statically unrolled with no masking
        cs = jnp.ones((m,), dtype)
        sn = jnp.zeros((m,), dtype)
        g = jnp.zeros((m + 1,), dtype).at[0].set(beta)

        def arnoldi(j, state):
            V, H, cs, sn, g, iters, rnorm, converged = state
            active = jnp.logical_and(~converged, iters < maxiter)

            w = matvec(V[j].astype(dtype))
            # classical Gram-Schmidt: rows > j of V are zero, so one pair of
            # matmuls orthogonalizes against the whole active basis.  With a
            # reduced-precision basis the dots accumulate in the problem
            # dtype (preferred_element_type) while reading V at vdtype width.
            def vdot_mat(M, v):
                return jax.lax.dot_general(
                    M, v.astype(vdtype), (((1,), (0,)), ((), ())),
                    preferred_element_type=dtype, precision=HIGHEST,
                )

            def vtdot(M, hv):
                return jax.lax.dot_general(
                    M.T, hv.astype(vdtype), (((1,), (0,)), ((), ())),
                    preferred_element_type=dtype, precision=HIGHEST,
                )

            h = psum(vdot_mat(V, w))       # (m+1,)
            w = w - vtdot(V, h)
            if orthog == "cgs2":           # re-orthogonalization pass
                h2 = psum(vdot_mat(V, w))
                w = w - vtdot(V, h2)
                h = h + h2
            hj1 = pnorm(w)
            vnext = jnp.where(
                hj1 > 0, w / jnp.where(hj1 > 0, hj1, 1.0), w
            ).astype(vdtype)

            hcol = h.at[j + 1].set(hj1)
            # happy breakdown: the new direction is numerically inside
            # the current span.  Compare hj1 against ||A v_j|| — which is
            # ||hcol|| by Pythagoras (projections + remainder), free of
            # extra collectives — NOT against the cycle-entry residual
            # beta: with a strong right preconditioner and a large ||b||,
            # eps*beta can sit orders of magnitude ABOVE ||A v_j||, and
            # the old test declared false convergence after one step
            # (caught by the bjacobi CLI verify; tests/test_bjacobi.py).
            happy = hj1 <= eps * jnp.sqrt(jnp.sum(hcol * hcol))

            # apply the accumulated Givens rotations to the new column.
            # Statically unrolled: slots >= j hold the identity rotation
            # (cs=1, sn=0), so all m-1 steps can run unconditionally as
            # straight-line fused code — a dynamic fori_loop of tiny
            # serial ops costs far more than its FLOPs in per-step loop
            # overhead.  Rows j+1.. of hcol are zero, so identity slots
            # leave the column unchanged.
            for i in range(m - 1):
                t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol = hcol.at[i].set(t1).at[i + 1].set(t2)

            # new rotation annihilating hcol[j+1]
            a_, b_ = hcol[j], hcol[j + 1]
            denom = jnp.sqrt(a_ * a_ + b_ * b_)
            c_new = jnp.where(denom > 0, a_ / jnp.where(denom > 0, denom, 1.0), 1.0)
            s_new = jnp.where(denom > 0, b_ / jnp.where(denom > 0, denom, 1.0), 0.0)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            gj = g[j]
            g_new = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
            rnorm_new = jnp.abs(g_new[j + 1])

            # masked commit (freeze once converged / out of budget).
            # Mask only the touched row/column — `where(active, V.set(...),
            # V)` would select over the whole (m+1, n) basis every
            # iteration (~64 MB of pure overhead traffic per step).
            V = V.at[j + 1].set(jnp.where(active, vnext, V[j + 1]))
            H = H.at[:, j].set(jnp.where(active, hcol, H[:, j]))
            cs = cs.at[j].set(jnp.where(active, c_new, cs[j]))
            sn = sn.at[j].set(jnp.where(active, s_new, sn[j]))
            g = jnp.where(active, g_new, g)
            iters = jnp.where(active, iters + 1, iters)
            rnorm = jnp.where(active, rnorm_new, rnorm)
            converged = jnp.logical_or(
                converged, jnp.logical_and(active, rnorm_new <= tol)
            )
            converged = jnp.logical_or(converged, jnp.logical_and(active, happy))
            return V, H, cs, sn, g, iters, rnorm, converged

        state = (V, H, cs, sn, g, iters, rnorm, converged)
        V, H, cs, sn, g, iters, rnorm, converged = lax.fori_loop(
            0, m, arnoldi, state
        )

        # back-substitution on the rotated (upper-triangular) H.  Untouched
        # columns have zero diagonal — mask them to identity so y = 0 there.
        R = H[:m, :]
        diag = jnp.diagonal(R)
        safe = jnp.abs(diag) > 0
        R = R + jnp.diag(jnp.where(safe, 0.0, 1.0).astype(dtype))
        # untaken columns (masked to identity) must contribute y = 0; the
        # frozen g still carries the residual value at slot k — zero it.
        y = jax.scipy.linalg.solve_triangular(
            R, jnp.where(safe, g[:m], 0.0), lower=False
        )
        x_new = x + jax.lax.dot_general(
            V[:m].T, y.astype(vdtype), (((1,), (0,)), ((), ())),
            preferred_element_type=dtype, precision=HIGHEST,
        )
        return x_new, iters, rnorm, converged, beta, diverged

    def cond(carry):
        _, iters, rnorm, converged, _, diverged = carry
        return jnp.logical_and(
            ~jnp.logical_or(converged, diverged), iters < maxiter
        )

    converged0 = beta0 <= tol
    init = (x0, jnp.zeros((), jnp.int32), beta0, converged0,
            jnp.asarray(jnp.inf, dtype), jnp.asarray(False))
    if fixed_cycles:
        # SPMD-lockstep mode for shard_map: a data-dependent while_loop trip
        # count would desynchronize collectives between blocks that converge
        # at different sweeps, so run a static number of restart cycles with
        # all updates masked by the converged flag (they already are).
        ncycles = -(-maxiter // m)
        x, iters, rnorm, converged, _, _ = lax.fori_loop(
            0, ncycles, lambda _, c: cycle(c), init
        )
    else:
        x, iters, rnorm, converged, _, _ = lax.while_loop(cond, cycle, init)
    return KrylovResult(
        x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0_, converged=converged
    )


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

def cg(
    matvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0: Optional[jax.Array] = None,
    axis_name=None,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
    matvec_dot: Optional[Callable] = None,
    precond_dot: Optional[Callable] = None,
) -> KrylovResult:
    """Conjugate gradients for SPD systems (the reference's outer-CG config,
    ``config/default_run_variables`` outer ksp_type cg).

    ``matvec_dot``: optional fused ``p -> (A p, p · A p)`` (LOCAL dot —
    it is still ``psum``-reduced here).  ``Stencil3D.mv_dot`` writes the
    dot beside the apply so XLA can fuse the two (the reference's
    back-to-back MatMult/VecTDot hotspot).  Must return bit-identical
    ``A p`` and a dot consistent with ``jnp.vdot(p, A p)`` up to
    reduction order.

    ``divtol``: divergence cutoff (PETSc KSPConvergedDefault divtol 1e5,
    same convention as ``gmres``): stop iterating when the recurrence
    residual exceeds ``divtol * rnorm0`` (e.g. an indefinite or wrongly
    scaled operator); reported as NOT converged.  0 disables.

    ``precond``: optional SPD preconditioner apply ``M(r) -> z ~= A^{-1} r``
    (e.g. ``solvers.multigrid.mg_preconditioner``) — standard PCG with the
    convergence test still on the TRUE residual norm ``||r||_2`` (PETSc
    UNPRECONDITIONED norm type), so tolerances mean the same thing with
    and without preconditioning.

    ``precond_dot``: optional fused ``r -> (z, r · z)`` (LOCAL dot —
    ``psum``-reduced here), the preconditioner twin of ``matvec_dot``:
    ``mg_preconditioner(op, return_rdot=True)`` computes PCG's
    post-cycle ``vdot(r, z)`` beside the cycle's final smoothing sweep.
    Takes precedence over ``precond`` when both are given.
    """
    dtype = b.dtype
    psum = make_reducer(axis_name)
    x0_zero = x0 is None
    if x0 is None:
        x0 = jnp.zeros_like(b)
    if precond_dot is not None:
        # precedence matches the docstring: precond_dot wins over precond,
        # so the SPMD branch and the single-device body use the SAME
        # preconditioner.  The SPMD path and the rare non-dot uses below
        # ride the fused form too (XLA drops the unused scalar output).
        M = lambda v: precond_dot(v)[0]   # noqa: E731
    elif precond is not None:
        M = precond
    else:
        M = lambda v: v                   # noqa: E731
    # x0 = 0 => r0 = b exactly; skip the initial matvec (see gmres)
    r = b if x0_zero else b - matvec(x0)
    rs0 = psum(_vdot(r, r))
    beta0 = jnp.sqrt(rs0)
    rnorm0_ = beta0 if rnorm0 is None else jnp.asarray(rnorm0, dtype)
    tol = _tol(jnp.asarray(rtol, dtype), jnp.asarray(atol, dtype), rnorm0_)

    def cond(carry):
        _, _, _, _, rs, iters = carry
        keep = jnp.logical_and(jnp.sqrt(rs) > tol, iters < maxiter)
        if divtol > 0.0:
            keep = jnp.logical_and(
                keep, jnp.sqrt(rs) <= divtol * rnorm0_)
        return keep

    def mvd(p):
        if matvec_dot is not None:
            ap, pap_loc = matvec_dot(p)
            return ap, psum(pap_loc)
        ap = matvec(p)
        return ap, psum(_vdot(p, ap))

    if axis_name is None:
        # single-device order: the preconditioner runs at the START of
        # the body (z = M(r) of the carried residual, beta = 0 on the
        # first trip makes p = z0 exactly), so the FINAL iteration —
        # whose z/beta/p the classical order computes and then throws
        # away — skips the dead M apply.  One whole W-cycle saved per
        # inner solve (~10 ms of a ~100 ms MG-PCG solve at 512^3);
        # iterates are bit-identical to the classical order.
        def body(carry):
            x, r, p, rz, rs, iters = carry
            if precond_dot is not None:
                z, rz_loc = precond_dot(r)
                rz_new = psum(rz_loc.astype(dtype))
            else:
                z = M(r)
                rz_new = psum(_vdot(r, z))
            beta = jnp.where(
                jnp.logical_and(iters > 0, rz != 0),
                rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            p = z + beta * p
            ap, pap = mvd(p)
            alpha = jnp.where(
                pap != 0, rz_new / jnp.where(pap != 0, pap, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = psum(_vdot(r, r))
            return x, r, p, rz_new, rs_new, iters + 1

        init = (x0, r, jnp.zeros_like(b), jnp.asarray(1.0, dtype),
                rs0, jnp.zeros((), jnp.int32))
        x, r, _, rz, rs, iters = lax.while_loop(cond, body, init)
    else:
        # SPMD order: z at the END lets the two post-update dots ride
        # ONE stacked psum — each psum is a latency-bound collective
        # round-trip (the reference's measured hotspot is exactly these
        # reductions, VecMDot/VecNorm), and 2 collectives/iteration
        # beat the 3 the M-first order would need.
        def body(carry):
            x, r, p, rz, rs, iters = carry
            ap, pap = mvd(p)
            alpha = jnp.where(
                pap != 0, rz / jnp.where(pap != 0, pap, 1.0), 0.0)
            x = x + alpha * p
            r = r - alpha * ap
            z = M(r)
            rz_new, rs_new = psum(
                jnp.stack([_vdot(r, z), _vdot(r, r)]))
            beta = jnp.where(
                rz != 0, rz_new / jnp.where(rz != 0, rz, 1.0), 0.0)
            p = z + beta * p
            return x, r, p, rz_new, rs_new, iters + 1

        z0 = M(r)
        rz, rs = psum(jnp.stack([_vdot(r, z0), _vdot(r, r)]))
        x, r, _, rz, rs, iters = lax.while_loop(
            cond, body, (x0, r, z0, rz, rs, jnp.zeros((), jnp.int32))
        )
    rnorm = jnp.sqrt(rs)
    return KrylovResult(
        x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0_,
        converged=rnorm <= tol,
    )


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------

def bicgstab(
    matvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0: Optional[jax.Array] = None,
    axis_name=None,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
) -> KrylovResult:
    """BiCGStab for general (nonsymmetric) systems — the PETSc KSPBCGS
    analog (the reference exposes it through ``KSPSetFromOptions``,
    ``src/utils/utils.c:511-530``; ``-inner_ksp_type bcgs``).

    Short recurrences: O(1) memory vs GMRES's restart-length basis, two
    matvecs + a handful of dots per iteration, all inside one
    ``lax.while_loop`` (SPMD-lockstep-safe via ``axis_name`` psums like
    ``cg``/``gmres``).  ``iters`` counts MATVECS (two per BiCGStab step)
    so budgets compare 1:1 with GMRES iteration counts.

    ``precond``: optional RIGHT preconditioner apply ``M(v) ~= A^{-1} v``
    — the recurrence runs on ``A M`` with ``x`` accumulated in the
    preconditioned variable and mapped back at exit, so the convergence
    test sees the TRUE residual (same choice as the CLI's right-PC
    GMRES; a left PC would test the M-norm).

    Breakdown (``rho ~ 0`` or ``omega ~ 0``, the method's known failure
    mode on some nonsymmetric spectra) freezes the iterate and exits
    via the stagnation of the residual — reported honestly as NOT
    converged rather than NaN-ing.
    """
    dtype = b.dtype
    psum = make_reducer(axis_name)
    x0_zero = x0 is None
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = precond if precond is not None else (lambda v: v)
    amv = (lambda v: matvec(M(v))) if precond is not None else matvec

    # right-PC: iterate y with x = M y; r0 = b - A x0 either way
    # (x0 = 0 => r0 = b exactly; skip the matvec, see gmres)
    r = b if x0_zero else b - matvec(x0)
    beta0 = jnp.sqrt(psum(_vdot(r, r)))
    rnorm0_ = beta0 if rnorm0 is None else jnp.asarray(rnorm0, dtype)
    tol = _tol(jnp.asarray(rtol, dtype), jnp.asarray(atol, dtype), rnorm0_)
    rhat = r     # fixed shadow vector r~0 = r0 (the standard choice)

    def body(carry):
        y, r, p, v, rho, alpha, omega, rs, iters, broke = carry
        rho_new = psum(_vdot(rhat, r))
        ok_rho = jnp.abs(rho_new) > 0
        beta = jnp.where(
            ok_rho & (jnp.abs(rho) > 0) & (jnp.abs(omega) > 0),
            (rho_new / jnp.where(jnp.abs(rho) > 0, rho, 1.0))
            * (alpha / jnp.where(jnp.abs(omega) > 0, omega, 1.0)),
            0.0,
        )
        p = r + beta * (p - omega * v)
        v = amv(p)
        rhv = psum(_vdot(rhat, v))
        ok_a = jnp.abs(rhv) > 0
        alpha = jnp.where(ok_a, rho_new / jnp.where(ok_a, rhv, 1.0), 0.0)
        s = r - alpha * v
        t = amv(s)
        # one fused reduction for the three stabilization dots
        ts, tt, ss = psum(jnp.stack([
            _vdot(t, s), _vdot(t, t), _vdot(s, s)]))
        ok_w = tt > 0
        omega = jnp.where(ok_w, ts / jnp.where(ok_w, tt, 1.0), 0.0)
        y = y + alpha * p + omega * s
        r = s - omega * t
        rs_new = jnp.where(ok_w, ss - omega * ts, ss)  # ||r||^2 algebraic
        rs_new = jnp.maximum(rs_new, 0.0)
        broke = broke | ~ok_rho | ~ok_a | ~ok_w
        return (y, r, p, v, rho_new, alpha, omega,
                jnp.where(broke, rs, rs_new), iters + 2, broke)

    def cond(carry):
        _, _, _, _, _, _, _, rs, iters, broke = carry
        keep = jnp.logical_and(jnp.sqrt(rs) > tol, iters < maxiter)
        keep = jnp.logical_and(keep, ~broke)
        if divtol > 0.0:
            keep = jnp.logical_and(keep, jnp.sqrt(rs) <= divtol * rnorm0_)
        return keep

    one = jnp.ones((), dtype)
    init = (jnp.zeros_like(b), r, jnp.zeros_like(b), jnp.zeros_like(b),
            one, one, one, psum(_vdot(r, r)),
            jnp.zeros((), jnp.int32), jnp.asarray(False))
    y, r, *_, rs, iters, _ = lax.while_loop(cond, body, init)
    x = x0 + M(y) if precond is not None else x0 + y
    rnorm = jnp.sqrt(rs)
    return KrylovResult(
        x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0_,
        converged=rnorm <= tol,
    )


# ---------------------------------------------------------------------------
# MINRES
# ---------------------------------------------------------------------------

def minres(
    matvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    rnorm0: Optional[jax.Array] = None,
    axis_name=None,
    precond: Optional[Callable] = None,
    divtol: float = 1e5,
) -> KrylovResult:
    """MINRES for symmetric (possibly INDEFINITE) systems — the PETSc
    KSPMINRES analog (exposed by the reference through
    ``KSPSetFromOptions``, ``src/utils/utils.c:511-530``).

    Fills the gap between ``cg`` (needs positive definiteness) and
    ``gmres`` (general, but stores a restart-length basis): the
    Paige-Saunders Lanczos + Givens recurrence minimizes ``||b - A x||``
    over the Krylov space with O(1) memory and ONE matvec + two fused
    reductions per iteration — symmetric saddle-point / shifted systems
    where CG's recurrence breaks run at CG cost instead of paying
    GMRES's O(m·n) basis traffic.

    ``precond``: optional SPD preconditioner apply ``M(v) ~= A^{-1} v``
    (jacobi/bjacobi with SPD blocks, multigrid).  MINRES requires an SPD
    M even for indefinite A (the Lanczos inner product is the M-norm);
    the recurrence residual — and therefore the convergence test — is
    then ``||r||_{M}`` (PETSc's PRECONDITIONED norm type, its MINRES
    default).  Unpreconditioned, the estimate is the true 2-norm.
    """
    dtype = b.dtype
    psum = make_reducer(axis_name)
    x0_zero = x0 is None
    if x0 is None:
        x0 = jnp.zeros_like(b)
    M = precond if precond is not None else (lambda v: v)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    # x0 = 0 => r1 = b exactly; skip the initial matvec (see gmres)
    r1 = b if x0_zero else b - matvec(x0)
    y0 = M(r1)
    beta1sq, rtrue0sq = psum(
        jnp.stack([_vdot(r1, y0), _vdot(r1, r1)]))
    # an indefinite M makes the Lanczos inner product invalid — freeze
    # immediately (reported NOT converged) instead of sqrt(negative).
    # beta1sq == 0 with a NONZERO residual is the same breakdown (e.g.
    # M with mixed-sign diagonal annihilating r'Mr), not convergence.
    broke0 = jnp.logical_and(beta1sq <= 0, rtrue0sq > 0)
    beta1 = jnp.sqrt(jnp.maximum(beta1sq, 0.0))
    rnorm0_ = beta1 if rnorm0 is None else jnp.asarray(rnorm0, dtype)
    tol = _tol(jnp.asarray(rtol, dtype), jnp.asarray(atol, dtype), rnorm0_)

    def body(carry):
        (x, r1_, r2, y, w, w2, oldb, beta, dbar, epsln, phibar,
         cs, sn, iters, broke) = carry
        # --- Lanczos step on the M-inner product ---------------------
        ok_b = beta > 0
        v = y / jnp.where(ok_b, beta, 1.0)
        yk = matvec(v)
        # subtract the previous couplings (first step: oldb = 0 and
        # r1_ = r2, so the correction term is a harmless scaled self)
        yk = yk - jnp.where(oldb > 0, beta / jnp.where(oldb > 0, oldb, 1.0),
                            0.0) * r1_
        alfa = psum(_vdot(v, yk))
        yk = yk - (alfa / jnp.where(ok_b, beta, 1.0)) * r2
        r1n, r2n = r2, yk
        yn = M(yk)
        betasq = psum(_vdot(r2n, yn))
        ok_m = betasq >= 0
        oldb_n = beta
        beta_n = jnp.sqrt(jnp.where(ok_m, betasq, 0.0))
        # --- Givens QR of the tridiagonal, right-hand-side update ----
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.sqrt(gbar * gbar + beta_n * beta_n)
        gamma = jnp.maximum(gamma, eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        # an M-breakdown zeroed beta_n, which would drive phibar -> 0 and
        # falsely report convergence — freeze the estimate instead (the
        # broke flag below exits the loop with the honest last value)
        phibar_n = jnp.where(ok_m, jnp.abs(sn_n * phibar), phibar)
        # --- solution update (three-term w recurrence) ----------------
        w1n = w2           # w_{k-2}
        wn = (v - oldeps * w1n - delta * w) / gamma
        xn = x + phi * wn
        # the cond guard keeps broken states out of the body, so a new
        # breakage (broke_n) exits the loop with phibar frozen above
        broke_n = broke | ~ok_b | ~ok_m
        return (xn, r1n, r2n, yn, wn, w,
                oldb_n, beta_n, dbar_n, epsln_n, phibar_n,
                cs_n, sn_n, iters + 1, broke_n)

    def cond(carry):
        phibar, iters, broke = carry[10], carry[13], carry[14]
        keep = jnp.logical_and(phibar > tol, iters < maxiter)
        keep = jnp.logical_and(keep, ~broke)
        if divtol > 0.0:
            keep = jnp.logical_and(keep, phibar <= divtol * rnorm0_)
        return keep

    zero = jnp.zeros((), dtype)
    init = (x0, r1, r1, y0, jnp.zeros_like(b), jnp.zeros_like(b),
            zero, beta1, zero, zero, beta1,
            -jnp.ones((), dtype), zero,
            jnp.zeros((), jnp.int32), broke0)
    out = lax.while_loop(cond, body, init)
    x, phibar, iters, broke = out[0], out[10], out[13], out[14]
    return KrylovResult(
        x=x, iters=iters, resnorm=phibar, resnorm0=rnorm0_,
        converged=jnp.logical_and(phibar <= tol, ~broke),
    )
