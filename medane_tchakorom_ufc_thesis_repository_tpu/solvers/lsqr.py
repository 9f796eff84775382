"""Least-squares Krylov solvers: LSQR and CGNE.

The reference's outer (minimization) stage solves ``min_a ||rhs - R a||``
with PETSc KSPLSQR / KSPCGNE on the tall-skinny ``R = A @ S``
(``outer_solver_lsqr`` ``src/utils/utils.c:998-1020``, ``outer_solver_cgne``
``utils.c:1022-1043``).  R here is ``(n, s)`` with s ~ 4..30, so each LSQR
iteration is one tall-skinny matvec + one rmatvec — both skinny matmuls
when R is dense.

Pure-JAX fixed-shape loops, vmappable over a leading block axis.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax

from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import (
    KrylovResult,
    _tol,
    make_reducer,
)


def lsqr(
    matvec: Callable,
    rmatvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    n: Optional[int] = None,
    *,
    maxiter: int = 100,
    rtol: float = 1e-8,
    atol: float = 0.0,
    axis_name=None,
    lockstep_axis=None,
) -> KrylovResult:
    """Paige-Saunders LSQR for ``min ||b - A x||_2``.

    Golub-Kahan bidiagonalization; stops when the residual norm estimate
    drops below ``max(rtol * ||b||, atol)`` or ``||A^T r||`` vanishes
    (least-squares optimum reached), or at ``maxiter``.

    ``axis_name`` shards the ROW space of A (``b``/``u`` sharded, ``x``/``v``
    replicated): row-space norms are ``psum``-reduced over it, and the
    caller's ``rmatvec`` must itself reduce (return a replicated vector).

    ``lockstep_axis``: an extra mesh axis whose devices run *independent*
    LSQR instances but must take identical while_loop trip counts (the
    SPMD invariant — no device-divergent collectives).  The loop
    continues while ANY instance along that axis is still active;
    converged instances keep iterating harmlessly (divisions are
    guarded, updates stay finite as phibar -> 0).
    """
    dtype = b.dtype
    rpsum = make_reducer(axis_name)

    def unorm(vec):  # row-space (sharded) norm
        return jnp.sqrt(rpsum(jnp.sum(vec * vec)))
    if x0 is not None:
        # shift: solve min||(b - A x0) - A dx||, x = x0 + dx
        b_eff = b - matvec(x0)
    else:
        b_eff = b
    if n is None:
        n = rmatvec(b).shape[0]

    beta0 = unorm(b_eff)
    tol = _tol(jnp.asarray(rtol, dtype), jnp.asarray(atol, dtype), beta0)
    eps = jnp.asarray(jnp.finfo(dtype).eps, dtype)

    u = jnp.where(beta0 > 0, b_eff / jnp.where(beta0 > 0, beta0, 1.0), b_eff)
    v0 = rmatvec(u)
    alpha0 = jnp.linalg.norm(v0)
    v0 = jnp.where(alpha0 > 0, v0 / jnp.where(alpha0 > 0, alpha0, 1.0), v0)

    def body(carry):
        x, u, v, w, alpha, beta, phibar, rhobar, iters, _, _ = carry
        # bidiagonalization step
        u_new = matvec(v) - alpha * u
        beta_new = unorm(u_new)
        u_new = jnp.where(
            beta_new > 0, u_new / jnp.where(beta_new > 0, beta_new, 1.0), u_new
        )
        v_new = rmatvec(u_new) - beta_new * v
        alpha_new = jnp.linalg.norm(v_new)
        v_new = jnp.where(
            alpha_new > 0, v_new / jnp.where(alpha_new > 0, alpha_new, 1.0), v_new
        )
        # orthogonal transformation (rho guarded: a fully-converged
        # lockstep instance can reach rhobar = beta = 0 exactly)
        rho = jnp.sqrt(rhobar * rhobar + beta_new * beta_new)
        rho = jnp.where(rho > 0, rho, 1.0)
        c = rhobar / rho
        s = beta_new / rho
        theta = s * alpha_new
        rhobar_new = -c * alpha_new
        phi = c * phibar
        phibar_new = s * phibar
        x = x + (phi / rho) * w
        w = v_new - (theta / rho) * w
        # |phibar| estimates ||r||; |phibar * alpha * c| estimates
        # ||A^T r|| — the least-squares optimality measure (Paige-Saunders
        # stopping rule 2).  Essential for inconsistent systems, where
        # ||r|| plateaus at ||r_min|| > 0 and the primary test never fires.
        arnorm = jnp.abs(phibar_new * alpha_new * c)
        return (
            x, u_new, v_new, w, alpha_new, beta_new,
            phibar_new, rhobar_new, iters + 1, jnp.abs(phibar_new), arnorm,
        )

    arnorm0 = alpha0 * beta0  # ||A^T b||
    artol = jnp.asarray(rtol, dtype) * arnorm0 + jnp.asarray(atol, dtype)

    def cond(carry):
        *_, alpha, beta, phibar, rhobar, iters, rnorm, arnorm = carry
        active = jnp.logical_and(rnorm > tol, arnorm > artol)
        if lockstep_axis is not None:
            active = lax.psum(active.astype(jnp.int32), lockstep_axis) > 0
        return jnp.logical_and(active, iters < maxiter)

    x_init = jnp.zeros((n,), dtype)
    init = (
        x_init, u, v0, v0, alpha0, beta0, beta0, alpha0,
        jnp.zeros((), jnp.int32), beta0, arnorm0,
    )
    out = lax.while_loop(cond, body, init)
    x, *_, iters, rnorm, arnorm = out
    if x0 is not None:
        x = x0 + x
    converged = jnp.logical_or(rnorm <= tol, arnorm <= artol)
    return KrylovResult(
        x=x, iters=iters, resnorm=rnorm, resnorm0=beta0, converged=converged
    )


def cgne(
    matvec: Callable,
    rmatvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    n: Optional[int] = None,
    *,
    maxiter: int = 100,
    rtol: float = 1e-8,
    atol: float = 0.0,
) -> KrylovResult:
    """CG on the normal equations ``A^T A x = A^T b`` (KSPCGNE-equivalent,
    reference ``outer_solver_cgne`` ``utils.c:1022-1043``)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import cg

    if n is None:
        n = rmatvec(b).shape[0]
    if x0 is None:
        x0 = jnp.zeros((n,), b.dtype)
    atb = rmatvec(b)
    normal_mv = lambda v: rmatvec(matvec(v))
    return cg(normal_mv, atb, x0, maxiter=maxiter, rtol=rtol, atol=atol)
