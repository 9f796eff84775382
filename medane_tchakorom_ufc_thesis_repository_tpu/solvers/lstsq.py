"""Direct tall-skinny least-squares kernels.

The minimization stages solve ``min_a ||rhs - R a||`` where ``R`` is
``(n, s)`` with tiny ``s`` (4..30).  On a data-parallel device the right
move is NOT an iterative KSP loop but one fused panel reduction:

* ``lstsq_normal`` — form the s x s Gram matrix ``R^T R`` (one matmul)
  and Cholesky-solve.  This is the direct version of the reference's
  ``outer_solver`` / ``outer_solver_norm_equation`` (explicit ``R^T R`` +
  CG, ``src/utils/utils.c:972-996,1061-1078``) with the iterative solve
  collapsed to a direct s x s factorization.
* ``lstsq_qr`` — tall-skinny QR (XLA's Householder QR) for the
  ill-conditioned cases where normal equations lose half the digits.

Both batch with ``vmap`` over a leading block axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lstsq_normal(R: jax.Array, rhs: jax.Array, l2: float = 0.0) -> jax.Array:
    """argmin_a ||rhs - R a|| via normal equations + Cholesky.

    ``l2`` adds Tikhonov damping (guards rank-deficient bases, e.g. when
    the multisplitting iterates stagnate and S columns become parallel).
    """
    # HIGHEST: an unpinned f32 matmul may run in TF32 (~1e-3) on the
    # GPU — on a Gram matrix the VALUES matter
    hi = jax.lax.Precision.HIGHEST
    g = jnp.matmul(R.T, R, precision=hi)
    if l2:
        g = g + l2 * jnp.eye(g.shape[0], dtype=g.dtype)
    # scale-aware jitter keeps Cholesky alive on nearly-rank-deficient S
    eps = jnp.finfo(g.dtype).eps
    jitter = eps * jnp.trace(g) / g.shape[0]
    g = g + jitter * jnp.eye(g.shape[0], dtype=g.dtype)
    c, low = jax.scipy.linalg.cho_factor(g, lower=True)
    return jax.scipy.linalg.cho_solve(
        (c, low), jnp.matmul(R.T, rhs, precision=hi)
    )


def lstsq_qr(R: jax.Array, rhs: jax.Array) -> jax.Array:
    """argmin_a ||rhs - R a|| via reduced QR."""
    q, r = jnp.linalg.qr(R, mode="reduced")
    diag = jnp.diagonal(r)
    safe = jnp.abs(diag) > jnp.finfo(R.dtype).eps * jnp.max(jnp.abs(diag))
    r = r + jnp.diag(jnp.where(safe, 0.0, 1.0).astype(R.dtype))
    y = jnp.matmul(q.T, rhs, precision=jax.lax.Precision.HIGHEST)
    return jax.scipy.linalg.solve_triangular(r, jnp.where(safe, y, 0.0), lower=False)
