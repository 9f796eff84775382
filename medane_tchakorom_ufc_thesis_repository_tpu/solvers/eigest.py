"""Lanczos spectral-interval estimation for SPD operators.

The Chebyshev inner iteration and the CA-GMRES Newton basis need the
spectral interval ``[lmin, lmax]``.  The Poisson strip operators carry
analytic bounds (``diag_eig_bounds``); user (AIJ) matrices do not — the
reference inherits this from PETSc, whose ``KSPChebyshev`` runs a few
GMRES iterations to estimate the interval (``-ksp_chebyshev_esteig``).
Here the jit-friendly equivalent: a fixed-trip-count Lanczos recurrence
(matvec + whole-basis matmuls per step — one jitted ``lax.scan``, no
data-dependent control flow) whose extreme Ritz values converge to the
extreme eigenvalues first, safety-widened exactly like PETSc's default
``esteig 0,0.1,0,1.1`` transform.

Breakdown handling: when the Krylov grade is below the trip count
(e.g. (near-)scaled-identity operators), the recurrence hits
``beta_j ~ 0`` and subsequent steps normalize roundoff noise into
garbage coefficients.  The fixed-shape scan records everything; the
HOST then truncates at the first sub-roundoff ``beta`` (relative to the
running coefficient scale) and diagonalizes only the valid leading
tridiagonal block — so a grade-1 identity comes back as exactly
``[(1-s)·1, (1+s)·1]`` instead of a spurious "not SPD" rejection.

Reference anchors: ``initializeKSP``/``KSPSetFromOptions``
(``src/utils/utils.c:511-530``) exposes PETSc's whole KSP zoo including
Chebyshev with estimated eigenvalues.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["lanczos_bounds", "lanczos_coeffs", "bounds_from_coeffs"]


def lanczos_coeffs(mv: Callable, v0: jax.Array, m: int):
    """``m`` Lanczos steps with full reorthogonalization; returns the
    raw tridiagonal coefficients ``(alphas (m,), betas (m,))``.

    Traceable (pure ``lax.scan``, fixed shapes) — jit/vmap it yourself;
    the multisplitting per-block estimation vmaps ONE compiled program
    over all blocks instead of compiling a closure per block (the
    CLAUDE.md cached-jit rule).  Full CGS-style reorthogonalization
    (whole-basis matmuls) is numerically equivalent to the textbook
    three-term recurrence but immune to the ghost-eigenvalue
    duplication that breaks the raw form in f32.
    """
    n = v0.shape[0]

    def step(carry, _):
        V, alphas, betas, j = carry
        v = V[j]
        w = mv(v)
        # rows > j of V are zero, so one pair of whole-basis matmuls
        # orthogonalizes against every previous vector (CGS + re-pass)
        hi = jax.lax.Precision.HIGHEST
        h = jnp.matmul(V, w, precision=hi)
        w = w - jnp.matmul(V.T, h, precision=hi)
        h2 = jnp.matmul(V, w, precision=hi)
        w = w - jnp.matmul(V.T, h2, precision=hi)
        alpha = h[j] + h2[j]
        beta = jnp.sqrt(jnp.sum(w * w))
        vnext = jnp.where(beta > 0, w / jnp.where(beta > 0, beta, 1.0), w)
        V = V.at[j + 1].set(vnext)
        alphas = alphas.at[j].set(alpha)
        betas = betas.at[j].set(beta)
        return (V, alphas, betas, j + 1), None

    dt = v0.dtype
    V = jnp.zeros((m + 1, n), dt).at[0].set(v0)
    alphas = jnp.zeros((m,), dt)
    betas = jnp.zeros((m,), dt)
    (V, alphas, betas, _), _ = jax.lax.scan(
        step, (V, alphas, betas, 0), None, length=m
    )
    return alphas, betas


def bounds_from_coeffs(alphas, betas, *, safety: float = 0.1,
                       eps: float | None = None) -> Tuple[float, float]:
    """Host-side: truncate at the first breakdown-scale ``beta``,
    diagonalize the valid leading tridiagonal block, return the
    safety-widened Ritz interval.  Raises ``ValueError`` when the
    interval is not positive (the operator is not SPD as far as
    Lanczos can see)."""
    alphas = np.asarray(alphas, np.float64)
    betas = np.asarray(betas, np.float64)
    m = alphas.shape[0]
    if eps is None:
        eps = float(np.finfo(np.float64).eps)
    # valid prefix: stop at the first beta that is roundoff relative to
    # the running coefficient scale (steps past it normalize noise)
    g = m
    scale = 0.0
    for j in range(m):
        scale = max(scale, abs(alphas[j]))
        if betas[j] <= 100.0 * eps * max(scale, 1e-300):
            g = j + 1
            break
        scale = max(scale, betas[j])
    T = np.diag(alphas[:g])
    if g > 1:
        T += np.diag(betas[: g - 1], 1) + np.diag(betas[: g - 1], -1)
    theta = np.linalg.eigvalsh(T)
    tmin, tmax = float(theta.min()), float(theta.max())
    lmin = (1.0 - safety) * tmin
    lmax = (1.0 + safety) * tmax
    if not (np.isfinite(lmin) and np.isfinite(lmax)) or lmin <= 0:
        raise ValueError(
            f"lanczos bounds: estimated interval [{lmin:.3e}, {lmax:.3e}] "
            "is not positive — the operator does not look SPD; "
            "chebyshev/ca_gmres need an SPD diagonal block (use "
            "gmres/cg, or pass eig_min/eig_max explicitly)"
        )
    return lmin, lmax


def lanczos_bounds(mv: Callable, n: int, *, iters: int = 30,
                   seed: int = 7, safety: float = 0.1,
                   dtype=None) -> Tuple[float, float]:
    """Estimate the spectral interval of an SPD operator (see module
    docstring).  One jitted Lanczos sweep + host-side Ritz extraction."""
    if n < 1:
        raise ValueError(f"n must be positive, got {n}")
    m = max(1, min(int(iters), n))
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    dt = jnp.float32 if dtype is None else dtype
    alphas, betas = jax.jit(
        lambda v: lanczos_coeffs(mv, v, m)
    )(jnp.asarray(v0, dt))
    eps = float(jnp.finfo(dt).eps)
    return bounds_from_coeffs(alphas, betas, safety=safety, eps=eps)
