"""Communication-avoiding s-step GMRES (Newton basis).

Standard GMRES pays 2-4 global reductions per matvec (the CGS dots and
norms) — on a device mesh every one is a `psum` on the critical path, and
on a single chip each is a separately-launched fused op.  The s-step
reformulation (Hoemmen/Demmel's CA-GMRES family) builds the whole Krylov
block first and orthogonalizes once:

  1. basis: ``k_0 = r``, ``k_{j+1} = (A − θ_j I) k_j`` — s matvecs with
     NO reductions beyond one norm per column (for scaling);
  2. the shifted recurrence gives ``A k̂_j = (σ_{j+1}/σ_j) k̂_{j+1}
     + θ_j k̂_j`` exactly, so the projected LS ``min ‖r − A K_s y‖``
     becomes a tall-skinny least-squares over explicitly known columns —
     one QR of an ``(n, s)`` panel (BLAS-3) instead of s
     Gram-Schmidt sweeps;
  3. ``x += K_s y``; restart.

Shift choice: monomial (θ=0) conditions like κ^s — unusable beyond s≈4;
Chebyshev points of the spectral interval ``[lmin, lmax]`` (Leja-ordered)
keep the basis well-conditioned to s≈12-20.  For Poisson operators the
interval is analytic (``solvers.chebyshev.poisson_strip_eig_bounds_*``).

Per restart cycle this spans exactly the same Krylov subspace as
GMRES(s), so iteration counts match GMRES with ``restart=s`` while the
reduction count per matvec drops from ~3 to ~1 and the orthogonalization
runs as one matmul-shaped factorization.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import (
    KrylovResult,
    make_reducer,
)


def chebyshev_shifts(lmin: float, lmax: float, s: int) -> list:
    """Chebyshev points of [lmin, lmax] in Leja order (max-min spread) —
    the standard Newton-basis shifts for a real positive spectrum."""
    pts = [
        0.5 * (lmax + lmin)
        + 0.5 * (lmax - lmin) * math.cos((2 * k + 1) * math.pi / (2 * s))
        for k in range(s)
    ]
    # Leja ordering: greedily maximize the product of distances
    ordered = [max(pts)]
    rest = [p for p in pts if p != ordered[0]]
    while rest:
        nxt = max(
            rest,
            key=lambda p: sum(math.log(abs(p - q) + 1e-300) for q in ordered),
        )
        ordered.append(nxt)
        rest.remove(nxt)
    return ordered


def ca_gmres(
    matvec: Callable,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    s: int = 8,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    shifts: Optional[Sequence[float]] = None,
    lmin: Optional[float] = None,
    lmax: Optional[float] = None,
    axis_name=None,
    reductions: str = "column",
    fixed_cycles: bool = False,
) -> KrylovResult:
    """Restarted s-step GMRES.  ``shifts`` (length >= s) or the spectral
    interval ``[lmin, lmax]`` supply the Newton basis; omitting both
    falls back to the monomial basis (keep ``s <= 4``).

    Under ``shard_map`` pass ``axis_name``; the panel LS then runs via a
    psum-reduced Gram system.

    ``reductions``:

    * ``'column'`` — one norm reduction per basis column (scaled Newton
      basis; f32-safe).
    * ``'single'`` — the full communication-avoiding schedule: the
      Newton basis is built UNSCALED with zero reductions, then ONE
      ``(s+1) x (s+1)`` Gram psum per cycle supplies the least-squares
      system AND the residual norm (Gram algebra:
      ``‖r − Cᵀy‖² = G₀₀ − 2 yᵀc + yᵀ C Cᵀ y``) — exactly one
      collective per s matvecs, the latency profile CA-GMRES exists for
      (Hoemmen 2010 §3).  Conditioning is κ(W)² through the Gram:
      use f64 (or s ≤ 6 in f32); Chebyshev shifts keep the unscaled
      column growth ~O((λmax/4)^s), far inside f32/f64 range.
    """
    if reductions not in ("column", "single"):
        raise ValueError(f"unknown reductions mode {reductions!r}")
    dtype = b.dtype
    n = b.shape[0]
    psum = make_reducer(axis_name)

    def pnorm2(v):
        return psum(jnp.sum(v * v))

    if shifts is None:
        if lmin is not None and lmax is not None:
            shifts = chebyshev_shifts(lmin, lmax, s)
        else:
            shifts = [0.0] * s
    theta = jnp.asarray(list(shifts)[:s], dtype)

    if x0 is None:
        x0 = jnp.zeros_like(b)

    r0 = b - matvec(x0)
    beta0 = jnp.sqrt(pnorm2(r0))
    rnorm0 = beta0
    tol = jnp.maximum(rtol * rnorm0, jnp.asarray(atol, dtype))
    eps = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

    # logarithmic-capacity column scaling for the reduction-free basis
    # build (Philippe/Reichel scaled Newton basis): with Chebyshev-point
    # shifts the polynomials are ~O(1) on [lmin, lmax] after dividing
    # each degree by the interval capacity (lmax-lmin)/4, so column
    # norms stay O(‖r‖) and the Gram stays far from overflow/underflow —
    # without this the unscaled f32 basis overflows the Gram's dynamic
    # range by s≈10 (measured NaN)
    if lmin is not None and lmax is not None and lmax > lmin:
        capacity = jnp.asarray((lmax - lmin) / 4.0, dtype)
    else:
        capacity = jnp.asarray(1.0, dtype)

    def cycle_single(carry):
        # one-collective cycle: capacity-scaled Newton basis, Gram-only
        # algebra
        x, iters, rnorm, converged = carry
        r = b - matvec(x)

        def step(w_prev, th):
            w = (matvec(w_prev) - th * w_prev) / capacity
            return w, w

        _, W_rest = lax.scan(step, r, theta)
        W = jnp.concatenate([r[None, :], W_rest], axis=0)      # (s+1, n)
        # full-precision Gram: reduced-precision operands (TF32 for an
        # unpinned f32 matmul on the GPU) destroy the κ(W)²-sensitive
        # Gram
        G = psum(jnp.matmul(W, W.T, precision="highest"))      # ONE psum
        # A ŵ_j = capacity ŵ_{j+1} + θ_j ŵ_j  =>  C = B @ W with
        # B[j] = capacity e_{j+1} + θ_j e_j  (s, s+1) — small, replicated
        B = (capacity * jnp.eye(s, s + 1, k=1, dtype=dtype)
             + theta[:, None] * jnp.eye(s, s + 1, dtype=dtype))
        hi = "highest"
        Gc = jnp.matmul(jnp.matmul(B, G, precision=hi), B.T,
                        precision=hi)                          # C Cᵀ
        c = jnp.matmul(B, G[:, 0], precision=hi)               # C r
        jitter = jnp.finfo(dtype).eps * (jnp.trace(Gc) / s + 1.0)
        ch, low = jax.scipy.linalg.cho_factor(
            Gc + jitter * jnp.eye(s, dtype=dtype), lower=True
        )
        y = jax.scipy.linalg.cho_solve((ch, low), c)
        x_new = x + jnp.matmul(W[:s].T, y, precision="highest")
        # residual norm via Gram algebra (no extra reduction); fp
        # cancellation can drive the small value slightly negative
        rsq = (G[0, 0] - 2.0 * jnp.dot(y, c, precision=hi)
               + jnp.dot(y, jnp.matmul(Gc, y, precision=hi), precision=hi))
        rnorm_new = jnp.sqrt(jnp.maximum(rsq, 0.0))

        # κ(W)² flows through the Gram: when the scaled basis still
        # exceeds the working precision (f32 + ill-conditioned blocks +
        # larger s) the Cholesky emits non-finites — freeze the ITERATE
        # instead of poisoning it while iters keeps counting toward
        # maxiter (run ends honest: converged=False, finite x).  Use
        # f64, smaller s, or reductions='column' there.
        finite = jnp.logical_and(
            jnp.isfinite(rsq), jnp.all(jnp.isfinite(y))
        )
        running = jnp.logical_and(~converged, iters < maxiter)
        active = jnp.logical_and(running, finite)
        x = jnp.where(active, x_new, x)
        rnorm = jnp.where(active, rnorm_new, rnorm)
        iters = jnp.where(running, iters + s, iters)
        converged = jnp.logical_or(
            converged, jnp.logical_and(active, rnorm_new <= tol)
        )
        return x, iters, rnorm, converged

    def cycle(carry):
        x, iters, rnorm, converged = carry
        r = b - matvec(x)

        # build the scaled Newton basis K (s+1, n) and the scale ratios
        def step(k_prev, th):
            w = matvec(k_prev) - th * k_prev
            sigma = jnp.sqrt(pnorm2(w))
            k_next = w / jnp.maximum(sigma, eps)
            return k_next, (k_next, sigma)

        beta = jnp.sqrt(pnorm2(r))
        k0 = r / jnp.maximum(beta, eps)
        _, (K_rest, sigmas) = lax.scan(step, k0, theta)
        K = jnp.concatenate([k0[None, :], K_rest], axis=0)   # (s+1, n)

        # exact recurrence: A k̂_j = sigma_{j+1} k̂_{j+1} + θ_j k̂_j
        # (sigma_{j+1} is the UNnormalized next-column norm, since k̂_j
        # was already unit)  =>  columns of A·K_s:
        C = sigmas[:, None] * K[1:] + theta[:, None] * K[:s]  # (s, n)

        # LS: min_y ‖r − Cᵀ y‖.  The Gram form squares the basis
        # conditioning (fatal in f32 beyond s≈6); use panel QR on a
        # single device, Gram+Cholesky only under shard_map where the
        # rows are distributed (one collective).
        if axis_name is None:
            q, rr = jnp.linalg.qr(C.T, mode="reduced")     # (n,s),(s,s)
            diag = jnp.diagonal(rr)
            safe = jnp.abs(diag) > jnp.finfo(dtype).eps * jnp.max(
                jnp.abs(diag)
            )
            rr = rr + jnp.diag(jnp.where(safe, 0.0, 1.0).astype(dtype))
            qtr = jnp.where(
                safe, jnp.matmul(q.T, r, precision="highest"), 0.0)
            y = jax.scipy.linalg.solve_triangular(rr, qtr, lower=False)
        else:
            # full precision: the kappa(W)^2-sensitive Gram cannot survive
            # TF32 operands (see cycle_single)
            G = psum(jnp.matmul(C, C.T, precision="highest"))  # (s, s)
            c = psum(jnp.matmul(C, r, precision="highest"))
            jitter = jnp.finfo(dtype).eps * (jnp.trace(G) / s + 1.0)
            Gj = G + jitter * jnp.eye(s, dtype=dtype)
            ch, low = jax.scipy.linalg.cho_factor(Gj, lower=True)
            y = jax.scipy.linalg.cho_solve((ch, low), c)

        x_new = x + jnp.matmul(K[:s].T, y, precision="highest")
        res = r - jnp.matmul(C.T, y, precision="highest")
        rnorm_new = jnp.sqrt(pnorm2(res))

        active = jnp.logical_and(~converged, iters < maxiter)
        x = jnp.where(active, x_new, x)
        rnorm = jnp.where(active, rnorm_new, rnorm)
        iters = jnp.where(active, iters + s, iters)
        converged = jnp.logical_or(
            converged, jnp.logical_and(active, rnorm_new <= tol)
        )
        return x, iters, rnorm, converged

    def cond(carry):
        _, iters, rnorm, converged = carry
        return jnp.logical_and(~converged, iters < maxiter)

    init = (x0, jnp.zeros((), jnp.int32), beta0, beta0 <= tol)
    body = cycle_single if reductions == "single" else cycle
    if fixed_cycles:
        # SPMD-lockstep mode (the per-block inner-solve invariant): a
        # static cycle count with masked updates — the cycle bodies
        # already freeze converged instances via `active`, so devices
        # whose flags differ across non-participating mesh axes take
        # identical trip counts
        ncycles = -(-maxiter // s)
        x, iters, rnorm, converged = lax.fori_loop(
            0, ncycles, lambda i, c: body(c), init
        )
    else:
        x, iters, rnorm, converged = lax.while_loop(cond, body, init)
    return KrylovResult(
        x=x, iters=iters, resnorm=rnorm, resnorm0=rnorm0, converged=converged
    )
