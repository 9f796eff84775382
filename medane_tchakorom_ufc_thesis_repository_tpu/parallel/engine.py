"""Shared SPMD multisplitting engine.

The outer solve loop (sweeps, staleness publishing, s-step basis
collection, Gram minimization, pseudo-period-gated termination) is
identical for every sharded layout — only the local matvecs, local
shapes, and mesh axes differ.  ``make_spmd_body`` builds the per-device
body once; layout modules (``sharded``, ``tiled``) supply:

* ``diag_mv(g)``     — A_ii on the local tile (intra-block halos inside)
* ``coupling_mv(g)`` — A_ij contribution from published peer-block state
* ``inner_solve(rhs, x)`` — per-block Krylov solve (SPMD-lockstep)
* ``lshape``         — local tile shape
* ``intra_axes`` / ``all_axes`` — mesh axes for block-local vs global
  reductions ('block' must be the leading axis of ``all_axes``)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

import numpy as np


def make_spmd_body(
    *,
    diag_mv: Callable,
    coupling_mv: Callable,
    inner_solve: Callable,
    lshape: Tuple[int, ...],
    nb: int,
    intra_axes,
    all_axes,
    is_async: bool,
    stal: jax.Array,           # (nb,) int32 publish periods
    minimization: Optional[str],
    s: int,
    outer,                     # OuterConfig (method/maxiter/rtol/damping)
    rtol: float,
    atol: float,
    maxiter: int,
    min_convergence_count: int,
    dtype,
    record_history: bool = False,
    basis_collection: str = "sweep",
    pinned_rnorm0=None,
):
    lsize = int(np.prod(lshape))
    if basis_collection not in ("sweep", "publish"):
        raise ValueError(f"unknown basis_collection {basis_collection!r}")
    collect_publish = (
        basis_collection == "publish" and is_async and minimization is not None
    )
    # 'publish' collection: columns recorded at publish boundaries only
    # (fresh peer data per column — fixes the AMAM staleness pathology,
    # measured 2824 -> 144 sweeps at d=4); a cycle then
    # spans s * max(staleness) sweeps
    spc = s * int(np.asarray(stal).max()) if collect_publish else s
    # per-cycle residual-norm history (the SPMD analog of the stacked
    # driver's record_history and the reference's per-iteration norm
    # printouts, asynchronous-multisplitting_prime.c:345); rnorm is
    # replicated so the history array is too
    max_cycles = -(-maxiter // max(s, 1)) if record_history else 1

    def solve_gram(G, c):
        eps = jnp.finfo(dtype).eps
        jitter = eps * jnp.trace(G) / G.shape[0] + outer.damping
        G = G + jitter * jnp.eye(G.shape[0], dtype=dtype)
        ch, low = jax.scipy.linalg.cho_factor(G, lower=True)
        return jax.scipy.linalg.cho_solve((ch, low), c)

    def alpha_normal(Rmat, tgt, axes):
        """Gram normal equations (reference ``outer_solver_cholesky``,
        ``utils.c:972-996``): one s x s psum.  Cheapest collective; loses
        ~half the working digits (kappa^2) — fatal in f32 beyond s~6."""
        # precision='highest': an unpinned f32 matmul may run in TF32 on
        # the GPU, which the kappa^2-sensitive Gram cannot afford
        G = lax.psum(jnp.matmul(Rmat.T, Rmat, precision="highest"), axes)
        c = lax.psum(jnp.matmul(Rmat.T, tgt, precision="highest"), axes)
        return solve_gram(G, c)

    def alpha_tsqr(Rmat, tgt, axes):
        """Distributed tall-skinny QR least-squares (Householder-stable,
        no normal equations anywhere — safe for f32 at s=20, the g5k
        production config ``running_bulk_test_g5k``; reference
        ``outer_solver_qr`` ``utils.c:998-1020``).

        Two-level TSQR: local reduced QR of the (lsize, s) panel, project
        the target through Q0 locally, then all_gather the tiny (s, s)
        R factors + projected targets and finish with one replicated QR
        of the (P*s, s) stack.  Communication = one all_gather of
        s*(s+1) scalars per device — same order as the Gram psum."""
        Q0, R0 = jnp.linalg.qr(Rmat, mode="reduced")
        t0 = jnp.matmul(Q0.T, tgt, precision="highest")
        Rs = lax.all_gather(R0, axes)          # (P, s, s)
        ts = lax.all_gather(t0, axes)          # (P, s)
        Q1, R1 = jnp.linalg.qr(
            Rs.reshape(-1, s), mode="reduced"
        )
        t1 = jnp.matmul(Q1.T, ts.reshape(-1), precision="highest")
        return jax.scipy.linalg.solve_triangular(R1, t1, lower=False)

    def alpha_lsqr(Rmat, tgt, axes):
        """Iterative LSQR on the row-sharded panel (reference
        ``outer_solver_lsqr`` ``utils.c:998-1020``; the active g5k bulk
        config runs outer lsqr with s=20).  matvec is local; rmatvec
        psum-reduces to a replicated s-vector.  ``lockstep_axis='block'``
        keeps trip counts identical across blocks when the minimization
        scope is local/semi-local (SPMD invariant: no device-divergent
        collectives)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lsqr import (
            lsqr,
        )

        lockstep = None if "block" in axes else "block"
        # full-precision panel matvecs: TF32 operands would cap the
        # attainable LS accuracy far above outer.rtol
        res = lsqr(
            lambda a: jnp.matmul(Rmat, a, precision="highest"),
            lambda u: lax.psum(
                jnp.matmul(Rmat.T, u, precision="highest"), axes),
            tgt,
            n=s,
            maxiter=outer.maxiter,
            rtol=outer.rtol,
            atol=outer.atol,
            axis_name=axes,
            lockstep_axis=lockstep,
        )
        return res.x

    solve_alpha = {
        "normal": alpha_normal, "qr": alpha_tsqr, "lsqr": alpha_lsqr,
    }[outer.method]

    def body(b_loc, x0):
        # current initial residual (warm restart: x0 may be a checkpoint)
        r0 = b_loc - diag_mv(x0) - coupling_mv(x0)
        r0norm = jnp.sqrt(lax.psum(jnp.sum(r0 * r0), all_axes))
        # reference norm: the reference's UIRNorm semantics use the
        # residual at entry; a pinned value (checkpoint resume) keeps
        # the ORIGINAL run's tolerance anchor
        rnorm0 = (r0norm if pinned_rnorm0 is None
                  else jnp.asarray(pinned_rnorm0, dtype))
        tol_global = jnp.maximum(rtol * rnorm0, atol)
        tol_local = jnp.maximum(
            rtol / jnp.sqrt(jnp.asarray(float(nb), dtype)) * rnorm0, atol
        )
        my_stal = stal[lax.axis_index("block")]

        rhs0 = b_loc - coupling_mv(x0)

        def publish(x, x_vis, sweeps):
            return jnp.where((sweeps % my_stal) == 0, x, x_vis)

        def sweep_body(i, carry):
            x, x_vis, rhs, sweeps, inner_total, S, pub, pc = carry
            res = inner_solve(rhs, x)
            x = res.x.reshape(lshape)
            inner_total = inner_total + lax.psum(res.iters, "block").astype(
                jnp.int32
            )
            sweeps = sweeps + 1
            published = (sweeps % my_stal) == 0
            pub = jnp.logical_or(pub, published)
            x_vis = publish(x, x_vis, sweeps)
            rhs = b_loc - coupling_mv(x_vis)
            if collect_publish:
                S_new = lax.dynamic_update_index_in_dim(S, x, pc % s, 0)
                S = jnp.where(published, S_new, S)
                pc = pc + published.astype(jnp.int32)
            else:
                S = S.at[i].set(x)
            return (x, x_vis, rhs, sweeps, inner_total, S, pub, pc)

        def minimize(S, x, x_vis, rhs, sweeps):
            if minimization == "local":
                Rcols = diag_mv(S)
                target = rhs
                axes = intra_axes
            else:
                Rcols = diag_mv(S) + coupling_mv(S)
                target = b_loc
                axes = intra_axes if minimization == "semi_local" else all_axes
            Rmat = Rcols.reshape(s, lsize).T
            tgt = target.reshape(-1)
            alpha = solve_alpha(Rmat, tgt, axes)
            if outer.alpha_average and minimization != "global":
                # the reference's *_modify alpha exchange
                # (comm_{sync,async}_send_and_receive_alpha,
                # comm.c:143-197): blocks average their combination
                # coefficients; alpha is 'intra'-replicated so a pmean
                # over 'block' is the whole exchange
                alpha = lax.pmean(alpha, "block")
            resid = tgt - jnp.matmul(Rmat, alpha, precision="highest")
            out_sq = lax.psum(jnp.sum(resid * resid), axes)
            outer_rnorm = jnp.sqrt(out_sq)
            x_new = jnp.matmul(
                S.reshape(s, lsize).T, alpha, precision="highest"
            ).reshape(lshape)
            x_vis = publish(x_new, x_vis, sweeps)
            rhs = b_loc - coupling_mv(x_vis)
            return x_new, x_vis, rhs, outer_rnorm

        def cycle(carry):
            (x, x_vis, rhs, sweeps, cycles, inner_total,
             conv_count, rnorm, outer_rnorm, converged, hist) = carry
            S0 = jnp.zeros((s,) + lshape, dtype)
            pub0 = jnp.zeros((), bool)
            pc0 = jnp.zeros((), jnp.int32)
            x, x_vis, rhs, sweeps, inner_total, S, pub, _ = lax.fori_loop(
                0, spc, sweep_body,
                (x, x_vis, rhs, sweeps, inner_total, S0, pub0, pc0),
            )
            if minimization is not None:
                x, x_vis, rhs, outer_rnorm = minimize(S, x, x_vis, rhs, sweeps)

            local_r = rhs - diag_mv(x)
            block_sq = lax.psum(jnp.sum(local_r * local_r), intra_axes)
            block_norm = jnp.sqrt(block_sq)
            rnorm = jnp.sqrt(lax.psum(block_sq, "block"))
            if record_history:
                hist = hist.at[cycles].set(rnorm)
            cycles = cycles + 1

            if is_async:
                # pseudo-period gate: only publish-complete cycles count
                under = block_norm <= tol_local
                all_pub = lax.psum(pub.astype(jnp.int32), "block") == nb
                conv_count = jnp.where(
                    ~under, 0,
                    jnp.where(all_pub, conv_count + 1, conv_count),
                )
                ok = (conv_count >= min_convergence_count).astype(jnp.int32)
                converged = lax.psum(ok, "block") == nb
            elif minimization == "global":
                converged = outer_rnorm <= tol_global
            elif minimization is not None:
                ok = (block_norm <= tol_local).astype(jnp.int32)
                converged = lax.psum(ok, "block") == nb
            else:
                converged = rnorm <= tol_global

            return (x, x_vis, rhs, sweeps, cycles, inner_total,
                    conv_count, rnorm, outer_rnorm, converged, hist)

        def cond(carry):
            return jnp.logical_and(~carry[-2], carry[3] < maxiter)

        init = (
            x0, x0, rhs0,
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
            r0norm, jnp.asarray(jnp.inf, dtype),
            r0norm <= tol_global,
            jnp.full((max_cycles,), jnp.inf, dtype),
        )
        (x, _, rhs, sweeps, cycles, inner_total, _, rnorm, outer_rnorm,
         converged, hist) = lax.while_loop(cond, cycle, init)

        local_r = rhs - diag_mv(x)
        block_norm = jnp.sqrt(
            lax.psum(jnp.sum(local_r * local_r), intra_axes)
        )
        return (x, sweeps, cycles, inner_total, rnorm, rnorm0, block_norm,
                outer_rnorm, converged, hist)

    return body
