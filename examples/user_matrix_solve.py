"""Solve YOUR sparse matrix (the AIJ migration path).

A user of the reference assembles an AIJ matrix with
``create_matrix_sparse`` (``src/utils/utils.c:139-155``) and hands it to
the KSP/multisplitting drivers.  Here the same journey from a
``scipy.sparse`` matrix:

1. ``from_scipy`` routes the pattern to a device-efficient operator
   (banded -> DIA slices, blockable -> BSR sub-block matmuls, small ->
   dense, else the routed-gather AIJ);
2. whole-system GMRES, optionally right-preconditioned with block-Jacobi
   (batched dense block inverses — the PCBJACOBI analog);
3. the same matrix through the two-stage multisplitting drivers with
   inner block-Jacobi (``--inner-pc-type bjacobi``);
4. the one-call forms: ``solve(A, b)`` (assemble -> KSPSolve collapsed)
   and ``lstsq(A, b)`` (the KSPLSQR analog for rectangular /
   inconsistent systems).

CLI equivalents::

    python -m ...utils.cli --alg GMRES --matrix my.npz --pc-type bjacobi
    python -m ...utils.cli --alg SM --matrix my.npz --inner-pc-type bjacobi
    python -m ...utils.cli --alg GMRES --matrix my.npz --backend sharded \
        --nblocks 2 --intra 4 --pc-type bjacobi   # row-sharded over a mesh
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import scipy.sparse as sp

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import from_scipy
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
    block_jacobi_from_scipy,
)


def build_demo_matrix(nb=32, bs=16, seed=0):
    """A block-structured system: ill-conditioned dense diagonal blocks
    (cond 1e3 — think multi-dof FEM nodes) + weak BLOCK-structured
    coupling (a few dense off-diagonal blocks per block row, the natural
    FEM connectivity — this is what makes the pattern BSR-routable)."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    A = sp.lil_matrix((n, n))
    for k in range(nb):
        Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
        lam = np.logspace(0, 3, bs)
        A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = (Q * lam) @ Q.T
        for c in rng.choice(nb, size=3, replace=False):
            if c != k:
                A[k * bs:(k + 1) * bs, c * bs:(c + 1) * bs] = (
                    0.01 * rng.standard_normal((bs, bs))
                )
    A = A.tocsr()
    return (0.5 * (A + A.T)).tocsr()


def main():
    A = build_demo_matrix()
    n = A.shape[0]
    b = np.asarray(A @ np.ones(n))          # exact solution u = 1

    # 1. route the pattern to a device-efficient operator
    op = from_scipy(A, dtype=jnp.float32)
    print(f"routed {n}x{n} ({A.nnz} nnz) -> {type(op).__name__}")

    bj = jnp.asarray(b, jnp.float32)

    # 2a. plain GMRES
    plain = gmres(op.mv, bj, restart=30, maxiter=2000, rtol=1e-4)
    print(f"GMRES none    : {int(plain.iters):4d} iterations")

    # 2b. right-preconditioned with block-Jacobi: solve (A M) y = b,
    # x = M y — the convergence test sees the TRUE residual
    M = block_jacobi_from_scipy(A, bs=16, dtype=jnp.float32)
    pre = gmres(lambda v: op.mv(M(v)), bj, restart=8, maxiter=2000,
                rtol=1e-4)
    x = np.asarray(M(pre.x), np.float64)
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    print(f"GMRES bjacobi : {int(pre.iters):4d} iterations, "
          f"true rel residual {rel:.2e}, err vs u=1 "
          f"{np.linalg.norm(x - 1.0):.2e}")

    # 3. or let the one-call API do all of the above
    from medane_tchakorom_ufc_thesis_repository_tpu import lstsq, solve

    x, info = solve(A, b, rtol=1e-4, pc="bjacobi", pc_block_size=16)
    print(f"solve()       : {info['iters']:4d} iterations via "
          f"{info['operator']}, rel {info['rel_residual']:.2e}")

    # 4. least squares: overdetermined system, LSQR stops on the
    # ||A^T r|| optimality rule (the residual itself never reaches rtol)
    rng = np.random.default_rng(1)
    R = sp.random(4 * n, n, density=0.01, random_state=1) + sp.eye(4 * n, n)
    brect = np.asarray(R @ np.ones(n)) + 0.1 * rng.standard_normal(4 * n)
    x, info = lstsq(R, brect, rtol=1e-5)
    print(f"lstsq()       : {info['iters']:4d} LSQR iterations, "
          f"||A^T r||/||A^T b|| = {info['rel_opt']:.2e}")


if __name__ == "__main__":
    main()
