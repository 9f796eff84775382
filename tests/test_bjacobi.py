"""Block-Jacobi preconditioner (solvers/bjacobi.py): scipy-verified
apply, singular-block fallback, and end-to-end Krylov acceleration.

The reference exposes PETSc PCs through ``-inner_pc_type``/
``-outer_pc_type`` (``iSolve:78-83``; ``src/utils/utils.c:511-530``);
PCBJACOBI is the MPI workhorse there.  This analog applies batched
dense block inverses (one einsum) instead of per-block ILU sweeps.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import from_scipy
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import cg, gmres
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
    block_jacobi_from_coo,
    block_jacobi_from_scipy,
)


def _block_ill_conditioned(nb, bs, seed=0, coupling=1e-2):
    """SPD matrix = blkdiag(ill-conditioned SPD blocks) + weak symmetric
    off-block coupling: point Jacobi can't fix the intra-block spread,
    block Jacobi nearly inverts it."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    A = sp.lil_matrix((n, n))
    for k in range(nb):
        Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
        lam = np.logspace(0, 3, bs)   # condition 1e3 inside each block
        A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = (Q * lam) @ Q.T
    C = sp.random(n, n, density=0.02, random_state=seed + 1)
    A = A.tocsr() + coupling * (C + C.T)
    return A.tocsr()


class TestApply:
    def test_matches_blockdiag_solve(self):
        A = _block_ill_conditioned(nb=6, bs=8, seed=3)
        M = block_jacobi_from_scipy(A, bs=8, dtype=jnp.float64)
        r = np.random.default_rng(4).standard_normal(A.shape[0])
        z = np.asarray(M.apply(jnp.asarray(r)))
        expect = np.concatenate([
            np.linalg.solve(A[k * 8:(k + 1) * 8, k * 8:(k + 1) * 8].toarray(),
                            r[k * 8:(k + 1) * 8])
            for k in range(6)
        ])
        np.testing.assert_allclose(z, expect, rtol=1e-10)

    def test_ragged_tail_identity(self):
        # n = 20 with bs = 8: the last block holds 4 true rows + identity
        rows = np.arange(20)
        vals = np.full(20, 2.0)
        M = block_jacobi_from_coo(rows, rows, vals, 20, bs=8,
                                  dtype=jnp.float64)
        r = np.ones(20)
        np.testing.assert_allclose(np.asarray(M.apply(jnp.asarray(r))),
                                   0.5 * r, rtol=1e-12)
        assert M.inv_blocks.shape == (3, 8, 8)

    def test_singular_block_pinv_fallback(self):
        # second diagonal block is all-zero -> pinv gives 0, stays finite
        rows = np.arange(4)
        vals = np.array([2.0, 2.0, 0.0, 0.0])
        keep = vals != 0
        M = block_jacobi_from_coo(rows[keep], rows[keep], vals[keep], 4,
                                  bs=2, dtype=jnp.float64)
        z = np.asarray(M.apply(jnp.asarray(np.ones(4))))
        assert np.isfinite(z).all()
        np.testing.assert_allclose(z[:2], 0.5)
        np.testing.assert_allclose(z[2:], 0.0)


class TestKrylovAcceleration:
    def test_gmres_right_pc_fewer_iters_same_solution(self):
        # RIGHT preconditioning (the CLI's composition): solve
        # (A M) y = b, x = M y — the convergence test sees the TRUE
        # residual, so rtol is honest even for a stiff PC
        A = _block_ill_conditioned(nb=8, bs=16, seed=7)
        op = from_scipy(A, dtype=jnp.float64)
        b = np.asarray(A @ np.ones(A.shape[0]))
        bj = jnp.asarray(b)
        plain = gmres(op.mv, bj, restart=30, maxiter=400, rtol=1e-8)
        M = block_jacobi_from_scipy(A, bs=16, dtype=jnp.float64)
        pre = gmres(lambda v: op.mv(M(v)), bj, restart=30, maxiter=400,
                    rtol=1e-8)
        assert bool(pre.converged)
        x = np.asarray(M(pre.x))
        ref = spla.spsolve(A.tocsc(), b)
        np.testing.assert_allclose(x, ref, rtol=1e-6, atol=1e-8)
        # true residual meets rtol (right PC tests the true norm)
        rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        assert rel <= 1.1e-8
        # block-Jacobi nearly inverts the blkdiag-dominated spectrum
        assert int(pre.iters) < int(plain.iters) / 3

    def test_pcg_precond_fewer_iters(self):
        A = _block_ill_conditioned(nb=8, bs=16, seed=11)
        op = from_scipy(A, dtype=jnp.float64)
        b = jnp.asarray(np.asarray(A @ np.ones(A.shape[0])))
        plain = cg(op.mv, b, maxiter=600, rtol=1e-8)
        M = block_jacobi_from_scipy(A, bs=16, dtype=jnp.float64)
        pre = cg(op.mv, b, maxiter=600, rtol=1e-8, precond=M.apply)
        assert bool(pre.converged)
        np.testing.assert_allclose(np.asarray(pre.x), 1.0, rtol=1e-5)
        assert int(pre.iters) < int(plain.iters) / 3

    def test_pc_block_size_need_not_match_bsr(self):
        # the PC block size is a free knob: bs=32 blocks over a matrix
        # whose natural block structure is 16
        A = _block_ill_conditioned(nb=8, bs=16, seed=13)
        op = from_scipy(A, dtype=jnp.float64)
        b = jnp.asarray(np.asarray(A @ np.ones(A.shape[0])))
        M = block_jacobi_from_scipy(A, bs=32, dtype=jnp.float64)
        pre = gmres(lambda v: op.mv(M(v)), b, restart=30, maxiter=400,
                    rtol=1e-8)
        assert bool(pre.converged)
        np.testing.assert_allclose(np.asarray(M(pre.x)), 1.0, rtol=1e-5)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
