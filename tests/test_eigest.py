"""Lanczos spectral-interval estimation (solvers/eigest.py): the
PETSc ``-ksp_chebyshev_esteig`` analog that unlocks Chebyshev /
CA-GMRES inner solves on user (AIJ) matrices with no analytic bounds.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops,
    multisplitting as ms,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.eigest import (
    lanczos_bounds,
)


class TestLanczosBounds:
    def test_diagonal_matrix_exact(self):
        d = jnp.asarray(np.linspace(0.5, 9.0, 200))
        lmin, lmax = lanczos_bounds(lambda v: d * v, 200,
                                    dtype=jnp.float64)
        # extreme Ritz values converge first; safety widens 10%
        assert lmin <= 0.5 <= lmin / (1 - 0.1) * 1.05
        assert lmax >= 9.0 >= lmax / (1 + 0.1) * 0.95

    def test_poisson_matches_analytic(self):
        # a 2D Poisson operator with known spectrum
        op = poisson.poisson2d(24, 24)
        n = 24 * 24
        # Dirichlet 5-point spectrum: 4 - 2cos(i*pi/25) - 2cos(j*pi/25)
        c = 2.0 * np.cos(np.pi * np.arange(1, 25) / 25)
        lam = 4.0 - np.add.outer(c, c)
        exact_min, exact_max = float(lam.min()), float(lam.max())
        lmin, lmax = lanczos_bounds(
            lambda v: op.mv(v.reshape(24, 24)).reshape(-1), n,
            dtype=jnp.float64,
        )
        assert lmin <= exact_min * 1.02
        assert lmax >= exact_max * 0.98
        # not absurdly wide either
        assert lmin >= 0.3 * exact_min
        assert lmax <= 1.5 * exact_max

    def test_non_spd_raises(self):
        d = jnp.asarray(np.linspace(-1.0, 5.0, 64))
        with pytest.raises(ValueError, match="SPD"):
            lanczos_bounds(lambda v: d * v, 64, dtype=jnp.float64)

    @pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
    def test_identity_breakdown_handled(self, dtype):
        # Krylov grade 1: beta_0 ~ 0 after the first step — the host
        # truncation must keep only the valid leading block instead of
        # normalizing roundoff noise into spurious Ritz values
        # (pre-fix: identity was rejected as "not SPD")
        lmin, lmax = lanczos_bounds(lambda v: v, 64, dtype=dtype)
        assert 0.85 <= lmin <= 1.0 and 1.0 <= lmax <= 1.15

    def test_scalar_problem(self):
        # n=1: grade-1 recurrence, exact eigenvalue 3
        lmin, lmax = lanczos_bounds(lambda v: 3.0 * v, 1,
                                    dtype=jnp.float64)
        assert 2.5 <= lmin <= 3.0 <= lmax <= 3.5

    def test_low_grade_spectrum(self):
        # two distinct eigenvalues -> grade 2 regardless of n
        d = jnp.asarray(np.where(np.arange(100) < 50, 2.0, 7.0))
        lmin, lmax = lanczos_bounds(lambda v: d * v, 100,
                                    dtype=jnp.float64)
        assert lmin <= 2.0 and lmax >= 7.0 and lmin > 1.0 and lmax < 9.0


class TestChebyshevOnUserMatrix:
    def _spd_blockable(self, nb=16, bs=16, seed=51):
        rng = np.random.default_rng(seed)
        n = nb * bs
        A = sp.lil_matrix((n, n))
        for k in range(nb):
            Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
            lam = np.linspace(1.0, 20.0, bs)   # mild conditioning
            A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = (Q * lam) @ Q.T
        C = sp.random(n, n, density=0.02, random_state=seed + 1)
        return (A.tocsr() + 1e-2 * (C + C.T)).tocsr()

    def test_sm_chebyshev_inner_estimated_bounds(self):
        A = self._spd_blockable()
        coo = A.tocoo()
        a_ii, a_ic = poisson.block_split_ell(
            coo.row, coo.col, coo.data, A.shape, nblocks=2,
            dtype=jnp.float64,
        )
        op = blockops.as_stacked_device_operator(
            blockops.StackedELLOperator(a_ii=a_ii, a_ic=a_ic)
        )
        n = A.shape[0]
        b = jnp.asarray(np.asarray(A @ np.ones(n))).reshape(2, n // 2)
        # no eig_min/eig_max, no analytic bounds -> Lanczos estimation
        res = ms.sm(op, b, rtol=1e-8, maxiter=3000,
                    inner=ms.InnerConfig(method="chebyshev", maxiter=30))
        assert bool(res.converged)
        x = np.asarray(res.x.reshape(-1))
        bnp = np.asarray(A @ np.ones(n))
        assert (np.linalg.norm(bnp - A @ x)
                / np.linalg.norm(bnp)) <= 1.05e-8


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-q"]))
