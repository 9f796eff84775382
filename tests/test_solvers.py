"""Krylov solver property tests vs dense reference solves (SURVEY.md §4:
the rebuild adds solver coverage the reference lacked)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import DenseOp, Stencil2D
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
    cg,
    cgne,
    gmres,
    lsqr,
    lstsq_normal,
    lstsq_qr,
)


@pytest.fixture(scope="module")
def poisson_8x8():
    m = n = 8
    op = Stencil2D(m=m, n=n)
    dense = poisson.poisson2d_dense_np(m, n)
    b = np.asarray(dense @ np.ones(m * n))
    x_exact = np.linalg.solve(dense, b)
    return op, dense, jnp.asarray(b), x_exact


def test_gmres_matches_dense_solve(poisson_8x8):
    op, dense, b, x_exact = poisson_8x8
    res = gmres(op.mv, b, restart=30, maxiter=500, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), x_exact, rtol=1e-8, atol=1e-10)
    assert bool(res.converged)
    rnorm = np.linalg.norm(b - dense @ np.asarray(res.x))
    assert rnorm <= 1e-10 * np.linalg.norm(b)


def test_gmres_convergence_invariant_and_iter_count(poisson_8x8):
    """||r_final|| <= rtol * ||r_0|| and the reported estimate agrees with
    the true residual (Givens recurrence correctness)."""
    op, dense, b, _ = poisson_8x8
    res = gmres(op.mv, b, restart=10, maxiter=200, rtol=1e-6)
    true_r = np.linalg.norm(b - dense @ np.asarray(res.x))
    assert bool(res.converged)
    assert true_r <= 1.01e-6 * np.linalg.norm(np.asarray(b))
    np.testing.assert_allclose(float(res.resnorm), true_r, rtol=1e-6, atol=1e-12)
    assert 0 < int(res.iters) <= 200


def test_gmres_warm_start(poisson_8x8):
    """Nonzero initial guess (KSPSetInitialGuessNonzero analog): starting
    at the exact solution converges in 0 iterations when the convergence
    norm is pinned to ||b|| (as the multisplitting loops pin it)."""
    op, dense, b, x_exact = poisson_8x8
    res = gmres(op.mv, b, x0=jnp.asarray(x_exact), rtol=1e-8,
                rnorm0=jnp.linalg.norm(b))
    assert int(res.iters) == 0
    assert bool(res.converged)


def test_gmres_maxiter_budget(poisson_8x8):
    """maxiter counts total inner iterations across restart cycles."""
    op, dense, b, _ = poisson_8x8
    res = gmres(op.mv, b, restart=5, maxiter=7, rtol=1e-14)
    assert int(res.iters) == 7
    assert not bool(res.converged)


def test_cg_matches_dense_solve(poisson_8x8):
    op, dense, b, x_exact = poisson_8x8
    res = cg(op.mv, b, maxiter=1000, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), x_exact, rtol=1e-8, atol=1e-10)
    assert bool(res.converged)


def test_cg_matvec_dot_identical_iterates(poisson_8x8):
    """``matvec_dot`` (the fused MatMult+VecTDot hook Stencil3D.mv_dot
    plugs in) must reproduce plain CG bit-for-bit when the fused pair is
    computed the same way."""
    op, dense, b, x_exact = poisson_8x8
    plain = cg(op.mv, b, maxiter=37, rtol=1e-12)
    fused = cg(op.mv, b, maxiter=37, rtol=1e-12,
               matvec_dot=lambda p: (op.mv(p), jnp.vdot(p, op.mv(p))))
    assert int(plain.iters) == int(fused.iters)
    np.testing.assert_array_equal(np.asarray(plain.x), np.asarray(fused.x))


def test_stencil3d_mv_dot_pair():
    """Stencil3D.mv_dot returns (A x, x·Ax) consistent with mv + vdot
    (``tests/test_plain_paths.py`` pins it against an f64 reference)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as p3
    op = p3.poisson3d(8, 8, 8)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(512), jnp.float32)
    y, dot = op.mv_dot(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(op.mv(x)), rtol=1e-6)
    np.testing.assert_allclose(
        float(dot), float(jnp.vdot(x, op.mv(x))), rtol=1e-5)


def test_gmres_vmap_over_blocks(poisson_8x8):
    """Batched GMRES over a leading block axis — the single-chip analog of
    the reference's two concurrent per-block inner KSPSolves."""
    op, dense, b, x_exact = poisson_8x8
    B = jnp.stack([b, 2.0 * b])
    f = jax.vmap(lambda bb: gmres(op.mv, bb, restart=30, maxiter=300, rtol=1e-10).x)
    X = np.asarray(f(B))
    np.testing.assert_allclose(X[0], x_exact, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(X[1], 2 * x_exact, rtol=1e-7, atol=1e-9)


def test_lsqr_tall_skinny():
    rng = np.random.default_rng(0)
    R = rng.standard_normal((50, 6))
    rhs = rng.standard_normal(50)
    want, *_ = np.linalg.lstsq(R, rhs, rcond=None)
    opR = DenseOp(a=jnp.asarray(R))
    res = lsqr(opR.mv, opR.rmv, jnp.asarray(rhs), maxiter=200, rtol=0.0, atol=0.0)
    # LSQR stops on maxiter here (inconsistent system: residual floor > 0);
    # with 6 unknowns it reaches the LS optimum in a few iterations.
    np.testing.assert_allclose(np.asarray(res.x), want, rtol=1e-6, atol=1e-8)


def test_lsqr_consistent_system_converges():
    rng = np.random.default_rng(1)
    R = rng.standard_normal((50, 6))
    a_true = rng.standard_normal(6)
    rhs = R @ a_true
    opR = DenseOp(a=jnp.asarray(R))
    res = lsqr(opR.mv, opR.rmv, jnp.asarray(rhs), maxiter=100, rtol=1e-12)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), a_true, rtol=1e-8)


def test_cgne_tall_skinny():
    rng = np.random.default_rng(2)
    R = rng.standard_normal((40, 5))
    rhs = rng.standard_normal(40)
    want, *_ = np.linalg.lstsq(R, rhs, rcond=None)
    opR = DenseOp(a=jnp.asarray(R))
    res = cgne(opR.mv, opR.rmv, jnp.asarray(rhs), maxiter=100, rtol=1e-13)
    np.testing.assert_allclose(np.asarray(res.x), want, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("fn", [lstsq_normal, lstsq_qr])
def test_direct_lstsq(fn):
    rng = np.random.default_rng(3)
    R = rng.standard_normal((64, 8))
    rhs = rng.standard_normal(64)
    want, *_ = np.linalg.lstsq(R, rhs, rcond=None)
    got = np.asarray(fn(jnp.asarray(R), jnp.asarray(rhs)))
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_direct_lstsq_batched():
    rng = np.random.default_rng(4)
    R = rng.standard_normal((2, 64, 8))
    rhs = rng.standard_normal((2, 64))
    got = np.asarray(jax.vmap(lstsq_qr)(jnp.asarray(R), jnp.asarray(rhs)))
    for k in range(2):
        want, *_ = np.linalg.lstsq(R[k], rhs[k], rcond=None)
        np.testing.assert_allclose(got[k], want, rtol=1e-8, atol=1e-10)


def test_gmres_f32_still_converges():
    """Device default dtype path: f32 GMRES to 1e-3 (the reference's default
    inner rtol, config/default_run_variables)."""
    m = n = 16
    op = Stencil2D(m=m, n=n)
    b = jnp.asarray(poisson.rhs_for_exact_ones(op), jnp.float32)
    res = gmres(op.mv, b, restart=30, maxiter=300, rtol=1e-3)
    assert bool(res.converged)
    rnorm = float(jnp.linalg.norm(b - op.mv(res.x)))
    assert rnorm <= 1.01e-3 * float(jnp.linalg.norm(b))


class TestMaxiterZero:
    def test_gmres_maxiter_zero_noop(self):
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

        op = poisson.poisson2d(8, 8)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        for fixed in (False, True):
            res = gmres(op.mv, b, restart=30, maxiter=0, fixed_cycles=fixed)
            assert int(res.iters) == 0
            assert not bool(res.converged)


class TestDivergence:
    def test_divtol_stops_without_false_convergence(self):
        # restarted GMRES has monotone residuals on linear operators, so
        # a real explosion needs a broken recurrence (e.g. nonfinite
        # matvec in production).  Exercise the cutoff mechanically with a
        # sub-1 divtol: the residual trivially exceeds divtol*rnorm0, the
        # loop must stop immediately and NOT report convergence.
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

        op = poisson.poisson2d(16, 16)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        res = gmres(op.mv, b, restart=30, maxiter=10000, rtol=1e-12,
                    divtol=0.5)
        # stops at the first cycle boundary (divergence is checked on the
        # recomputed true residual at each restart), far below the budget
        assert int(res.iters) <= 30
        assert not bool(res.converged)

    def test_cg_divtol_stops_without_false_convergence(self):
        # same mechanical exercise as the GMRES case: a sub-1 divtol
        # makes the initial residual already "diverged" — the loop must
        # stop immediately and NOT report convergence
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import cg

        op = poisson.poisson2d(16, 16)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        res = cg(op.mv, b, rtol=1e-12, maxiter=10000, divtol=0.5)
        assert int(res.iters) == 0
        assert not bool(res.converged)
        # disabled cutoff keeps the normal behavior
        res2 = cg(op.mv, b, rtol=1e-8, maxiter=500, divtol=0.0)
        assert bool(res2.converged)

    def test_divtol_disabled(self):
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

        op = poisson.poisson2d(16, 16)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        res = gmres(op.mv, b, restart=30, maxiter=500, rtol=1e-8, divtol=0.0)
        assert bool(res.converged)


class TestCAGMRES:
    def test_matches_gmres_restart_counts(self):
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
            ca_gmres,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
        )

        m = n = 32
        op = poisson.poisson2d(m, n)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        lmin, lmax = poisson_strip_eig_bounds_2d(m, n)
        rc = ca_gmres(op.mv, b, s=8, maxiter=20000, rtol=1e-6,
                      lmin=lmin, lmax=lmax)
        rg = gmres(op.mv, b, restart=8, maxiter=20000, rtol=1e-6)
        assert bool(rc.converged)
        # same Krylov subspace per cycle -> iteration counts agree to
        # within one restart cycle
        assert abs(int(rc.iters) - int(rg.iters)) <= 8
        rel = float(jnp.linalg.norm(b - op.mv(rc.x)) / rc.resnorm0)
        assert rel <= 1.5e-6

    def test_monomial_small_s(self):
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
            ca_gmres,
        )

        op = poisson.poisson2d(16, 16)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        res = ca_gmres(op.mv, b, s=4, maxiter=10000, rtol=1e-6)
        assert bool(res.converged)

    def test_leja_shifts_cover_interval(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
            chebyshev_shifts,
        )

        sh = chebyshev_shifts(0.1, 7.9, 8)
        assert len(sh) == 8
        assert all(0.1 <= p <= 7.9 for p in sh)
        assert len(set(round(p, 12) for p in sh)) == 8  # distinct


class TestCaGmresSingleF32:
    def test_scaled_single_cycle_f32(self):
        """The one-collective CA cycle must stay finite and accurate in
        f32 at moderate s: capacity-scaled Newton columns keep the Gram
        in range (unscaled overflowed by s=10), and the Gram matmul runs
        at precision='highest' (reduced-precision operands NaN'd at s=6)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
            ca_gmres,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
        )

        op = poisson.poisson2d(24, 24)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float32)
        lmin, lmax = poisson_strip_eig_bounds_2d(24, 24, 4.0, -1.0)
        for s in (4, 6, 8):
            res = ca_gmres(
                op.mv, b, s=s, maxiter=600, rtol=1e-4,
                lmin=lmin, lmax=lmax, reductions="single",
            )
            assert bool(jnp.isfinite(res.x).all()), f"s={s} not finite"
            r = b - op.mv(res.x)
            rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b))
            assert rel <= 5e-4, f"s={s} rel={rel}"

    def test_ill_conditioned_f32_stalls_finite(self):
        """Beyond f32's kappa^2 budget the one-collective cycle must end
        finite and honestly unconverged (frozen iterate, iters run to
        maxiter) — not NaN-poisoned or looping forever."""
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
            ca_gmres,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
        )

        op = poisson.poisson2d(128, 128)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float32)
        lmin, lmax = poisson_strip_eig_bounds_2d(128, 128, 4.0, -1.0)
        res = ca_gmres(op.mv, b, s=16, maxiter=160, rtol=1e-6,
                       lmin=lmin, lmax=lmax, reductions="single")
        assert bool(jnp.isfinite(res.x).all())
        assert not bool(res.converged)
        assert int(res.iters) == 160


class TestBiCGStab:
    """BiCGStab (PETSc KSPBCGS analog): nonsymmetric short-recurrence
    solver — O(1) memory vs GMRES's restart basis."""

    def _nonsym(self, n=200, seed=5):
        import scipy.sparse as sp

        rng = np.random.default_rng(seed)
        A = sp.random(n, n, density=0.03, random_state=seed).tocsr()
        A = A + sp.eye(n) * 8.0   # diagonally dominant, nonsymmetric
        return A

    def test_matches_direct_solution(self):
        import scipy.sparse.linalg as spla

        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
            bicgstab,
        )

        A = self._nonsym()
        n = A.shape[0]
        b = np.asarray(A @ np.ones(n))
        Ad = jnp.asarray(A.todense())
        res = bicgstab(lambda v: Ad @ v, jnp.asarray(b), maxiter=600,
                       rtol=1e-10)
        assert bool(res.converged)
        x = np.asarray(res.x)
        np.testing.assert_allclose(x, spla.spsolve(A.tocsc(), b),
                                   rtol=1e-7, atol=1e-9)
        # true residual honors the tolerance (small recurrence drift ok)
        rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        assert rel <= 5e-10

    def test_right_precond_fewer_matvecs(self):
        import scipy.sparse as sp

        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
            bicgstab,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
            block_jacobi_from_scipy,
        )

        rng = np.random.default_rng(31)
        nb, bs = 8, 16
        n = nb * bs
        A = sp.lil_matrix((n, n))
        for k in range(nb):
            Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
            lam = np.logspace(0, 3, bs)
            A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = (Q * lam) @ Q.T
        C = sp.random(n, n, density=0.02, random_state=32)
        A = (A.tocsr() + 1e-2 * C).tocsr()   # nonsymmetric coupling
        b = np.asarray(A @ np.ones(n))
        Ad = jnp.asarray(A.todense())
        bj = jnp.asarray(b)
        plain = bicgstab(lambda v: Ad @ v, bj, maxiter=2000, rtol=1e-8)
        M = block_jacobi_from_scipy(A, bs=16, dtype=jnp.float64)
        pre = bicgstab(lambda v: Ad @ v, bj, maxiter=2000, rtol=1e-8,
                       precond=M.apply)
        assert bool(pre.converged)
        np.testing.assert_allclose(np.asarray(pre.x), 1.0, rtol=1e-5)
        assert int(pre.iters) < int(plain.iters) / 3

    def test_warm_start(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
            bicgstab,
        )

        op = poisson.poisson2d(24, 24)
        b = poisson.rhs_for_exact_ones(op)
        half = bicgstab(op.mv, b.reshape(-1), maxiter=30, rtol=1e-12)
        res = bicgstab(op.mv, b.reshape(-1), half.x, maxiter=2000,
                       rtol=1e-10)
        assert bool(res.converged)
        assert int(res.iters) < 2000

    def test_indefinite_reports_not_converged(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
            bicgstab,
        )

        # indefinite diagonal: BiCGStab may break down / diverge — the
        # result must stay finite and honestly NOT converged
        d = jnp.asarray(np.where(np.arange(64) % 2, 1.0, -1.0))
        res = bicgstab(lambda v: d * v, jnp.ones(64), maxiter=100,
                       rtol=1e-12)
        assert bool(jnp.isfinite(res.x).all())
        # (a diagonal +-1 system CAN be solved by chance symmetry—just
        # require finite + honest flagging)
        if not bool(res.converged):
            assert float(res.resnorm) > 0

    def test_sharded_general_bicgstab(self):
        import scipy.sparse as sp

        from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
            mesh as meshmod,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel.general import (
            shard_general_from_coo,
            sharded_general_solve,
        )

        A = self._nonsym(n=256, seed=9)
        coo = A.tocoo()
        gop = shard_general_from_coo(coo.row, coo.col, coo.data,
                                     A.shape[0], 8, dtype=jnp.float64)
        mesh = meshmod.make_mesh(nblocks=2, intra=4)
        b = jnp.asarray(np.asarray(A @ np.ones(A.shape[0])))
        res = sharded_general_solve(mesh, gop, b, method="bicgstab",
                                    rtol=1e-9, maxiter=2000)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), 1.0, rtol=1e-6)


class TestMinres:
    """MINRES (PETSc KSPMINRES analog): symmetric INDEFINITE systems —
    the class CG's recurrence breaks on and GMRES pays O(m·n) basis
    traffic for.  Paige-Saunders Lanczos + Givens, one matvec and two
    reductions per iteration."""

    def _sym_indefinite(self, n=200, neg=40, seed=11):
        rng = np.random.default_rng(seed)
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        d = np.concatenate([np.linspace(1.0, 10.0, n - neg),
                            -np.linspace(1.0, 5.0, neg)])
        return (Q * d) @ Q.T

    def test_indefinite_matches_direct_solution(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        A = self._sym_indefinite()
        n = A.shape[0]
        b = np.asarray(A @ np.ones(n))
        Ad = jnp.asarray(A)
        res = minres(lambda v: Ad @ v, jnp.asarray(b), maxiter=2000,
                     rtol=1e-11)
        assert bool(res.converged)
        x = np.asarray(res.x)
        np.testing.assert_allclose(x, 1.0, rtol=1e-7, atol=1e-9)
        # the recurrence estimate tracks the TRUE residual
        rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
        assert rel <= 2e-11
        assert abs(float(res.resnorm) / np.linalg.norm(b) - rel) <= 1e-12

    def test_spd_iteration_parity_with_cg(self, poisson_8x8):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        op, dense, b, x_exact = poisson_8x8
        rm = minres(op.mv, b, maxiter=500, rtol=1e-10)
        rc = cg(op.mv, b, maxiter=500, rtol=1e-10)
        assert bool(rm.converged)
        np.testing.assert_allclose(np.asarray(rm.x), x_exact, rtol=1e-7,
                                   atol=1e-9)
        # on SPD problems MINRES and CG explore the same Krylov space:
        # counts match within a couple of steps
        assert abs(int(rm.iters) - int(rc.iters)) <= 3

    def test_scipy_iteration_anchor(self):
        """External anchor (VERDICT r2 #3 policy): iterations to a MATCHED
        true-residual level within ±10% of scipy.sparse.linalg.minres.
        (Raw rtol-for-rtol counts are not comparable: scipy's default
        stopping rule is ``rtol * ||A|| * ||x||``, not ``rtol * ||r0||``,
        so it exits at a different achieved residual — the anchor is the
        iteration where scipy's TRUE residual first crosses our target.)"""
        import scipy.sparse.linalg as spla

        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        A = self._sym_indefinite(seed=12)
        b = np.asarray(A @ np.ones(A.shape[0]))
        bn = np.linalg.norm(b)
        rtol = 1e-9
        Ad = jnp.asarray(A)
        res = minres(lambda v: Ad @ v, jnp.asarray(b), maxiter=2000,
                     rtol=rtol)
        rels = []
        spla.minres(A, b, rtol=1e-13, maxiter=2000,
                    callback=lambda xk: rels.append(
                        np.linalg.norm(b - A @ xk) / bn))
        crossing = 1 + next(i for i, r in enumerate(rels) if r <= rtol)
        assert bool(res.converged)
        assert abs(int(res.iters) - crossing) <= max(3, 0.1 * crossing)

    def test_spd_precond_cuts_iterations(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        rng = np.random.default_rng(13)
        n = 200
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        d = np.linspace(1.0, 50.0, n)
        A = (Q * d) @ Q.T + np.diag(np.linspace(1.0, 1000.0, n))
        b = rng.standard_normal(n)
        Ad, bj = jnp.asarray(A), jnp.asarray(b)
        Minv = jnp.asarray(1.0 / np.diag(A))
        plain = minres(lambda v: Ad @ v, bj, maxiter=2000, rtol=1e-10)
        pre = minres(lambda v: Ad @ v, bj, maxiter=2000, rtol=1e-10,
                     precond=lambda v: Minv * v)
        assert bool(pre.converged)
        # preconditioned test is the M-norm — check the true residual too
        rel = np.linalg.norm(b - A @ np.asarray(pre.x)) / np.linalg.norm(b)
        assert rel <= 1e-8
        assert int(pre.iters) < int(plain.iters) / 2

    def test_indefinite_precond_reports_not_converged(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        # an INDEFINITE M invalidates the Lanczos inner product: the
        # breakdown guard must freeze (finite result, honestly not
        # converged) rather than report a false convergence via beta=0
        d = jnp.asarray(np.where(np.arange(64) % 2, 1.0, -1.0))
        A = jnp.eye(64) * 2.0
        res = minres(lambda v: A @ v, jnp.ones(64), maxiter=100,
                     rtol=1e-12, precond=lambda v: d * v)
        assert np.isfinite(np.asarray(res.x)).all()
        assert not bool(res.converged)

    def test_warm_start(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        op = poisson.poisson2d(24, 24)
        b = poisson.rhs_for_exact_ones(op)
        half = minres(op.mv, b.reshape(-1), maxiter=30, rtol=1e-12)
        res = minres(op.mv, b.reshape(-1), half.x, maxiter=2000,
                     rtol=1e-10)
        assert bool(res.converged)
        assert int(res.iters) < int(minres(op.mv, b.reshape(-1),
                                           maxiter=2000, rtol=1e-10).iters)

    def test_zero_rhs_immediate(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import minres

        res = minres(lambda v: 2.0 * v, jnp.zeros(32), maxiter=10,
                     rtol=1e-10)
        assert bool(res.converged)
        assert int(res.iters) == 0
        np.testing.assert_array_equal(np.asarray(res.x), 0.0)
