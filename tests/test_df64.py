"""Double-float (two-f32) residual arithmetic — solvers/df64.py.

These tests pin the error-free-transformation precision (~2^-48) against
exact numpy f64, which also guards against any future XLA fast-math /
reassociation flag silently breaking the compensated sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import cg, df64, mg_preconditioner
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
    df_iterative_refinement,
    stencil2d_mv_np,
    stencil3d_mv_np,
)


class TestPrimitives:
    def test_two_sum_exact(self):
        a = jnp.float32(1.0)
        b = jnp.float32(1e-7)
        s, e = df64.two_sum(a, b)
        # s + e == a + b exactly in f64
        assert float(s) + float(e) == float(a) + float(b)

    def test_split_roundtrip(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal(1000) * 10.0
        hi, lo = df64.df_from_f64(x)
        back = df64.df_to_f64((hi, lo))
        np.testing.assert_allclose(back, x, rtol=0, atol=1e-13)
        # lo really carries the sub-f32 tail
        assert np.max(np.abs(np.asarray(lo))) > 0

    def test_df_add_precision(self):
        rng = np.random.default_rng(1)
        a64 = rng.standard_normal(4096)
        b64 = rng.standard_normal(4096)
        a = df64.df_from_f64(a64)
        b = df64.df_from_f64(b64)
        s = df64.df_to_f64(df64.df_add(a, b))
        np.testing.assert_allclose(s, a64 + b64, rtol=1e-12, atol=5e-15)

    def test_df_mul_f32(self):
        rng = np.random.default_rng(2)
        a64 = rng.standard_normal(4096)
        s32 = np.float32(3.14159)
        a = df64.df_from_f64(a64)
        p = df64.df_to_f64(df64.df_mul_f32(a, jnp.float32(s32)))
        np.testing.assert_allclose(p, a64 * np.float64(s32), rtol=1e-13)


@pytest.mark.parametrize("dims,diag", [((33, 47), 4.0), ((12, 15, 17), 6.0)])
class TestDFResidual:
    def test_matches_f64_residual(self, dims, diag):
        """df residual == exact f64 residual to ~1e-13 relative, even when
        the residual is tiny (cancellation regime)."""
        maker = poisson.poisson2d if len(dims) == 2 else poisson.poisson3d
        op = maker(*dims)
        mv_np = (
            stencil2d_mv_np(*dims) if len(dims) == 2
            else stencil3d_mv_np(*dims)
        )
        rng = np.random.default_rng(3)
        # near-solution x so r = b - A x is ~1e-7 of b (worst case for f32)
        xstar = rng.standard_normal(int(np.prod(dims)))
        b64 = mv_np(xstar)
        x64 = xstar * (1.0 + 1e-7 * rng.standard_normal(xstar.shape))
        r_exact = b64 - mv_np(x64)

        residual = df64.df_residual_for(op)
        b = df64.df_from_f64(b64.reshape(dims))
        x = df64.df_from_f64(x64.reshape(dims))
        rhi, rlo = residual(b, x)
        r_df = df64.df_to_f64((rhi, rlo)).reshape(-1)
        scale = np.linalg.norm(b64)
        assert np.max(np.abs(r_df - r_exact)) < 1e-13 * scale


class TestDFRefinement:
    @pytest.mark.parametrize("dims", [(64, 64), (32, 32, 32)])
    def test_reaches_1e12(self, dims):
        """f32 MG-PCG solves + df residuals drive the true f64 relative
        residual below 1e-12 — past the 1e-8 north-star, no device f64."""
        maker = poisson.poisson2d if len(dims) == 2 else poisson.poisson3d
        op = maker(*dims)
        mv_np = (
            stencil2d_mv_np(*dims) if len(dims) == 2
            else stencil3d_mv_np(*dims)
        )
        b64 = mv_np(np.ones(int(np.prod(dims)))).reshape(dims)
        M = mg_preconditioner(op)

        def solve_f32(r32):
            return cg(
                op.mv, r32.astype(jnp.float32), maxiter=40, rtol=1e-5,
                precond=M,
            ).x.astype(jnp.float32)

        res = df_iterative_refinement(op, b64, solve_f32, rtol=1e-12)
        assert res.converged
        # independent exact check in f64
        r = b64.reshape(-1) - mv_np(res.x.reshape(-1))
        rel = np.linalg.norm(r) / np.linalg.norm(b64)
        assert rel <= 5e-12
        assert np.max(np.abs(res.x - 1.0)) < 1e-10

    def test_monotone_history(self):
        op = poisson.poisson2d(32, 32)
        mv_np = stencil2d_mv_np(32, 32)
        b64 = mv_np(np.ones(1024)).reshape(32, 32)
        M = mg_preconditioner(op)

        def solve_f32(r32):
            return cg(
                op.mv, r32.astype(jnp.float32), maxiter=40, rtol=1e-5,
                precond=M,
            ).x.astype(jnp.float32)

        res = df_iterative_refinement(op, b64, solve_f32, rtol=1e-12)
        assert all(
            b < a for a, b in zip(res.rel_history, res.rel_history[1:])
        )
