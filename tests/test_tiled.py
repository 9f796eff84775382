"""Tests for the 2D-tiled sharded path (mesh ('block','ir','ic'))."""

import jax.numpy as jnp
import numpy as np
import pytest

from medane_tchakorom_ufc_thesis_repository_tpu.models import (
    blockops,
    multisplitting as ms,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
    make_tiled_mesh,
    tiled_multisplit_solve,
)


@pytest.fixture(scope="module")
def mesh222():
    return make_tiled_mesh(2, 2, 2)


def _setup(m=32, n=32):
    sop = blockops.block_poisson2d(m, n)
    b = blockops.rhs_ones(sop, jnp.float64).reshape(m, n)
    return sop, b


class TestTiledGmres:
    def test_matches_single_device_iterations(self, mesh222):
        """Whole-mesh GMRES on the 2-D-tiled mesh: identical iteration
        counts to single-device GMRES (same math, 2-D tiled layout)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
            tiled_gmres_solve,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

        m = n = 32
        op = poisson.poisson2d(m, n)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        ref = gmres(op.mv, b, restart=30, maxiter=2000, rtol=1e-6)
        res = tiled_gmres_solve(
            mesh222, m, n, b.reshape(m, n), restart=30, maxiter=2000,
            rtol=1e-6,
        )
        assert int(res.iters) == int(ref.iters)
        assert bool(res.converged)
        r = b - op.mv(res.x.reshape(-1))
        assert float(jnp.linalg.norm(r) / jnp.linalg.norm(b)) <= 1e-6


def _true_rel(sop, b, x):
    r = b.reshape(-1) - sop.global_mv(x.reshape(-1))
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b.reshape(-1)))


class TestTiled:
    def test_sm_matches_stacked(self, mesh222):
        sop, b = _setup()
        res = tiled_multisplit_solve(mesh222, 32, 32, b, rtol=1e-3,
                                     maxiter=2000)
        st = ms.sm(sop, blockops.rhs_ones(sop, jnp.float64), rtol=1e-3,
                   maxiter=2000)
        assert int(res.sweeps) == int(st.sweeps)
        assert bool(res.converged)
        assert _true_rel(sop, b, res.x) <= 1e-3
        np.testing.assert_allclose(
            np.asarray(res.x.reshape(-1)), np.asarray(st.x.reshape(-1)),
            rtol=1e-5, atol=1e-5,
        )

    @pytest.mark.parametrize("scope", ["local", "semi_local", "global"])
    def test_minimization_scopes(self, mesh222, scope):
        sop, b = _setup()
        res = tiled_multisplit_solve(
            mesh222, 32, 32, b, minimization=scope, s=4, rtol=1e-3,
            maxiter=2000,
        )
        assert bool(res.converged)
        assert _true_rel(sop, b, res.x) <= 1.5e-3

    def test_async(self, mesh222):
        sop, b = _setup()
        res = tiled_multisplit_solve(
            mesh222, 32, 32, b, schedule="async", staleness=2, rtol=1e-3,
            maxiter=4000,
        )
        assert bool(res.converged)
        assert _true_rel(sop, b, res.x) <= 1.5e-3

    def test_column_only_tiling(self):
        # degenerate pr=1: tiles split columns only
        mesh = make_tiled_mesh(2, 1, 4)
        sop, b = _setup()
        res = tiled_multisplit_solve(mesh, 32, 32, b, rtol=1e-3, maxiter=2000)
        assert bool(res.converged)
        assert _true_rel(sop, b, res.x) <= 1e-3

    def test_indivisible_rejected(self, mesh222):
        _, b = _setup()
        with pytest.raises(ValueError):
            tiled_multisplit_solve(mesh222, 30, 32, b[:30], rtol=1e-3)

    def test_ca_gmres_inner_dispatched(self, mesh222):
        """Regression: inner method='ca_gmres' must be honestly
        dispatched (it used to fall into the GMRES else-branch and run a
        different algorithm than configured).  Pin the dispatch via its
        distinct composition rule: ca_gmres + pc raises, where the old
        silent-GMRES path would happily run jacobi-preconditioned."""
        from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
            InnerConfig,
        )

        sop, b = _setup()
        with pytest.raises(ValueError, match="does not compose with pc"):
            tiled_multisplit_solve(
                mesh222, 32, 32, b, rtol=1e-3,
                inner=InnerConfig(method="ca_gmres", pc="jacobi"),
            )
        res = tiled_multisplit_solve(
            mesh222, 32, 32, b, rtol=1e-3, maxiter=2000,
            inner=InnerConfig(method="ca_gmres", restart=8, maxiter=16),
        )
        assert bool(res.converged)
        assert _true_rel(sop, b, res.x) <= 1e-3


class TestTiled3D:
    def test_3d_matches_stacked(self, mesh222):
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
            tiled_multisplit_solve_3d,
        )

        sop = blockops.block_poisson3d(16, 8, 8)
        b = blockops.rhs_ones(sop, jnp.float64).reshape(16, 8, 8)
        res = tiled_multisplit_solve_3d(mesh222, 16, 8, 8, b, rtol=1e-3,
                                        maxiter=2000)
        st = ms.sm(sop, blockops.rhs_ones(sop, jnp.float64), rtol=1e-3,
                   maxiter=2000)
        assert int(res.sweeps) == int(st.sweeps)
        assert bool(res.converged)
        r = b.reshape(-1) - sop.global_mv(res.x.reshape(-1))
        assert float(jnp.linalg.norm(r) / jnp.linalg.norm(b.reshape(-1))) <= 1e-3

    def test_3d_minimization(self, mesh222):
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
            tiled_multisplit_solve_3d,
        )

        sop = blockops.block_poisson3d(16, 8, 8)
        b = blockops.rhs_ones(sop, jnp.float64).reshape(16, 8, 8)
        res = tiled_multisplit_solve_3d(
            mesh222, 16, 8, 8, b, minimization="global", s=4, rtol=1e-3,
            maxiter=2000,
        )
        assert bool(res.converged)

    def test_3d_async(self, mesh222):
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
            tiled_multisplit_solve_3d,
        )

        sop = blockops.block_poisson3d(16, 8, 8)
        b = blockops.rhs_ones(sop, jnp.float64).reshape(16, 8, 8)
        res = tiled_multisplit_solve_3d(
            mesh222, 16, 8, 8, b, schedule="async", staleness=2, rtol=1e-3,
            maxiter=4000,
        )
        assert bool(res.converged)
        r = b.reshape(-1) - sop.global_mv(res.x.reshape(-1))
        assert float(jnp.linalg.norm(r) / jnp.linalg.norm(b.reshape(-1))) <= 1.5e-3


class TestTiledGmres3D:
    def test_matches_single_device_iterations(self, mesh222):
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
            tiled_gmres_solve_3d,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

        op = poisson.poisson3d(16, 8, 8)
        b = poisson.rhs_for_exact_ones(op).astype(jnp.float64)
        ref = gmres(op.mv, b, restart=30, maxiter=2000, rtol=1e-6)
        res = tiled_gmres_solve_3d(
            mesh222, 16, 8, 8, b.reshape(16, 8, 8), restart=30,
            maxiter=2000, rtol=1e-6,
        )
        assert int(res.iters) == int(ref.iters)
        r = b - op.mv(res.x.reshape(-1))
        assert float(jnp.linalg.norm(r) / jnp.linalg.norm(b)) <= 1e-6
