"""AIJ (Clos-routed general-sparse) operator tests.

Capability match: PETSc MatAIJ assembly + MatMult/MatMultTranspose
(reference ``src/utils/utils.c:139-155``) — ANY pattern, any size,
square or rectangular, without the gather-ELL compile/throughput wall.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators
from medane_tchakorom_ufc_thesis_repository_tpu.ops import (
    aij_pack,
    clos_route,
)


def _random_coo(rng, n, ncols, nnz):
    rows = rng.randint(0, n, nnz)
    cols = rng.randint(0, ncols, nnz)
    vals = rng.randn(nnz)
    return rows, cols, vals


def _dense(rows, cols, vals, shape):
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    return a


class TestClosRouting:
    def test_edge_color_proper(self):
        rng = np.random.RandomState(0)
        for nl, delta in [(16, 8), (64, 32), (256, 128)]:
            src = np.tile(np.arange(nl), delta)
            dst = np.concatenate(
                [rng.permutation(nl) for _ in range(delta)])
            col = clos_route.edge_color(src, dst, nl, nl, delta)
            a = np.zeros((nl, delta), int)
            np.add.at(a, (src, col), 1)
            b = np.zeros((nl, delta), int)
            np.add.at(b, (dst, col), 1)
            assert a.max() == 1 and b.max() == 1

    def test_edge_color_python_fallback(self, monkeypatch):
        from medane_tchakorom_ufc_thesis_repository_tpu import native

        monkeypatch.setattr(native, "clos_available", lambda: False)
        rng = np.random.RandomState(1)
        src = np.tile(np.arange(32), 8)
        dst = np.concatenate([rng.permutation(32) for _ in range(8)])
        col = clos_route.edge_color(src, dst, 32, 32, 8)
        a = np.zeros((32, 8), int)
        np.add.at(a, (src, col), 1)
        assert a.max() == 1

    def test_block_perm_round_trip(self):
        rng = np.random.RandomState(2)
        for _ in range(3):
            perm = rng.permutation(1024)
            cA1, cB, cA2 = clos_route.block_perm_indices(
                np.arange(1024), perm)
            blk = rng.rand(8, 128).astype(np.float32)
            out = clos_route.apply_block_perm_np(blk, cA1, cB, cA2)
            want = np.zeros(1024, np.float32)
            want[perm] = blk.reshape(-1)
            np.testing.assert_array_equal(out.reshape(-1), want)


class TestAIJPackNumpy:
    """Numpy bit-reference of the routed pipeline vs a dense matmul."""

    @pytest.mark.parametrize("n,ncols,nnz", [
        (100, 100, 300),          # tiny, pads dominate
        (1024, 1024, 5000),       # exactly one tile
        (5000, 5000, 40000),      # several tiles/chunks
        (3000, 7000, 20000),      # rectangular
        (2500, 300, 8000),        # wide-to-narrow
    ])
    def test_mv_matches_dense(self, n, ncols, nnz):
        rng = np.random.RandomState(n + nnz)
        rows, cols, vals = _random_coo(rng, n, ncols, nnz)
        plan = aij_pack.pack_aij(rows, cols, vals, (n, ncols))
        x = rng.randn(ncols).astype(np.float32)
        y = aij_pack.aij_mv_np(plan, x)
        want = _dense(rows, cols, vals, (n, ncols)).astype(np.float32) @ x
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)

    def test_multi_segment(self):
        rng = np.random.RandomState(7)
        rows, cols, vals = _random_coo(rng, 6000, 6000, 60000)
        plan = aij_pack.pack_aij(rows, cols, vals, (6000, 6000),
                                 target_nnz=9000)
        assert len(plan.segments) >= 4
        x = rng.randn(6000).astype(np.float32)
        y = aij_pack.aij_mv_np(plan, x)
        want = _dense(rows, cols, vals, (6000, 6000)).astype(
            np.float32) @ x
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)

    def test_duplicate_heavy_column_spills_not_fails(self):
        """Many rows hitting one column stresses the K1 placement
        constraint (same lane, mixed sublanes + duplicates)."""
        rng = np.random.RandomState(8)
        nnz = 20000
        rows = rng.randint(0, 2048, nnz)
        cols = np.where(rng.rand(nnz) < 0.5, 7,
                        rng.randint(0, 2048, nnz))
        vals = rng.randn(nnz)
        plan = aij_pack.pack_aij(rows, cols, vals, (2048, 2048))
        x = rng.randn(2048).astype(np.float32)
        y = aij_pack.aij_mv_np(plan, x)
        want = _dense(rows, cols, vals, (2048, 2048)).astype(
            np.float32) @ x
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)

    def test_duplicate_entries_summed(self):
        rows = np.array([0, 0, 1, 5])
        cols = np.array([3, 3, 2, 5])
        vals = np.array([1.0, 2.0, 4.0, -1.0])
        plan = aij_pack.pack_aij(rows, cols, vals, (8, 8))
        x = np.arange(8, dtype=np.float32)
        y = aij_pack.aij_mv_np(plan, x)
        want = _dense(rows, cols, vals, (8, 8)).astype(np.float32) @ x
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)

    def test_empty_rows_and_empty_matrix(self):
        plan = aij_pack.pack_aij(np.array([500]), np.array([900]),
                                 np.array([2.0]), (2000, 2000))
        x = np.ones(2000, np.float32)
        y = aij_pack.aij_mv_np(plan, x)
        want = np.zeros(2000)
        want[500] = 2.0
        np.testing.assert_allclose(y, want, atol=1e-6)
        plan0 = aij_pack.pack_aij(np.zeros(0, int), np.zeros(0, int),
                                  np.zeros(0), (64, 64))
        y0 = aij_pack.aij_mv_np(plan0, np.ones(64, np.float32))
        np.testing.assert_allclose(y0, np.zeros(64))


class TestAIJOperator:
    def test_jnp_path_matches_dense(self):
        rng = np.random.RandomState(11)
        rows, cols, vals = _random_coo(rng, 3000, 3000, 30000)
        op = operators.AIJ.from_coo(rows, cols, vals, (3000, 3000))
        assert op.shape == (3000, 3000)
        assert op.nnz == len(np.unique(rows * 3000 + cols))
        x = jnp.asarray(rng.randn(3000), jnp.float32)
        y = np.asarray(op.mv(x))
        want = _dense(rows, cols, vals, (3000, 3000)).astype(
            np.float32) @ np.asarray(x)
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-4)

    def test_rmv_matches_dense_transpose(self):
        rng = np.random.RandomState(12)
        rows, cols, vals = _random_coo(rng, 2000, 1500, 12000)
        op = operators.AIJ.from_coo(rows, cols, vals, (2000, 1500))
        y = jnp.asarray(rng.randn(2000), jnp.float32)
        out = np.asarray(op.rmv(y))
        want = _dense(rows, cols, vals, (2000, 1500)).astype(
            np.float32).T @ np.asarray(y)
        np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)

    def test_jit_and_pytree(self):
        rng = np.random.RandomState(13)
        rows, cols, vals = _random_coo(rng, 1500, 1500, 9000)
        op = operators.AIJ.from_coo(rows, cols, vals, (1500, 1500),
                                    with_rmv=False)
        x = jnp.asarray(rng.randn(1500), jnp.float32)
        y1 = np.asarray(op.mv(x))
        y2 = np.asarray(jax.jit(lambda o, v: o.mv(v))(op, x))
        np.testing.assert_allclose(y1, y2, rtol=1e-6, atol=1e-6)


class TestAIJJnpApply:
    """The routed gather program's plain-jnp apply (the only AIJ apply)
    against the numpy bit-reference and a dense product, under ``jit``."""

    def test_apply_matches_numpy_reference(self):
        rng = np.random.RandomState(21)
        rows, cols, vals = _random_coo(rng, 2500, 2500, 20000)
        plan = aij_pack.pack_aij(rows, cols, vals, (2500, 2500))
        op = operators.AIJ.from_coo(rows, cols, vals, (2500, 2500),
                                    with_rmv=False)
        x = rng.randn(2500).astype(np.float32)
        want = aij_pack.aij_mv_np(plan, x)
        got = np.asarray(jax.jit(lambda o, v: o.mv(v))(op, jnp.asarray(x)))
        np.testing.assert_allclose(got, want.astype(np.float32),
                                   rtol=1e-5, atol=1e-5)

    def test_apply_multi_segment(self):
        rng = np.random.RandomState(22)
        rows, cols, vals = _random_coo(rng, 4000, 4000, 24000)
        op = operators.AIJ.from_coo(rows, cols, vals, (4000, 4000),
                                    with_rmv=False, target_nnz=7000)
        assert len(op.segments) >= 3
        x = rng.randn(4000).astype(np.float32)
        want = _dense(rows, cols, vals, (4000, 4000)).astype(
            np.float32) @ x
        got = np.asarray(jax.jit(lambda o, v: o.mv(v))(op, jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestAIJSolves:
    def test_solve_api_routes_structureless_to_aij(self):
        """The whole user journey on a structureless matrix: scipy in,
        AIJ routing, KSP solve — warning-free (the round-4 gather-ELL
        warn branch is retired)."""
        import warnings

        import scipy.sparse as sp

        from medane_tchakorom_ufc_thesis_repository_tpu import solve

        n = 6000   # above the dense cutoff (max_dense_n=4096)
        B = sp.random(n, n, density=0.0008, random_state=1)
        A = (B + B.T) * 0.5
        A = A + sp.eye(n) * (abs(A).sum(axis=1).max() + 1.0)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            x, info = solve(A.tocsr(), np.ones(n), rtol=1e-6,
                            method="gmres", pc="jacobi")
        assert info["operator"] == "AIJ"
        assert info["converged"]
        rel = (np.linalg.norm(A @ np.asarray(x) - 1.0)
               / np.linalg.norm(np.ones(n)))
        assert rel <= 2e-6, rel

    def test_gmres_on_aij_random_spd(self):
        """End-to-end: GMRES on an AIJ-wrapped SPD matrix converges to
        the dense solution (the reference's gmres_solution driver on a
        user matrix)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
            gmres,
        )

        rng = np.random.RandomState(31)
        n, nnz = 1200, 6000
        rows, cols, vals = _random_coo(rng, n, n, nnz)
        # SPD-ify: A = B + B^T + diag shift
        dense = _dense(rows, cols, vals, (n, n))
        dense = dense + dense.T
        dense += np.eye(n) * (np.abs(dense).sum(1).max() + 1.0)
        r2, c2 = np.nonzero(dense)
        op = operators.AIJ.from_coo(r2, c2, dense[r2, c2], (n, n),
                                    with_rmv=False)
        x_true = rng.randn(n)
        b = jnp.asarray(dense @ x_true, jnp.float32)
        res = gmres(op.mv, b, restart=40, maxiter=400, rtol=1e-6)
        rel = float(jnp.linalg.norm(b - op.mv(res.x))
                    / jnp.linalg.norm(b))
        assert rel <= 2e-6, rel
