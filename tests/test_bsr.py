"""BSR (block-ELL) operator: scipy-verified correctness + routing.

The reference's ``create_matrix_sparse`` (``src/utils/utils.c:139-155``)
accepts ANY sparsity pattern; the elementwise-gather ELL path is the
slowest format, so ``as_device_operator`` routes banded → DIA and
blockable → BSR (dense sub-blocks, block-row gathers + batched sub-block
matvecs, transpose pack for ``rmv`` — no scatter-adds).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
    BSR,
    DIA,
    ELL,
    as_device_operator,
    bsr_block_fill_from_coo,
)


def _random_block_sparse(nb, bs, blocks_per_row, seed=0, spd=False):
    """Random block-sparse matrix: dense (bs, bs) blocks at random block
    positions — the natural BSR pattern (FEM multi-dof nodes)."""
    rng = np.random.default_rng(seed)
    n = nb * bs
    A = sp.lil_matrix((n, n))
    for r in range(nb):
        cols = rng.choice(nb, size=min(blocks_per_row, nb), replace=False)
        for c in cols:
            A[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs] = (
                rng.standard_normal((bs, bs))
            )
    A = A.tocsr()
    if spd:
        A = (A @ A.T).tocsr() + sp.eye(n) * n
    return A


def _to_coo(A):
    A = A.tocoo()
    return A.row, A.col, A.data, A.shape


class TestBsrCorrectness:
    @pytest.mark.parametrize("bs", [4, 8, 16])
    def test_mv_rmv_match_scipy(self, bs):
        A = _random_block_sparse(nb=12, bs=bs, blocks_per_row=3, seed=1)
        rows, cols, vals, shape = _to_coo(A)
        op = BSR.from_coo(rows, cols, vals, shape, bs=bs, dtype=jnp.float64)
        x = np.random.default_rng(2).standard_normal(shape[1])
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(x))), A.T @ x, rtol=1e-12
        )

    def test_block_size_not_dividing_n(self):
        # true n = 50, bs = 16 -> padded 64; mv/rmv pad+unpad correctly
        rng = np.random.default_rng(3)
        A = sp.random(50, 50, density=0.1, random_state=3).tocsr()
        rows, cols, vals, shape = _to_coo(A)
        op = BSR.from_coo(rows, cols, vals, shape, bs=16, dtype=jnp.float64)
        assert op.shape == (50, 50)
        x = rng.standard_normal(50)
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(x))), A.T @ x, rtol=1e-12
        )

    def test_rectangular(self):
        A = sp.random(40, 72, density=0.15, random_state=5).tocsr()
        rows, cols, vals, shape = _to_coo(A)
        op = BSR.from_coo(rows, cols, vals, shape, bs=8, dtype=jnp.float64)
        x = np.random.default_rng(6).standard_normal(72)
        y = np.random.default_rng(7).standard_normal(40)
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(y))), A.T @ y, rtol=1e-12
        )

    def test_duplicate_coo_entries_sum(self):
        rows = np.array([0, 0, 1, 5])
        cols = np.array([1, 1, 2, 5])
        vals = np.array([1.0, 2.0, 3.0, 4.0])
        op = BSR.from_coo(rows, cols, vals, (6, 6), bs=4, dtype=jnp.float64)
        d = np.asarray(op.to_dense())
        assert d[0, 1] == 3.0 and d[1, 2] == 3.0 and d[5, 5] == 4.0

    def test_permuted_poisson_mv(self):
        # randomly permuted Poisson: genuinely non-banded, scipy-verified
        rows, cols, vals, shape = poisson.poisson2d_coo(24, 24)
        n = shape[0]
        rng = np.random.default_rng(11)
        perm = rng.permutation(n)
        A = sp.csr_matrix((vals, (perm[rows], perm[cols])), shape=shape)
        rows2, cols2, vals2, _ = _to_coo(A)
        op = BSR.from_coo(rows2, cols2, vals2, shape, bs=16,
                          dtype=jnp.float64)
        x = rng.standard_normal(n)
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )

    def test_fill_estimator_matches_pack(self):
        A = _random_block_sparse(nb=6, bs=8, blocks_per_row=2, seed=9)
        rows, cols, vals, shape = _to_coo(A)
        est = bsr_block_fill_from_coo(rows, cols, shape, bs=8)
        op = BSR.from_coo(rows, cols, vals, shape, bs=8, dtype=jnp.float64)
        true_nnz = len(vals)
        stored = int(np.count_nonzero(
            np.asarray(op.values).reshape(op.indices.shape[0], -1)
            .any(axis=-1)
        ))
        # estimator counts stored blocks * bs^2 / nnz (no padding slots)
        nub = (sp.csr_matrix((np.ones_like(vals), (rows // 8, cols // 8)),
                             shape=(shape[0] // 8, shape[1] // 8)).nnz)
        assert est == pytest.approx(nub * 64 / true_nnz)

    def test_krylov_solve_via_bsr(self):
        # end-to-end: CG on a random block-sparse SPD matrix through BSR
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import cg

        A = _random_block_sparse(nb=8, bs=8, blocks_per_row=2, seed=13,
                                 spd=True)
        rows, cols, vals, shape = _to_coo(A)
        op = BSR.from_coo(rows, cols, vals, shape, bs=8, dtype=jnp.float64)
        xstar = np.ones(shape[0])
        b = A @ xstar
        res = cg(op.mv, jnp.asarray(b), rtol=1e-10, maxiter=500)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), xstar, atol=1e-7)

    def test_lsqr_via_bsr_rmv(self):
        # rmv (transpose pack) drives LSQR — the path that was a
        # scatter-add on gather-ELL
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import lsqr

        A = _random_block_sparse(nb=6, bs=8, blocks_per_row=2, seed=17,
                                 spd=True)
        rows, cols, vals, shape = _to_coo(A)
        op = BSR.from_coo(rows, cols, vals, shape, bs=8, dtype=jnp.float64)
        xstar = np.ones(shape[0])
        b = A @ xstar
        res = lsqr(op.mv, op.rmv, jnp.asarray(b), n=shape[1],
                   rtol=1e-10, maxiter=500)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), xstar, atol=1e-6)


class TestRouting:
    def test_banded_still_goes_dia(self):
        ell = poisson.poisson2d_ell(16, 16, dtype=jnp.float64)
        out = as_device_operator(ell)
        assert isinstance(out, DIA)

    def test_blockable_goes_bsr(self):
        A = _random_block_sparse(nb=4, bs=16, blocks_per_row=2, seed=21)
        rows, cols, vals, shape = _to_coo(A)
        ell = poisson.coo_to_ell(rows, cols, vals, shape,
                                 dtype=jnp.float64)
        out = as_device_operator(ell, max_diags=8,
                              bsr_block_sizes=(16,), max_bsr_cost=40.0)
        assert isinstance(out, BSR)
        x = np.random.default_rng(22).standard_normal(shape[1])
        np.testing.assert_allclose(
            np.asarray(out.mv(jnp.asarray(x))),
            np.asarray(ell.mv(jnp.asarray(x))), rtol=1e-12,
        )

    def test_unblockable_routes_aij(self):
        # neither banded nor blockable, dense route disabled, BSR pack
        # memory-capped: since round 5 this lands on the Clos-routed
        # AIJ (the "stay on gather-ELL and warn" branch is retired)
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (  # noqa: E501
            AIJ,
        )

        A = sp.random(256, 256, density=0.002, random_state=23).tocsr()
        A = A + sp.eye(256)
        rows, cols, vals, shape = _to_coo(A)
        ell = poisson.coo_to_ell(rows, cols, vals, shape,
                                 dtype=jnp.float64)
        out = as_device_operator(ell, max_diags=8, max_bsr_cost=4.0,
                              bsr_block_sizes=(128,), max_dense_n=0,
                              max_bsr_bytes=1024)
        assert isinstance(out, AIJ)
        x = np.random.default_rng(3).standard_normal(256)
        np.testing.assert_allclose(
            np.asarray(out.mv(jnp.asarray(x, jnp.float64))),
            A @ x, rtol=1e-10, atol=1e-10,
        )

    def test_highfill_bsr_vs_aij_bar(self, monkeypatch, tmp_path):
        # denser random pattern that fails max_bsr_cost: under the
        # round-5 measured AIJ bar (12x) the ~42x high-fill BSR LOSES
        # the last-resort comparison and the matrix routes to the
        # Clos-routed AIJ; with the bar raised (calibration override)
        # the high-fill BSR branch still fires with its warning
        from medane_tchakorom_ufc_thesis_repository_tpu.core import (
            calibration,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (  # noqa: E501
            AIJ,
        )

        A = sp.random(256, 256, density=0.02, random_state=23).tocsr()
        A = A + sp.eye(256)
        rows, cols, vals, shape = _to_coo(A)
        ell = poisson.coo_to_ell(rows, cols, vals, shape,
                                 dtype=jnp.float64)
        out = as_device_operator(ell, max_diags=8, max_bsr_cost=4.0,
                              bsr_block_sizes=(128,), max_dense_n=0)
        assert isinstance(out, AIJ)
        x = np.random.default_rng(25).standard_normal(256)
        np.testing.assert_allclose(
            np.asarray(out.mv(jnp.asarray(x, jnp.float64))), A @ x,
            rtol=1e-10, atol=1e-10,
        )

        path = tmp_path / "cal.json"
        monkeypatch.setenv("MEDANE_CALIBRATION", str(path))
        calibration.save({"aij_relative_cost": 1950.0})
        try:
            with pytest.warns(UserWarning, match="HIGH-fill BSR"):
                out2 = as_device_operator(
                    ell, max_diags=8, max_bsr_cost=4.0,
                    bsr_block_sizes=(128,), max_dense_n=0)
            assert isinstance(out2, BSR)
            np.testing.assert_allclose(
                np.asarray(out2.mv(jnp.asarray(x))), A @ x, rtol=1e-12
            )
        finally:
            calibration.reset_cache()

    def test_small_unstructured_routes_dense(self):
        # same pattern, dense route at the default cutoff: small
        # unstructured matrices go DenseOp
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            DenseOp,
        )

        A = sp.random(256, 256, density=0.02, random_state=23).tocsr()
        A = A + sp.eye(256)
        rows, cols, vals, shape = _to_coo(A)
        ell = poisson.coo_to_ell(rows, cols, vals, shape,
                                 dtype=jnp.float64)
        out = as_device_operator(ell, max_diags=8, max_bsr_cost=4.0,
                              bsr_block_sizes=(128,))
        assert isinstance(out, DenseOp)
        x = np.random.default_rng(24).standard_normal(256)
        np.testing.assert_allclose(
            np.asarray(out.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(out.rmv(jnp.asarray(x))), A.T @ x, rtol=1e-12
        )

    def test_dense_route_coalesces_coo_duplicates(self):
        # operator_from_coo must SUM duplicate (i, j) entries like
        # scipy / the reference's MatSetValues(ADD_VALUES)
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            DenseOp, operator_from_coo,
        )

        rows = np.array([0, 0, 1, 2, 0])
        cols = np.array([0, 1, 2, 0, 0])
        vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
        op = operator_from_coo(rows, cols, vals, (3, 3),
                               dtype=jnp.float64, max_diags=0,
                               max_bsr_cost=0.0)
        assert isinstance(op, DenseOp)
        expect = np.array([[6.0, 2.0, 0.0],
                           [0.0, 0.0, 3.0],
                           [4.0, 0.0, 0.0]])
        np.testing.assert_allclose(np.asarray(op.to_dense()), expect)

    def test_stacked_unbanded_warns(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.models import (
            blockops,
        )

        rows, cols, vals, shape = poisson.poisson2d_coo(12, 12)
        n = shape[0]
        perm = np.random.default_rng(29).permutation(n)
        a_ii, a_ic = poisson.block_split_ell(
            perm[rows], perm[cols], vals, shape, nblocks=2,
            dtype=jnp.float64,
        )
        op = blockops.StackedELLOperator(a_ii=a_ii, a_ic=a_ic)
        with pytest.warns(UserWarning, match="gather-ELL"):
            out = blockops.as_stacked_device_operator(op)
        assert out is op


class TestFromScipy:
    """operator_from_coo / from_scipy: the create_matrix_sparse entry
    point (reference utils.c:139-155) — any scipy matrix in, the
    routed device operator out."""

    def test_banded_routes_dia(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            from_scipy,
        )

        rows, cols, vals, shape = poisson.poisson2d_coo(16, 16)
        A = sp.csr_matrix((vals, (rows, cols)), shape=shape)
        op = from_scipy(A, dtype=jnp.float64)
        assert isinstance(op, DIA)
        x = np.random.default_rng(1).standard_normal(shape[0])
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )

    def test_blocky_routes_bsr_and_symmetric_shares_buffers(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            from_scipy,
        )

        A = _random_block_sparse(nb=6, bs=16, blocks_per_row=2, seed=31,
                                 spd=True)
        op = from_scipy(A, dtype=jnp.float64,
                        bsr_block_sizes=(16,), max_bsr_cost=64.0)
        assert isinstance(op, BSR)
        # symmetric: transpose pack is the SAME buffer, not a copy
        assert op.values_t is op.values
        assert op.indices_t is op.indices
        x = np.random.default_rng(2).standard_normal(A.shape[0])
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(x))), A.T @ x, rtol=1e-11
        )

    def test_nonsymmetric_gets_real_transpose_pack(self):
        A = sp.random(64, 64, density=0.08, random_state=37).tocsr()
        A = A + sp.eye(64)
        rows, cols, vals, shape = _to_coo(A)
        op = BSR.from_coo(rows, cols, vals, shape, bs=8,
                          dtype=jnp.float64)
        assert op.values_t is not op.values
        x = np.random.default_rng(3).standard_normal(64)
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(x))), A.T @ x, rtol=1e-12
        )

    def test_small_rectangular_routes_dense(self):
        # rectangular rmv on ELL is a scatter-add — small rectangular
        # goes dense so lsqr/cgne get dense matvecs
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            DenseOp, from_scipy,
        )

        A = sp.random(30, 50, density=0.1, random_state=41).tocsr()
        op = from_scipy(A, dtype=jnp.float64)
        assert isinstance(op, DenseOp)
        x = np.random.default_rng(4).standard_normal(50)
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x))), A @ x, rtol=1e-12
        )
        y = np.random.default_rng(5).standard_normal(30)
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(y))), A.T @ y, rtol=1e-12
        )

    def test_large_rectangular_routes_aij(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            AIJ,
            from_scipy,
        )

        A = sp.random(30, 50, density=0.1, random_state=41).tocsr()
        op = from_scipy(A, dtype=jnp.float64, max_dense_n=0)
        assert isinstance(op, AIJ)
        x = np.random.default_rng(4).standard_normal(50)
        np.testing.assert_allclose(
            np.asarray(op.mv(jnp.asarray(x, jnp.float64))), A @ x,
            rtol=1e-10, atol=1e-12,
        )
        # the AIJ rmv is a routed gather (not ELL's scatter-add)
        y = np.random.default_rng(5).standard_normal(30)
        np.testing.assert_allclose(
            np.asarray(op.rmv(jnp.asarray(y, jnp.float64))), A.T @ y,
            rtol=1e-10, atol=1e-12,
        )

    def test_fill_estimate_counts_padding(self):
        # one dense block ROW (FEM constraint-row shape): block-ELL pads
        # every block row to the widest, so the honest fill — and the
        # high-fill memory cap — must count nbr * width, not just the
        # unique blocks (review round 3)
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            bsr_block_fill_from_coo,
        )

        n, bs = 64, 8   # 8 block rows x 8 block cols
        rows = np.concatenate([np.arange(n), np.zeros(n, np.int64)])
        cols = np.concatenate([np.arange(n), np.arange(n)])
        # diagonal + full first row: block row 0 hits all 8 block cols
        fill = bsr_block_fill_from_coo(rows, cols, (n, n), bs)
        # padded pack: 8 block rows x width 8 x 64 = 4096 stored values
        assert fill == pytest.approx(4096 / len(rows))


class TestStackedBSR:
    """StackedBSROperator: the multisplitting (MPIAIJ-analog) path for
    blockable unstructured systems."""

    def _blocky_system(self, nb_jacobi=2, seed=51):
        # SPD random block-sparse (8x8 sub-blocks), split into 2 Jacobi
        # blocks
        A = _random_block_sparse(nb=8, bs=8, blocks_per_row=2, seed=seed,
                                 spd=True)
        rows, cols, vals, shape = _to_coo(A)
        a_ii, a_ic = poisson.block_split_ell(
            rows, cols, vals, shape, nblocks=nb_jacobi, dtype=jnp.float64,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.models import (
            blockops,
        )

        return A, blockops.StackedELLOperator(a_ii=a_ii, a_ic=a_ic)

    def test_routing_and_mv_match_ell(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.models import (
            blockops,
        )

        A, ell_op = self._blocky_system()
        out = blockops.as_stacked_device_operator(
            ell_op, max_diags=4, bsr_block_sizes=(8,), max_bsr_cost=64.0,
        )
        assert isinstance(out, blockops.StackedBSROperator)
        x = jnp.asarray(
            np.random.default_rng(3).standard_normal(A.shape[0])
        ).reshape(out.nblocks, out.block_size)
        np.testing.assert_allclose(
            np.asarray(out.diag_mv(x)), np.asarray(ell_op.diag_mv(x)),
            rtol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(out.coupling_mv(x)),
            np.asarray(ell_op.coupling_mv(x)), rtol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(out.full_mv(x)),
            (A @ np.asarray(x).reshape(-1)).reshape(x.shape), rtol=1e-11,
        )

    def test_single_block_hooks(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.models import (
            blockops,
        )

        A, ell_op = self._blocky_system()
        out = blockops.stacked_bsr_from_ell(ell_op, (8,), 64.0)
        args0 = jax.tree_util.tree_map(lambda t: t[0], out.diag_mv_args)
        xb = jnp.asarray(
            np.random.default_rng(5).standard_normal(out.block_size)
        )
        full = out.diag_mv(jnp.stack([xb, jnp.zeros_like(xb)]))
        np.testing.assert_allclose(
            np.asarray(out.single_diag_mv(args0, xb)),
            np.asarray(full[0]), rtol=1e-12,
        )
        d = out.single_diag_vector(args0, out.block_size)
        dense_ii = np.asarray(A.todense())[: out.block_size,
                                           : out.block_size]
        np.testing.assert_allclose(
            np.asarray(d), np.diag(dense_ii), rtol=1e-12,
        )

    def test_multisplitting_solve_via_stacked_bsr(self):
        """The flagship driver runs on a blockable unstructured system
        through the BSR path, converging to the reference invariant."""
        from medane_tchakorom_ufc_thesis_repository_tpu.models import (
            blockops,
            multisplitting as ms,
        )

        A, ell_op = self._blocky_system()
        op = blockops.stacked_bsr_from_ell(ell_op, (8,), 64.0)
        assert op is not None
        xstar = np.ones(A.shape[0])
        b = jnp.asarray(A @ xstar).reshape(op.nblocks, op.block_size)
        rtol = 1e-8
        res = ms.multisplit_solve(
            op, b, schedule="sync", minimization="global", s=4,
            inner=ms.InnerConfig(restart=20, maxiter=20, rtol=1e-10,
                                 pc="jacobi"),
            rtol=rtol, maxiter=400,
        )
        assert bool(res.converged)
        r = b - op.full_mv(res.x)
        rel = float(jnp.linalg.norm(r.reshape(-1))
                    / jnp.linalg.norm(b.reshape(-1)))
        assert rel <= 1.05 * rtol
        np.testing.assert_allclose(
            np.asarray(res.x).reshape(-1), xstar, atol=1e-5,
        )
