"""Generator tests — the rebuild of the reference's stencil unit tests
(``src/tests/utils_test.c:66-221``: per-block 2D/3D Poisson rows compared
against hand-written values)."""

import jax.numpy as jnp
import numpy as np
import pytest

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
    Stencil2D,
    Stencil3D,
    StencilStrip2D,
)


def hand_poisson2d(m, n):
    """Independent dense assembly straight from the 5-point definition."""
    size = m * n
    a = np.zeros((size, size))
    for i in range(m):
        for j in range(n):
            r = i * n + j
            a[r, r] = 4.0
            if i > 0:
                a[r, r - n] = -1.0
            if i < m - 1:
                a[r, r + n] = -1.0
            if j > 0:
                a[r, r - 1] = -1.0
            if j < n - 1:
                a[r, r + 1] = -1.0
    return a


@pytest.mark.parametrize("m,n", [(2, 2), (4, 4), (4, 6), (6, 4), (3, 5)])
def test_poisson2d_dense_matches_hand_rows(m, n):
    np.testing.assert_array_equal(poisson.poisson2d_dense_np(m, n), hand_poisson2d(m, n))


@pytest.mark.parametrize("m,n", [(4, 4), (4, 6), (8, 4)])
def test_poisson2d_ell_and_stencil_agree_with_dense(m, n):
    dense = poisson.poisson2d_dense_np(m, n)
    x = np.random.default_rng(0).standard_normal(m * n)
    want = dense @ x

    ell = poisson.poisson2d_ell(m, n, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(ell.mv(jnp.asarray(x))), want, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(ell.to_dense()), dense)
    # symmetric: rmv == mv
    np.testing.assert_allclose(np.asarray(ell.rmv(jnp.asarray(x))), want, rtol=1e-12)

    st = Stencil2D(m=m, n=n)
    np.testing.assert_allclose(np.asarray(st.mv(jnp.asarray(x))), want, rtol=1e-12)
    assert st.nnz == (dense != 0).sum()


@pytest.mark.parametrize("dims", [(2, 2, 2), (3, 4, 5), (4, 4, 4)])
def test_poisson3d_stencil_and_ell_agree_with_dense(dims):
    nx, ny, nz = dims
    dense = poisson.poisson3d_dense_np(nx, ny, nz)
    # structural sanity: diag 6, symmetric, row sums >= 0
    assert np.all(np.diag(dense) == 6.0)
    np.testing.assert_array_equal(dense, dense.T)

    x = np.random.default_rng(1).standard_normal(nx * ny * nz)
    want = dense @ x
    st = Stencil3D(nx=nx, ny=ny, nz=nz)
    np.testing.assert_allclose(np.asarray(st.mv(jnp.asarray(x))), want, rtol=1e-12)
    ell = poisson.poisson3d_ell(nx, ny, nz, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(ell.mv(jnp.asarray(x))), want, rtol=1e-12)
    assert st.nnz == (dense != 0).sum()


def test_block_split_matches_reference_convention():
    """2-block split: A_ii row blocks + A_ic coupling reproduce A @ x
    (divideSubDomainIntoBlockMatrices, reference utils.c:450-478)."""
    m, n = 6, 4
    rows, cols, vals, shape = poisson.poisson2d_coo(m, n)
    a_ii, a_ic = poisson.block_split_ell(rows, cols, vals, shape, nblocks=2,
                                         dtype=jnp.float64)
    dense = poisson.poisson2d_dense_np(m, n)
    x = np.random.default_rng(2).standard_normal(m * n)
    bs = m * n // 2
    for blk in range(2):
        x_own = jnp.asarray(x[blk * bs:(blk + 1) * bs])
        own = ELL_like(a_ii, blk).mv(x_own)
        coup = ELL_like(a_ic, blk).mv(jnp.asarray(x))
        want = dense[blk * bs:(blk + 1) * bs] @ x
        np.testing.assert_allclose(np.asarray(own + coup), want, rtol=1e-12)


def ELL_like(stacked, blk):
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import ELL

    return ELL(indices=stacked.indices[blk], values=stacked.values[blk],
               ncols=stacked.ncols)


def test_strip2d_halo_coupling_equals_global_rows():
    """StencilStrip2D.mv_full == the global operator's strip rows."""
    m, n = 8, 6
    strip = poisson.strip2d(m, n, nblocks=2)
    full = Stencil2D(m=m, n=n)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(m * n))
    want = np.asarray(full.mv(x)).reshape(m, n)
    xg = np.asarray(x).reshape(m, n)
    half = m // 2
    zeros = jnp.zeros((n,), x.dtype)
    # block 0: halo_top = 0, halo_bottom = first row of block 1
    y0 = strip.mv_full(x[: half * n], zeros, jnp.asarray(xg[half]))
    np.testing.assert_allclose(np.asarray(y0).reshape(half, n), want[:half], rtol=1e-12)
    # block 1: halo_top = last row of block 0, halo_bottom = 0
    y1 = strip.mv_full(x[half * n:], jnp.asarray(xg[half - 1]), zeros)
    np.testing.assert_allclose(np.asarray(y1).reshape(half, n), want[half:], rtol=1e-12)


def test_strip3d_halo_coupling_equals_global_rows():
    nx, ny, nz = 6, 4, 5
    strip = poisson.strip3d(nx, ny, nz, nblocks=2)
    full = Stencil3D(nx=nx, ny=ny, nz=nz)
    x = jnp.asarray(np.random.default_rng(4).standard_normal(nx * ny * nz))
    want = np.asarray(full.mv(x)).reshape(nx, ny, nz)
    xg = np.asarray(x).reshape(nx, ny, nz)
    half = nx // 2
    zeros = jnp.zeros((ny * nz,), x.dtype)
    y0 = strip.mv_full(x[: half * ny * nz], zeros, jnp.asarray(xg[half].ravel()))
    np.testing.assert_allclose(
        np.asarray(y0).reshape(half, ny, nz), want[:half], rtol=1e-12)
    y1 = strip.mv_full(x[half * ny * nz:], jnp.asarray(xg[half - 1].ravel()), zeros)
    np.testing.assert_allclose(
        np.asarray(y1).reshape(half, ny, nz), want[half:], rtol=1e-12)


def test_rhs_for_exact_ones():
    m, n = 4, 4
    op = Stencil2D(m=m, n=n)
    b = poisson.rhs_for_exact_ones(op)
    dense = poisson.poisson2d_dense_np(m, n)
    np.testing.assert_allclose(np.asarray(b), dense @ np.ones(m * n), rtol=1e-6)


class TestDIA:
    def test_dia_matches_dense_2d(self):
        import numpy as np
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson

        dia = poisson.poisson2d_dia(6, 5, dtype=jnp.float64)
        dense = poisson.poisson2d_dense_np(6, 5)
        np.testing.assert_allclose(np.asarray(dia.to_dense()), dense, rtol=1e-14)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.standard_normal(30))
        np.testing.assert_allclose(np.asarray(dia.mv(x)), dense @ np.asarray(x), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(dia.rmv(x)), dense.T @ np.asarray(x), rtol=1e-12)

    def test_dia_matches_dense_3d(self):
        import numpy as np
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson

        dia = poisson.poisson3d_dia(3, 4, 3, dtype=jnp.float64)
        dense = poisson.poisson3d_dense_np(3, 4, 3)
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.standard_normal(36))
        np.testing.assert_allclose(np.asarray(dia.mv(x)), dense @ np.asarray(x), rtol=1e-12)

    def test_dia_nnz(self):
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson

        dia = poisson.poisson2d_dia(4, 4, dtype=jnp.float64)
        # 5 diagonals at offsets 0, +-1, +-4; but the +-1 diagonal has
        # zero entries at row-wrap positions — nnz counts stored band slots
        assert dia.offsets == (-4, -1, 0, 1, 4)


class TestFormatConversion:
    def test_ell_to_dia_exact(self):
        import numpy as np
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson

        ell = poisson.poisson2d_ell(7, 9, dtype=jnp.float64)
        dia = ell.to_dia()
        np.testing.assert_allclose(
            np.asarray(dia.to_dense()), np.asarray(ell.to_dense()), rtol=1e-14
        )

    def test_as_tpu_operator_routes_banded_to_dia(self):
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            DIA,
            as_device_operator,
        )

        ell = poisson.poisson2d_ell(8, 8, dtype=jnp.float64)
        op = as_device_operator(ell)
        assert isinstance(op, DIA)
        assert op.offsets == (-8, -1, 0, 1, 8)

    def test_as_tpu_operator_routes_unstructured_to_aij(self):
        import numpy as np
        import jax.numpy as jnp
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            AIJ,
            as_device_operator,
        )

        # random sparsity, every better route disabled (no DIA fit, BSR
        # and dense rejected) -> Clos-routed AIJ (round 5; the
        # stay-on-gather-ELL warn branch is retired)
        rng = np.random.default_rng(0)
        n = 200
        rows = rng.integers(0, n, 800)
        cols = rng.integers(0, n, 800)
        pairs = np.unique(np.stack([rows, cols]), axis=1)
        vals = rng.standard_normal(pairs.shape[1])
        ell = poisson.coo_to_ell(pairs[0], pairs[1], vals, (n, n),
                                 dtype=jnp.float64)
        out = as_device_operator(ell, max_diags=64, max_bsr_cost=0.0,
                              bsr_block_sizes=(), max_dense_n=0)
        assert isinstance(out, AIJ)
        x = rng.standard_normal(n)
        np.testing.assert_allclose(
            np.asarray(out.mv(jnp.asarray(x, jnp.float64))),
            np.asarray(ell.to_dense()) @ x, rtol=1e-10, atol=1e-10,
        )
