"""Problem generators: 2D/3D Poisson stencil systems.

Matrix-free-first rebuild of the reference's assembly routines
(``poisson2DMatrix`` ``src/utils/utils.c:247-293``, ``poisson3DMatrix``
``utils.c:30-121``, ``poisson2DMatrix_complete`` ``utils.c:383-445``) and of
the block split ``divideSubDomainIntoBlockMatrices`` (``utils.c:450-478``).

Conventions (identical to the reference):
  * 2D: grid ``m x n`` (lines x columns), unknown ``Ii = i*n + j``;
    row = ``4*x[i,j] - x[i-1,j] - x[i+1,j] - x[i,j-1] - x[i,j+1]`` with
    Dirichlet truncation.  Blocks own contiguous row ranges, i.e. horizontal
    strips of the grid (``m`` must divide by ``nblocks``).
  * 3D: 7-point, diag 6, off -1; the block split is on the slowest
    flattened grid axis (the reference's ``k``/depth loop).

Assembly happens host-side in numpy (cheap: O(N) index arithmetic) and is
shipped to device as ELL planes; the matrix-free ``Stencil*`` operators in
``core.operators`` need no assembly at all and are the preferred device
path.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
    DIA,
    ELL,
    Stencil2D,
    Stencil3D,
    StencilStrip2D,
    StencilStrip3D,
)

__all__ = [
    "poisson2d_coo",
    "poisson3d_coo",
    "poisson2d_dense_np",
    "poisson3d_dense_np",
    "poisson2d",
    "poisson3d",
    "poisson2d_ell",
    "poisson3d_ell",
    "block_split_ell",
    "coo_to_ell",
    "rhs_for_exact_ones",
]


# ---------------------------------------------------------------------------
# COO assembly (numpy, host side)
# ---------------------------------------------------------------------------

def poisson2d_coo(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """Full 2D 5-point matrix in COO (rows, cols, vals) numpy arrays."""
    size = m * n
    ii = np.arange(size)
    gi, gj = ii // n, ii % n
    rows = [ii]
    cols = [ii]
    vals = [np.full(size, diag)]
    for mask, delta in (
        (gi > 0, -n),
        (gi < m - 1, n),
        (gj > 0, -1),
        (gj < n - 1, 1),
    ):
        rows.append(ii[mask])
        cols.append(ii[mask] + delta)
        vals.append(np.full(mask.sum(), off))
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (size, size),
    )


def poisson3d_coo(nx: int, ny: int, nz: int, diag: float = 6.0, off: float = -1.0):
    """Full 3D 7-point matrix in COO; unknown order ``ix*ny*nz + iy*nz + iz``
    (slowest axis = the block-split axis, as in the reference's k loop)."""
    size = nx * ny * nz
    ii = np.arange(size)
    ix = ii // (ny * nz)
    iy = (ii // nz) % ny
    iz = ii % nz
    rows = [ii]
    cols = [ii]
    vals = [np.full(size, diag)]
    for mask, delta in (
        (ix > 0, -ny * nz),
        (ix < nx - 1, ny * nz),
        (iy > 0, -nz),
        (iy < ny - 1, nz),
        (iz > 0, -1),
        (iz < nz - 1, 1),
    ):
        rows.append(ii[mask])
        cols.append(ii[mask] + delta)
        vals.append(np.full(mask.sum(), off))
    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        (size, size),
    )


def _coo_to_dense(rows, cols, vals, shape):
    dense = np.zeros(shape)
    np.add.at(dense, (rows, cols), vals)
    return dense


def poisson2d_dense_np(m, n, diag: float = 4.0, off: float = -1.0):
    return _coo_to_dense(*poisson2d_coo(m, n, diag, off))


def poisson3d_dense_np(nx, ny, nz, diag: float = 6.0, off: float = -1.0):
    return _coo_to_dense(*poisson3d_coo(nx, ny, nz, diag, off))


# ---------------------------------------------------------------------------
# ELL conversion
# ---------------------------------------------------------------------------

def coo_to_ell(rows, cols, vals, shape, width: int | None = None,
               dtype=jnp.float32) -> ELL:
    """Pack COO into ELLPACK planes.  Deterministic: within a row, entries
    are ordered by column index (stable)."""
    nrows, ncols = shape
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=nrows)
    w = int(counts.max()) if width is None else width
    if counts.max() > w:
        raise ValueError(f"row with {counts.max()} nnz exceeds width {w}")
    slot = np.arange(len(rows)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    indices = np.zeros((nrows, w), np.int32)
    values = np.zeros((nrows, w))
    indices[rows, slot] = cols
    values[rows, slot] = vals
    return ELL(
        indices=jnp.asarray(indices),
        values=jnp.asarray(values, dtype=dtype),
        ncols=ncols,
    )


def coo_to_dia(rows, cols, vals, shape, dtype=jnp.float32) -> DIA:
    """Pack COO into DIA planes (row-aligned diagonals)."""
    n, ncols = shape
    if n != ncols:
        raise ValueError("DIA requires a square matrix")
    offs = np.asarray(cols) - np.asarray(rows)
    uniq = np.unique(offs)
    data = np.zeros((len(uniq), n))
    for d, off in enumerate(uniq):
        mask = offs == off
        data[d, rows[mask]] = vals[mask]
    return DIA(data=jnp.asarray(data, dtype=dtype),
               offsets=tuple(int(o) for o in uniq))


def poisson2d_ell(m, n, dtype=jnp.float32) -> ELL:
    return coo_to_ell(*poisson2d_coo(m, n), dtype=dtype)


def poisson2d_dia(m, n, dtype=jnp.float32) -> DIA:
    return coo_to_dia(*poisson2d_coo(m, n), dtype=dtype)


def poisson3d_dia(nx, ny, nz, dtype=jnp.float32) -> DIA:
    return coo_to_dia(*poisson3d_coo(nx, ny, nz), dtype=dtype)


def poisson3d_ell(nx, ny, nz, dtype=jnp.float32) -> ELL:
    return coo_to_ell(*poisson3d_coo(nx, ny, nz), dtype=dtype)


# ---------------------------------------------------------------------------
# Matrix-free operators
# ---------------------------------------------------------------------------

def poisson2d(m: int, n: int) -> Stencil2D:
    return Stencil2D(m=m, n=n)


def poisson3d(nx: int, ny: int, nz: int) -> Stencil3D:
    return Stencil3D(nx=nx, ny=ny, nz=nz)


def strip2d(m: int, n: int, nblocks: int = 2) -> StencilStrip2D:
    if m % nblocks:
        raise ValueError(f"m={m} not divisible by nblocks={nblocks}")
    return StencilStrip2D(rows=m // nblocks, n=n)


def strip3d(nx: int, ny: int, nz: int, nblocks: int = 2) -> StencilStrip3D:
    if nx % nblocks:
        raise ValueError(f"nx={nx} not divisible by nblocks={nblocks}")
    return StencilStrip3D(rows=nx // nblocks, ny=ny, nz=nz)


# ---------------------------------------------------------------------------
# Block split (general sparse path)
# ---------------------------------------------------------------------------

def block_split_ell(rows, cols, vals, shape, nblocks: int = 2,
                    dtype=jnp.float32) -> Tuple[ELL, ELL]:
    """Split a COO matrix into stacked per-block (A_ii, A_ic) ELL operators.

    Mirrors ``divideSubDomainIntoBlockMatrices`` (reference
    ``src/utils/utils.c:450-478``): block ``i`` owns rows
    ``[i*bs, (i+1)*bs)``; ``A_ii`` keeps the columns inside the block
    (re-indexed locally), ``A_ic`` keeps all *other* columns, re-indexed
    into the global space (its matvec takes the full x vector with the own
    block zeroed or not — padded slots point at column 0 with value 0, and
    entries store global column indices).

    Returns two ELL pytrees whose planes have a leading ``nblocks`` axis
    (stacked for ``vmap``/``shard_map``):
      * ``A_ii``: indices (nblocks, bs, w1) local column ids, ncols = bs
      * ``A_ic``: indices (nblocks, bs, w2) GLOBAL column ids, ncols = N
    """
    nrows, ncols_g = shape
    if nrows % nblocks:
        raise ValueError("rows not divisible by nblocks")
    bs = nrows // nblocks
    diag_i, diag_v, off_i, off_v = [], [], [], []
    w_diag = w_off = 0
    for blk in range(nblocks):
        lo, hi = blk * bs, (blk + 1) * bs
        rmask = (rows >= lo) & (rows < hi)
        r, c, v = rows[rmask] - lo, cols[rmask], vals[rmask]
        own = (c >= lo) & (c < hi)
        dd = coo_like_to_padded(r[own], c[own] - lo, v[own], bs)
        oo = coo_like_to_padded(r[~own], c[~own], v[~own], bs)
        diag_i.append(dd[0]); diag_v.append(dd[1])
        off_i.append(oo[0]); off_v.append(oo[1])
        w_diag = max(w_diag, dd[0].shape[1])
        w_off = max(w_off, oo[0].shape[1])
    diag_i = [_pad_w(a, w_diag) for a in diag_i]
    diag_v = [_pad_w(a, w_diag) for a in diag_v]
    off_i = [_pad_w(a, w_off) for a in off_i]
    off_v = [_pad_w(a, w_off) for a in off_v]
    a_ii = ELL(
        indices=jnp.asarray(np.stack(diag_i)),
        values=jnp.asarray(np.stack(diag_v), dtype=dtype),
        ncols=bs,
    )
    a_ic = ELL(
        indices=jnp.asarray(np.stack(off_i)),
        values=jnp.asarray(np.stack(off_v), dtype=dtype),
        ncols=ncols_g,
    )
    return a_ii, a_ic


def coo_like_to_padded(r, c, v, nrows):
    """COO triplet -> (indices, values) padded planes (numpy)."""
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    counts = np.bincount(r, minlength=nrows)
    w = max(int(counts.max()) if len(r) else 0, 1)
    slot = np.arange(len(r)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts
    )
    indices = np.zeros((nrows, w), np.int32)
    values = np.zeros((nrows, w))
    indices[r, slot] = c
    values[r, slot] = v
    return indices, values


def _pad_w(a, w):
    if a.shape[1] == w:
        return a
    pad = np.zeros((a.shape[0], w - a.shape[1]), a.dtype)
    return np.concatenate([a, pad], axis=1)


# ---------------------------------------------------------------------------
# RHS
# ---------------------------------------------------------------------------

def rhs_for_exact_ones(op) -> jnp.ndarray:
    """b = A @ ones — the reference's RHS so the exact solution is u = 1
    (``computeTheRightHandSideWithInitialGuess``, ``utils.c:623-650``).
    Matrix-free stencils have no stored dtype; the session float width
    applies (f64 under jax_enable_x64)."""
    n = op.shape[1]
    dtype = getattr(op, "dtype", None) or jnp.result_type(float)
    return op.mv(jnp.ones((n,), dtype))
