"""Linear-operator pytrees: the framework's replacement for PETSc Mat.

The reference manipulates PETSc ``Mat`` objects (MPIAIJ sparse, MPIDENSE) —
see ``create_matrix_sparse`` / ``create_matrix_dense``
(reference ``src/utils/utils.c:123-168``).  Here an operator is an immutable
dataclass registered as a JAX pytree, so it can be closed over by jitted
solvers, vmapped over a leading "block" axis, and sharded with
``shard_map``.  Matrix-vector products are pure functions of (operator, x).

Representations
---------------
``Stencil2D`` / ``Stencil3D``
    Matrix-free constant-coefficient 5/7-point Poisson stencils — the
    fastest path (no index gathers; XLA fuses the shifted adds).
``ELL``
    ELLPACK padded sparse: row-major ``(n, width)`` column-index and value
    planes.  The general path; Poisson rows have <= 5 (2D) / 7 (3D)
    nonzeros so padding waste is tiny.  SpMV is a gather + small reduction.
``DIA``
    Diagonal format for banded matrices: SpMV is shifted slices, no
    gathers — the fast general path (``as_device_operator`` routes
    banded ELL here).
``BSR``
    Block-sparse rows (block-ELL): dense ``(bs, bs)`` sub-blocks, SpMV is
    block-row gathers + batched sub-block matvecs, ``rmv`` via a
    transpose pack — the path for genuinely unstructured sparsity with
    block structure.
``DenseOp``
    Thin wrapper over a dense matrix, for tests and tall-skinny blocks.

All operators expose ``mv`` (matvec) and ``rmv`` (transpose matvec, needed
by LSQR/CGNE), plus ``shape`` / ``dtype`` / ``nnz`` metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _register(cls, data_fields, meta_fields):
    jax.tree_util.register_dataclass(
        cls, data_fields=list(data_fields), meta_fields=list(meta_fields)
    )
    return cls


@dataclasses.dataclass(frozen=True)
class ELL:
    """ELLPACK sparse matrix.

    ``indices``/``values`` have shape ``(nrows, width)``; padded slots carry
    ``values == 0`` and an arbitrary valid index (0), so the padded products
    vanish.  ``ncols`` is static metadata (the matvec output/input widths).
    """

    indices: jax.Array  # int32 (nrows, width)
    values: jax.Array   # (nrows, width)
    ncols: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.indices.shape[0], self.ncols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> int:
        # padded count; exact nnz tracked by callers when it matters
        return int(self.indices.shape[0] * self.indices.shape[1])

    def mv(self, x: jax.Array) -> jax.Array:
        """y = A @ x.  Gather + small fixed-width reduction (VPU-friendly)."""
        gathered = jnp.take(x, self.indices, axis=0)  # (nrows, width)
        return jnp.sum(self.values * gathered, axis=1)

    def rmv(self, y: jax.Array) -> jax.Array:
        """x = A.T @ y via scatter-add (segment sum over column indices)."""
        contrib = (self.values * y[:, None]).reshape(-1)
        return jnp.zeros((self.ncols,), self.values.dtype).at[
            self.indices.reshape(-1)
        ].add(contrib)

    def to_dense(self) -> jax.Array:
        n, w = self.indices.shape
        dense = jnp.zeros((n, self.ncols), self.values.dtype)
        rows = jnp.repeat(jnp.arange(n), w)
        return dense.at[rows, self.indices.reshape(-1)].add(
            self.values.reshape(-1)
        )

    def to_coo_np(self):
        """Nonzero entries as numpy COO (rows, cols, vals)."""
        n, w = self.indices.shape
        rows = np.repeat(np.arange(n), w)
        cols = np.asarray(self.indices).reshape(-1)
        vals = np.asarray(self.values).reshape(-1)
        keep = vals != 0
        return rows[keep], cols[keep], vals[keep]

    def to_dia(self) -> "DIA":
        """Convert to DIA: shifted adds instead of an index gather per
        nonzero — any matrix whose distinct-diagonal count is modest
        should run as DIA."""
        if self.shape[0] != self.ncols:
            raise ValueError("DIA requires a square matrix")
        rows, cols, vals = self.to_coo_np()
        offs = cols - rows
        uniq = np.unique(offs)
        n = self.ncols
        data = np.zeros((len(uniq), n))
        for d, off in enumerate(uniq):
            mask = offs == off
            data[d, rows[mask]] = vals[mask]
        return DIA(
            data=jnp.asarray(data, self.values.dtype),
            offsets=tuple(int(o) for o in uniq),
        )

    def ndiags(self) -> int:
        """Number of distinct diagonals (host-side; DIA suitability)."""
        rows, cols, _ = self.to_coo_np()
        return len(np.unique(cols - rows))


_register(ELL, ["indices", "values"], ["ncols"])


@dataclasses.dataclass(frozen=True)
class DenseOp:
    """Dense matrix operator (small unstructured/rectangular route,
    tall-skinny R blocks).

    The matvecs pin ``precision=HIGHEST``: an unpinned f32 contraction
    may run in TF32 on the GPU (about three decimal digits), which
    stalls Krylov solves and is invisible to the CPU (f64) suite.  The
    op is bandwidth-bound, so the pin costs nothing."""

    a: jax.Array

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self.a.dtype

    @property
    def nnz(self) -> int:
        return int(np.prod(self.a.shape))

    def mv(self, x):
        return jnp.matmul(self.a, x, precision=jax.lax.Precision.HIGHEST)

    def rmv(self, y):
        return jnp.matmul(self.a.T, y, precision=jax.lax.Precision.HIGHEST)

    def to_dense(self):
        return self.a


_register(DenseOp, ["a"], [])


@dataclasses.dataclass(frozen=True)
class Stencil2D:
    """Matrix-free 2D 5-point Poisson operator on an ``m x n`` grid.

    Row ``i*n + j`` is ``diag*x[i,j] + off*(x[i-1,j]+x[i+1,j]+x[i,j-1]+x[i,j+1])``
    with Dirichlet truncation at the boundary — exactly the rows assembled by
    the reference's ``poisson2DMatrix`` (``src/utils/utils.c:247-293``,
    diag 4, off -1).  ``x`` is the flattened grid of length ``m*n``.
    """

    m: int
    n: int
    diag: float = 4.0
    off: float = -1.0

    @property
    def shape(self):
        return (self.m * self.n, self.m * self.n)

    @property
    def nnz(self) -> int:
        m, n = self.m, self.n
        return 5 * m * n - 2 * m - 2 * n

    def mv(self, x):
        # pad+slice formulation: XLA fuses the pad, the four shifted
        # reads and the combine into one bandwidth-bound loop (the
        # ``.at[].add`` chain lowers to a sequence of dynamic-update-
        # slices instead).  Shape-polymorphic: flat (m*n,) or grid
        # (m, n) in -> same shape out.
        m, n = self.m, self.n
        g = x if x.ndim == 2 else x.reshape(m, n)
        p = jnp.pad(g, 1)
        y = self.diag * g + self.off * (
            p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        )
        return y if x.ndim == 2 else y.reshape(-1)

    rmv = mv  # symmetric

    def to_dense(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson

        return jnp.asarray(
            poisson.poisson2d_dense_np(self.m, self.n, self.diag, self.off)
        )


_register(Stencil2D, [], ["m", "n", "diag", "off"])


@dataclasses.dataclass(frozen=True)
class Stencil3D:
    """Matrix-free 3D 7-point Poisson operator (diag 6, off -1) — the
    matrix-free analog of ``poisson3DMatrix`` (reference ``utils.c:30-121``).
    Unknown order: ``x[ix, iy, iz]`` flattened C-style.

    Every method is one pad+slice stencil expression with its elementwise
    epilogue (and, for the ``*_dot`` forms, its reduction) written beside
    it, so XLA compiles each into one fused pass over the operands."""

    nx: int
    ny: int
    nz: int
    diag: float = 6.0
    off: float = -1.0

    @property
    def shape(self):
        size = self.nx * self.ny * self.nz
        return (size, size)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        size = nx * ny * nz
        return 7 * size - 2 * (nx * ny + ny * nz + nx * nz)

    def _grid(self, x):
        return x if x.ndim == 3 else x.reshape(self.nx, self.ny, self.nz)

    def _apply(self, g):
        p = jnp.pad(g, 1)
        return self.diag * g + self.off * (
            p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
            + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]
        )

    def mv(self, x):
        """Shape-polymorphic apply: accepts the flat ``(nx*ny*nz,)`` vector
        or the grid-shaped ``(nx, ny, nz)`` array and returns the same
        shape.  Solvers keep their state grid-shaped in hot loops, which
        spares the reshape between the two views."""
        y = self._apply(self._grid(x))
        return y if x.ndim == 3 else y.reshape(-1)

    rmv = mv  # symmetric

    def mv_dot(self, x):
        """``(A @ x, x · A x)`` — CG's MatMult+VecTDot pair, written as
        one expression so the reduction can join the stencil's fusion.
        The dot accumulates in f32 regardless of storage dtype."""
        g = self._grid(x)
        y = self._apply(g)
        dot = jnp.sum(g.astype(jnp.float32) * y.astype(jnp.float32))
        return (y if x.ndim == 3 else y.reshape(-1), dot.astype(x.dtype))

    def jacobi_sweep(self, x, b, omega, out_dtype=None):
        """One damped-Jacobi smoothing sweep ``x + omega * (b - A x)``
        (the MG smoother, ``solvers/multigrid.py``).  ``out_dtype``: the
        result's storage dtype (default ``x.dtype``); the cast is part of
        the same expression."""
        g = self._grid(x)
        w = jnp.asarray(omega, g.dtype)
        y = g + w * (self._grid(b) - self._apply(g))
        if out_dtype is not None:
            y = y.astype(out_dtype)
        return y if x.ndim == 3 else y.reshape(x.shape)

    def jacobi_sweep_dot(self, x, b, omega, out_dtype=None):
        """``(x', b · x')`` with ``x' = x + omega (b - A x)`` — the final
        smoothing sweep of an MG cycle plus PCG's ``vdot(r, z)`` on its
        result, accumulated in f32."""
        y = self.jacobi_sweep(x, b, omega, out_dtype=out_dtype)
        dot = jnp.sum(b.astype(jnp.float32).reshape(y.shape)
                      * y.astype(jnp.float32))
        return y, dot

    def residual(self, x, b):
        """``b - A x``."""
        g = self._grid(x)
        y = self._grid(b) - self._apply(g)
        return y if x.ndim == 3 else y.reshape(x.shape)

    def to_dense(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson

        return jnp.asarray(
            poisson.poisson3d_dense_np(self.nx, self.ny, self.nz, self.diag, self.off)
        )


_register(Stencil3D, [], ["nx", "ny", "nz", "diag", "off"])


@dataclasses.dataclass(frozen=True)
class StencilStrip2D:
    """One block's row strip of a 2D Poisson operator, matrix-free.

    The reference splits the global matrix into 2 horizontal strips (one per
    Jacobi block) and each strip by columns into the inner operator ``A_ii``
    and the coupling operator ``A_ij`` (``divideSubDomainIntoBlockMatrices``,
    reference ``src/utils/utils.c:450-478``).  For a 5-point stencil split on
    grid-row boundaries the coupling is exactly one halo grid-row on each cut
    side, so ``A_ij @ x_j`` only needs ``n`` peer values — this is what rides
    ``ppermute`` in the sharded path instead of the reference's full-block
    ``MPI_Sendrecv`` (``comm.c:126-141``).

    ``rows``: number of grid rows owned by this strip (``m / nblocks``).
    """

    rows: int
    n: int
    diag: float = 4.0
    off: float = -1.0

    @property
    def shape(self):
        return (self.rows * self.n, self.rows * self.n)

    @property
    def nnz(self) -> int:
        r, n = self.rows, self.n
        return 5 * r * n - 2 * r - 2 * n

    def mv(self, x):
        """A_ii @ x — the strip's diagonal block (zero halo)."""
        g = x.reshape(self.rows, self.n)
        p = jnp.pad(g, 1)
        y = self.diag * g + self.off * (
            p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        )
        return y.reshape(-1)

    rmv = mv  # A_ii is symmetric

    def coupling(self, halo_top: jax.Array, halo_bottom: jax.Array):
        """A_ij @ x_j given the peer grid rows adjacent to this strip.

        ``halo_top`` is the grid row above the strip (zeros when this is the
        topmost block), ``halo_bottom`` the row below; each has length ``n``.
        """
        c = jnp.zeros((self.rows, self.n), halo_top.dtype)
        c = c.at[0, :].add(self.off * halo_top)
        c = c.at[-1, :].add(self.off * halo_bottom)
        return c.reshape(-1)

    def mv_full(self, x, halo_top, halo_bottom):
        """Full strip product ``A_i @ x_global`` = A_ii x_i + A_ij x_j."""
        return self.mv(x) + self.coupling(halo_top, halo_bottom)


_register(StencilStrip2D, [], ["rows", "n", "diag", "off"])


@dataclasses.dataclass(frozen=True)
class StencilStrip3D:
    """One block's strip of a 3D 7-point Poisson operator, split on the
    leading (x) grid axis.  Halos are full (ny, nz) planes."""

    rows: int  # grid planes owned along x
    ny: int
    nz: int
    diag: float = 6.0
    off: float = -1.0

    @property
    def shape(self):
        size = self.rows * self.ny * self.nz
        return (size, size)

    @property
    def nnz(self) -> int:
        r, ny, nz = self.rows, self.ny, self.nz
        return 7 * r * ny * nz - 2 * (r * ny + r * nz + ny * nz)

    def mv(self, x):
        g = x.reshape(self.rows, self.ny, self.nz)
        p = jnp.pad(g, 1)
        y = self.diag * g + self.off * (
            p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
            + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]
        )
        return y.reshape(-1)

    rmv = mv

    def coupling(self, halo_top, halo_bottom):
        c = jnp.zeros((self.rows, self.ny, self.nz), halo_top.dtype)
        c = c.at[0].add(self.off * halo_top.reshape(self.ny, self.nz))
        c = c.at[-1].add(self.off * halo_bottom.reshape(self.ny, self.nz))
        return c.reshape(-1)

    def mv_full(self, x, halo_top, halo_bottom):
        return self.mv(x) + self.coupling(halo_top, halo_bottom)


_register(StencilStrip3D, [], ["rows", "ny", "nz", "diag", "off"])


@dataclasses.dataclass(frozen=True)
class DIA:
    """Diagonal (DIA) sparse format — the general path for banded
    matrices (every constant-stencil PDE discretization).

    ``offsets`` is a static tuple of diagonal offsets; ``data`` has shape
    ``(ndiag, n)`` with ``data[d, i] = A[i, i + offsets[d]]`` (row-aligned;
    out-of-range slots are 0).  SpMV is a sum of shifted elementwise
    products — contiguous slices only, no gathers, so XLA fuses it into
    one bandwidth-bound pass like the matrix-free stencils.  This is the
    capability-parity replacement for the reference's AIJ matrices
    (``create_matrix_sparse``, ``src/utils/utils.c:139-155``) on banded
    problems; use ``ELL`` for genuinely unstructured sparsity.
    """

    data: jax.Array              # (ndiag, n)
    offsets: Tuple[int, ...]     # static

    @property
    def shape(self):
        n = self.data.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        n = self.data.shape[1]
        return sum(n - abs(o) for o in self.offsets)

    def mv(self, x: jax.Array) -> jax.Array:
        # pad+slice formulation (NOT .at[].add slice chains, which lower
        # to chains of dynamic-update-slices): one padded copy, then every diagonal
        # is a contiguous slice * elementwise multiply, all fused by XLA
        # into one bandwidth-bound pass.  Out-of-range x reads hit the
        # zero padding, so padded data slots need no masking.
        n = self.data.shape[1]
        maxo = max((abs(o) for o in self.offsets), default=0)
        xp = jnp.pad(x, (maxo, maxo))
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * xp[maxo + off: maxo + off + n]
        return y

    def rmv(self, x: jax.Array) -> jax.Array:
        """A.T @ x: each stored diagonal contributes ``data[d] * x``
        shifted by ``+off`` — realized as slices of one padded product
        (same no-scatter rationale as ``mv``)."""
        n = self.data.shape[1]
        maxo = max((abs(o) for o in self.offsets), default=0)
        y = jnp.zeros_like(x)
        for d, off in enumerate(self.offsets):
            zp = jnp.pad(self.data[d] * x, (maxo, maxo))
            y = y + zp[maxo - off: maxo - off + n]
        return y

    def to_dense(self) -> jax.Array:
        n = self.data.shape[1]
        dense = jnp.zeros((n, n), self.dtype)
        for d, off in enumerate(self.offsets):
            if off >= 0:
                rows = jnp.arange(n - off)
                dense = dense.at[rows, rows + off].add(self.data[d, : n - off])
            else:
                rows = jnp.arange(-off, n)
                dense = dense.at[rows, rows + off].add(self.data[d, -off:])
        return dense


_register(DIA, ["data"], ["offsets"])


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse row operator (block-ELL layout) — the path for
    genuinely unstructured sparsity with block structure.

    This is the capability-parity answer to the reference's AIJ matrices
    (``create_matrix_sparse``, ``src/utils/utils.c:139-155``) when the
    pattern is neither banded (→ ``DIA``) nor a constant stencil
    (→ ``Stencil2D/3D``): nonzeros are stored as dense ``(bs, bs)``
    sub-blocks, so SpMV is a block-row gather (contiguous ``bs``-sized
    rows of the reshaped ``x``, not elementwise gathers) followed by
    batched sub-block matvecs (one ``dot_general``).  ``rmv`` runs the
    same contraction on a transpose pack built at construction time — no
    scatter-adds anywhere.

    ``indices``/``values``: ``(nbr, width)`` block-column ids and
    ``(nbr, width, bs, bs)`` blocks for A; ``indices_t``/``values_t``:
    the same for A^T.  Padded slots carry index 0 and all-zero blocks.
    ``nrows``/``ncols`` are the TRUE (pre-padding) dimensions; ``mv``
    pads/unpads at the boundary.
    """

    indices: jax.Array    # int32 (nbr, width)
    values: jax.Array     # (nbr, width, bs, bs)
    indices_t: jax.Array  # int32 (ncb, width_t)
    values_t: jax.Array   # (ncb, width_t, bs, bs)
    nrows: int
    ncols: int

    @property
    def bs(self) -> int:
        return self.values.shape[-1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz(self) -> int:
        # stored (padded) count, like ELL.nnz; true nnz via host count
        return int(np.prod(self.values.shape))

    @property
    def fill(self) -> float:
        """Stored values per true nonzero (host-side; 1.0 = no waste)."""
        true_nnz = int(np.count_nonzero(np.asarray(self.values)))
        return float(self.nnz) / max(true_nnz, 1)

    @staticmethod
    def _blockmv(indices, values, x, n_out, n_in):
        bs = values.shape[-1]
        ncb = -(-n_in // bs)
        xp = jnp.pad(x, (0, ncb * bs - n_in)) if ncb * bs != n_in else x
        xb = xp.reshape(ncb, bs)
        g = jnp.take(xb, indices, axis=0)          # (nbr, width, bs) rows
        # blocks are stored TRANSPOSED (values[r, w, j, i] = A_blk[i, j])
        # so the contraction runs over the second-to-last dim
        y = jnp.einsum(
            "rwji,rwj->ri", values, g,
            precision=jax.lax.Precision.HIGHEST,   # values matter: no
        )                                          # TF32 operand rounding
        return y.reshape(-1)[:n_out]

    def mv(self, x: jax.Array) -> jax.Array:
        return self._blockmv(self.indices, self.values, x,
                             self.nrows, self.ncols)

    def rmv(self, y: jax.Array) -> jax.Array:
        return self._blockmv(self.indices_t, self.values_t, y,
                             self.ncols, self.nrows)

    def to_dense(self) -> jax.Array:
        nbr, width = self.indices.shape
        bs = self.bs
        ncb = -(-self.ncols // bs)
        dense = jnp.zeros((nbr * bs, ncb * bs), self.dtype)
        for r in range(nbr):
            for w in range(width):
                c = int(self.indices[r, w])
                blk = self.values[r, w].T   # stored transposed
                dense = dense.at[
                    r * bs:(r + 1) * bs, c * bs:(c + 1) * bs
                ].add(blk)
        return dense[: self.nrows, : self.ncols]

    @staticmethod
    def from_coo(rows, cols, vals, shape, bs: int = 128,
                 dtype=jnp.float32) -> "BSR":
        """Host-side (numpy) COO -> block-ELL pack, both A and A^T.
        Symmetric matrices (detected exactly) reuse the forward pack for
        the transpose — zero extra memory."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        i, v = _bsr_pack_np(rows, cols, vals, shape, bs)
        iv, vv = jnp.asarray(i), jnp.asarray(v, dtype)
        if shape[0] == shape[1] and _coo_symmetric(rows, cols, vals):
            it, vt = iv, vv          # A^T = A: same buffers
        else:
            it_, vt_ = _bsr_pack_np(cols, rows, vals,
                                    (shape[1], shape[0]), bs)
            it, vt = jnp.asarray(it_), jnp.asarray(vt_, dtype)
        return BSR(
            indices=iv, values=vv, indices_t=it, values_t=vt,
            nrows=int(shape[0]), ncols=int(shape[1]),
        )


_register(BSR, ["indices", "values", "indices_t", "values_t"],
          ["nrows", "ncols"])


def _bsr_pack_np(rows, cols, vals, shape, bs: int):
    """One-sided block-ELL pack: (indices (nbr,width) int32,
    values (nbr,width,bs,bs) f64-precision numpy).

    Routes through the native OpenMP packer when available (the
    sort-based np.unique below costs ~24 s at 42M nnz; the native
    counting-sort ~1 s — ``native/src/assembly.cpp:bsr_pack_*``); this
    numpy form is the always-available reference implementation."""
    from medane_tchakorom_ufc_thesis_repository_tpu import native

    packed = native.bsr_pack(rows, cols, vals, shape, bs)
    if packed is not None:
        return packed
    nrows, ncols = int(shape[0]), int(shape[1])
    nbr, ncb = -(-nrows // bs), -(-ncols // bs)
    br, bc = rows // bs, cols // bs
    key = br.astype(np.int64) * ncb + bc
    uniq, inv = np.unique(key, return_inverse=True)
    ubr, ubc = (uniq // ncb).astype(np.int64), (uniq % ncb).astype(np.int64)
    counts = np.bincount(ubr, minlength=nbr)
    width = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.zeros(nbr, np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    slot = np.arange(len(uniq)) - starts[ubr]   # uniq sorted => row-grouped
    blocks = np.zeros((len(uniq), bs, bs))
    # stored transposed: blocks[b, j, i] = A_blk[i, j] (the layout
    # BSR._blockmv contracts over)
    np.add.at(blocks, (inv, cols % bs, rows % bs), vals)
    indices = np.zeros((nbr, width), np.int32)
    values = np.zeros((nbr, width, bs, bs))
    indices[ubr, slot] = ubc.astype(np.int32)
    values[ubr, slot] = blocks
    return indices, values


def _coo_symmetric(rows, cols, vals) -> bool:
    """Exact (structural + numeric) symmetry check, host-side: the
    canonically-sorted (r, c, v) triples of A and A^T coincide.
    Duplicate COO entries are coalesced first (packs sum them)."""
    def canon(r, c, v):
        key = r.astype(np.int64) * (c.max() + 1 if c.size else 1) + c
        order = np.argsort(key, kind="stable")
        k, r2, c2, v2 = key[order], r[order], c[order], v[order]
        uniq, inv = np.unique(k, return_inverse=True)
        vs = np.zeros(len(uniq), np.float64)
        np.add.at(vs, inv, v2.astype(np.float64))
        first = np.searchsorted(k, uniq)
        return r2[first], c2[first], vs

    ra, ca, va = canon(rows, cols, vals)
    rb, cb, vb = canon(cols, rows, vals)
    return (len(ra) == len(rb)
            and bool(np.array_equal(ra, rb))
            and bool(np.array_equal(ca, cb))
            and bool(np.array_equal(va, vb)))


@dataclasses.dataclass(frozen=True)
class AIJSegment:
    """One routed row segment of an ``AIJ`` operator (device arrays are
    the static gather/permutation maps; see ``ops/aij_pack.py``)."""

    chunk_ids: jax.Array   # (a,) int32
    k1_idx: jax.Array      # (a*8, 128) int32 (packed 5-field)
    k2_idx: jax.Array      # (a*8, 128) int32 (packed 3-field)
    k3_idx: jax.Array      # (a*8, 128) int32 (packed 3-field)
    vals: jax.Array        # (a*8, 128)
    y_tile: jax.Array      # (a,) int32
    yp_r2: jax.Array       # (a_y*8, 128) int32 — y-unpermute stages
    yp_mid: jax.Array
    yp_r1: jax.Array
    a: int
    tile0: int
    ntiles: int
    a_y: int
    wide: bool = False


_register(AIJSegment,
          ["chunk_ids", "k1_idx", "k2_idx", "k3_idx", "vals", "y_tile",
           "yp_r2", "yp_mid", "yp_r1"],
          ["a", "tile0", "ntiles", "a_y", "wide"])


@dataclasses.dataclass(frozen=True)
class AIJ:
    """General unstructured sparse operator — the PETSc MatAIJ analog
    (reference ``create_matrix_sparse``, ``src/utils/utils.c:139-155``).

    ANY sparsity pattern, square or rectangular, at any size: the pack
    compiles the access pattern into a Clos-routed gather program over
    (8, 128) blocks (``ops/aij_pack.py`` has the construction), applied
    as plain ``take_along_axis`` gathers (``aij_pack.aij_mv_jnp``).
    Per-apply traffic is pattern-independent.

    ``rmv`` (LSQR/CGNE's transpose matvec) runs a second plan packed
    from the transpose — a gather like any other, where ELL's rmv is a
    scatter-add.
    """

    segments: Tuple[AIJSegment, ...]
    t_segments: Tuple[AIJSegment, ...]
    nrows: int
    ncols: int
    n_pad_cols: int
    n_pad_rows: int
    nnz_count: int
    fill: float

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def dtype(self):
        return self.segments[0].vals.dtype

    @property
    def nnz(self) -> int:
        return self.nnz_count

    @staticmethod
    def from_coo(rows, cols, vals, shape, dtype=jnp.float32,
                 with_rmv: bool = True, target_nnz: int = 900_000):
        """``with_rmv`` packs a second plan for the transpose (LSQR/
        CGNE's rmv).  SYMMETRIC matrices share the forward plan instead
        (auto-detected: sorted (row, col, val) triples equal their
        swapped sort) — halving pack time for the common SPD case.  A
        false negative in the detector (duplicate entries sorting
        differently) only costs the extra pack, never correctness."""
        from medane_tchakorom_ufc_thesis_repository_tpu.ops import aij_pack

        def to_segs(plan):
            return tuple(
                AIJSegment(
                    chunk_ids=jnp.asarray(s.chunk_ids),
                    k1_idx=jnp.asarray(s.k1_idx),
                    k2_idx=jnp.asarray(s.k2_idx),
                    k3_idx=jnp.asarray(s.k3_idx),
                    vals=jnp.asarray(s.vals),
                    y_tile=jnp.asarray(s.y_tile),
                    yp_r2=jnp.asarray(s.yp_r2),
                    yp_mid=jnp.asarray(s.yp_mid),
                    yp_r1=jnp.asarray(s.yp_r1),
                    a=s.a, tile0=s.tile0, ntiles=s.ntiles, a_y=s.a_y,
                    wide=s.wide,
                ) for s in plan.segments
            )

        np_dtype = np.dtype(jnp.zeros((), dtype).dtype)
        plan = aij_pack.pack_aij(rows, cols, vals, shape, dtype=np_dtype,
                                 target_nnz=target_nnz)
        t_plan = None
        symmetric = False
        if with_rmv and shape[0] == shape[1]:
            r_ = np.asarray(rows, np.int64)
            c_ = np.asarray(cols, np.int64)
            v_ = np.asarray(vals)
            k1 = r_ * shape[1] + c_
            k2 = c_ * shape[1] + r_
            o1 = np.argsort(k1, kind="stable")
            o2 = np.argsort(k2, kind="stable")
            symmetric = bool(
                np.array_equal(k1[o1], k2[o2])
                and np.allclose(v_[o1], v_[o2], rtol=0, atol=0)
            )
        if with_rmv and not symmetric:
            t_plan = aij_pack.pack_aij(cols, rows, vals,
                                       (shape[1], shape[0]),
                                       dtype=np_dtype,
                                       target_nnz=target_nnz)
        fwd = to_segs(plan)
        return AIJ(
            segments=fwd,
            t_segments=(fwd if (with_rmv and symmetric)
                        else to_segs(t_plan) if t_plan is not None
                        else ()),
            nrows=int(shape[0]), ncols=int(shape[1]),
            n_pad_cols=plan.n_pad_cols,
            n_pad_rows=(t_plan.n_pad_cols if t_plan is not None
                        else 1024 * max(1, -(-int(shape[0]) // 1024))),
            nnz_count=plan.nnz, fill=plan.fill,
        )

    def _apply(self, segments, n_pad, nout, x):
        from medane_tchakorom_ufc_thesis_repository_tpu.ops import aij_pack

        return aij_pack.aij_mv_jnp(segments, n_pad, nout, x)

    def mv(self, x: jax.Array) -> jax.Array:
        return self._apply(self.segments, self.n_pad_cols, self.nrows, x)

    def rmv(self, y: jax.Array) -> jax.Array:
        if not self.t_segments:
            raise ValueError("AIJ packed with with_rmv=False")
        return self._apply(self.t_segments, self.n_pad_rows, self.ncols, y)


_register(AIJ, ["segments", "t_segments"],
          ["nrows", "ncols", "n_pad_cols", "n_pad_rows", "nnz_count",
           "fill"])


def operator_from_coo(rows, cols, vals, shape, dtype=jnp.float32,
                      max_diags: int = 64, max_bsr_cost: float = 16.0,
                      bsr_block_sizes: Tuple[int, ...] = (8, 16, 32, 64,
                                                          128),
                      max_dense_n: Optional[int] = None,
                      max_bsr_bytes: int = 2 << 30):
    """The ``create_matrix_sparse`` entry point (reference
    ``src/utils/utils.c:139-155``): accept ANY sparsity pattern as COO
    and return a device-efficient operator directly — banded → ``DIA``,
    blockable → ``BSR``, small unstructured (n ≤ ``max_dense_n``) →
    ``DenseOp``, large unstructured → ``AIJ`` (or a high-fill ``BSR``
    when its estimated cost undercuts AIJ's).

    ``max_dense_n`` defaults to the calibrated value for the current
    device (``core.calibration``)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu.core.calibration import (
        default_max_dense_n,
    )

    if max_dense_n is None:
        max_dense_n = default_max_dense_n()
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if shape[0] == shape[1]:
        if len(np.unique(cols - rows)) <= max_diags:
            return poisson.coo_to_dia(rows, cols, vals, shape, dtype=dtype)
        routed = _route_unbanded_square_coo(
            rows, cols, vals, shape, dtype, max_bsr_cost,
            bsr_block_sizes, max_dense_n, max_bsr_bytes=max_bsr_bytes,
            caller="operator_from_coo",
        )
        if routed is not None:
            return routed
    elif max(shape) <= max_dense_n:
        # small rectangular → dense: ELL's rectangular rmv is a
        # scatter-add, and rmv is exactly what the least-squares KSPs
        # (lsqr/cgne) drive
        return _dense_from_coo(rows, cols, vals, shape, dtype)
    else:
        # large rectangular → AIJ (Clos-routed gather; rmv is a second
        # routed gather, not a scatter-add)
        return AIJ.from_coo(rows, cols, vals, shape, dtype=dtype)
    return poisson.coo_to_ell(rows, cols, vals, shape, dtype=dtype)


def _dense_from_coo(rows, cols, vals, shape, dtype):
    """Host-side COO -> DenseOp (duplicates coalesced by sum)."""
    dense = np.zeros(shape, np.float64)
    np.add.at(dense, (rows, cols), vals)
    return DenseOp(a=jnp.asarray(dense, dtype))


# Routing constants (gather-ELL and AIJ cost bars, BSR block-size
# penalties, dense cutoff) live in core.calibration: shipped H100
# measurements, overridable by a per-device file from ``utils.calibrate``.


def _route_unbanded_square_coo(rows, cols, vals, shape, dtype,
                               max_bsr_cost, bsr_block_sizes, max_dense_n,
                               max_bsr_bytes: int = 2 << 30, caller=""):
    """Shared routing tail for square non-banded patterns: BSR if the
    estimated cost clears ``max_bsr_cost``; dense if small; then a
    last-resort comparison — a HIGH-fill BSR whose estimated per-nonzero
    cost still undercuts the measured Clos-AIJ cost wins as long as the
    pack fits in ``max_bsr_bytes``; otherwise AIJ (the routed gather —
    pattern-independent, compiles at any n).  Never returns None since
    round 5: the "stay on gather-ELL and warn" branch is retired."""
    import warnings

    from medane_tchakorom_ufc_thesis_repository_tpu.core.calibration import (
        bsr_bs_penalty,
        ell_relative_cost,
    )

    _ELL_RELATIVE_COST = ell_relative_cost()
    penalty = bsr_bs_penalty()
    best = None
    for bs in bsr_block_sizes:
        fill = bsr_block_fill_from_coo(rows, cols, shape, bs)
        cost = fill * penalty.get(bs, 1.0)
        if best is None or cost < best[1]:
            best = (bs, cost, fill)
    if best is not None and best[1] <= max_bsr_cost:
        return BSR.from_coo(rows, cols, vals, shape, bs=best[0],
                            dtype=dtype)
    if shape[0] <= max_dense_n:
        return _dense_from_coo(rows, cols, vals, shape, dtype)
    # AIJ: Clos-routed gather SpMV — pattern-independent cost, compiles
    # at any n (the gather-ELL path OOM'd past ~2048² and ran ~2000x
    # off slice speed; the round-4 "stay on gather-ELL and warn" branch
    # is retired).  A HIGH-fill BSR only wins when its estimated cost
    # undercuts the measured AIJ cost.
    from medane_tchakorom_ufc_thesis_repository_tpu.core.calibration import (
        aij_relative_cost,
    )

    _AIJ_COST = aij_relative_cost()
    if best is not None and best[1] < _AIJ_COST:
        bs, cost, fill = best
        # values + transpose pack + indices ≈ 2.5x the stored values
        pack_bytes = 2.5 * fill * len(rows) * np.dtype(dtype).itemsize
        if pack_bytes <= max_bsr_bytes:
            warnings.warn(
                f"{caller}: matrix is neither banded nor cleanly "
                f"blockable; using HIGH-fill BSR(bs={bs}) at an "
                f"estimated {cost:.0f}x per-nonzero cost — still "
                f"~{_AIJ_COST / max(cost, 1e-9):.1f}x faster "
                "than the routed-gather AIJ (pass max_bsr_cost=inf to "
                "silence, or max_dense_n/max_bsr_cost to reroute)",
                UserWarning, stacklevel=3,
            )
            return BSR.from_coo(rows, cols, vals, shape, bs=bs,
                                dtype=dtype)
    return AIJ.from_coo(rows, cols, vals, shape, dtype=dtype)


def from_scipy(A, dtype=jnp.float32, **route_kw):
    """``operator_from_coo`` over a ``scipy.sparse`` matrix — the
    drop-in for users arriving from the reference's AIJ assembly."""
    coo = A.tocoo()
    return operator_from_coo(coo.row, coo.col, coo.data, coo.shape,
                             dtype=dtype, **route_kw)


def bsr_block_fill_from_coo(rows, cols, shape, bs: int) -> float:
    """Stored-values-per-nonzero if packed as BSR(bs) (cheap, index-only).

    Counts the PADDED pack: block-ELL pads every block row to the widest
    row's block count, and the kernel processes padding like real blocks
    — so a pattern with one dense row (FEM constraint/Lagrange rows)
    costs ``nbr * ncb`` blocks, not just its unique blocks.  Using the
    padded count keeps the routing cost model honest and makes the
    high-fill memory cap match what ``BSR.from_coo`` actually allocates."""
    nbr = -(-int(shape[0]) // bs)
    ncb = -(-int(shape[1]) // bs)
    key = (np.asarray(rows) // bs).astype(np.int64) * ncb \
        + np.asarray(cols) // bs
    ub = np.unique(key)
    width = int(np.bincount(ub // ncb, minlength=nbr).max()) if len(ub) \
        else 0
    return nbr * width * bs * bs / max(len(np.asarray(rows)), 1)


def as_device_operator(op, max_diags: int = 64, max_bsr_cost: float = 16.0,
                    bsr_block_sizes: Tuple[int, ...] = (8, 16, 32, 64, 128),
                    max_dense_n: Optional[int] = None,
                    max_bsr_bytes: int = 2 << 30):
    """Pick a device-efficient representation for ``op``.

    ELL matvecs are elementwise-gather-bound.  Routing for a square ELL
    matrix:

    1. at most ``max_diags`` distinct diagonals → ``DIA`` (slice speed);
    2. blockable → ``BSR`` (block-row gathers + batched sub-block
       matvecs): pick the ``bs`` minimizing
       ``fill(bs) * bsr_bs_penalty()[bs]`` (estimated per-nonzero cost
       relative to the slice paths), accept if that cost is at most
       ``max_bsr_cost``;
    3. small unstructured (n ≤ ``max_dense_n``) → ``DenseOp``;
    4. last resort, a HIGH-fill BSR whose estimated cost still beats
       the measured AIJ cost (``core.calibration``) wins if the pack
       fits in ``max_bsr_bytes``; otherwise ``AIJ``, the routed gather.

    ``max_dense_n`` defaults to the calibrated value for the current
    device (``core.calibration``).
    """
    from medane_tchakorom_ufc_thesis_repository_tpu.core.calibration import (
        default_max_dense_n,
    )

    if max_dense_n is None:
        max_dense_n = default_max_dense_n()
    if isinstance(op, ELL) and op.shape[0] == op.ncols:
        if op.ndiags() <= max_diags:
            return op.to_dia()
        rows, cols, vals = op.to_coo_np()
        routed = _route_unbanded_square_coo(
            rows, cols, vals, op.shape, op.dtype, max_bsr_cost,
            bsr_block_sizes, max_dense_n, max_bsr_bytes=max_bsr_bytes,
            caller="as_device_operator",
        )
        if routed is not None:
            return routed
    return op


def as_matvec(op):
    """Return a pure ``x -> A@x`` closure for any operator."""
    return op.mv


def as_rmatvec(op):
    return op.rmv
