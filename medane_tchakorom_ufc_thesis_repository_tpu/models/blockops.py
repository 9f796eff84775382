"""Stacked block operators: the Jacobi-block decomposition as one pytree.

The reference splits the global system into ``njacobi_blocks`` horizontal
row strips, each strip further split by columns into the diagonal operator
``A_ii`` and the coupling operator ``A_ij``
(``divideSubDomainIntoBlockMatrices``, reference ``src/utils/utils.c:450-478``).
Each block then lives on its own MPI sub-communicator.

Here the decomposition is *data layout*, not process topology: all block
states are stacked along a leading ``nblocks`` axis — ``x`` has shape
``(nblocks, block_size)`` — and the per-block operators act blockwise.
On one chip the block axis is a batch axis (XLA vectorizes across it);
under ``shard_map`` the same arrays shard along the mesh ``'block'`` axis
and the coupling term becomes a ``ppermute`` (see ``parallel/``).

A ``BlockOperator`` exposes:
  * ``diag_mv(x)``     — blockwise ``A_ii @ x_i``            (nb, bs) -> (nb, bs)
  * ``coupling_mv(x)`` — blockwise ``sum_j A_ij @ x_j``      (nb, bs) -> (nb, bs)
  * ``full_mv(x)``     — the global product ``A @ x`` in stacked layout
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import BSR, DIA, ELL
from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson as _poisson


class BlockOperator:
    """Interface (duck-typed; implementations below)."""

    nblocks: int
    block_size: int

    def diag_mv(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def coupling_mv(self, x: jax.Array) -> jax.Array:
        raise NotImplementedError

    def full_mv(self, x: jax.Array) -> jax.Array:
        return self.diag_mv(x) + self.coupling_mv(x)

    # -- global (merged-vector) views, for baselines and residual checks --
    def global_mv(self, x_flat: jax.Array) -> jax.Array:
        nb, bs = self.nblocks, self.block_size
        return self.full_mv(x_flat.reshape(nb, bs)).reshape(-1)


@dataclasses.dataclass(frozen=True)
class StackedStencil2D(BlockOperator):
    """2D 5-point Poisson, matrix-free, blocks = horizontal grid strips.

    Grid ``m x n``; block ``k`` owns grid rows ``[k*rows, (k+1)*rows)``
    with ``rows = m // nblocks`` — the same row convention as the
    reference's ``poisson2DMatrix`` (``src/utils/utils.c:247-293``).
    The coupling ``A_ij @ x_j`` reduces to one halo grid-row per cut.
    """

    m: int
    n: int
    nblocks: int = 2
    diag: float = 4.0
    off: float = -1.0

    def __post_init__(self):
        if self.m % self.nblocks:
            raise ValueError(f"m={self.m} not divisible by {self.nblocks}")

    @property
    def rows(self) -> int:
        return self.m // self.nblocks

    @property
    def block_size(self) -> int:
        return self.rows * self.n

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m * self.n, self.m * self.n)

    @property
    def nnz(self) -> int:
        return 5 * self.m * self.n - 2 * self.m - 2 * self.n

    @property
    def dtype(self):
        # matrix-free: no stored values; follow the session float width
        # (f64 under jax_enable_x64) so default RHS construction doesn't
        # silently truncate intended f64 runs
        return jnp.result_type(float)

    def _grid(self, x):
        return x.reshape(self.nblocks, self.rows, self.n)

    def diag_mv(self, x):
        # pad+slice: XLA fuses it into one bandwidth-bound pass (the
        # .at[].add form lowers to update-slice chains); the block axis
        # is not padded
        g = self._grid(x)
        p = jnp.pad(g, ((0, 0), (1, 1), (1, 1)))
        y = self.diag * g + self.off * (
            p[:, :-2, 1:-1] + p[:, 2:, 1:-1]
            + p[:, 1:-1, :-2] + p[:, 1:-1, 2:]
        )
        return y.reshape(x.shape)

    # per-block matvec hooks for vmapped inner solves -------------------
    @property
    def diag_mv_args(self):
        return None  # uniform stencil: every block shares the operator

    def single_diag_vector(self, args, n):
        """diagonal of A_ii (constant for the Dirichlet stencil) — used by
        Jacobi preconditioning."""
        return jnp.full((n,), self.diag)

    def diag_eig_bounds(self):
        """Analytic spectral bounds of A_ii (Chebyshev inner solves)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
        )

        return poisson_strip_eig_bounds_2d(self.rows, self.n, self.diag,
                                           self.off)

    def single_diag_mv(self, args, xb):
        """``A_ii @ x_i`` for one block (``xb`` of length block_size)."""
        g = xb.reshape(self.rows, self.n)
        p = jnp.pad(g, 1)
        y = self.diag * g + self.off * (
            p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
        )
        return y.reshape(xb.shape)

    def diag_stencil_op(self):
        """A_ii as a standalone stencil operator (the strip's diagonal
        block IS a Dirichlet Poisson operator on the strip rectangle) —
        used to build multigrid inner preconditioning (pc='mg')."""
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            Stencil2D,
        )

        return Stencil2D(self.rows, self.n, self.diag, self.off)

    def halos(self, x):
        """Peer boundary rows for every block: (top, bottom), each (nb, n).

        ``top[k]`` is the last grid row of block ``k-1`` (zeros for k=0);
        ``bottom[k]`` the first grid row of block ``k+1``.  This is the
        entire payload the reference ships with ``MPI_Sendrecv`` of the
        whole block (``comm.c:126-141``) — the stencil only needs the cut
        rows.
        """
        g = self._grid(x)
        zero = jnp.zeros((1, self.n), x.dtype)
        top = jnp.concatenate([zero, g[:-1, -1, :]], axis=0)
        bottom = jnp.concatenate([g[1:, 0, :], zero], axis=0)
        return top, bottom

    def coupling_mv(self, x):
        top, bottom = self.halos(x)
        c = jnp.zeros_like(self._grid(x))
        c = c.at[:, 0, :].add(self.off * top)
        c = c.at[:, -1, :].add(self.off * bottom)
        return c.reshape(x.shape)

    def to_dense(self):
        return jnp.asarray(_poisson.poisson2d_dense_np(self.m, self.n, self.diag, self.off))


jax.tree_util.register_dataclass(
    StackedStencil2D, data_fields=[], meta_fields=["m", "n", "nblocks", "diag", "off"]
)


@dataclasses.dataclass(frozen=True)
class StackedStencil3D(BlockOperator):
    """3D 7-point Poisson, blocks split on the leading grid axis
    (the reference's depth loop, ``poisson3DMatrix`` ``utils.c:30-121``).
    Halos are (ny, nz) planes."""

    nx: int
    ny: int
    nz: int
    nblocks: int = 2
    diag: float = 6.0
    off: float = -1.0

    def __post_init__(self):
        if self.nx % self.nblocks:
            raise ValueError(f"nx={self.nx} not divisible by {self.nblocks}")

    @property
    def rows(self) -> int:
        return self.nx // self.nblocks

    @property
    def block_size(self) -> int:
        return self.rows * self.ny * self.nz

    @property
    def shape(self):
        size = self.nx * self.ny * self.nz
        return (size, size)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return 7 * nx * ny * nz - 2 * (nx * ny + ny * nz + nx * nz)

    def _grid(self, x):
        return x.reshape(self.nblocks, self.rows, self.ny, self.nz)

    def diag_mv(self, x):
        g = self._grid(x)
        p = jnp.pad(g, ((0, 0), (1, 1), (1, 1), (1, 1)))
        y = self.diag * g + self.off * (
            p[:, :-2, 1:-1, 1:-1] + p[:, 2:, 1:-1, 1:-1]
            + p[:, 1:-1, :-2, 1:-1] + p[:, 1:-1, 2:, 1:-1]
            + p[:, 1:-1, 1:-1, :-2] + p[:, 1:-1, 1:-1, 2:]
        )
        return y.reshape(x.shape)

    @property
    def diag_mv_args(self):
        return None

    def single_diag_vector(self, args, n):
        return jnp.full((n,), self.diag)

    def diag_eig_bounds(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            poisson_strip_eig_bounds_3d,
        )

        return poisson_strip_eig_bounds_3d(self.rows, self.ny, self.nz,
                                           self.diag, self.off)

    def single_diag_mv(self, args, xb):
        g = xb.reshape(self.rows, self.ny, self.nz)
        p = jnp.pad(g, 1)
        y = self.diag * g + self.off * (
            p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
            + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]
        )
        return y.reshape(xb.shape)

    def diag_stencil_op(self):
        """A_ii as a standalone stencil operator (see StackedStencil2D)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            Stencil3D,
        )

        return Stencil3D(self.rows, self.ny, self.nz, self.diag, self.off)

    def halos(self, x):
        g = self._grid(x)
        zero = jnp.zeros((1, self.ny, self.nz), x.dtype)
        top = jnp.concatenate([zero, g[:-1, -1]], axis=0)
        bottom = jnp.concatenate([g[1:, 0], zero], axis=0)
        return top, bottom

    def coupling_mv(self, x):
        top, bottom = self.halos(x)
        c = jnp.zeros_like(self._grid(x))
        c = c.at[:, 0].add(self.off * top)
        c = c.at[:, -1].add(self.off * bottom)
        return c.reshape(x.shape)

    def to_dense(self):
        return jnp.asarray(
            _poisson.poisson3d_dense_np(self.nx, self.ny, self.nz, self.diag, self.off)
        )


jax.tree_util.register_dataclass(
    StackedStencil3D,
    data_fields=[],
    meta_fields=["nx", "ny", "nz", "nblocks", "diag", "off"],
)


@dataclasses.dataclass(frozen=True)
class StackedELLOperator(BlockOperator):
    """General sparse path: stacked per-block ELL planes.

    ``a_ii``: indices/values ``(nb, bs, w1)`` with *local* column ids;
    ``a_ic``: indices/values ``(nb, bs, w2)`` with *global* column ids
    (padded slots value 0).  Produced by ``core.poisson.block_split_ell``,
    the analog of the reference's sub-matrix extraction
    (``divideSubDomainIntoBlockMatrices``, ``utils.c:450-478``).
    """

    a_ii: ELL
    a_ic: ELL

    @property
    def nblocks(self) -> int:
        return self.a_ii.indices.shape[0]

    @property
    def block_size(self) -> int:
        return self.a_ii.indices.shape[1]

    @property
    def shape(self):
        n = self.nblocks * self.block_size
        return (n, n)

    @property
    def nnz(self) -> int:
        return int((self.a_ii.values != 0).sum() + (self.a_ic.values != 0).sum())

    @property
    def dtype(self):
        return self.a_ii.values.dtype

    def diag_mv(self, x):
        def one(idx, val, xb):
            return jnp.sum(val * xb[idx], axis=-1)

        return jax.vmap(one)(self.a_ii.indices, self.a_ii.values, x)

    @property
    def diag_mv_args(self):
        return (self.a_ii.indices, self.a_ii.values)

    def single_diag_mv(self, args, xb):
        idx, val = args
        return jnp.sum(val * xb[idx], axis=-1)

    def single_diag_vector(self, args, n):
        idx, val = args
        rows = jnp.arange(idx.shape[0])[:, None]
        return jnp.sum(jnp.where(idx == rows, val, 0.0), axis=-1)

    def diag_coo_np(self):
        """Per-block COO of A_ii, host-side (the ``pc='bjacobi'`` setup
        hook): list of ``(rows, cols, vals)`` numpy triples."""
        idx = np.asarray(self.a_ii.indices)
        val = np.asarray(self.a_ii.values)
        nb, bs, w = idx.shape
        rows = np.broadcast_to(np.arange(bs)[:, None], (bs, w))
        out = []
        for b in range(nb):
            m = val[b] != 0
            out.append((rows[m], idx[b][m], val[b][m]))
        return out

    def coupling_mv(self, x):
        x_flat = x.reshape(-1)
        gathered = x_flat[self.a_ic.indices]  # (nb, bs, w2)
        return jnp.sum(self.a_ic.values * gathered, axis=-1)

    def to_dense(self):
        nb, bs = self.nblocks, self.block_size
        n = nb * bs
        dense = jnp.zeros((n, n), self.dtype)
        for b in range(nb):
            sub = ELL(self.a_ii.indices[b], self.a_ii.values[b], bs).to_dense()
            dense = dense.at[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs].add(sub)
            subc = ELL(self.a_ic.indices[b], self.a_ic.values[b], n).to_dense()
            dense = dense.at[b * bs:(b + 1) * bs, :].add(subc)
        return dense


jax.tree_util.register_dataclass(
    StackedELLOperator, data_fields=["a_ii", "a_ic"], meta_fields=[]
)


@dataclasses.dataclass(frozen=True)
class StackedDIAOperator(BlockOperator):
    """Banded general-sparse path: diagonal-plane storage, no gathers.

    The ELL gather SpMV reads an index per nonzero and gathers — for
    banded systems
    (every constant-stencil PDE discretization, the reference's
    ``create_matrix_sparse`` AIJ use case, ``utils.c:139-155``) the same
    matrix is a handful of diagonal planes, and the matvec becomes a sum
    of shifted contiguous slices that XLA fuses into one bandwidth-bound
    pass.

    ``dia_ii``/``dia_ic`` are GLOBAL row-aligned ``DIA`` planes over the
    merged ``(nb*bs,)`` vector — ``dia_ii`` holds entries whose column
    lies in the row's own block (the A_ii blocks; identical offsets in
    every block since the split is uniform), ``dia_ic`` the cross-block
    coupling.  Build from an ELL split with ``from_stacked_ell``.
    """

    dia_ii: DIA
    dia_ic: DIA
    nblocks: int

    @property
    def block_size(self) -> int:
        return self.dia_ii.shape[0] // self.nblocks

    @property
    def shape(self):
        return self.dia_ii.shape

    @property
    def nnz(self) -> int:
        return int((np.asarray(self.dia_ii.data) != 0).sum()
                   + (np.asarray(self.dia_ic.data) != 0).sum())

    @property
    def dtype(self):
        return self.dia_ii.dtype

    def diag_mv(self, x):
        return self.dia_ii.mv(x.reshape(-1)).reshape(x.shape)

    def coupling_mv(self, x):
        return self.dia_ic.mv(x.reshape(-1)).reshape(x.shape)

    # per-block hooks for the vmapped inner solves -----------------------
    @property
    def diag_mv_args(self):
        # A_ii rows/cols shift together across blocks, so each block's
        # local DIA shares the global offsets with data plane slice
        # data[:, i*bs:(i+1)*bs]
        nd = self.dia_ii.data.shape[0]
        bs = self.block_size
        return self.dia_ii.data.reshape(nd, self.nblocks, bs).transpose(1, 0, 2)

    def single_diag_mv(self, args, xb):
        data = args                      # (ndiag, bs)
        bs = xb.shape[0]
        offs = self.dia_ii.offsets
        maxo = max((abs(o) for o in offs), default=0)
        xp = jnp.pad(xb, (maxo, maxo))
        y = jnp.zeros_like(xb)
        for d, off in enumerate(offs):
            y = y + data[d] * xp[maxo + off: maxo + off + bs]
        return y

    def single_diag_vector(self, args, n):
        data = args
        for d, off in enumerate(self.dia_ii.offsets):
            if off == 0:
                return data[d]
        return jnp.zeros((n,), self.dtype)

    def diag_coo_np(self):
        """Per-block COO of A_ii, host-side (the ``pc='bjacobi'`` setup
        hook).  Matches ``single_diag_mv``'s row-aligned convention:
        ``A_ii[i, i+off] = args[d, i]``."""
        args = np.asarray(self.diag_mv_args)    # (nblocks, ndiag, bs)
        bs = self.block_size
        out = []
        for b in range(self.nblocks):
            rows, cols, vals = [], [], []
            for d, off in enumerate(self.dia_ii.offsets):
                i = np.arange(max(0, -off), min(bs, bs - off))
                rows.append(i)
                cols.append(i + off)
                vals.append(args[b, d, i])
            r = np.concatenate(rows)
            c = np.concatenate(cols)
            v = np.concatenate(vals)
            m = v != 0
            out.append((r[m], c[m], v[m]))
        return out

    def to_dense(self):
        return self.dia_ii.to_dense() + self.dia_ic.to_dense()


jax.tree_util.register_dataclass(
    StackedDIAOperator, data_fields=["dia_ii", "dia_ic"],
    meta_fields=["nblocks"],
)


@dataclasses.dataclass(frozen=True)
class StackedBSROperator(BlockOperator):
    """Blockable general-sparse path: the multisplitting analog of
    ``core.operators.BSR`` (MPIAIJ parity for patterns that are neither
    banded nor a constant stencil, ``utils.c:139-155``).

    ``ii_idx``/``ii_val``: per-Jacobi-block diagonal parts as block-ELL
    with a shared width — ``(nb, nbr, w)`` int32 LOCAL sub-block-column
    ids and ``(nb, nbr, w, c, c)`` TRANSPOSED ``(c, c)`` sub-blocks
    (the layout ``BSR`` uses).
    ``ii_diag``: ``(nb, bs)`` diagonal of each A_ii (Jacobi pc hook).
    ``ic``: the cross-block coupling as one global ``BSR`` over the
    merged ``(nb*bs,)`` vector.  Build with ``from_stacked_ell``.
    """

    ii_idx: jax.Array
    ii_val: jax.Array
    ii_diag: jax.Array
    ic: BSR
    nblocks: int
    block_size: int

    @property
    def shape(self):
        n = self.nblocks * self.block_size
        return (n, n)

    @property
    def nnz(self) -> int:
        return int((np.asarray(self.ii_val) != 0).sum()
                   + (np.asarray(self.ic.values) != 0).sum())

    @property
    def dtype(self):
        return self.ii_val.dtype

    @staticmethod
    def _bell_mv(idx, val, xb, bs):
        """Block-ELL matvec on one block's local vector (length bs)."""
        c = val.shape[-1]
        nbr = val.shape[0]
        xp = jnp.pad(xb, (0, nbr * c - bs)) if nbr * c != bs else xb
        g = jnp.take(xp.reshape(nbr, c), idx, axis=0)   # (nbr, w, c)
        y = jnp.einsum("rwji,rwj->ri", val, g,
                       precision=jax.lax.Precision.HIGHEST)
        return y.reshape(-1)[:bs]

    def diag_mv(self, x):
        bs = self.block_size
        return jax.vmap(
            lambda i, v, xb: self._bell_mv(i, v, xb, bs)
        )(self.ii_idx, self.ii_val, x)

    def coupling_mv(self, x):
        return self.ic.mv(x.reshape(-1)).reshape(x.shape)

    # per-block hooks for the vmapped inner solves -----------------------
    @property
    def diag_mv_args(self):
        return (self.ii_idx, self.ii_val, self.ii_diag)

    def single_diag_mv(self, args, xb):
        idx, val, _ = args
        return self._bell_mv(idx, val, xb, xb.shape[0])

    def single_diag_vector(self, args, n):
        _, _, dvec = args
        return dvec

    def diag_coo_np(self):
        """Per-block COO of A_ii, host-side (the ``pc='bjacobi'`` setup
        hook).  Blocks are stored transposed (``ii_val[b,r,k,j,i]``);
        rows/cols beyond the true ``block_size`` are block-ELL padding
        (all-zero) and are dropped."""
        idx = np.asarray(self.ii_idx)
        val = np.asarray(self.ii_val)           # (nb, nbr, w, c, c)
        nb, nbr, w, c, _ = val.shape
        bs = self.block_size
        out = []
        for b in range(nb):
            rows, cols, vals = [], [], []
            for r in range(nbr):
                for k in range(w):
                    blk = val[b, r, k].T        # un-transpose
                    if not blk.any():
                        continue
                    cc = int(idx[b, r, k])
                    rr, ccx = np.nonzero(blk)
                    rows.append(r * c + rr)
                    cols.append(cc * c + ccx)
                    vals.append(blk[rr, ccx])
            if rows:
                r_ = np.concatenate(rows)
                c_ = np.concatenate(cols)
                v_ = np.concatenate(vals)
            else:
                r_ = np.zeros(0, np.int64)
                c_ = np.zeros(0, np.int64)
                v_ = np.zeros(0)
            m = (r_ < bs) & (c_ < bs)
            out.append((r_[m], c_[m], v_[m]))
        return out

    def to_dense(self):
        nb, bs = self.nblocks, self.block_size
        n = nb * bs
        dense = jnp.asarray(self.ic.to_dense())
        c = self.ii_val.shape[-1]
        for b in range(nb):
            nbr, w = self.ii_idx.shape[1], self.ii_idx.shape[2]
            sub = np.zeros((nbr * c, nbr * c), np.float64)
            for r in range(nbr):
                for k in range(w):
                    cc = int(self.ii_idx[b, r, k])
                    sub[r * c:(r + 1) * c, cc * c:(cc + 1) * c] += (
                        np.asarray(self.ii_val[b, r, k]).T
                    )
            dense = dense.at[b * bs:(b + 1) * bs, b * bs:(b + 1) * bs].add(
                jnp.asarray(sub[:bs, :bs], self.dtype)
            )
        return dense


jax.tree_util.register_dataclass(
    StackedBSROperator,
    data_fields=["ii_idx", "ii_val", "ii_diag", "ic"],
    meta_fields=["nblocks", "block_size"],
)


def from_stacked_ell(op: StackedELLOperator,
                     max_diags: int = 64):
    """Convert a banded ``StackedELLOperator`` to ``StackedDIAOperator``.

    Host-side one-time repack (numpy): every nonzero ``A[g, c]`` lands on
    diagonal ``c - g`` of a global row-aligned plane.  Returns the input
    unchanged when either part has more than ``max_diags`` distinct
    diagonals (genuinely unstructured sparsity stays on the ELL path).
    """
    nb, bs = op.nblocks, op.block_size
    n = nb * bs
    dtype = np.asarray(op.a_ii.values).dtype

    def planes(idx, val, local):
        rows_g = (np.arange(nb)[:, None, None] * bs
                  + np.arange(bs)[None, :, None])      # (nb, bs, 1)
        if local:
            # a_ii column ids are block-local: globalize by block offset
            cols_g = idx + np.arange(nb)[:, None, None] * bs
        else:
            cols_g = idx
        nzmask = val != 0
        offs = np.unique((cols_g - rows_g)[nzmask])
        if offs.size > max_diags:
            return None, None
        data = np.zeros((offs.size, n), dtype)
        omap = {int(o): d for d, o in enumerate(offs)}
        g = np.broadcast_to(rows_g, idx.shape)[nzmask]
        c = cols_g[nzmask]
        v = val[nzmask]
        # dtype pinned: an EMPTY part (e.g. block-diagonal system with a
        # zero coupling half) yields a float64 array from the empty
        # comprehension, which np.add.at rejects as an index
        d_idx = np.array([omap[int(o)] for o in (c - g)], dtype=np.intp)
        np.add.at(data, (d_idx, g), v)
        return data, tuple(int(o) for o in offs)

    ii_idx = np.asarray(op.a_ii.indices)
    ii_val = np.asarray(op.a_ii.values)
    ic_idx = np.asarray(op.a_ic.indices)
    ic_val = np.asarray(op.a_ic.values)
    data_ii, offs_ii = planes(ii_idx, ii_val, local=True)
    data_ic, offs_ic = planes(ic_idx, ic_val, local=False)
    if data_ii is None or data_ic is None:
        return op
    return StackedDIAOperator(
        dia_ii=DIA(data=jnp.asarray(data_ii), offsets=offs_ii),
        dia_ic=DIA(data=jnp.asarray(data_ic), offsets=offs_ic),
        nblocks=nb,
    )


def stacked_bsr_from_ell(op: StackedELLOperator,
                         block_sizes: Tuple[int, ...] = (8, 16, 32, 64),
                         max_cost: float = 16.0):
    """Convert a blockable (non-banded) ``StackedELLOperator`` to
    ``StackedBSROperator``.  Returns None when no sub-block size in
    ``block_sizes`` keeps the estimated per-nonzero cost (fill x
    measured layout penalty, shared with ``as_device_operator``) under
    ``max_cost`` for BOTH the diagonal parts and the coupling."""
    from medane_tchakorom_ufc_thesis_repository_tpu.core.calibration import (
        bsr_bs_penalty,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        _bsr_pack_np,
        bsr_block_fill_from_coo,
    )

    _BSR_BS_PENALTY = bsr_bs_penalty()

    nb, bsz = op.nblocks, op.block_size
    n = nb * bsz
    ii_idx = np.asarray(op.a_ii.indices)
    ii_val = np.asarray(op.a_ii.values)
    ic_idx = np.asarray(op.a_ic.indices)
    ic_val = np.asarray(op.a_ic.values)
    rows_local = np.broadcast_to(
        np.arange(bsz)[None, :, None], ii_idx.shape
    )

    def part_coo(idx, val, globalize_rows):
        mask = val != 0
        r = np.broadcast_to(
            np.arange(bsz)[None, :, None], idx.shape)[mask]
        if globalize_rows:
            b = np.broadcast_to(
                np.arange(nb)[:, None, None], idx.shape)[mask]
            r = r + b * bsz
        return r, idx[mask], val[mask]

    # candidate cost over diag blocks (worst block) + coupling
    total_nnz_ii = int((ii_val != 0).sum())
    total_nnz_ic = int((ic_val != 0).sum())
    best = None
    for c in block_sizes:
        stored = 0
        for b in range(nb):
            mask = ii_val[b] != 0
            r = rows_local[b][mask]
            cc = ii_idx[b][mask]
            stored += bsr_block_fill_from_coo(
                r, cc, (bsz, bsz), c) * mask.sum()
        rg, cg, _ = part_coo(ic_idx, ic_val, True)
        if total_nnz_ic:
            stored += bsr_block_fill_from_coo(rg, cg, (n, n), c) \
                * total_nnz_ic
        cost = (stored / max(total_nnz_ii + total_nnz_ic, 1)
                * _BSR_BS_PENALTY.get(c, 1.0))
        if cost <= max_cost and (best is None or cost < best[1]):
            best = (c, cost)
    if best is None:
        return None
    c = best[0]
    dtype = op.a_ii.values.dtype

    # per-block diagonal packs with a SHARED width (pad to max)
    packs = []
    for b in range(nb):
        mask = ii_val[b] != 0
        packs.append(_bsr_pack_np(
            rows_local[b][mask], ii_idx[b][mask], ii_val[b][mask],
            (bsz, bsz), c,
        ))
    w = max(p[0].shape[1] for p in packs)
    nbr = packs[0][0].shape[0]
    idx_all = np.zeros((nb, nbr, w), np.int32)
    val_all = np.zeros((nb, nbr, w, c, c))
    for b, (i_, v_) in enumerate(packs):
        idx_all[b, :, : i_.shape[1]] = i_
        val_all[b, :, : v_.shape[1]] = v_

    # diagonal vector of each A_ii (Jacobi pc hook)
    dvec = np.zeros((nb, bsz))
    diag_mask = (ii_idx == rows_local) & (ii_val != 0)
    np.add.at(
        dvec,
        (np.broadcast_to(np.arange(nb)[:, None, None],
                         ii_idx.shape)[diag_mask],
         rows_local[diag_mask]),
        ii_val[diag_mask],
    )

    rg, cg, vg = part_coo(ic_idx, ic_val, True)
    ic_bsr = BSR.from_coo(rg, cg, vg, (n, n), bs=c, dtype=dtype)
    return StackedBSROperator(
        ii_idx=jnp.asarray(idx_all),
        ii_val=jnp.asarray(val_all, dtype),
        ii_diag=jnp.asarray(dvec, dtype),
        ic=ic_bsr, nblocks=nb, block_size=bsz,
    )


def as_stacked_device_operator(op, max_diags: int = 64,
                               max_bsr_cost: float = 16.0,
                               bsr_block_sizes: Tuple[int, ...] = (8, 16, 32,
                                                                   64)):
    """Pick the device-efficient stacked representation (the blockwise
    analog of ``core.operators.as_device_operator``): banded ELL splits
    become DIA planes, blockable splits become ``StackedBSROperator``,
    and anything left passes through with a ``UserWarning`` (the
    elementwise-gather path is the slowest of the three)."""
    if isinstance(op, StackedELLOperator):
        out = from_stacked_ell(op, max_diags=max_diags)
        if out is not op:
            return out
        bsr = stacked_bsr_from_ell(op, bsr_block_sizes, max_bsr_cost)
        if bsr is not None:
            return bsr
        import warnings

        warnings.warn(
            "as_stacked_device_operator: block split is neither banded "
            f"(> {max_diags} distinct diagonals) nor blockable "
            f"(estimated BSR cost > {max_bsr_cost}x per nonzero); "
            "staying on gather-ELL block applies.",
            UserWarning, stacklevel=2,
        )
    return op


def block_poisson2d(m: int, n: int, nblocks: int = 2) -> StackedStencil2D:
    return StackedStencil2D(m=m, n=n, nblocks=nblocks)


def block_poisson3d(nx: int, ny: int, nz: int, nblocks: int = 2) -> StackedStencil3D:
    return StackedStencil3D(nx=nx, ny=ny, nz=nz, nblocks=nblocks)


def block_poisson2d_ell(m: int, n: int, nblocks: int = 2, dtype=jnp.float32) -> StackedELLOperator:
    a_ii, a_ic = _poisson.block_split_ell(
        *_poisson.poisson2d_coo(m, n), nblocks=nblocks, dtype=dtype
    )
    return StackedELLOperator(a_ii=a_ii, a_ic=a_ic)


def final_residual_norm(op: BlockOperator, xs, bs) -> jax.Array:
    """Global true residual norm with PER-BLOCK full-length iterates —
    parity with ``computeFinalResidualNorm_new`` (reference
    ``src/utils/utils.c:597-620``): block ``i`` applies its row strip
    ``A_i`` to its OWN full-length vector ``xs[i]`` (each block holds a
    private copy of the merged x in the reference drivers), computes
    ``r_i = bs[i] - A_i xs[i]``, and the global norm is
    ``sqrt(sum_i ||r_i||^2)`` (the roots-communicator Allreduce).

    ``xs``: ``(nblocks, nblocks * block_size)`` per-block merged iterates;
    ``bs``: ``(nblocks, block_size)`` per-block RHS strips.
    """
    nb = op.nblocks
    xs = jnp.asarray(xs)
    bs = jnp.asarray(bs)
    rs = [
        bs[i] - op.full_mv(xs[i].reshape(nb, op.block_size))[i]
        for i in range(nb)
    ]
    r = jnp.stack(rs)
    return jnp.sqrt(jnp.sum(r * r))


def rhs_ones(op: BlockOperator, dtype=None) -> jax.Array:
    """Stacked RHS ``b = A @ 1`` (exact solution u = 1), the analog of
    ``computeTheRightHandSideWithInitialGuess`` (``utils.c:623-650``).
    Default dtype: the operator's (stored-value dtype for ELL/DIA; the
    session float width for matrix-free stencils)."""
    dtype = dtype or getattr(op, "dtype", None) or jnp.result_type(float)
    ones = jnp.ones((op.nblocks, op.block_size), dtype)
    return op.full_mv(ones)
