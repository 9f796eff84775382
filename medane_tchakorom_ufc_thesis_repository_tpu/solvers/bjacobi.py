"""Block-Jacobi preconditioner with batched dense block inverses.

The reference exposes PETSc's whole PC zoo through ``-inner_pc_type`` /
``-outer_pc_type`` (``iSolve:78-83``, wired in ``initializeKSP``,
``src/utils/utils.c:511-530``); on MPI matrices PETSc's workhorse there
is PCBJACOBI — per-process diagonal blocks solved by local ILU/LU
triangular sweeps.  Sequential triangular solves serialize on a
data-parallel device, so this analog inverts the ``(bs, bs)``
diagonal blocks ONCE at setup (host-side, f64) and applies
``z = blkdiag(B_k^{-1}) r`` as a single batched ``(nb, bs, bs) @ (nb, bs)``
contraction — one batched einsum per application, no data-dependent
control flow, jit/vmap/shard_map-safe.

Accuracy note: an explicit inverse is backward-stable enough for a
preconditioner (it only needs ~1 digit per application); the inverses
are computed in f64 on the host and cast to the run dtype, so the cast,
not the inversion, bounds the error.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "BlockJacobi",
    "block_jacobi_from_coo",
    "block_jacobi_from_scipy",
]


@dataclasses.dataclass(frozen=True)
class BlockJacobi:
    """``M ~= blkdiag(A)^{-1}`` applied as one batched contraction.

    ``inv_blocks``: ``(nb, bs, bs)`` inverses of the diagonal blocks
    (padded tail rows carry identity).  ``n`` is the true vector length.
    Registered as a pytree, so it passes through ``jit``/``shard_map``
    boundaries as data (no retrace per instance).
    """

    inv_blocks: jax.Array
    n: int

    @property
    def bs(self) -> int:
        return self.inv_blocks.shape[-1]

    def apply(self, r: jax.Array) -> jax.Array:
        """``z = M r`` — pad to block multiple, one batched matvec, unpad."""
        nb, bs, _ = self.inv_blocks.shape
        rp = jnp.pad(r, (0, nb * bs - self.n)) if nb * bs != self.n else r
        rb = rp.reshape(nb, bs)
        # values matter (this steers Krylov directions): full f32, not
        # the TF32 an unpinned f32 contraction may get on the GPU
        z = jnp.einsum(
            "bij,bj->bi", self.inv_blocks, rb,
            precision=jax.lax.Precision.HIGHEST,
        )
        return z.reshape(-1)[: self.n]

    def __call__(self, r: jax.Array) -> jax.Array:
        return self.apply(r)


jax.tree_util.register_dataclass(
    BlockJacobi, data_fields=["inv_blocks"], meta_fields=["n"]
)


def block_jacobi_from_coo(rows, cols, vals, n: int, bs: int = 64,
                          dtype=jnp.float32) -> BlockJacobi:
    """Host-side setup: extract the ``(bs, bs)`` diagonal blocks of an
    ``n x n`` COO matrix, invert them in f64, ship ``(nb, bs, bs)``
    inverses to the device.

    Padded tail rows (``n .. nb*bs``) get identity so the last block stays
    invertible.  A singular diagonal block falls back to its pseudo-inverse
    (the PC stays well-defined; PETSc's bjacobi+ILU would error there).
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float64)
    if n <= 0:
        raise ValueError(f"n must be positive, got {n}")
    nb = -(-n // bs)
    blocks = np.zeros((nb, bs, bs), np.float64)
    mask = (rows // bs) == (cols // bs)
    br = rows[mask] // bs
    np.add.at(blocks, (br, rows[mask] % bs, cols[mask] % bs), vals[mask])
    if nb * bs != n:
        tail = np.arange(n % bs, bs)
        blocks[nb - 1, tail, tail] = 1.0
    try:
        inv = np.linalg.inv(blocks)
        finite = np.isfinite(inv).all()
    except np.linalg.LinAlgError:
        inv, finite = None, False
    if inv is None or not finite:
        inv = np.empty_like(blocks)
        for k in range(nb):
            try:
                inv[k] = np.linalg.inv(blocks[k])
                if not np.isfinite(inv[k]).all():
                    raise np.linalg.LinAlgError
            except np.linalg.LinAlgError:
                inv[k] = np.linalg.pinv(blocks[k])
    return BlockJacobi(inv_blocks=jnp.asarray(inv, dtype), n=int(n))


def block_jacobi_from_scipy(A, bs: int = 64, dtype=jnp.float32) -> BlockJacobi:
    """``block_jacobi_from_coo`` over a ``scipy.sparse`` matrix."""
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"block Jacobi needs a square matrix, got {A.shape}")
    coo = A.tocoo()
    return block_jacobi_from_coo(coo.row, coo.col, coo.data, A.shape[0],
                                 bs=bs, dtype=dtype)
