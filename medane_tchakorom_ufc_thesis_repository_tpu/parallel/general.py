"""Distributed general-sparse operators: MPIAIJ across ranks on a mesh.

The reference's ``create_matrix_sparse`` builds MPIAIJ matrices whose
row strips live on different ranks and whose matvec scatters the needed
x entries between them (``utils.c:139-155``; PETSc VecScatter).  Here
the same capability for ARBITRARY sparsity on a device mesh:

* rows are split into one strip per device; each strip is packed as
  block-ELL with **global** sub-block-column ids (the transposed-block
  layout measured fastest in ``core.operators.BSR``);
* the matvec ``all_gather``s x across the mesh and applies the local
  strip — the correct general-pattern baseline (an arbitrary pattern may
  read any entry; the banded/stencil paths in ``parallel/sharded.py``
  exploit structure to exchange only boundary planes instead);
* Krylov reductions ``psum`` over the mesh axes (``solvers/`` is
  distribution-agnostic via ``axis_name``).

Single-chip twin: ``core.operators.BSR`` / ``models.blockops.
StackedBSROperator``.  Use those when the matrix fits one chip; use
this to scale rows across a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov


@dataclasses.dataclass(frozen=True)
class ShardedGeneralBSR:
    """Row-strip-sharded block-ELL operator (device d owns rows
    ``[d*strip, (d+1)*strip)``); ``idx`` holds GLOBAL sub-block-column
    ids, ``val`` the transposed ``(c, c)`` sub-blocks; strips share one
    padded width."""

    idx: jax.Array   # int32 (ndev, nbr, w)
    val: jax.Array   # (ndev, nbr, w, c, c)
    n: int           # true global dimension

    @property
    def ndev(self) -> int:
        return self.idx.shape[0]

    @property
    def c(self) -> int:
        return self.val.shape[-1]

    @property
    def strip(self) -> int:
        return self.idx.shape[1] * self.c

    @property
    def dtype(self):
        return self.val.dtype


jax.tree_util.register_dataclass(
    ShardedGeneralBSR, data_fields=["idx", "val"], meta_fields=["n"],
)


def shard_general_from_coo(rows, cols, vals, n: int, ndev: int,
                           c: int = 8, dtype=jnp.float32
                           ) -> ShardedGeneralBSR:
    """Host-side pack: COO -> one block-ELL strip per device (shared
    padded width).  ``n`` must be divisible by ``ndev`` and the strip by
    ``c`` (pad the matrix first otherwise)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        _bsr_pack_np,
    )

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if n % ndev:
        raise ValueError(f"n={n} not divisible by ndev={ndev}")
    strip = n // ndev
    if strip % c:
        raise ValueError(f"strip={strip} not divisible by c={c}")
    packs = []
    for d in range(ndev):
        lo, hi = d * strip, (d + 1) * strip
        m = (rows >= lo) & (rows < hi)
        packs.append(_bsr_pack_np(
            rows[m] - lo, cols[m], vals[m], (strip, n), c,
        ))
    w = max(p[0].shape[1] for p in packs)
    nbr = strip // c
    idx = np.zeros((ndev, nbr, w), np.int32)
    val = np.zeros((ndev, nbr, w, c, c))
    for d, (i_, v_) in enumerate(packs):
        idx[d, :, : i_.shape[1]] = i_
        val[d, :, : v_.shape[1]] = v_
    return ShardedGeneralBSR(
        idx=jnp.asarray(idx), val=jnp.asarray(val, dtype), n=int(n),
    )


@dataclasses.dataclass(frozen=True)
class ShardedBlockJacobi:
    """Row-strip-sharded block-Jacobi PC (PETSc PCBJACOBI across ranks):
    the ``(bs, bs)`` diagonal-block inverses of device d's strip live on
    device d, so the apply is entirely local — one batched einsum, no
    collectives.  ``inv``: ``(ndev, nb_local, bs, bs)``."""

    inv: jax.Array

    @property
    def bs(self) -> int:
        return self.inv.shape[-1]


jax.tree_util.register_dataclass(
    ShardedBlockJacobi, data_fields=["inv"], meta_fields=[],
)


def shard_bjacobi_from_coo(rows, cols, vals, n: int, ndev: int,
                           bs: int = 64, dtype=jnp.float32
                           ) -> ShardedBlockJacobi:
    """Host-side setup for the sharded PC: global block-diagonal
    inverses (f64, pinv fallback — ``solvers.bjacobi``) reshaped to one
    strip of blocks per device.  ``bs`` must divide the strip so no PC
    block straddles a device boundary."""
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (
        block_jacobi_from_coo,
    )

    if n % ndev:
        raise ValueError(f"n={n} not divisible by ndev={ndev}")
    strip = n // ndev
    if strip % bs:
        raise ValueError(
            f"pc block size {bs} must divide the per-device strip {strip} "
            "(PC blocks must not straddle device boundaries)"
        )
    M = block_jacobi_from_coo(rows, cols, vals, n, bs=bs, dtype=dtype)
    nb = M.inv_blocks.shape[0]
    return ShardedBlockJacobi(
        inv=M.inv_blocks.reshape(ndev, nb // ndev, bs, bs)
    )


def _local_pc_apply(inv_loc, r_loc):
    """Device-local block-diagonal solve ``z = blkdiag(B^-1) r``."""
    bs = inv_loc.shape[-1]
    z = jnp.einsum("bij,bj->bi", inv_loc, r_loc.reshape(-1, bs),
                   precision=jax.lax.Precision.HIGHEST)
    return z.reshape(-1)


def _local_mv(idx, val, x_full):
    """One strip's y from the FULL x (global block-col ids)."""
    c = val.shape[-1]
    g = jnp.take(x_full.reshape(-1, c), idx, axis=0)   # (nbr, w, c)
    y = jnp.einsum("rwji,rwj->ri", val, g,
                   precision=jax.lax.Precision.HIGHEST)
    return y.reshape(-1)


def _solve_program(mesh: Mesh, op: ShardedGeneralBSR, method: str,
                   restart: int, maxiter: int, rtol: float,
                   with_pc: bool):
    axes = tuple(mesh.axis_names)
    ndev = math.prod(mesh.shape[a] for a in axes)
    if ndev != op.ndev:
        raise ValueError(
            f"operator packed for {op.ndev} devices, mesh has {ndev}"
        )
    vec = P(axes)                       # dim 0 over all mesh axes
    idx_spec = P(axes, None, None)
    val_spec = P(axes, None, None, None, None)
    pc_spec = P(axes, None, None, None)

    def body(b_loc, idx_loc, val_loc, pc_loc):
        idx0, val0 = idx_loc[0], val_loc[0]

        def mv(x_loc):
            x_full = lax.all_gather(x_loc, axes, tiled=True)
            return _local_mv(idx0, val0, x_full)

        if method == "cg":
            # true-residual PCG: the (SPD) PC enters as precond
            M = ((lambda r: _local_pc_apply(pc_loc[0], r))
                 if with_pc else None)
            res = krylov.cg(mv, b_loc, maxiter=maxiter, rtol=rtol,
                            axis_name=axes, precond=M)
            x = res.x
        elif method == "bicgstab":
            # nonsymmetric short-recurrence (PETSc KSPBCGS analog):
            # O(1) memory vs GMRES's restart basis; the PC enters as a
            # RIGHT preconditioner (true-residual test, device-local)
            M = ((lambda r: _local_pc_apply(pc_loc[0], r))
                 if with_pc else None)
            res = krylov.bicgstab(mv, b_loc, maxiter=maxiter, rtol=rtol,
                                  axis_name=axes, precond=M)
            x = res.x
        else:
            # RIGHT preconditioning: solve (A M) y = b, x = M y — the
            # Givens estimate then tracks the TRUE residual ||b - A x||
            # (left PC converges in the M-norm, which a stiff PC can
            # leave orders of magnitude off the true one; the reference
            # gestures at the same choice, utils.c:524 KSPSetPCSide
            # PC_RIGHT)
            if with_pc:
                base = mv
                mv = lambda v: base(_local_pc_apply(pc_loc[0], v))
            res = krylov.gmres(mv, b_loc, restart=restart,
                               maxiter=maxiter, rtol=rtol, axis_name=axes)
            x = (_local_pc_apply(pc_loc[0], res.x) if with_pc else res.x)
        return x, res.iters, res.resnorm, res.resnorm0, res.converged

    return jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(vec, idx_spec, val_spec, pc_spec),
        out_specs=(vec, P(), P(), P(), P()),
        check_vma=False,
    ))


def sharded_general_solve(mesh: Mesh, op: ShardedGeneralBSR,
                          b: jax.Array, *, method: str = "gmres",
                          restart: int = 30, maxiter: int = 2000,
                          rtol: float = 1e-6,
                          pc: ShardedBlockJacobi | None = None
                          ) -> krylov.KrylovResult:
    """Solve ``A x = b`` for a row-sharded general-sparse operator with
    GMRES(restart) or CG (SPD), reductions psum'd over the mesh.
    ``pc``: optional row-sharded block-Jacobi (device-local batched
    block-inverse applies; RIGHT PC for GMRES so convergence tests the
    true residual, true-residual ``precond`` for CG)."""
    if method not in ("gmres", "cg", "bicgstab"):
        raise ValueError(
            f"method must be 'gmres' | 'cg' | 'bicgstab', got {method!r}"
        )
    run = _solve_program(mesh, op, method, int(restart), int(maxiter),
                         float(rtol), pc is not None)
    if pc is not None:
        if pc.inv.shape[0] != op.ndev:
            raise ValueError(
                f"pc packed for {pc.inv.shape[0]} devices, operator "
                f"for {op.ndev}"
            )
        pc_inv = jnp.asarray(pc.inv, op.dtype)
    else:
        # unused placeholder so the jitted signature stays fixed
        pc_inv = jnp.zeros((op.ndev, 1, 1, 1), op.dtype)
    x, iters, rnorm, rnorm0, conv = run(
        jnp.asarray(b, op.dtype), op.idx, op.val, pc_inv,
    )
    return krylov.KrylovResult(x=x, iters=iters, resnorm=rnorm,
                               resnorm0=rnorm0, converged=conv)


# ---------------------------------------------------------------------------
# Row-strip-sharded AIJ: the Clos-routed gather SpMV per device strip
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedAIJ:
    """Row-strip-sharded Clos-routed AIJ (round 5): device ``d`` owns
    rows ``[d*strip, (d+1)*strip)`` packed as ONE single-segment AIJ
    plan (``ops/aij_pack``, uniform ``a`` across strips via
    ``min_blocks``); the matvec ``all_gather``s x and runs the routed
    gather program strip-locally.  This is MPIAIJ for STRUCTURELESS
    patterns at gather-kernel speed — ``ShardedGeneralBSR`` remains the
    pick when the pattern has exploitable block structure.

    Arrays carry a leading ``(ndev,)`` axis (one plan per strip).
    """

    chunk_ids: jax.Array   # (ndev, a) int32
    k1_idx: jax.Array      # (ndev, a, 1024) int32 (wide) or (ndev, a*8, 128)
    k2_idx: jax.Array
    k3_idx: jax.Array
    vals: jax.Array
    y_tile: jax.Array      # (ndev, a) int32
    yp_r2: jax.Array       # (ndev, a_y*8, 128) int32
    yp_mid: jax.Array
    yp_r1: jax.Array
    n: int
    a: int
    ntiles: int
    a_y: int
    wide: bool
    n_pad_cols: int

    @property
    def ndev(self) -> int:
        return self.chunk_ids.shape[0]

    @property
    def strip(self) -> int:
        return self.n // self.ndev

    @property
    def dtype(self):
        return self.vals.dtype


jax.tree_util.register_dataclass(
    ShardedAIJ,
    data_fields=["chunk_ids", "k1_idx", "k2_idx", "k3_idx", "vals",
                 "y_tile", "yp_r2", "yp_mid", "yp_r1"],
    meta_fields=["n", "a", "ntiles", "a_y", "wide", "n_pad_cols"],
)


def shard_aij_from_coo(rows, cols, vals, n: int, ndev: int,
                       dtype=jnp.float32) -> ShardedAIJ:
    """Host-side pack: COO -> one single-segment AIJ plan per device
    strip, padded to a UNIFORM block count (two-phase: natural packs,
    then re-pack below-max strips with ``min_blocks`` floored at the
    max).  ``n`` must be divisible by ``ndev``; each strip must fit one
    routing segment (<= 2^20 routed positions ~ 0.8M nnz/strip — split
    rows across more devices beyond that)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.ops import aij_pack

    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    if n % ndev:
        raise ValueError(f"n={n} not divisible by ndev={ndev}")
    strip = n // ndev
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype)

    def pack(d, min_blocks=1):
        lo, hi = d * strip, (d + 1) * strip
        msk = (rows >= lo) & (rows < hi)
        plan = aij_pack.pack_aij(rows[msk] - lo, cols[msk], vals[msk],
                                 (strip, n), dtype=np_dtype,
                                 target_nnz=1 << 62,
                                 min_blocks=min_blocks)
        if len(plan.segments) != 1:
            raise ValueError(
                f"strip {d} needs {len(plan.segments)} routing segments "
                "(> 2^20 routed positions); use more devices")
        return plan.segments[0]

    segs = [pack(d) for d in range(ndev)]
    a_max = max(s.a for s in segs)
    segs = [s if s.a == a_max else pack(d, min_blocks=a_max)
            for d, s in enumerate(segs)]
    stack = lambda f: jnp.asarray(np.stack([getattr(s, f)  # noqa: E731
                                            for s in segs]))
    s0 = segs[0]
    assert all(s.a == a_max and s.ntiles == s0.ntiles
               and s.a_y == s0.a_y and s.wide == s0.wide for s in segs)
    return ShardedAIJ(
        chunk_ids=stack("chunk_ids"), k1_idx=stack("k1_idx"),
        k2_idx=stack("k2_idx"), k3_idx=stack("k3_idx"),
        vals=stack("vals"), y_tile=stack("y_tile"),
        yp_r2=stack("yp_r2"), yp_mid=stack("yp_mid"),
        yp_r1=stack("yp_r1"),
        n=int(n), a=int(a_max), ntiles=int(s0.ntiles),
        a_y=int(s0.a_y), wide=bool(s0.wide),
        n_pad_cols=int(1024 * max(1, -(-n // 1024))),
    )


def _aij_local_mv(op: ShardedAIJ, plan_loc, x_full):
    """One strip's y from the FULL x via the routed gather program."""
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        AIJSegment,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.ops import aij_pack

    (cid, k1, k2, k3, vl, yt, r2, mid, r1) = plan_loc
    seg = AIJSegment(
        chunk_ids=cid[0], k1_idx=k1[0], k2_idx=k2[0], k3_idx=k3[0],
        vals=vl[0], y_tile=yt[0], yp_r2=r2[0], yp_mid=mid[0],
        yp_r1=r1[0], a=op.a, tile0=0, ntiles=op.ntiles, a_y=op.a_y,
        wide=op.wide,
    )
    return aij_pack.aij_mv_jnp((seg,), op.n_pad_cols, op.strip, x_full)


def sharded_aij_solve(mesh: Mesh, op: ShardedAIJ, b: jax.Array, *,
                      method: str = "gmres", restart: int = 30,
                      maxiter: int = 2000, rtol: float = 1e-6
                      ) -> krylov.KrylovResult:
    """GMRES/CG/BiCGStab on a row-sharded AIJ operator: all_gather'd x,
    strip-local routed-gather applies, psum reductions (the
    MPIAIJ-MatMult + KSP pattern for structureless matrices)."""
    if method not in ("gmres", "cg", "bicgstab"):
        raise ValueError(
            f"method must be 'gmres' | 'cg' | 'bicgstab', got {method!r}"
        )
    axes = tuple(mesh.axis_names)
    ndev = math.prod(mesh.shape[a] for a in axes)
    if ndev != op.ndev:
        raise ValueError(
            f"operator packed for {op.ndev} devices, mesh has {ndev}"
        )
    vec = P(axes)
    plan_specs = tuple(
        P(axes, *([None] * (getattr(op, f).ndim - 1)))
        for f in ("chunk_ids", "k1_idx", "k2_idx", "k3_idx", "vals",
                  "y_tile", "yp_r2", "yp_mid", "yp_r1")
    )

    def body(b_loc, *plan_loc):
        def mv(x_loc):
            x_full = lax.all_gather(x_loc, axes, tiled=True)
            return _aij_local_mv(op, plan_loc, x_full)

        if method == "cg":
            res = krylov.cg(mv, b_loc, maxiter=maxiter, rtol=rtol,
                            axis_name=axes)
        elif method == "bicgstab":
            res = krylov.bicgstab(mv, b_loc, maxiter=maxiter, rtol=rtol,
                                  axis_name=axes)
        else:
            res = krylov.gmres(mv, b_loc, restart=restart,
                               maxiter=maxiter, rtol=rtol,
                               axis_name=axes)
        return res.x, res.iters, res.resnorm, res.resnorm0, res.converged

    run = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(vec,) + plan_specs,
        out_specs=(vec, P(), P(), P(), P()),
        check_vma=False,
    ))
    x, iters, rnorm, rnorm0, conv = run(
        jnp.asarray(b, op.dtype), op.chunk_ids, op.k1_idx, op.k2_idx,
        op.k3_idx, op.vals, op.y_tile, op.yp_r2, op.yp_mid, op.yp_r1,
    )
    return krylov.KrylovResult(x=x, iters=iters, resnorm=rnorm,
                               resnorm0=rnorm0, converged=conv)
