"""Sharded multisplitting: the multi-chip execution path.

The same mathematics as ``models.multisplitting`` laid out over a device
mesh ``('block', 'intra')`` with ``shard_map``:

* each device owns a contiguous strip of grid rows (2D) / planes (3D);
* the inner GMRES runs *per block* as an SPMD collective over ``'intra'``
  (dot products ``psum`` over 'intra') — the analog of the reference's
  per-block KSPSolve over the block sub-communicator;
* the diagonal-block matvec exchanges one boundary row between intra
  neighbors via ``ppermute`` (the analog of PETSc's VecScatter halos);
* the inter-block coupling term ships the cut rows across the ``'block'``
  axis via ``ppermute`` — replacing ``comm_sync_send_and_receive``
  (reference ``src/utils/comm.c:126-141``); bounded-staleness publishing
  replaces the async ``Isend``/``Iprobe``-drain path (``comm.c:6-77``);
* norms are two-level psums ('intra' then 'block'), matching the
  roots-communicator ``MPI_Allreduce`` hierarchy
  (``computeFinalResidualNorm``, ``utils.c:575-595``);
* the s-step minimization solves the tall-skinny least-squares via a
  psum-reduced s x s Gram matrix — replacing the reference's explicit
  dense-R half exchange (``comm_sync_send_and_receive_minimization``,
  ``comm.c:252-286``) with one tiny collective.

SPMD lockstep notes: inner solves run ``fixed_cycles`` GMRES (static trip
count, masked updates) so blocks that converge early cannot desynchronize
collectives; all outer termination flags are global reductions, so every
device sees identical loop trip counts.

Canonical local layout: every device's state is ``(rows_local, fdim)``
where ``fdim`` is the product of the non-split grid dims (n for 2D,
ny*nz for 3D) — boundary rows are then uniformly ``g[..., 0, :]`` /
``g[..., -1, :]`` regardless of grid rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map  # jax>=0.8 home (was jax.experimental)

from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
)


# ---------------------------------------------------------------------------
# Sharded stencil configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPoisson2D:
    """2D 5-point Poisson on ``m x n``, grid rows sharded over devices."""

    m: int
    n: int
    diag: float = 4.0
    off: float = -1.0

    @property
    def split_extent(self) -> int:
        return self.m

    @property
    def fdim(self) -> int:
        return self.n

    @property
    def global_shape(self):
        return (self.m, self.n)

    @property
    def nnz(self) -> int:
        return 5 * self.m * self.n - 2 * self.m - 2 * self.n

    def interior_mv(self, g):
        """Local-strip stencil, zero external halos; ``g`` is
        ``(..., rows, n)`` (possibly stacked with a leading s axis).
        Pad+slice form — fuses to one bandwidth-bound pass."""
        lead = len(g.shape) - 2
        p = jnp.pad(g, ((0, 0),) * lead + ((1, 1), (1, 1)))
        sl = (slice(None),) * lead
        return self.diag * g + self.off * (
            p[sl + (slice(0, -2), slice(1, -1))]
            + p[sl + (slice(2, None), slice(1, -1))]
            + p[sl + (slice(1, -1), slice(0, -2))]
            + p[sl + (slice(1, -1), slice(2, None))]
        )


@dataclasses.dataclass(frozen=True)
class ShardedPoisson3D:
    """3D 7-point Poisson on ``nx x ny x nz``, x-planes sharded;
    canonical local layout ``(planes, ny*nz)``."""

    nx: int
    ny: int
    nz: int
    diag: float = 6.0
    off: float = -1.0

    @property
    def split_extent(self) -> int:
        return self.nx

    @property
    def fdim(self) -> int:
        return self.ny * self.nz

    @property
    def global_shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def nnz(self) -> int:
        nx, ny, nz = self.nx, self.ny, self.nz
        return 7 * nx * ny * nz - 2 * (nx * ny + ny * nz + nx * nz)

    def interior_mv(self, g):
        lead = g.shape[:-1]
        gg = g.reshape(lead + (self.ny, self.nz))
        nlead = len(lead) - 1  # the rows axis is lead[-1]
        p = jnp.pad(gg, ((0, 0),) * nlead + ((1, 1), (1, 1), (1, 1)))
        sl = (slice(None),) * nlead
        c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
        y = self.diag * gg + self.off * (
            p[sl + (lo, c, c)] + p[sl + (hi, c, c)]
            + p[sl + (c, lo, c)] + p[sl + (c, hi, c)]
            + p[sl + (c, c, lo)] + p[sl + (c, c, hi)]
        )
        return y.reshape(g.shape)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

def _check_spmd_configs(inner, outer) -> None:
    """Fail loudly on options the SPMD backends don't implement (silently
    running a different algorithm than configured corrupts experiments)."""
    if inner.method not in ("gmres", "chebyshev", "ca_gmres"):
        raise ValueError(
            f"SPMD backends support inner methods 'gmres', 'chebyshev', "
            f"and 'ca_gmres', not {inner.method!r} (use the stacked "
            f"backend for 'cg')"
        )
    if inner.pc not in ("none", "jacobi"):
        raise ValueError(
            f"SPMD backends implement inner pc 'none' and 'jacobi', "
            f"not {inner.pc!r}"
        )
    if outer.method not in ("qr", "normal", "lsqr"):
        raise ValueError(
            f"SPMD backends implement outer methods 'qr' (distributed "
            f"TSQR), 'normal' (psum-reduced Gram), and 'lsqr' (sharded "
            f"Paige-Saunders), not {outer.method!r} — use the stacked "
            f"backend for cgne"
        )
    # alpha_average (the reference's *_modify variants) is a pmean over
    # 'block' after the per-block LS solve — composes with every outer
    # method (lsqr is already lockstep across 'block')


def make_full_mv(opcfg, ni: int, nb: int):
    """Whole-mesh stencil apply on the canonical ``(rows, fdim)`` local
    layout, shared by the sharded GMRES/CA-GMRES baselines.

    Halo/compute overlap schedule (the VecScatterBegin/End split — the
    reference's VecScatterEnd wait is a top-6 hotspot): issue every
    ppermute FIRST, compute the whole interior while the collectives are
    in flight, and only then consume the halos.  The
    ``optimization_barrier`` pins that order — XLA's latency-hiding
    scheduler places collective-permute-start before the interior fusion
    and collective-permute-done after it, so the transfer time hides
    under the interior stencil pass.
    """
    off = opcfg.off
    up_pairs = [(i, i + 1) for i in range(ni - 1)]
    down_pairs = [(i, i - 1) for i in range(1, ni)]
    blk_up = [(k, k + 1) for k in range(nb - 1)]
    blk_down = [(k, k - 1) for k in range(1, nb)]

    def full_mv(g):
        top_i = lax.ppermute(g[-1, :], "intra", up_pairs)
        bot_i = lax.ppermute(g[0, :], "intra", down_pairs)
        wrap_top = lax.ppermute(g[-1, :], "intra", [(ni - 1, 0)])
        top_b = lax.ppermute(wrap_top, "block", blk_up)
        wrap_bot = lax.ppermute(g[0, :], "intra", [(0, ni - 1)])
        bot_b = lax.ppermute(wrap_bot, "block", blk_down)
        y = opcfg.interior_mv(g)
        y, top_i, bot_i, top_b, bot_b = lax.optimization_barrier(
            (y, top_i, bot_i, top_b, bot_b)
        )
        y = y.at[0, :].add(off * (top_i + top_b))
        y = y.at[-1, :].add(off * (bot_i + bot_b))
        return y

    return full_mv


def sharded_gmres_solve(
    mesh: Mesh,
    opcfg,
    b: jax.Array,
    *,
    restart: int = 30,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    orthog: str = "cgs2",
):
    """Full-system restarted GMRES over the whole mesh — the sharded
    analog of the reference's ``gmres_solution`` baseline
    (``src/gmres_solution/gmres_solution.c:58-91``).  The operator is the
    complete stencil (intra halos + cross-block halos on the same
    iterate); reductions psum over both mesh axes.  Returns a
    ``KrylovResult`` with ``x`` in grid shape.
    """
    nb = mesh.shape["block"]
    ni = mesh.shape["intra"]
    ndev = nb * ni
    if opcfg.split_extent % ndev:
        raise ValueError(
            f"grid extent {opcfg.split_extent} not divisible by {ndev} devices"
        )
    gshape = opcfg.global_shape
    rows_loc = opcfg.split_extent // ndev
    fdim = opcfg.fdim
    lshape = (rows_loc, fdim)
    full_mv = make_full_mv(opcfg, ni, nb)

    def body(b_loc):
        # the while_loop is SPMD-safe here: all reductions span the whole
        # mesh, so every device computes the identical convergence flag
        # and takes the same trip count.  fixed_cycles is only needed for
        # per-block solves whose flags differ across 'block'.
        res = krylov.gmres(
            lambda v: full_mv(v.reshape(lshape)).reshape(-1),
            b_loc.reshape(-1),
            restart=restart, maxiter=maxiter, rtol=rtol, atol=atol,
            orthog=orthog, axis_name=("block", "intra"),
        )
        return (res.x.reshape(lshape), res.iters, res.resnorm,
                res.resnorm0, res.converged)

    shard_spec = P(("block", "intra"), None)
    scalar = P()
    run = shard_map(
        body, mesh=mesh,
        in_specs=(shard_spec,),
        out_specs=(shard_spec, scalar, scalar, scalar, scalar),
        check_vma=False,
    )
    b_flat = b.reshape(opcfg.split_extent, fdim)
    b_sh = jax.device_put(b_flat, NamedSharding(mesh, shard_spec))
    x, iters, resnorm, resnorm0, converged = run(b_sh)
    return krylov.KrylovResult(
        x=x.reshape(gshape), iters=iters, resnorm=resnorm,
        resnorm0=resnorm0, converged=converged,
    )


def sharded_ca_gmres_solve(
    mesh: Mesh,
    opcfg,
    b: jax.Array,
    *,
    s: int = 12,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    reductions: str = "single",
    lmin: Optional[float] = None,
    lmax: Optional[float] = None,
):
    """Communication-avoiding whole-mesh GMRES: ONE collective per s
    matvecs (``reductions='single'``) instead of GMRES's 2-4 psums per
    iteration.  This is CA-GMRES's actual target deployment: on a device
    mesh every reduction is a round-trip between devices on the critical
    path,
    and the Newton-basis reformulation amortizes s matvecs' worth of
    orthogonalization into one ``(s+1) x (s+1)`` Gram psum
    (``solvers/castep.py``; Hoemmen 2010).  Spectral interval defaults
    to the analytic whole-domain Poisson bounds.
    """
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
        ca_gmres,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
        poisson_strip_eig_bounds_2d,
        poisson_strip_eig_bounds_3d,
    )

    nb = mesh.shape["block"]
    ni = mesh.shape["intra"]
    ndev = nb * ni
    if opcfg.split_extent % ndev:
        raise ValueError(
            f"grid extent {opcfg.split_extent} not divisible by {ndev} devices"
        )
    if lmin is None or lmax is None:
        if isinstance(opcfg, ShardedPoisson2D):
            lmin, lmax = poisson_strip_eig_bounds_2d(
                opcfg.m, opcfg.n, opcfg.diag, opcfg.off
            )
        elif isinstance(opcfg, ShardedPoisson3D):
            lmin, lmax = poisson_strip_eig_bounds_3d(
                opcfg.nx, opcfg.ny, opcfg.nz, opcfg.diag, opcfg.off
            )
        else:
            raise ValueError(
                "ca_gmres needs lmin/lmax for this operator (analytic "
                "bounds are derived only for the Poisson stencils)"
            )
    gshape = opcfg.global_shape
    rows_loc = opcfg.split_extent // ndev
    fdim = opcfg.fdim
    lshape = (rows_loc, fdim)
    full_mv = make_full_mv(opcfg, ni, nb)

    def body(b_loc):
        res = ca_gmres(
            lambda v: full_mv(v.reshape(lshape)).reshape(-1),
            b_loc.reshape(-1),
            s=s, maxiter=maxiter, rtol=rtol, atol=atol,
            lmin=lmin, lmax=lmax, reductions=reductions,
            axis_name=("block", "intra"),
        )
        return (res.x.reshape(lshape), res.iters, res.resnorm,
                res.resnorm0, res.converged)

    shard_spec = P(("block", "intra"), None)
    scalar = P()
    run = shard_map(
        body, mesh=mesh,
        in_specs=(shard_spec,),
        out_specs=(shard_spec, scalar, scalar, scalar, scalar),
        check_vma=False,
    )
    b_flat = b.reshape(opcfg.split_extent, fdim)
    b_sh = jax.device_put(b_flat, NamedSharding(mesh, shard_spec))
    x, iters, resnorm, resnorm0, converged = run(b_sh)
    return krylov.KrylovResult(
        x=x.reshape(gshape), iters=iters, resnorm=resnorm,
        resnorm0=resnorm0, converged=converged,
    )


def sharded_multisplit_solve(
    mesh: Mesh,
    opcfg,
    b: jax.Array,
    x0: Optional[jax.Array] = None,
    *,
    rnorm0: Optional[float] = None,
    schedule: str = "sync",
    staleness: Union[int, Sequence[int]] = 1,
    minimization: Optional[str] = None,
    s: int = 4,
    inner: InnerConfig = InnerConfig(),
    outer: OuterConfig = OuterConfig(),
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    record_history: bool = False,
    basis_collection: str = "sweep",
) -> MultisplitResult:
    """Sharded two-stage multisplitting over ``mesh ('block','intra')``.

    ``b`` is the GLOBAL right-hand side in grid shape; it is resharded to
    ``P(('block','intra'))`` on the leading grid axis internally.  The
    returned ``MultisplitResult.x`` is the global solution in grid shape.
    Parameters match ``models.multisplitting.multisplit_solve``.
    """
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    is_async = schedule == "async"
    if minimization is None:
        s = 1

    nb = mesh.shape["block"]
    ni = mesh.shape["intra"]
    ndev = nb * ni
    if opcfg.split_extent % ndev:
        raise ValueError(
            f"grid extent {opcfg.split_extent} not divisible by {ndev} devices"
        )
    gshape = opcfg.global_shape
    if tuple(b.shape) != tuple(gshape):
        raise ValueError(f"b must have grid shape {gshape}, got {b.shape}")
    rows_loc = opcfg.split_extent // ndev
    fdim = opcfg.fdim
    lshape = (rows_loc, fdim)
    lsize = rows_loc * fdim
    dtype = b.dtype
    off = opcfg.off

    stal_host = np.broadcast_to(np.asarray(staleness, np.int32), (nb,)).copy()
    if not is_async and not np.all(stal_host == 1):
        raise ValueError("sync schedule requires staleness == 1")
    stal = jnp.asarray(stal_host)

    up_pairs = [(i, i + 1) for i in range(ni - 1)]
    down_pairs = [(i, i - 1) for i in range(1, ni)]
    blk_up = [(k, k + 1) for k in range(nb - 1)]
    blk_down = [(k, k - 1) for k in range(1, nb)]

    def intra_halos(g):
        """Boundary-row exchange between intra neighbors (same block);
        zeros arrive at block-internal edges."""
        top = lax.ppermute(g[..., -1, :], "intra", up_pairs)
        bot = lax.ppermute(g[..., 0, :], "intra", down_pairs)
        return top, bot

    def cross_block_halos(g):
        """Cut rows from neighboring *blocks*: wrap within 'intra', then
        shift across 'block'; only (intra==0)/(intra==ni-1) devices of
        interior blocks receive nonzeros, everything else gets ppermute's
        implicit zeros (incl. the global Dirichlet boundary)."""
        wrap_top = lax.ppermute(g[..., -1, :], "intra", [(ni - 1, 0)])
        top = lax.ppermute(wrap_top, "block", blk_up)
        wrap_bot = lax.ppermute(g[..., 0, :], "intra", [(0, ni - 1)])
        bot = lax.ppermute(wrap_bot, "block", blk_down)
        return top, bot

    def diag_mv(g):
        """A_ii @ x_i on the local strip (intra halos only).

        Overlap schedule: ppermutes issued first, interior stencil
        computed while they fly, halos consumed after the barrier (see
        ``full_mv`` in ``sharded_gmres_solve``)."""
        top, bot = intra_halos(g)
        y = opcfg.interior_mv(g)
        y, top, bot = lax.optimization_barrier((y, top, bot))
        y = y.at[..., 0, :].add(off * top)
        y = y.at[..., -1, :].add(off * bot)
        return y

    def coupling_mv(g_vis):
        """A_ij @ x_j from the published peer-block state."""
        top, bot = cross_block_halos(g_vis)
        c = jnp.zeros_like(g_vis)
        c = c.at[..., 0, :].add(off * top)
        c = c.at[..., -1, :].add(off * bot)
        return c

    _check_spmd_configs(inner, outer)
    if inner.method in ("chebyshev", "ca_gmres") and inner.pc != "none":
        raise ValueError(
            f"{inner.method} inner solve does not compose with pc"
        )
    if inner.method in ("chebyshev", "ca_gmres"):
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            chebyshev,
            poisson_strip_eig_bounds_2d,
            poisson_strip_eig_bounds_3d,
        )

        if inner.eig_min is not None and inner.eig_max is not None:
            cheb_bounds = (inner.eig_min, inner.eig_max)
        elif isinstance(opcfg, ShardedPoisson2D):
            cheb_bounds = poisson_strip_eig_bounds_2d(
                opcfg.m // nb, opcfg.n, opcfg.diag, opcfg.off
            )
        elif isinstance(opcfg, ShardedPoisson3D):
            cheb_bounds = poisson_strip_eig_bounds_3d(
                opcfg.nx // nb, opcfg.ny, opcfg.nz, opcfg.diag, opcfg.off
            )
        else:
            raise ValueError(
                f"{inner.method} needs eig bounds for this operator"
            )

        if inner.method == "ca_gmres":
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
                ca_gmres,
            )

            def inner_solve(rhs, x):
                # communication-avoiding inner solve: ONE 'intra' psum
                # per inner.restart matvecs (vs ~3/matvec for GMRES);
                # fixed_cycles keeps trip counts lockstep across 'block'
                return ca_gmres(
                    lambda v: diag_mv(v.reshape(lshape)).reshape(-1),
                    rhs.reshape(-1), x.reshape(-1),
                    s=inner.restart, maxiter=inner.maxiter,
                    rtol=inner.rtol, atol=inner.atol,
                    lmin=cheb_bounds[0], lmax=cheb_bounds[1],
                    axis_name="intra", fixed_cycles=True,
                    reductions="single",
                )
        else:
            def inner_solve(rhs, x):
                return chebyshev(
                    lambda v: diag_mv(v.reshape(lshape)).reshape(-1),
                    rhs.reshape(-1), x.reshape(-1),
                    lmin=cheb_bounds[0], lmax=cheb_bounds[1],
                    maxiter=inner.maxiter, axis_name="intra",
                )
    else:
        # left Jacobi preconditioning: the stencil diagonal is constant,
        # so D^-1 is one scalar scale of operator and RHS (convergence
        # tested in the preconditioned norm, PETSc default — matches the
        # stacked backend's pc='jacobi' path)
        dinv = 1.0 / opcfg.diag if inner.pc == "jacobi" else 1.0

        def inner_solve(rhs, x):
            return krylov.gmres(
                lambda v: dinv * diag_mv(v.reshape(lshape)).reshape(-1),
                dinv * rhs.reshape(-1),
                x.reshape(-1),
                restart=inner.restart,
                maxiter=inner.maxiter,
                rtol=inner.rtol,
                atol=inner.atol,
                orthog=inner.orthog,
                axis_name="intra",
                fixed_cycles=True,
                basis_dtype=inner.basis_dtype(),
            )

    # the SPMD solver loop is shared with the tiled layout
    from medane_tchakorom_ufc_thesis_repository_tpu.parallel.engine import (
        make_spmd_body,
    )

    body_scalar = make_spmd_body(
        diag_mv=diag_mv, coupling_mv=coupling_mv, inner_solve=inner_solve,
        lshape=lshape, nb=nb, intra_axes=("intra",),
        all_axes=("block", "intra"), is_async=is_async, stal=stal,
        minimization=minimization, s=s, outer=outer,
        rtol=rtol, atol=atol, maxiter=maxiter,
        min_convergence_count=min_convergence_count, dtype=dtype,
        record_history=record_history, basis_collection=basis_collection,
        pinned_rnorm0=rnorm0,
    )

    def body(b_loc, x0_loc):
        (x, sweeps, cycles, inner_total, rn, rn0, block_norm,
         outer_rnorm, converged, hist) = body_scalar(b_loc, x0_loc)
        return (x, sweeps, cycles, inner_total, rn, rn0,
                block_norm.reshape(1), outer_rnorm, converged, hist)

    shard_spec = P(("block", "intra"), None)
    scalar = P()
    run = shard_map(
        body,
        mesh=mesh,
        in_specs=(shard_spec, shard_spec),
        out_specs=(shard_spec, scalar, scalar, scalar, scalar, scalar,
                   P("block"), scalar, scalar, scalar),
        check_vma=False,
    )
    b_flat = b.reshape(opcfg.split_extent, fdim)
    b_sh = jax.device_put(b_flat, NamedSharding(mesh, shard_spec))
    x0_flat = (jnp.zeros_like(b_flat) if x0 is None
               else jnp.asarray(x0, dtype).reshape(opcfg.split_extent, fdim))
    x0_sh = jax.device_put(x0_flat, NamedSharding(mesh, shard_spec))
    (x, sweeps, cycles, inner_total, rnorm_out, rnorm0_out, block_norms,
     outer_rnorm, converged, hist) = run(b_sh, x0_sh)
    return MultisplitResult(
        x=x.reshape(gshape), sweeps=sweeps, cycles=cycles,
        inner_iters=inner_total, rnorm=rnorm_out, rnorm0=rnorm0_out,
        local_rnorms=block_norms, outer_rnorm=outer_rnorm,
        converged=converged,
        history=hist if record_history else None,
    )
