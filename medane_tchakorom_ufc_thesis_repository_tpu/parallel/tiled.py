"""2D/3D-tiled sharded multisplitting: mesh ``('block', 'ir', 'ic')``.

The reference (and ``parallel.sharded``) split the grid along the leading
axis only — fine at small scale, but strips get thin as devices grow and
halo traffic scales with the full cross-section.  These drivers tile each
Jacobi block's band in TWO directions, so halo traffic per device scales
with the tile perimeter:

* ``'block'`` — Jacobi blocks (leading-axis bands, as always);
* ``'ir'``    — leading-axis tiles within a block;
* ``'ic'``    — second-axis tiles (shared by all blocks).

Halo pattern (5/7-point stencils need no corners):
  leading axis: ppermute over 'ir' inside a block; block-boundary
  slices ride the wrap + 'block'-shift two-step (see ``parallel.sharded``);
  second axis: ppermute over 'ic' (no cross-block component — blocks
  split the leading axis only, exactly the reference's decomposition);
  third axis (3D): device-local.

Surface-to-volume: a P-device 1-D split moves O(cross-section) per device
per sweep; an (P_r x P_c) tiling moves O(perimeter) — asymptotically the
square root at equal device counts.

The solver loop itself lives in ``parallel.engine`` (shared with the 1-D
``sharded`` layout).
"""

from __future__ import annotations

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
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.engine import (
    make_spmd_body,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel.sharded import (
    _check_spmd_configs,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
    chebyshev,
    poisson_strip_eig_bounds_2d,
    poisson_strip_eig_bounds_3d,
)


def _make_tiled_inner(inner: InnerConfig, diag_mv, lshape, bounds_fn,
                      diag_val=None):
    """Per-block inner solve over the ('ir','ic') axes; honest dispatch
    on InnerConfig.method (silently substituting GMRES for a configured
    method would corrupt experiments).  ``diag_val`` enables the scalar
    Jacobi left-preconditioner for constant-diagonal stencils."""
    if inner.method in ("chebyshev", "ca_gmres") and inner.pc != "none":
        raise ValueError(
            f"{inner.method} inner solve does not compose with pc")
    if inner.method in ("chebyshev", "ca_gmres"):
        if inner.eig_min is not None and inner.eig_max is not None:
            lo, hi = inner.eig_min, inner.eig_max
        else:
            lo, hi = bounds_fn()

        if inner.method == "ca_gmres":
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
                ca_gmres,
            )

            def inner_solve(rhs, x):
                # communication-avoiding inner solve: ONE ('ir','ic')
                # psum per inner.restart matvecs; fixed_cycles keeps
                # trip counts lockstep across 'block' (mirrors the 1-D
                # sharded backend's dispatch)
                return ca_gmres(
                    lambda v: diag_mv(v.reshape(lshape)).reshape(-1),
                    rhs.reshape(-1), x.reshape(-1),
                    s=inner.restart, maxiter=inner.maxiter,
                    rtol=inner.rtol, atol=inner.atol,
                    lmin=lo, lmax=hi,
                    axis_name=("ir", "ic"), fixed_cycles=True,
                    reductions="single",
                )
        else:
            def inner_solve(rhs, x):
                return chebyshev(
                    lambda v: diag_mv(v.reshape(lshape)).reshape(-1),
                    rhs.reshape(-1), x.reshape(-1),
                    lmin=lo, lmax=hi, maxiter=inner.maxiter,
                    axis_name=("ir", "ic"),
                )
    else:
        dinv = (1.0 / diag_val
                if (inner.pc == "jacobi" and diag_val is not None) else 1.0)

        def inner_solve(rhs, x):
            return krylov.gmres(
                lambda v: dinv * diag_mv(v.reshape(lshape)).reshape(-1),
                dinv * rhs.reshape(-1), x.reshape(-1),
                restart=inner.restart, maxiter=inner.maxiter,
                rtol=inner.rtol, atol=inner.atol, orthog=inner.orthog,
                axis_name=("ir", "ic"), fixed_cycles=True,
                basis_dtype=inner.basis_dtype(),
            )

    return inner_solve


def make_tiled_mesh(nblocks: int = 2, ir: int = 2, ic: int = 2,
                    devices=None) -> Mesh:
    devices = list(jax.devices() if devices is None else devices)
    need = nblocks * ir * ic
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.array(devices[:need]).reshape(nblocks, ir, ic)
    return Mesh(grid, ("block", "ir", "ic"))


def _common(mesh, schedule, staleness, minimization, s, inner, outer):
    _check_spmd_configs(inner, outer)
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    is_async = schedule == "async"
    if minimization is None:
        s = 1
    nb = mesh.shape["block"]
    pr = mesh.shape["ir"]
    pc = mesh.shape["ic"]
    stal_host = np.broadcast_to(np.asarray(staleness, np.int32), (nb,)).copy()
    if not is_async and not np.all(stal_host == 1):
        raise ValueError("sync schedule requires staleness == 1")
    return is_async, s, nb, pr, pc, jnp.asarray(stal_host)


def _halo_fns(nb, pr, pc, lead_edge, second_edge):
    """ppermute plumbing shared by the 2D and 3D stencils.

    ``lead_edge(g, side)`` / ``second_edge(g, side)`` extract boundary
    slices along the split axes ('first'/'last')."""
    r_up = [(i, i + 1) for i in range(pr - 1)]
    r_dn = [(i, i - 1) for i in range(1, pr)]
    c_up = [(i, i + 1) for i in range(pc - 1)]
    c_dn = [(i, i - 1) for i in range(1, pc)]
    blk_up = [(k, k + 1) for k in range(nb - 1)]
    blk_dn = [(k, k - 1) for k in range(1, nb)]

    def intra(g):
        north = lax.ppermute(lead_edge(g, "last"), "ir", r_up)
        south = lax.ppermute(lead_edge(g, "first"), "ir", r_dn)
        west = lax.ppermute(second_edge(g, "last"), "ic", c_up)
        east = lax.ppermute(second_edge(g, "first"), "ic", c_dn)
        return north, south, west, east

    def cross(g):
        wrap_n = lax.ppermute(lead_edge(g, "last"), "ir", [(pr - 1, 0)])
        north = lax.ppermute(wrap_n, "block", blk_up)
        wrap_s = lax.ppermute(lead_edge(g, "first"), "ir", [(0, pr - 1)])
        south = lax.ppermute(wrap_s, "block", blk_dn)
        return north, south

    return intra, cross


def _run(mesh, body_scalar, b, split0, split1, lshape, gshape, nb, dtype,
         record_history=False, x0=None):
    """shard_map launch + result assembly shared by 2D/3D."""
    def body(b_loc, x0_loc):
        (x, sweeps, cycles, inner_total, rnorm, rnorm0, block_norm,
         outer_rnorm, converged, hist) = body_scalar(b_loc, x0_loc)
        return (x, sweeps, cycles, inner_total, rnorm, rnorm0,
                block_norm.reshape((1,) * len(gshape)), outer_rnorm,
                converged, hist)

    grid_rank = len(gshape)
    shard_spec = P(("block", "ir"), "ic", *([None] * (grid_rank - 2)))
    scalar = P()
    block_spec = P("block", *([None] * (grid_rank - 1)))
    run = shard_map(
        body, mesh=mesh,
        in_specs=(shard_spec, shard_spec),
        out_specs=(shard_spec, scalar, scalar, scalar, scalar, scalar,
                   block_spec, scalar, scalar, scalar),
        check_vma=False,
    )
    b_sh = jax.device_put(b, NamedSharding(mesh, shard_spec))
    x0_full = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    x0_sh = jax.device_put(x0_full, NamedSharding(mesh, shard_spec))
    (x, sweeps, cycles, inner_total, rnorm, rnorm0, block_norms, outer_rnorm,
     converged, hist) = run(b_sh, x0_sh)
    return MultisplitResult(
        x=x, sweeps=sweeps, cycles=cycles, inner_iters=inner_total,
        rnorm=rnorm, rnorm0=rnorm0,
        local_rnorms=block_norms.reshape(-1)[:nb],
        outer_rnorm=outer_rnorm, converged=converged,
        history=hist if record_history else None,
    )


def tiled_multisplit_solve(
    mesh: Mesh,
    m: int,
    n: int,
    b: jax.Array,
    *,
    diag: float = 4.0,
    off: float = -1.0,
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
    """2D Poisson multisplitting over a ``('block','ir','ic')`` mesh.

    ``b`` is the global RHS in grid shape ``(m, n)``.
    """
    is_async, s, nb, pr, pc, stal = _common(
        mesh, schedule, staleness, minimization, s, inner, outer
    )
    if m % (nb * pr) or n % pc:
        raise ValueError(
            f"grid {m}x{n} not divisible by ({nb}*{pr}) x {pc} tiles"
        )
    rows_loc, cols_loc = m // (nb * pr), n // pc
    lshape = (rows_loc, cols_loc)
    dtype = b.dtype
    if tuple(b.shape) != (m, n):
        raise ValueError(f"b must be ({m}, {n}), got {b.shape}")

    intra, cross = _halo_fns(
        nb, pr, pc,
        lead_edge=lambda g, side: g[..., -1, :] if side == "last" else g[..., 0, :],
        second_edge=lambda g, side: g[..., :, -1] if side == "last" else g[..., :, 0],
    )

    def interior(g):
        p = jnp.pad(g, ((0, 0),) * (g.ndim - 2) + ((1, 1), (1, 1)))
        sl = (slice(None),) * (g.ndim - 2)
        c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
        return diag * g + off * (
            p[sl + (lo, c)] + p[sl + (hi, c)]
            + p[sl + (c, lo)] + p[sl + (c, hi)]
        )

    def diag_mv(g):
        # halo/compute overlap: ppermutes issued first, interior stencil
        # computed while they fly, halos consumed only after the barrier
        # (collective-start ... interior ... collective-done scheduling;
        # see parallel/sharded.py full_mv)
        nh, sh, wh, eh = intra(g)
        y = interior(g)
        y, nh, sh, wh, eh = lax.optimization_barrier((y, nh, sh, wh, eh))
        y = y.at[..., 0, :].add(off * nh)
        y = y.at[..., -1, :].add(off * sh)
        y = y.at[..., :, 0].add(off * wh)
        y = y.at[..., :, -1].add(off * eh)
        return y

    def coupling_mv(g_vis):
        nh, sh = cross(g_vis)
        c = jnp.zeros_like(g_vis)
        c = c.at[..., 0, :].add(off * nh)
        c = c.at[..., -1, :].add(off * sh)
        return c

    inner_solve = _make_tiled_inner(
        inner, diag_mv, lshape, diag_val=diag,
        bounds_fn=lambda: poisson_strip_eig_bounds_2d(m // nb, n, diag, off),
    )

    body_scalar = make_spmd_body(
        diag_mv=diag_mv, coupling_mv=coupling_mv, inner_solve=inner_solve,
        lshape=lshape, nb=nb, intra_axes=("ir", "ic"),
        all_axes=("block", "ir", "ic"), is_async=is_async, stal=stal,
        minimization=minimization, s=s, outer=outer,
        rtol=rtol, atol=atol, maxiter=maxiter,
        min_convergence_count=min_convergence_count, dtype=dtype,
        record_history=record_history, basis_collection=basis_collection,
    )
    return _run(mesh, body_scalar, b, None, None, lshape, (m, n), nb, dtype,
                record_history=record_history)


def tiled_multisplit_solve_3d(
    mesh: Mesh,
    nx: int,
    ny: int,
    nz: int,
    b: jax.Array,
    *,
    diag: float = 6.0,
    off: float = -1.0,
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
    """3D Poisson multisplitting: x-planes over ('block','ir'), y over
    'ic', z local.  ``b`` is the global RHS in grid shape (nx, ny, nz)."""
    is_async, s, nb, pr, pc, stal = _common(
        mesh, schedule, staleness, minimization, s, inner, outer
    )
    if nx % (nb * pr) or ny % pc:
        raise ValueError(
            f"grid {nx}x{ny}x{nz} not divisible by ({nb}*{pr}) x {pc} tiles"
        )
    px_loc, py_loc = nx // (nb * pr), ny // pc
    lshape = (px_loc, py_loc, nz)
    dtype = b.dtype
    if tuple(b.shape) != (nx, ny, nz):
        raise ValueError(f"b must be ({nx},{ny},{nz}), got {b.shape}")

    intra, cross = _halo_fns(
        nb, pr, pc,
        lead_edge=lambda g, side: (g[..., -1, :, :] if side == "last"
                                   else g[..., 0, :, :]),
        second_edge=lambda g, side: (g[..., :, -1, :] if side == "last"
                                     else g[..., :, 0, :]),
    )

    def interior(g):
        p = jnp.pad(g, ((0, 0),) * (g.ndim - 3) + ((1, 1), (1, 1), (1, 1)))
        sl = (slice(None),) * (g.ndim - 3)
        c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
        return diag * g + off * (
            p[sl + (lo, c, c)] + p[sl + (hi, c, c)]
            + p[sl + (c, lo, c)] + p[sl + (c, hi, c)]
            + p[sl + (c, c, lo)] + p[sl + (c, c, hi)]
        )

    def diag_mv(g):
        # halo/compute overlap (see the 2D driver above)
        nh, sh, wh, eh = intra(g)
        y = interior(g)
        y, nh, sh, wh, eh = lax.optimization_barrier((y, nh, sh, wh, eh))
        y = y.at[..., 0, :, :].add(off * nh)
        y = y.at[..., -1, :, :].add(off * sh)
        y = y.at[..., :, 0, :].add(off * wh)
        y = y.at[..., :, -1, :].add(off * eh)
        return y

    def coupling_mv(g_vis):
        nh, sh = cross(g_vis)
        c = jnp.zeros_like(g_vis)
        c = c.at[..., 0, :, :].add(off * nh)
        c = c.at[..., -1, :, :].add(off * sh)
        return c

    inner_solve = _make_tiled_inner(
        inner, diag_mv, lshape, diag_val=diag,
        bounds_fn=lambda: poisson_strip_eig_bounds_3d(
            nx // nb, ny, nz, diag, off
        ),
    )

    body_scalar = make_spmd_body(
        diag_mv=diag_mv, coupling_mv=coupling_mv, inner_solve=inner_solve,
        lshape=lshape, nb=nb, intra_axes=("ir", "ic"),
        all_axes=("block", "ir", "ic"), is_async=is_async, stal=stal,
        minimization=minimization, s=s, outer=outer,
        rtol=rtol, atol=atol, maxiter=maxiter,
        min_convergence_count=min_convergence_count, dtype=dtype,
        record_history=record_history, basis_collection=basis_collection,
    )
    return _run(mesh, body_scalar, b, None, None, lshape, (nx, ny, nz), nb,
                dtype, record_history=record_history)


def tiled_gmres_solve(
    mesh: Mesh,
    m: int,
    n: int,
    b: jax.Array,
    *,
    diag: float = 4.0,
    off: float = -1.0,
    restart: int = 30,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    orthog: str = "cgs2",
):
    """Whole-system GMRES over the 2-D-tiled ``('block','ir','ic')``
    mesh — the ``gmres_solution`` baseline (reference
    ``gmres_solution.c:58-91``) with the 2-D tiling: halo
    traffic per device scales with the tile PERIMETER instead of the
    full grid cross-section of the 1-D strip split
    (``sharded_gmres_solve``).  Reductions psum over all three axes;
    the while_loop is SPMD-safe because every flag is a global
    reduction.
    """
    nb = mesh.shape["block"]
    pr = mesh.shape["ir"]
    pc = mesh.shape["ic"]
    if m % (nb * pr) or n % pc:
        raise ValueError(
            f"grid {m}x{n} not divisible by ({nb}*{pr}) x {pc} tiles"
        )
    rows_loc, cols_loc = m // (nb * pr), n // pc
    lshape = (rows_loc, cols_loc)

    intra, cross = _halo_fns(
        nb, pr, pc,
        lead_edge=lambda g, side: g[..., -1, :] if side == "last" else g[..., 0, :],
        second_edge=lambda g, side: g[..., :, -1] if side == "last" else g[..., :, 0],
    )

    def interior(g):
        p = jnp.pad(g, ((1, 1), (1, 1)))
        c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
        return diag * g + off * (
            p[lo, c] + p[hi, c] + p[c, lo] + p[c, hi]
        )

    def full_mv(g):
        # complete stencil on one iterate: intra halos + cross-block
        # halos, with the overlap schedule (issue ppermutes, compute
        # interior, consume after the barrier)
        nh, sh, wh, eh = intra(g)
        cn, cs = cross(g)
        y = interior(g)
        y, nh, sh, wh, eh, cn, cs = lax.optimization_barrier(
            (y, nh, sh, wh, eh, cn, cs)
        )
        y = y.at[0, :].add(off * (nh + cn))
        y = y.at[-1, :].add(off * (sh + cs))
        y = y.at[:, 0].add(off * wh)
        y = y.at[:, -1].add(off * eh)
        return y

    def body(b_loc):
        res = krylov.gmres(
            lambda v: full_mv(v.reshape(lshape)).reshape(-1),
            b_loc.reshape(-1),
            restart=restart, maxiter=maxiter, rtol=rtol, atol=atol,
            orthog=orthog, axis_name=("block", "ir", "ic"),
        )
        return (res.x.reshape(lshape), res.iters, res.resnorm,
                res.resnorm0, res.converged)

    shard_spec = P(("block", "ir"), "ic")
    scalar = P()
    run = shard_map(
        body, mesh=mesh,
        in_specs=(shard_spec,),
        out_specs=(shard_spec, scalar, scalar, scalar, scalar),
        check_vma=False,
    )
    b_sh = jax.device_put(
        b.reshape(m, n), NamedSharding(mesh, shard_spec)
    )
    x, iters, resnorm, resnorm0, converged = run(b_sh)
    return krylov.KrylovResult(
        x=x, iters=iters, resnorm=resnorm,
        resnorm0=resnorm0, converged=converged,
    )


def tiled_gmres_solve_3d(
    mesh: Mesh,
    nx: int,
    ny: int,
    nz: int,
    b: jax.Array,
    *,
    diag: float = 6.0,
    off: float = -1.0,
    restart: int = 30,
    maxiter: int = 10000,
    rtol: float = 1e-5,
    atol: float = 0.0,
    orthog: str = "cgs2",
):
    """3D analog of ``tiled_gmres_solve``: whole-system GMRES with
    x-planes over ('block','ir'), y over 'ic', z device-local."""
    nb = mesh.shape["block"]
    pr = mesh.shape["ir"]
    pc = mesh.shape["ic"]
    if nx % (nb * pr) or ny % pc:
        raise ValueError(
            f"grid {nx}x{ny}x{nz} not divisible by ({nb}*{pr}) x {pc} tiles"
        )
    rows_loc, cols_loc = nx // (nb * pr), ny // pc
    lshape = (rows_loc, cols_loc, nz)

    intra, cross = _halo_fns(
        nb, pr, pc,
        lead_edge=lambda g, side: (g[..., -1, :, :] if side == "last"
                                   else g[..., 0, :, :]),
        second_edge=lambda g, side: (g[..., :, -1, :] if side == "last"
                                     else g[..., :, 0, :]),
    )

    def interior(g):
        p = jnp.pad(g, ((1, 1), (1, 1), (1, 1)))
        c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
        return diag * g + off * (
            p[lo, c, c] + p[hi, c, c] + p[c, lo, c] + p[c, hi, c]
            + p[c, c, lo] + p[c, c, hi]
        )

    def full_mv(g):
        nh, sh, wh, eh = intra(g)
        cn, cs = cross(g)
        y = interior(g)
        y, nh, sh, wh, eh, cn, cs = lax.optimization_barrier(
            (y, nh, sh, wh, eh, cn, cs)
        )
        y = y.at[0, :, :].add(off * (nh + cn))
        y = y.at[-1, :, :].add(off * (sh + cs))
        y = y.at[:, 0, :].add(off * wh)
        y = y.at[:, -1, :].add(off * eh)
        return y

    def body(b_loc):
        res = krylov.gmres(
            lambda v: full_mv(v.reshape(lshape)).reshape(-1),
            b_loc.reshape(-1),
            restart=restart, maxiter=maxiter, rtol=rtol, atol=atol,
            orthog=orthog, axis_name=("block", "ir", "ic"),
        )
        return (res.x.reshape(lshape), res.iters, res.resnorm,
                res.resnorm0, res.converged)

    shard_spec = P(("block", "ir"), "ic", None)
    scalar = P()
    run = shard_map(
        body, mesh=mesh,
        in_specs=(shard_spec,),
        out_specs=(shard_spec, scalar, scalar, scalar, scalar),
        check_vma=False,
    )
    b_sh = jax.device_put(
        b.reshape(nx, ny, nz), NamedSharding(mesh, shard_spec)
    )
    x, iters, resnorm, resnorm0, converged = run(b_sh)
    return krylov.KrylovResult(
        x=x, iters=iters, resnorm=resnorm,
        resnorm0=resnorm0, converged=converged,
    )
