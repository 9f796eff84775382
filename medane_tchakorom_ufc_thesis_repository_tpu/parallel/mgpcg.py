"""Sharded MG-PCG + double-float refinement — the multi-device north-star.

The single-device north-star recipe (BASELINE.json "3D Poisson to 1e-8")
is multigrid-preconditioned f32 CG plus double-float residual refinement
(``solvers/multigrid.py`` + ``solvers/df64.py``).  This module is the
same recipe laid out over a
device mesh so the flagship solve scales the way the reference's
production runs do (np ranks over MPI, ``iSolve:347-401``) — every piece
stays inside one jitted SPMD program.

Mesh-polymorphic: every public function accepts either the 1-D strip
mesh ``('block', 'intra')`` (x-slab sharding, like ``parallel.sharded``)
or the 2-D-tiled mesh ``('block', 'ir', 'ic')`` (perimeter halos,
like ``parallel.tiled``), detected from the mesh axis
names.

Design:

* stencil applies exchange one boundary plane per split axis via
  ``ppermute`` with the halo/compute overlap schedule (issue
  collectives, compute interior, barrier, consume — the
  VecScatterBegin/End split);
* the V-cycle coarsens ALL axes by 2 per level; every level's local
  tile keeps an even extent along each split axis until it reaches one
  plane, so cell-centered restriction/prolongation are **entirely
  device-local** (stride-2 pairwise adds + minor-axis pairing matmuls,
  as in ``solvers/multigrid.py``); the only
  communication in the whole cycle is the smoother's halo exchange;
* coarsening stops when a device's tile is one plane thick on some
  split axis (or an unsplit dim hits ``min_size``); the coarsest level
  is solved with Chebyshev under the analytic global Dirichlet bounds —
  dot-free, so the coarse solve adds halo ppermutes but NO reductions;
* PCG dot products psum over all mesh axes (the two-level reduction
  hierarchy of ``computeFinalResidualNorm``, ``utils.c:575-595``);
* refinement residuals are computed in double-float (two-f32 error-free
  transforms) on the local tile with halo planes exchanged first, so
  the multi-chip path reaches 1e-8..1e-12 relative residuals without
  device f64 — only scalar norms leave the mesh.

Reference anchors: the north-star metric itself (BASELINE.json), the
weak-scaling goal (SURVEY.md §6: "3D Poisson to 1e-8 on a multi-host
slice at >=80% weak-scaling efficiency"), and PETSc's distributed PCMG
(the L1 capability the thesis never enables, ``config/petsc``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map  # jax>=0.8 home (was jax.experimental)

from medane_tchakorom_ufc_thesis_repository_tpu.parallel import sharded as sh
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64, krylov
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import chebyshev
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
    _JACOBI_OMEGA,
    _dirichlet_bounds,
    _prolong,
    _restrict,
)


def _grid_dims(opcfg) -> Tuple[int, ...]:
    if isinstance(opcfg, sh.ShardedPoisson2D):
        return (opcfg.m, opcfg.n)
    if isinstance(opcfg, sh.ShardedPoisson3D):
        return (opcfg.nx, opcfg.ny, opcfg.nz)
    raise TypeError(
        f"mgpcg supports ShardedPoisson2D/3D, got {type(opcfg).__name__}"
    )


# ---------------------------------------------------------------------------
# Mesh layout dispatch: 1-D strip ('block','intra') vs 2-D tile
# ('block','ir','ic')
# ---------------------------------------------------------------------------

def _layout(mesh: Mesh) -> str:
    names = tuple(mesh.axis_names)
    if names == ("block", "intra"):
        return "strip"
    if names == ("block", "ir", "ic"):
        return "tile"
    raise ValueError(
        f"mgpcg expects mesh axes ('block','intra') or "
        f"('block','ir','ic'), got {names}"
    )


def _mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _axis_splits(mesh: Mesh, nd: int) -> Tuple[int, ...]:
    """Device count per GRID axis."""
    if _layout(mesh) == "strip":
        return (mesh.shape["block"] * mesh.shape["intra"],) + (1,) * (nd - 1)
    if nd < 2:
        raise ValueError("tiled mesh needs a >=2-D grid")
    return ((mesh.shape["block"] * mesh.shape["ir"], mesh.shape["ic"])
            + (1,) * (nd - 2))


def _grid_spec(mesh: Mesh, nd: int) -> P:
    if _layout(mesh) == "strip":
        return P(*((("block", "intra"),) + (None,) * (nd - 1)))
    return P(*((("block", "ir"), "ic") + (None,) * (nd - 2)))


def _interior_grid_mv(g: jax.Array, diag: float, off: float) -> jax.Array:
    """Stencil apply on a grid-shaped local tile with zero external halos
    (pad+slice form — one fused bandwidth-bound pass; ``Stencil3D.mv`` on
    the LOCAL tile is exactly this interior apply in 3-D)."""
    nd = g.ndim
    if nd == 3:
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            Stencil3D,
        )

        nx, ny, nz = g.shape
        return Stencil3D(nx, ny, nz, diag=diag, off=off).mv(g)
    p = jnp.pad(g, 1)
    c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)
    taps = 0.0
    for ax in range(nd):
        idx_lo = tuple(lo if i == ax else c for i in range(nd))
        idx_hi = tuple(hi if i == ax else c for i in range(nd))
        taps = taps + p[idx_lo] + p[idx_hi]
    return diag * g + off * taps


def _interior_jacobi_sweep(g, b, omega, diag: float, off: float):
    """``g + omega * (b - A_interior g)`` as one fused expression
    (``Stencil3D.jacobi_sweep`` in 3-D).  Halo contributions are
    corrected by the caller on the boundary planes (linear in the taps,
    so the edge fixup is just ``-omega*off*halo`` after the fused
    pass)."""
    if g.ndim == 3:
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
            Stencil3D,
        )

        nx, ny, nz = g.shape
        return Stencil3D(nx, ny, nz, diag=diag, off=off).jacobi_sweep(
            g, b, omega
        )
    return g + omega * (b - _interior_grid_mv(g, diag, off))


def _make_halo_mv(mesh: Mesh, diag: float, off: float
                  ) -> Tuple[Callable, Callable, Callable]:
    """Whole-mesh stencil apply on a grid-shaped local tile.

    Returns ``(halo_mv, halos, halo_sweep)``: ``halo_mv(g)`` is the full
    stencil; ``halo_sweep(x, b, omega)`` the fused damped-Jacobi smoother
    (interior update slab-fused, halo fixup ``-omega*off*halo`` on the
    boundary planes — linearity of the taps); ``halo_mv`` details:
    (ppermutes issued first, interior computed while they fly, halos
    consumed after an ``optimization_barrier`` — the overlap schedule);
    ``halos(g)`` returns, per split grid axis, the ``(lo, hi)`` neighbor
    boundary planes (used by the df residual).  The neighbor pairing is
    level-independent — the same ppermutes serve every grid size.
    """
    if _layout(mesh) == "strip":
        ni = mesh.shape["intra"]
        nb = mesh.shape["block"]
        up_pairs = [(i, i + 1) for i in range(ni - 1)]
        down_pairs = [(i, i - 1) for i in range(1, ni)]
        blk_up = [(k, k + 1) for k in range(nb - 1)]
        blk_down = [(k, k - 1) for k in range(1, nb)]

        def halos(g):
            top_i = lax.ppermute(g[-1], "intra", up_pairs)
            bot_i = lax.ppermute(g[0], "intra", down_pairs)
            wrap_top = lax.ppermute(g[-1], "intra", [(ni - 1, 0)])
            top_b = lax.ppermute(wrap_top, "block", blk_up)
            wrap_bot = lax.ppermute(g[0], "intra", [(0, ni - 1)])
            bot_b = lax.ppermute(wrap_bot, "block", blk_down)
            return ((top_i + top_b, bot_i + bot_b),)

        def halo_mv(g):
            (top, bot), = halos(g)
            y = _interior_grid_mv(g, diag, off)
            y, top, bot = lax.optimization_barrier((y, top, bot))
            y = y.at[0].add(off * top)
            y = y.at[-1].add(off * bot)
            return y

        def halo_sweep(x, b, omega):
            # fused damped-Jacobi sweep with the same halo/compute
            # overlap: the interior update runs slab-fused while the
            # ppermutes fly; halos enter linearly, so the edge fixup is
            # -omega*off*halo on the boundary planes
            (top, bot), = halos(x)
            w = jnp.asarray(omega, x.dtype)
            y = _interior_jacobi_sweep(x, b, w, diag, off)
            y, top, bot = lax.optimization_barrier((y, top, bot))
            wo = w * jnp.asarray(off, x.dtype)
            y = y.at[0].add(-wo * top)
            y = y.at[-1].add(-wo * bot)
            return y

        return halo_mv, halos, halo_sweep

    nb = mesh.shape["block"]
    pr = mesh.shape["ir"]
    pc = mesh.shape["ic"]
    r_up = [(i, i + 1) for i in range(pr - 1)]
    r_dn = [(i, i - 1) for i in range(1, pr)]
    c_up = [(i, i + 1) for i in range(pc - 1)]
    c_dn = [(i, i - 1) for i in range(1, pc)]
    blk_up = [(k, k + 1) for k in range(nb - 1)]
    blk_dn = [(k, k - 1) for k in range(1, nb)]

    def halos(g):
        north = lax.ppermute(g[-1], "ir", r_up)
        south = lax.ppermute(g[0], "ir", r_dn)
        wrap_n = lax.ppermute(g[-1], "ir", [(pr - 1, 0)])
        cn = lax.ppermute(wrap_n, "block", blk_up)
        wrap_s = lax.ppermute(g[0], "ir", [(0, pr - 1)])
        cs = lax.ppermute(wrap_s, "block", blk_dn)
        west = lax.ppermute(g[:, -1], "ic", c_up)
        east = lax.ppermute(g[:, 0], "ic", c_dn)
        return ((north + cn, south + cs), (west, east))

    def halo_mv(g):
        (top, bot), (west, east) = halos(g)
        y = _interior_grid_mv(g, diag, off)
        y, top, bot, west, east = lax.optimization_barrier(
            (y, top, bot, west, east)
        )
        y = y.at[0].add(off * top)
        y = y.at[-1].add(off * bot)
        y = y.at[:, 0].add(off * west)
        y = y.at[:, -1].add(off * east)
        return y

    def halo_sweep(x, b, omega):
        (top, bot), (west, east) = halos(x)
        w = jnp.asarray(omega, x.dtype)
        y = _interior_jacobi_sweep(x, b, w, diag, off)
        y, top, bot, west, east = lax.optimization_barrier(
            (y, top, bot, west, east)
        )
        wo = w * jnp.asarray(off, x.dtype)
        y = y.at[0].add(-wo * top)
        y = y.at[-1].add(-wo * bot)
        y = y.at[:, 0].add(-wo * west)
        y = y.at[:, -1].add(-wo * east)
        return y

    return halo_mv, halos, halo_sweep


# ---------------------------------------------------------------------------
# Level plan + distributed V-cycle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedMGPlan:
    """Static V-cycle description: per-level GLOBAL grid dims plus the
    per-axis device splits (local dims = ``dims[i] // splits[i]``)."""

    dims: Tuple[Tuple[int, ...], ...]
    diag: float
    off: float
    nu: int
    coarse_iters: int
    splits: Tuple[int, ...]
    agglomerate: bool = True
    min_size: int = 4
    cycle: str = "w"  # 'w' | 'v' (PCMG -pc_mg_cycle_type)

    def local(self, level: int) -> Tuple[int, ...]:
        return tuple(d // s for d, s in zip(self.dims[level], self.splits))


def plan_sharded(opcfg, splits, *, nu: int = 2, min_size: int = 4,
                 coarse_iters: int = 40,
                 agglomerate: bool = True,
                 cycle: str = "w") -> ShardedMGPlan:
    """Coarsen while (a) each device's tile keeps an even plane count
    along every SPLIT axis (so restriction never crosses a device
    boundary), and (b) unsplit dims stay even and above ``min_size``.
    ``splits`` is the per-grid-axis device count (an int means the
    leading axis only).

    ``agglomerate``: continue the V-cycle below the distributed coarsest
    level on a REPLICATED copy of the (tiny) coarse grid — see
    ``_sharded_vcycle``.  Without it the distributed coarsest grows with
    the device count (one plane per device) and a fixed-iteration
    Chebyshev under-solves it at scale; with it the level hierarchy is
    identical to the single-device plan at any device count.
    """
    if cycle not in ("v", "w"):
        raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
    dims = _grid_dims(opcfg)
    if isinstance(splits, int):
        splits = (splits,) + (1,) * (len(dims) - 1)
    splits = tuple(splits)
    for d, s, ax in zip(dims, splits, range(len(dims))):
        if d % s:
            raise ValueError(
                f"grid axis {ax} extent {d} not divisible by {s} devices"
            )
    levels = [dims]
    while True:
        d = levels[-1]
        stop = False
        for n, s in zip(d, splits):
            if s > 1:
                loc = n // s
                if loc % 2 or loc < 2:
                    stop = True
            else:
                if n % 2 or n // 2 < min_size:
                    stop = True
        if stop:
            break
        levels.append(tuple(n // 2 for n in d))
    return ShardedMGPlan(
        dims=tuple(levels), diag=float(opcfg.diag), off=float(opcfg.off),
        nu=nu, coarse_iters=coarse_iters, splits=splits,
        agglomerate=agglomerate, min_size=min_size, cycle=cycle,
    )


def _make_agglomerator(mesh: Mesh, splits: Tuple[int, ...]):
    """Gather a distributed grid onto EVERY device / slice the local
    tile back out — the coarse-grid agglomeration step of distributed
    multigrid.  ``all_gather`` with multiple axis names concatenates in
    mesh-axis-major order, which matches the tile ownership order
    (('block','ir') are the leading-axis owners, 'ic' the second-axis
    owners)."""
    layout = _layout(mesh)

    if layout == "strip":
        def gather(g):
            return lax.all_gather(g, ("block", "intra"), axis=0, tiled=True)

        def slice_local(full, local_dims):
            ni = mesh.shape["intra"]
            idx = lax.axis_index("block") * ni + lax.axis_index("intra")
            zero = jnp.zeros((), idx.dtype)
            start = ((idx * local_dims[0],)
                     + (zero,) * (len(local_dims) - 1))
            return lax.dynamic_slice(full, start, local_dims)

        return gather, slice_local

    def gather(g):
        g = lax.all_gather(g, ("block", "ir"), axis=0, tiled=True)
        return lax.all_gather(g, "ic", axis=1, tiled=True)

    def slice_local(full, local_dims):
        pr = mesh.shape["ir"]
        r_idx = lax.axis_index("block") * pr + lax.axis_index("ir")
        c_idx = lax.axis_index("ic")
        zero = jnp.zeros((), r_idx.dtype)
        start = ((r_idx * local_dims[0], c_idx * local_dims[1])
                 + (zero,) * (len(local_dims) - 2))
        return lax.dynamic_slice(full, start, local_dims)

    return gather, slice_local


def _cycle_precond(plan: "ShardedMGPlan", halo_mv: Callable, agg,
                   halo_sweep: Callable = None) -> Callable:
    """The V/W-cycle as a CG preconditioner, with the same auto bf16
    cycle precision as the single-device ``mg_preconditioner``: above
    ``_BF16_CYCLE_BYTES`` of LOCAL level-0 tile the whole cycle —
    including its halo ppermutes, so halo traffic halves too — runs in
    bf16."""
    import math as _math

    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
        _BF16_CYCLE_BYTES,
    )

    bf16 = 4 * _math.prod(plan.local(0)) > _BF16_CYCLE_BYTES

    def M(r: jax.Array) -> jax.Array:
        if bf16:
            z = _sharded_vcycle(plan, halo_mv, r.astype(jnp.bfloat16),
                                agg=agg, halo_sweep=halo_sweep)
            return z.astype(r.dtype)
        return _sharded_vcycle(plan, halo_mv, r, agg=agg,
                               halo_sweep=halo_sweep)

    return M


def _sharded_vcycle(plan: ShardedMGPlan, halo_mv: Callable, b: jax.Array,
                    level: int = 0, agg=None,
                    halo_sweep: Callable = None) -> jax.Array:
    """One V(nu, nu) cycle from the zero guess on the local tile.  The
    recursion is Python-static, so the whole cycle unrolls into one XLA
    program per device (identical on all devices — SPMD-lockstep).

    Coarsest level: with ``agg`` (coarse-grid agglomeration — the
    standard distributed-MG move), the tiny coarse grid is
    ``all_gather``ed onto every device and the SINGLE-DEVICE V-cycle
    recursion (``solvers.multigrid.vcycle``) continues on the replicated
    copy down to ``min_size`` — every device redundantly computes the
    identical correction (SPMD-lockstep by construction) and slices its
    tile back out.  This makes the effective level hierarchy IDENTICAL
    to the single-device plan at any device count; without it the
    distributed coarsest grows with the mesh (one plane per device) and
    the fixed-iteration Chebyshev under-solves it at scale."""
    dims = plan.dims[level]
    dtype = b.dtype
    omega = jnp.asarray(_JACOBI_OMEGA[len(dims)] / plan.diag, dtype)
    mv = halo_mv

    if level == len(plan.dims) - 1:
        if agg is not None:
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
                multigrid as mg_mod,
            )

            gather, slice_local = agg
            full = gather(b)
            sub = mg_mod.plan(
                mg_mod._make_op(dims, plan.diag, plan.off),
                nu=plan.nu, min_size=plan.min_size,
                coarse_iters=plan.coarse_iters, cycle=plan.cycle,
            )
            e_full = mg_mod.vcycle(sub, full)
            return slice_local(e_full, plan.local(level))
        lmin, lmax = _dirichlet_bounds(dims, plan.diag, plan.off)
        return chebyshev(
            mv, b, maxiter=plan.coarse_iters, lmin=lmin, lmax=lmax
        ).x

    smooth = (halo_sweep if halo_sweep is not None
              else (lambda x_, b_, w: x_ + w * (b_ - mv(x_))))
    x = omega * b
    for _ in range(plan.nu - 1):
        x = smooth(x, b, omega)

    r = b - mv(x)
    # (2h)^2 / h^2 rescaling of the h^2-convention residual
    rc = 4.0 * _restrict(r, plan.local(level))
    ec = _sharded_vcycle(plan, halo_mv, rc, level + 1, agg, halo_sweep)
    if plan.cycle == "w" and level + 1 < len(plan.dims) - 1:
        # W-cycle: second recursive coarse visit on the coarse residual
        # (halo_mv is shape-polymorphic — it applies the coarse-level
        # operator with the same level-independent neighbor pairing)
        ec = ec + _sharded_vcycle(
            plan, halo_mv, rc - halo_mv(ec), level + 1, agg, halo_sweep)
    x = x + _prolong(ec, plan.local(level + 1)).astype(dtype)

    for _ in range(plan.nu):
        x = smooth(x, b, omega)
    return x


# ---------------------------------------------------------------------------
# MG-PCG solve
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _mgpcg_run(mesh: Mesh, opcfg, rtol: float, atol: float, maxiter: int,
               nu: int, min_size: int, coarse_iters: int,
               cycle: str = "w"):
    """Compiled-per-configuration MG-PCG body.  Cached so repeated solves
    (refinement passes, benchmarks, CLI reruns in one process) reuse the
    XLA program — per-call closures re-trace and re-compile EVERY call
    (the ``refine._df_refine_helpers`` lesson).  ``mesh`` and the frozen
    operator dataclasses hash by value."""
    dims = _grid_dims(opcfg)
    plan = plan_sharded(opcfg, _axis_splits(mesh, len(dims)), nu=nu,
                        min_size=min_size, coarse_iters=coarse_iters,
                        cycle=cycle)
    halo_mv, _halos, halo_sweep = _make_halo_mv(mesh, plan.diag, plan.off)
    agg = _make_agglomerator(mesh, plan.splits) if plan.agglomerate else None
    axes = _mesh_axes(mesh)

    def body(b_loc):
        res = krylov.cg(
            halo_mv, b_loc,
            maxiter=maxiter, rtol=rtol, atol=atol,
            axis_name=axes,
            precond=_cycle_precond(plan, halo_mv, agg, halo_sweep),
        )
        return res.x, res.iters, res.resnorm, res.resnorm0, res.converged

    spec = _grid_spec(mesh, len(dims))
    scalar = P()
    run = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(spec,),
        out_specs=(spec, scalar, scalar, scalar, scalar),
        check_vma=False,
    ))
    return run, spec


def sharded_mgpcg_solve(
    mesh: Mesh,
    opcfg,
    b: jax.Array,
    *,
    rtol: float = 1e-5,
    atol: float = 0.0,
    maxiter: int = 100,
    nu: int = 2,
    min_size: int = 4,
    coarse_iters: int = 40,
    cycle: str = "w",
):
    """Whole-mesh multigrid-preconditioned CG (true-residual norm test):
    the sharded analog of ``cg(op.mv, b, precond=mg_preconditioner(op))``.
    ``b`` is the global grid-shaped RHS; returns ``KrylovResult`` with a
    global grid-shaped ``x``.  Works on both the strip and tiled meshes.
    """
    run, spec = _mgpcg_run(
        mesh, opcfg, float(rtol), float(atol), int(maxiter),
        int(nu), int(min_size), int(coarse_iters), cycle,
    )
    b_sh = jax.device_put(b, NamedSharding(mesh, spec))
    x, iters, resnorm, resnorm0, converged = run(b_sh)
    return krylov.KrylovResult(
        x=x, iters=iters, resnorm=resnorm, resnorm0=resnorm0,
        converged=converged,
    )


# ---------------------------------------------------------------------------
# Double-float residuals on the mesh
# ---------------------------------------------------------------------------

def _df_tile_residual(b_df, x_df, axis_halos, diag: float, off: float):
    """``r = b - A x`` in double-float on a grid-shaped local tile whose
    halos (neighbor boundary planes, already summed across mesh sources)
    are supplied per split axis as ``(axis, (lo_hi, lo_lo), (hi_hi,
    hi_lo))`` triples.

    Identical error-free-transform structure to
    ``df64.stencil3d_df_residual`` — halo planes are written into the
    zero padding BEFORE the pairwise two-sum tree, so boundary rows get
    the same ~2^-48 accuracy as the interior (corners stay zero: 5/7-
    point stencils have no diagonal taps).
    """
    xhi, xlo = x_df
    nd = xhi.ndim

    def with_halos(g, comp: int):
        p = jnp.pad(g, 1)
        for axis, lo_df, hi_df in axis_halos:
            idx_lo = tuple(
                0 if i == axis else slice(1, -1) for i in range(nd))
            idx_hi = tuple(
                -1 if i == axis else slice(1, -1) for i in range(nd))
            p = p.at[idx_lo].set(lo_df[comp])
            p = p.at[idx_hi].set(hi_df[comp])
        return p

    phi = with_halos(xhi, 0)
    plo = with_halos(xlo, 1)
    c, lo, hi = slice(1, -1), slice(0, -2), slice(2, None)

    def tap_pair(p, ax):
        idx_lo = tuple(lo if i == ax else c for i in range(nd))
        idx_hi = tuple(hi if i == ax else c for i in range(nd))
        return p[idx_lo], p[idx_hi]

    # compensated neighbor sum: two_sum per axis pair, then fold
    nh = None
    err = 0.0
    for ax in range(nd):
        a, bb = tap_pair(phi, ax)
        s, e = df64.two_sum(a, bb)
        err = err + e
        if nh is None:
            nh = s
        else:
            nh, e2 = df64.two_sum(nh, s)
            err = err + e2
    lo_taps = 0.0
    for ax in range(nd):
        a, bb = tap_pair(plo, ax)
        lo_taps = lo_taps + a + bb
    nl = err + lo_taps
    ndf = df64._df_combine(nh, nl, off)
    ddf = df64._int_coeff_mul(xhi, diag)
    ddf = df64.df_add_f32(ddf, jnp.float32(diag) * xlo)
    ax_ = df64.df_add(ddf, ndf)
    return df64.df_add(b_df, df64.df_neg(ax_))


def _df_slab_residual(b_df, x_df, top_df, bot_df, diag: float, off: float):
    """1-D-split convenience wrapper over ``_df_tile_residual``:
    ``top_df``/``bot_df`` are the (hi, lo) halo pairs on grid axis 0."""
    return _df_tile_residual(
        b_df, x_df, ((0, top_df, bot_df),), diag, off)


@jax.jit
def _b_norm(bhi):
    """f32-safe global norm of a sharded array under plain jit (XLA
    inserts the cross-device reductions)."""
    return df64.scaled_norm(bhi)


@functools.lru_cache(maxsize=64)
def _df_refine_helpers_sharded(mesh: Mesh, opcfg):
    """Compiled df residual/correction passes, cached per (mesh, op)."""
    dims = _grid_dims(opcfg)
    diag, off = float(opcfg.diag), float(opcfg.off)
    _halo_mv, halos, _hs = _make_halo_mv(mesh, diag, off)
    spec = _grid_spec(mesh, len(dims))
    axes = _mesh_axes(mesh)
    scalar = P()

    def _residual_body(bhi, blo, xhi, xlo):
        # halos() returns one (lo, hi) pair per LAYOUT axis, positionally
        # aligned with grid axes 0..k — consume them all (a degenerate
        # 1-device axis yields zero halos, which matches its Dirichlet
        # padding), rather than counting splits>1: on a tiled mesh with
        # block*ir == 1 the split axis is axis 1, and a count-based pair
        # would silently drop its real halos from the residual
        halos_hi = halos(xhi)
        halos_lo = halos(xlo)
        axis_halos = tuple(
            (axis,
             (hh[0], hl[0]),
             (hh[1], hl[1]))
            for axis, (hh, hl) in enumerate(zip(halos_hi, halos_lo))
        )
        rhi, rlo = _df_tile_residual(
            (bhi, blo), (xhi, xlo), axis_halos, diag, off)
        return rhi, rlo, df64.scaled_norm(rhi, axes)

    residual_pass = jax.jit(shard_map(
        _residual_body, mesh=mesh,
        in_specs=(spec,) * 4,
        out_specs=(spec, spec, scalar),
        check_vma=False,
    ))

    @jax.jit
    def apply_correction(xhi, xlo, d32, scale):
        upd = df64.df_mul_f32((d32, jnp.zeros_like(d32)), scale)
        return df64.df_add((xhi, xlo), upd)

    return residual_pass, apply_correction


def sharded_df_refine(
    mesh: Mesh,
    opcfg,
    solve_f32: Callable,
    b_df,
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
):
    """Double-float iterative refinement on the mesh.

    ``solve_f32(r_sharded) -> d_sharded`` is any sharded f32 approximate
    solve on grid-shaped global arrays (e.g. a jitted
    ``sharded_mgpcg_solve(...).x``); ``b_df = (bhi, blo)`` are sharded
    grid-shaped f32 arrays.  The df residual + norm run under one
    ``shard_map`` (halo planes for BOTH components ride the same
    ppermutes); the correction update is elementwise df arithmetic under
    plain jit, so XLA propagates the sharding.  Only scalar norms reach
    the host.  Returns ``solvers.refine.RefineResult`` with ``x`` as the
    sharded (hi, lo) pair.
    """
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        RefineResult,
    )

    residual_pass, apply_correction = _df_refine_helpers_sharded(mesh, opcfg)
    bhi, blo = b_df
    xhi = jnp.zeros_like(bhi)
    xlo = jnp.zeros_like(blo)
    # rnorm0 = ||b|| (x0 = 0 makes r = b by construction) — one f32-safe
    # scaled norm under plain jit (XLA inserts the cross-device psums for
    # the sharded array) instead of a full df residual pass
    rnorm0 = float(_b_norm(bhi))
    if rnorm0 == 0.0:
        return RefineResult((xhi, xlo), 0, [], 0.0, 0.0, True)
    history = []
    rhi, rnorm = bhi, rnorm0
    for p in range(max_passes):
        if p > 0:
            rhi, _rlo, rn = residual_pass(bhi, blo, xhi, xlo)
            rnorm = float(rn)
        rel = rnorm / rnorm0
        history.append(rel)
        if rel <= rtol:
            return RefineResult((xhi, xlo), p, history, rnorm, rnorm0, True)
        d32 = solve_f32(rhi / jnp.float32(rnorm))
        xhi, xlo = apply_correction(xhi, xlo, d32, jnp.float32(rnorm))
    rhi, _rlo, rn = residual_pass(bhi, blo, xhi, xlo)
    rnorm = float(rn)
    history.append(rnorm / rnorm0)
    return RefineResult(
        (xhi, xlo), max_passes, history, rnorm, rnorm0,
        rnorm / rnorm0 <= rtol,
    )


@functools.lru_cache(maxsize=64)
def _northstar_solvers(mesh: Mesh, opcfg, inner_rtol: float,
                       pcg_maxiter: int, nu: int, min_size: int,
                       coarse_iters: int, cycle: str = "w"):
    """Compiled per-pass PCG + on-mesh RHS builder, cached per config."""
    dims = _grid_dims(opcfg)
    splits = _axis_splits(mesh, len(dims))
    plan = plan_sharded(opcfg, splits, nu=nu, min_size=min_size,
                        coarse_iters=coarse_iters, cycle=cycle)
    halo_mv, _, halo_sweep = _make_halo_mv(mesh, plan.diag, plan.off)
    agg = _make_agglomerator(mesh, plan.splits) if plan.agglomerate else None
    spec = _grid_spec(mesh, len(dims))
    axes = _mesh_axes(mesh)

    def _pcg_body(r_loc):
        res = krylov.cg(
            halo_mv, r_loc,
            maxiter=pcg_maxiter, rtol=inner_rtol,
            axis_name=axes,
            precond=_cycle_precond(plan, halo_mv, agg, halo_sweep),
        )
        return res.x

    pcg = jax.jit(shard_map(
        _pcg_body, mesh=mesh, in_specs=(spec,), out_specs=spec,
        check_vma=False,
    ))

    def _rhs_body():
        ones = jnp.ones(plan.local(0), jnp.float32)
        return halo_mv(ones)

    make_b = jax.jit(shard_map(
        _rhs_body, mesh=mesh, in_specs=(), out_specs=spec,
        check_vma=False,
    ))
    return pcg, make_b


@functools.lru_cache(maxsize=64)
def _northstar_fused_run(mesh: Mesh, opcfg, rtol: float, inner_rtol: float,
                         pcg_maxiter: int, max_passes: int, nu: int,
                         min_size: int, coarse_iters: int, cycle: str):
    """ONE jitted SPMD program for the whole multi-chip north-star:
    b = A·1 on-mesh, then a ``lax.while_loop`` over refinement passes
    (MG-PCG + df tile residual with halo exchange inside) — a single
    dispatch instead of ~4 per pass (the single-device twin is
    ``solvers.refine.df_northstar_fused``; on a real mesh every saved
    dispatch is also a host round-trip)."""
    dims = _grid_dims(opcfg)
    splits = _axis_splits(mesh, len(dims))
    plan = plan_sharded(opcfg, splits, nu=nu, min_size=min_size,
                        coarse_iters=coarse_iters, cycle=cycle)
    halo_mv, halos, halo_sweep = _make_halo_mv(mesh, plan.diag, plan.off)
    agg = _make_agglomerator(mesh, plan.splits) if plan.agglomerate else None
    spec = _grid_spec(mesh, len(dims))
    axes = _mesh_axes(mesh)
    scalar = P()
    diag, off = plan.diag, plan.off

    def _norm(rhi):
        return df64.scaled_norm(rhi, axes)

    def _residual(bhi, blo, xhi, xlo):
        halos_hi = halos(xhi)
        halos_lo = halos(xlo)
        axis_halos = tuple(
            (axis, (hh[0], hl[0]), (hh[1], hl[1]))
            for axis, (hh, hl) in enumerate(zip(halos_hi, halos_lo))
        )
        return _df_tile_residual(
            (bhi, blo), (xhi, xlo), axis_halos, diag, off)

    def body_fn():
        bhi = halo_mv(jnp.ones(plan.local(0), jnp.float32))
        blo = jnp.zeros_like(bhi)
        rnorm0 = _norm(bhi)
        tol = jnp.float32(rtol) * rnorm0

        def body(carry):
            xhi, xlo, rhi, rnorm, passes = carry
            d = krylov.cg(
                halo_mv, rhi / rnorm,
                maxiter=pcg_maxiter, rtol=inner_rtol, axis_name=axes,
                precond=_cycle_precond(plan, halo_mv, agg, halo_sweep),
            ).x
            upd = df64.df_mul_f32((d, jnp.zeros_like(d)), rnorm)
            xhi2, xlo2 = df64.df_add((xhi, xlo), upd)
            rhi2, _rlo2 = _residual(bhi, blo, xhi2, xlo2)
            return xhi2, xlo2, rhi2, _norm(rhi2), passes + 1

        def cond(carry):
            _, _, _, rnorm, passes = carry
            return jnp.logical_and(rnorm > tol, passes < max_passes)

        x0 = jnp.zeros_like(bhi)
        init = (x0, jnp.zeros_like(bhi), bhi, rnorm0,
                jnp.zeros((), jnp.int32))
        xhi, xlo, _rhi, rnorm, passes = lax.while_loop(cond, body, init)
        # one stacked scalar output: separate float()/int() readbacks
        # are a device round-trip EACH (see refine._df_fused_program)
        stats = jnp.stack([rnorm, rnorm0, passes.astype(jnp.float32)])
        return xhi, xlo, stats

    run = jax.jit(shard_map(
        body_fn, mesh=mesh, in_specs=(),
        out_specs=(spec, spec, scalar),
        check_vma=False,
    ))
    return run


def sharded_df_northstar_fused(
    mesh: Mesh,
    opcfg,
    *,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-5,
    pcg_maxiter: int = 40,
    max_passes: int = 6,
    nu: int = 2,
    min_size: int = 4,
    coarse_iters: int = 40,
    cycle: str = "w",
):
    """Single-dispatch multi-chip north-star (see ``_northstar_fused_run``);
    same result contract as ``sharded_df_northstar`` minus the per-pass
    history (everything stays on the mesh — that is the point)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        RefineResult,
    )

    run = _northstar_fused_run(
        mesh, opcfg, float(rtol), float(inner_rtol), int(pcg_maxiter),
        int(max_passes), int(nu), int(min_size), int(coarse_iters),
        str(cycle),
    )
    import numpy as _np

    xhi, xlo, stats = run()
    stats = _np.asarray(stats)
    rn, rn0, p = float(stats[0]), float(stats[1]), int(stats[2])
    return RefineResult((xhi, xlo), p, [], rn, rn0, rn <= rtol * rn0)


def sharded_df_northstar(
    mesh: Mesh,
    opcfg,
    *,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-5,
    pcg_maxiter: int = 40,
    max_passes: int = 6,
    nu: int = 2,
    min_size: int = 4,
    coarse_iters: int = 40,
    cycle: str = "w",
):
    """The complete multi-chip north-star: solve ``A x = b`` with
    ``b = A·1`` (exact small-integer entries, built on-mesh) to ``rtol``
    relative TRUE residual via sharded MG-PCG + double-float refinement.

    Single-device twin: ``refine.df_northstar_fused`` (bench.py
    north-star section).  Returns the ``RefineResult`` (x is the sharded
    df pair).  Works on both the strip and tiled meshes.
    """
    pcg, make_b = _northstar_solvers(
        mesh, opcfg, float(inner_rtol), int(pcg_maxiter),
        int(nu), int(min_size), int(coarse_iters), cycle,
    )
    bhi = make_b()
    b_df = (bhi, jnp.zeros_like(bhi))
    return sharded_df_refine(
        mesh, opcfg, pcg, b_df, rtol=rtol, max_passes=max_passes,
    )
