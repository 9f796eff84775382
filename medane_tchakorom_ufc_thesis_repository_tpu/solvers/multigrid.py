"""Geometric multigrid for the Poisson stencil family — PCMG analog.

The reference runs every solver unpreconditioned (``pc none`` in
``config/default_run_variables:42-68``), but its L1 layer (PETSc) ships
``PCMG``; this module is the matrix-free counterpart, and it is the lever
that turns the O(n^(1/3)·n) Krylov cost of the 3D north-star solves into
O(n): a V(2,2) cycle costs ~8 fine-grid stencil applies and reduces the
error by a near-grid-independent factor, so MG-preconditioned CG reaches
1e-5 in ~10-20 iterations where plain CG needs ~1200 at 256^3.

Design
------
* Entirely matrix-free on grid-shaped state: smoothing is the stencil
  apply plus axpys (bandwidth-bound, fuses), transfers are strided sums
  and replications (zero gathers).  No reductions anywhere inside the
  V-cycle — like the Chebyshev smoother, its critical path has **no
  collectives**, which is what you want when each dot product is a
  round-trip between devices.
* **Cell-centered factor-2 coarsening**: the grids here have power-of-two
  interior sizes (256^3, 1024^2, ...) where vertex-centered coarsening
  (odd sizes) does not apply.  Restriction = mean over 2^d children,
  prolongation = piecewise-constant replication (P ∝ Rᵀ, so the V-cycle
  stays symmetric and is a valid CG preconditioner).  PWC transfer costs
  a worse per-cycle contraction than trilinear (~0.5 vs ~0.1) but keeps
  every transfer a reshape — under PCG the iteration count is still
  grid-size-independent, which is all that matters.
* The operators use the h^2-scaled convention (stencil (2d, -1) at every
  grid level — coefficients are h-independent); the (2h)^2/h^2 scaling
  surfaces as a single ``4 *`` on each restricted residual.
* Static level hierarchy (Python recursion over a list of shapes), so
  the whole V-cycle unrolls into one fused XLA program.
* Smoother: damped Jacobi with the dimension-optimal high-frequency
  weight (2/3, 4/5, 6/7 for d = 1, 2, 3).  Coarsest level: Chebyshev
  with the analytic Dirichlet bounds (exact for this stencil family) —
  a symmetric polynomial in A, preserving preconditioner symmetry.

Use ``mg_preconditioner(op)`` with ``solvers.cg(..., precond=M)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as ops_mod
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import chebyshev


def _op_dims(op) -> Tuple[int, ...]:
    if isinstance(op, ops_mod.Stencil2D):
        return (op.m, op.n)
    if isinstance(op, ops_mod.Stencil3D):
        return (op.nx, op.ny, op.nz)
    raise TypeError(
        f"multigrid supports Stencil2D/Stencil3D operators, got {type(op).__name__}"
    )


def _make_op(dims: Tuple[int, ...], diag: float, off: float):
    if len(dims) == 2:
        return ops_mod.Stencil2D(dims[0], dims[1], diag, off)
    return ops_mod.Stencil3D(dims[0], dims[1], dims[2], diag, off)


def _pair_sum(a: jax.Array, axis: int) -> jax.Array:
    """Sum adjacent pairs along ``axis`` via two stride-2 slices."""
    n = a.shape[axis]
    lo = jax.lax.slice_in_dim(a, 0, n, stride=2, axis=axis)
    hi = jax.lax.slice_in_dim(a, 1, n, stride=2, axis=axis)
    return lo + hi


def _interleave(a: jax.Array, axis: int) -> jax.Array:
    """Duplicate each element along ``axis`` (inverse layout of
    ``_pair_sum``): concat + reshape keeps the size-2 factor on a MAJOR
    dim when axis is major; for the minormost axis the caller routes
    through the matmul path instead."""
    twice = jnp.concatenate([a[None], a[None]], axis=0)  # (2, ...)
    # move the copy dim right after `axis`, then merge
    perm = list(range(1, a.ndim + 1))
    perm.insert(axis + 1, 0)
    twice = twice.transpose(perm)
    shape = list(a.shape)
    shape[axis] *= 2
    return twice.reshape(shape)


def _restrict(r: jax.Array, dims: Tuple[int, ...]) -> jax.Array:
    """Mean over each 2x2(x2) cell block (cell-centered full weighting).

    Major axes use stride-2 pairwise adds; the minormost axis uses a
    matmul against a constant 0/1 pairing matrix.
    """
    nd = len(dims)
    out = r
    for ax in range(nd - 1):
        out = _pair_sum(out, ax)
    nz = dims[-1]
    pair = jnp.zeros((nz, nz // 2), r.dtype)
    idx = jnp.arange(nz)
    pair = pair.at[idx, idx // 2].set(1.0)
    out = jax.lax.dot_general(
        out, pair, (((nd - 1,), (0,)), ((), ())),
        preferred_element_type=r.dtype,
        # full f32: an unpinned f32 matmul may run in TF32 on the GPU
        # (~3 decimal digits), enough to stall MG-preconditioned Krylov
        # solves
        precision=jax.lax.Precision.HIGHEST,
    )
    return out * (1.0 / (2 ** nd))


def _prolong(e: jax.Array, dims: Tuple[int, ...]) -> jax.Array:
    """Piecewise-constant replication to the fine grid (Rᵀ up to scale):
    interleave on major axes, replication matmul on the minormost axis."""
    nd = len(dims)
    out = e
    for ax in range(nd - 1):
        out = _interleave(out, ax)
    nzc = dims[-1]
    rep = jnp.zeros((nzc, nzc * 2), e.dtype)
    idx = jnp.arange(nzc * 2)
    rep = rep.at[idx // 2, idx].set(1.0)
    return jax.lax.dot_general(
        out, rep, (((nd - 1,), (0,)), ((), ())),
        preferred_element_type=e.dtype,
        precision=jax.lax.Precision.HIGHEST,  # see _restrict
    )


def _axis_blend(g: jax.Array, ax: int) -> jax.Array:
    """The 1D linear-interpolation blend on a fine axis (cell-centered
    factor-2): even index k mixes 3/4 of itself with 1/4 of its lower
    neighbor, odd k with its upper neighbor (boundary-clamped).  The
    operator is SYMMETRIC (each even/odd parity pair points at each
    other), so it serves both the trilinear prolongation
    ``P = B · U`` and the matching full weighting
    ``R = (1/2^d) Uᵀ Bᵀ = mean-restrict ∘ B`` — keeping the cycle a
    valid symmetric CG preconditioner.  Pure pad+slice + parity select:
    no stride-2 addressing, no size-2 minor dims."""
    from jax import lax

    n = g.shape[ax]
    down = jnp.concatenate([
        lax.slice_in_dim(g, 0, 1, axis=ax),
        lax.slice_in_dim(g, 0, n - 1, axis=ax),
    ], axis=ax)
    up = jnp.concatenate([
        lax.slice_in_dim(g, 1, n, axis=ax),
        lax.slice_in_dim(g, n - 1, n, axis=ax),
    ], axis=ax)
    k = lax.broadcasted_iota(jnp.int32, g.shape, ax)
    nb = jnp.where(k % 2 == 0, down, up)
    w = jnp.asarray(0.25, g.dtype)
    return (1 - w) * g + w * nb


def _prolong_lin(e: jax.Array, dims: Tuple[int, ...]) -> jax.Array:
    """Trilinear (bilinear in 2D) prolongation: PWC replication then the
    per-axis blends."""
    g = _prolong(e, dims)
    for ax in range(g.ndim):
        g = _axis_blend(g, ax)
    return g


def _restrict_lin(r: jax.Array, dims: Tuple[int, ...]) -> jax.Array:
    """Full weighting matched to ``_prolong_lin`` (R ∝ Pᵀ; B is
    symmetric so the blend is applied on the fine grid first)."""
    g = r
    for ax in range(g.ndim):
        g = _axis_blend(g, ax)
    return _restrict(g, dims)


def _dirichlet_bounds(dims: Tuple[int, ...], diag: float, off: float):
    """Exact spectral interval of the (2d, off) Dirichlet stencil: the
    eigenvalues are ``diag + 2*off*sum_i cos(k_i pi/(n_i+1))``."""
    a = 2.0 * abs(off) * sum(math.cos(math.pi / (n + 1)) for n in dims)
    return diag - a, diag + a


_JACOBI_OMEGA = {2: 0.8, 3: 6.0 / 7.0}  # optimal high-frequency damping

# level-0 f32 bytes above which the auto cycle precision drops to bf16.
# Set from measurements on the accelerator this code was first written
# for.  On an H100 (700 W limit) at 512^3 the bf16 cycle needed 18 PCG
# iterations to 1e-5 where the f32 cycle needed 5 (PERF.md); revisiting
# the threshold is ROADMAP S8.
_BF16_CYCLE_BYTES = 32 * 2**20


@dataclasses.dataclass(frozen=True)
class MGLevels:
    """Static V-cycle description (shapes and coefficients only — the
    stencil family is matrix-free, so there is nothing array-valued to
    store per level)."""

    dims: Tuple[Tuple[int, ...], ...]   # fine -> coarse grid shapes
    diag: float
    off: float
    nu: int                              # pre/post smoothing sweeps
    coarse_iters: int
    cycle: str = "w"                     # 'w' | 'v' (PCMG -pc_mg_cycle_type)
    transfers: str = "pwc"               # 'pwc' | 'linear' (trilinear P,
    #   matched full weighting R — the PCMG -pc_mg_interpolation-type
    #   analog).  MEASURED round 5 (CPU f64, 64^3/128^3): NO iteration
    #   win over pwc (V 8/10 -> 8/10, W 5/6 -> 6/6): with nu=2 damped
    #   Jacobi and cell-centered factor-2 coarsening the smoother, not
    #   the transfer order, limits the cycle — so pwc stays the
    #   default.


def plan(op, *, nu: int = 2, min_size: int = 4,
         max_levels: int = 32, coarse_iters: int = 40,
         cycle: str = "w", transfers: str = "pwc") -> MGLevels:
    """Build the level hierarchy for a Stencil2D/3D operator.

    Coarsening halves every dimension while all of them stay even and
    above ``min_size``; the coarsest level is solved with ``coarse_iters``
    Chebyshev steps under the analytic spectral bounds.  ``cycle``: 'w'
    (default — two recursive solves per level, PETSc's
    ``-pc_mg_cycle_type w``) or 'v' (one).  W fully compensates the
    piecewise-constant transfers' weak per-cycle contraction: with an
    f32 cycle W-PCG takes 5-6 grid-independent iterations to 1e-5
    (64^3..256^3 on the CPU, 512^3 on an H100) where V takes more, and
    each coarse level is 8x smaller in 3D.
    """
    if cycle not in ("v", "w"):
        raise ValueError(f"cycle must be 'v' or 'w', got {cycle!r}")
    if transfers not in ("pwc", "linear"):
        raise ValueError(
            f"transfers must be 'pwc' or 'linear', got {transfers!r}")
    dims = _op_dims(op)
    levels = [dims]
    while len(levels) < max_levels:
        d = levels[-1]
        if any(n % 2 != 0 or n // 2 < min_size for n in d):
            break
        levels.append(tuple(n // 2 for n in d))
    return MGLevels(
        dims=tuple(levels), diag=float(op.diag), off=float(op.off),
        nu=nu, coarse_iters=coarse_iters, cycle=cycle,
        transfers=transfers,
    )


def vcycle(levels: MGLevels, b: jax.Array, level: int = 0,
           out_dtype=None, cast_dtype=None, rdot: bool = False):
    """One V(nu, nu) cycle for ``A x = b`` from the zero initial guess,
    returning the approximate solution (grid-shaped).  A fixed linear
    symmetric operation in ``b`` — valid as a CG preconditioner.

    ``out_dtype``: dtype of the RETURNED correction (default:
    ``b.dtype``); the final smoothing sweep writes it directly.

    ``cast_dtype``: the cycle's arithmetic dtype when it differs from
    ``b.dtype`` (``b`` is cast on entry).

    ``rdot``: return ``(z, d)`` with ``d ≈ b · z`` (PCG's post-cycle
    ``vdot(r, z)``) computed beside the final smoothing sweep, or
    ``d = None`` when the level's operator has no fused sweep-and-dot
    (caller computes the dot itself).  Under a bf16 ``cast_dtype`` the
    dot sees the bf16-rounded residual copy — the per-element roundings
    are symmetric and average out across n elements, and CG's alpha/beta
    are flat to first order around their exact values."""
    dims = levels.dims[level]
    A = _make_op(dims, levels.diag, levels.off)
    omega = _JACOBI_OMEGA[len(dims)] / levels.diag

    if cast_dtype is not None and level == len(levels.dims) - 1:
        b = b.astype(cast_dtype)   # degenerate one-level hierarchy
    if level == len(levels.dims) - 1:
        lmin, lmax = _dirichlet_bounds(dims, levels.diag, levels.off)
        x = chebyshev(
            A.mv, b, maxiter=levels.coarse_iters, lmin=lmin, lmax=lmax
        ).x
        x = x if out_dtype is None else x.astype(out_dtype)
        return (x, None) if rdot else x

    smooth = getattr(A, "jacobi_sweep",
                     lambda x_, b_, w: x_ + w * (b_ - A.mv(x_)))
    resid = getattr(A, "residual", lambda x_, b_: b_ - A.mv(x_))
    if cast_dtype is not None and b.dtype != jnp.dtype(cast_dtype):
        b = b.astype(cast_dtype)
    if levels.nu >= 2:
        # x0 = 0 folds the first TWO sweeps into ONE stencil apply:
        # x2 = w b + w (b - A (w b)) = (2w - w^2 diag) b - w^2 off * N b
        # — a modified-coefficient stencil on b (same values up to
        # rounding), one pass instead of scale + sweep
        A2 = _make_op(
            dims,
            2.0 * omega - omega * omega * levels.diag,
            -omega * omega * levels.off,
        )
        x = A2.mv(b)
        presweeps = levels.nu - 2
    else:
        x = omega * b
        presweeps = levels.nu - 1
    dtype = x.dtype   # the cycle's arithmetic dtype from here on
    for _ in range(presweeps):
        x = smooth(x, b, omega)

    # (2h)^2 / h^2 rescaling of the h^2-convention residual
    linear = levels.transfers == "linear"
    r = resid(x, b)
    rc = 4.0 * (_restrict_lin(r, dims) if linear else _restrict(r, dims))
    ec = vcycle(levels, rc, level + 1)
    if levels.cycle == "w" and level + 1 < len(levels.dims) - 1:
        # W-cycle: re-solve the coarse problem on ITS residual (second
        # recursive visit per level, skipped at the coarsest)
        Ac = _make_op(levels.dims[level + 1], levels.diag, levels.off)
        resid_c = getattr(Ac, "residual", lambda x_, b_: b_ - Ac.mv(x_))
        ec = ec + vcycle(levels, resid_c(ec, rc), level + 1)
    pro = _prolong_lin if linear else _prolong
    x = x + pro(ec, levels.dims[level + 1]).astype(dtype)

    post = levels.nu
    js = getattr(A, "jacobi_sweep", None)
    if post and js is not None:
        # the final sweep writes the requested output dtype directly
        for _ in range(post - 1):
            x = smooth(x, b, omega)
        if rdot:
            return A.jacobi_sweep_dot(x, b, omega, out_dtype=out_dtype)
        return js(x, b, omega, out_dtype=out_dtype)
    for _ in range(post):
        x = smooth(x, b, omega)
    x = x if out_dtype is None else x.astype(out_dtype)
    return (x, None) if rdot else x


def mg_preconditioner(op, *, nu: int = 2, min_size: int = 4,
                      coarse_iters: int = 40, cycle: str = "w",
                      transfers: str = "pwc",
                      dtype=None, return_rdot: bool = False) -> Callable:
    """Return ``M(r) -> z ~= A^{-1} r`` (one V- or W-cycle, both
    symmetric — valid CG preconditioners), shape-polymorphic like the
    stencil ``mv`` (flat or grid-shaped input).

    ``dtype``: the CYCLE's arithmetic precision (the residual is cast in,
    the correction cast back to ``r.dtype``).  ``None`` = auto: bf16 at
    bandwidth-bound sizes, input dtype otherwise — a preconditioner only
    needs ~1-digit accuracy per application, and bf16 halves the cycle's
    memory traffic at the cost of a PCG iteration or two.  Auto keeps
    the input dtype below ``_BF16_CYCLE_BYTES``."""
    levels = plan(op, nu=nu, min_size=min_size, coarse_iters=coarse_iters,
                  cycle=cycle, transfers=transfers)
    dims = levels.dims[0]
    if dtype is None:
        nbytes_f32 = 4 * math.prod(dims)
        cycle_dtype = (jnp.bfloat16 if nbytes_f32 > _BF16_CYCLE_BYTES
                       else None)   # None = follow the input dtype
    else:
        cycle_dtype = jnp.dtype(dtype)

    def M(r: jax.Array) -> jax.Array:
        g = r if r.ndim == len(dims) else r.reshape(dims)
        if cycle_dtype is not None and g.dtype != cycle_dtype:
            # cast_dtype folds the entry cast into the pre-smooth
            # kernel; out_dtype folds the cast back to the solver dtype
            # into the final smoothing kernel (no separate passes)
            z = vcycle(levels, g, out_dtype=r.dtype,
                       cast_dtype=cycle_dtype)
        else:
            z = vcycle(levels, g)
        return z if r.ndim == len(dims) else z.reshape(-1)

    if not return_rdot:
        return M

    def M_dot(r: jax.Array):
        """``(z, r·z)`` — the cycle plus PCG's post-preconditioner dot
        (``cg(precond_dot=...)``), written beside the final smoothing
        sweep; levels without a fused sweep-and-dot take an explicit f32
        dot against the TRUE residual."""
        g = r if r.ndim == len(dims) else r.reshape(dims)
        if cycle_dtype is not None and g.dtype != cycle_dtype:
            z, d = vcycle(levels, g, out_dtype=r.dtype,
                          cast_dtype=cycle_dtype, rdot=True)
        else:
            z, d = vcycle(levels, g, rdot=True)
        if d is None:
            d = jnp.sum(g.astype(jnp.float32) * z.astype(jnp.float32))
        return (z if r.ndim == len(dims) else z.reshape(-1), d)

    return M_dot
