"""Mixed-precision iterative refinement.

The device solves run in f32 (and bf16 inside the MG cycle); a single
f32 solve bottoms out near 1e-6..1e-7 relative residual — short of the
north-star's 1e-8 target on 3D Poisson (BASELINE.json).  Classic
iterative refinement fixes this without giving up f32 device speed:

    repeat:  r = b - A x          (f64, host/numpy — exact to ~1e-16)
             d = solve(A, r)      (f32, on device, loose tolerance)
             x = x + d            (f64 accumulation)

Each pass multiplies the residual by roughly the f32 solve's relative
tolerance, so 2-3 passes reach 1e-8..1e-12 while all heavy compute stays
on the device.  The reference needs no such machinery because PETSc runs
f64 end-to-end on CPU; this module is the mixed-precision equivalent of
"just run to 1e-8".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray            # f64 solution
    passes: int
    rel_history: List[float]
    rnorm: float
    rnorm0: float
    converged: bool


def iterative_refinement(
    solve_f32: Callable,      # (b_f32: jax.Array) -> x_f32 approximate solve
    mv_f64: Callable,         # (x: np.ndarray f64) -> A @ x in f64 (host)
    b: np.ndarray,            # f64 RHS
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
) -> RefineResult:
    """Drive ``solve_f32`` to f64 accuracy by refinement.

    ``solve_f32`` may be any jitted device solve (GMRES, a multisplitting
    driver, ...) taking and returning flat f32 arrays; ``mv_f64`` is the
    exact operator in f64 (numpy; the stencil/DIA operators evaluate
    exactly in numpy via their ``to_dense``-free formulas).
    """
    b = np.asarray(b, np.float64)
    rnorm0 = float(np.linalg.norm(b))
    if rnorm0 == 0.0:
        return RefineResult(np.zeros_like(b), 0, [], 0.0, 0.0, True)
    x = np.zeros_like(b)
    history: List[float] = []
    for p in range(max_passes):
        r = b - mv_f64(x)
        rnorm = float(np.linalg.norm(r))
        rel = rnorm / rnorm0
        history.append(rel)
        if rel <= rtol:
            return RefineResult(x, p, history, rnorm, rnorm0, True)
        # scale the correction problem to O(1) so f32 dynamic range is
        # fully available to the inner solve
        scale = rnorm
        d32 = solve_f32(jnp.asarray(r / scale, jnp.float32))
        x = x + scale * np.asarray(d32, np.float64)
    r = b - mv_f64(x)
    rnorm = float(np.linalg.norm(r))
    history.append(rnorm / rnorm0)
    return RefineResult(
        x, max_passes, history, rnorm, rnorm0, rnorm / rnorm0 <= rtol
    )


@functools.lru_cache(maxsize=32)
def _device_refine_helpers(matvec_key):
    """Jitted refinement helpers, cached per operator.

    ``matvec`` arrives as a hashable key (the operator's bound ``mv`` —
    frozen-dataclass operators hash/compare by value) so that REPEATED
    refinement calls on the same operator reuse the compiled programs
    (per-call closures would re-trace and re-compile every call).
    """
    import jax

    @jax.jit
    def residual_pass(b64, x64):
        r = b64 - matvec_key(x64)
        return r, jnp.sqrt(jnp.sum(r * r))

    @jax.jit
    def apply_correction(x64, d32, scale):
        return x64 + scale * d32.astype(jnp.float64)

    return residual_pass, apply_correction


def device_iterative_refinement(
    matvec: Callable,         # dtype-generic operator apply (f32 AND f64)
    b64,                      # f64 RHS (any shape the matvec accepts)
    solve_f32: Callable,      # (r32) -> d32 approximate device solve
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
) -> RefineResult:
    """Refinement with the f64 residual computed ON DEVICE.

    The residual is one bandwidth-bound pass, so keeping it on the
    device beats shipping 2x the state to the host each pass; only
    scalars cross the host boundary.  Requires a ``matvec`` that evaluates in the dtype of its
    argument — true for the matrix-free stencil operators.  Pass a
    hashable ``matvec`` (e.g. an operator's bound ``mv``) to reuse the
    compiled residual pass across calls.
    """
    b64 = jnp.asarray(b64, jnp.float64)
    try:
        residual_pass, apply_correction = _device_refine_helpers(matvec)
    except TypeError:  # unhashable closure — fall back to per-call jits
        # (a failed lru_cache lookup raises BEFORE caching, so other
        # operators' compiled helpers stay cached — do NOT cache_clear)
        residual_pass, apply_correction = _device_refine_helpers.__wrapped__(
            matvec
        )

    rnorm0 = float(jnp.sqrt(jnp.sum(b64 * b64)))
    if rnorm0 == 0.0:
        z = np.zeros(np.shape(b64))
        return RefineResult(z, 0, [], 0.0, 0.0, True)
    x64 = jnp.zeros_like(b64)
    history: List[float] = []
    for p in range(max_passes):
        if p == 0:
            # x = 0 => r = b exactly; skip the f64 matvec pass
            r64, rnorm = b64, rnorm0
        else:
            r64, rn = residual_pass(b64, x64)
            rnorm = float(rn)
        rel = rnorm / rnorm0
        history.append(rel)
        if rel <= rtol:
            return RefineResult(np.asarray(x64), p, history, rnorm,
                                rnorm0, True)
        d32 = solve_f32((r64 / rnorm).astype(jnp.float32))
        x64 = apply_correction(x64, d32, rnorm)
    r64, rn = residual_pass(b64, x64)
    rnorm = float(rn)
    history.append(rnorm / rnorm0)
    return RefineResult(
        np.asarray(x64), max_passes, history, rnorm, rnorm0,
        rnorm / rnorm0 <= rtol,
    )


@functools.lru_cache(maxsize=32)
def _df_refine_helpers(op):
    """Jitted double-float refinement helpers, cached per operator."""
    import jax
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64

    residual = df64.df_residual_for(op)

    @jax.jit
    def residual_pass(bhi, blo, xhi, xlo):
        rhi, rlo = residual((bhi, blo), (xhi, xlo))
        return rhi, rlo, df64.scaled_norm(rhi)

    @jax.jit
    def apply_correction(xhi, xlo, d32, scale):
        # scale * d via Dekker two-product so the update rounding stays
        # ~2^-48 relative (a plain f32 product would floor refinement at
        # ~1e-7 — the very limit refinement exists to beat)
        upd = df64.df_mul_f32((d32, jnp.zeros_like(d32)), scale)
        return df64.df_add((xhi, xlo), upd)

    return residual_pass, apply_correction


def df_iterative_refinement(
    op,                       # Stencil2D/Stencil3D operator
    b64,                      # f64 RHS, host-side (numpy) — or None with b_df
    solve_f32: Callable,      # (r32 grid) -> d32 approximate device solve
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
    b_df=None,                # optional device-resident (bhi, blo) pair
    return_host: bool = True,
) -> RefineResult:
    """Iterative refinement with DOUBLE-FLOAT (two-f32) residuals.

    This driver keeps x and b as (hi, lo) f32 pairs on device, computes
    ``r = b - A x`` with error-free transformations (~4e-15 effective
    precision, ``solvers/df64.py``), and never touches f64 on the device
    at all — only the final solution is recombined on the host.  Shapes
    are grid-shaped throughout (no relayouts).

    ``b_df``: device-resident (bhi, blo) f32 pair for the RHS — pass this
    when b is already exactly representable on device (e.g. b = A·1 has
    small-integer entries) to skip the host split + upload of 2x the
    state.  ``return_host=False`` likewise leaves the solution as a df
    pair on device (``RefineResult.x`` is then the (hi, lo) tuple).
    """
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64
    import jax.numpy as _jnp

    residual_pass, apply_correction = _df_refine_helpers(op)
    if b_df is not None:
        bhi, blo = b_df
        dims = bhi.shape
        m = jnp.maximum(jnp.max(jnp.abs(bhi)), jnp.float32(1e-30))
        rnorm0 = float(m * jnp.sqrt(jnp.sum(jnp.square(bhi / m))))
    else:
        dims = np.shape(b64)
        b64 = np.asarray(b64, np.float64)
        rnorm0 = float(np.linalg.norm(b64.ravel()))
        bhi, blo = df64.df_from_f64(b64)
    if rnorm0 == 0.0:
        return RefineResult(np.zeros(dims), 0, [], 0.0, 0.0, True)
    xhi = _jnp.zeros_like(bhi)
    xlo = _jnp.zeros_like(blo)
    history: List[float] = []
    rhi, rnorm = bhi, rnorm0
    for p in range(max_passes):
        if p > 0:
            rhi, _rlo, rn = residual_pass(bhi, blo, xhi, xlo)
            rnorm = float(rn)
        rel = rnorm / rnorm0
        history.append(rel)
        if rel <= rtol:
            x = _df_out((xhi, xlo), dims, return_host)
            return RefineResult(x, p, history, rnorm, rnorm0, True)
        d32 = solve_f32(rhi / jnp.float32(rnorm))
        xhi, xlo = apply_correction(xhi, xlo, d32, jnp.float32(rnorm))
    rhi, _rlo, rn = residual_pass(bhi, blo, xhi, xlo)
    rnorm = float(rn)
    history.append(rnorm / rnorm0)
    x = _df_out((xhi, xlo), dims, return_host)
    return RefineResult(
        x, max_passes, history, rnorm, rnorm0, rnorm / rnorm0 <= rtol
    )


@functools.lru_cache(maxsize=32)
def _df_fused_program(op, rtol: float, max_passes: int,
                      inner_rtol: float, pcg_maxiter: int,
                      nu: int, min_size: int, coarse_iters: int,
                      cycle: str):
    """ONE jitted program for the whole df-refined MG-PCG north-star.

    The host-loop drivers (``df_iterative_refinement``) pay ~4
    dispatches per refinement pass (solve, residual, correction, scalar
    readback).  Fusing the pass loop into a ``lax.while_loop`` (CG +
    W-cycle + df residual all inline) makes the entire solve-to-1e-8 a
    SINGLE dispatch; only the final scalars cross the host boundary.
    """
    import jax
    from jax import lax

    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import cg
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
        mg_preconditioner,
    )

    residual = df64.df_residual_for(op)
    # return_rdot: PCG's post-cycle vdot(r, z) is written beside the
    # cycle's final smoothing sweep
    Md = mg_preconditioner(op, nu=nu, min_size=min_size,
                           coarse_iters=coarse_iters, cycle=cycle,
                           return_rdot=True)

    _norm = df64.scaled_norm

    @jax.jit
    def run(bhi, blo):
        rnorm0 = _norm(bhi)
        tol = jnp.float32(rtol) * rnorm0

        def body(carry):
            xhi, xlo, rhi, rnorm, passes = carry
            d = cg(op.mv, rhi / rnorm, maxiter=pcg_maxiter,
                   rtol=inner_rtol, precond_dot=Md,
                   matvec_dot=getattr(op, "mv_dot", None)).x
            upd = df64.df_mul_f32((d, jnp.zeros_like(d)), rnorm)
            xhi2, xlo2 = df64.df_add((xhi, xlo), upd)
            rhi2, _rlo2 = residual((bhi, blo), (xhi2, xlo2))
            return xhi2, xlo2, rhi2, _norm(rhi2), passes + 1

        def cond(carry):
            _, _, _, rnorm, passes = carry
            return jnp.logical_and(rnorm > tol, passes < max_passes)

        x0 = jnp.zeros_like(bhi)
        init = (x0, jnp.zeros_like(bhi), bhi, rnorm0,
                jnp.zeros((), jnp.int32))
        xhi, xlo, _rhi, rnorm, passes = lax.while_loop(cond, body, init)
        # ONE stacked scalar output: each separate float()/int()
        # readback is a device round-trip
        stats = jnp.stack([rnorm, rnorm0, passes.astype(jnp.float32)])
        return xhi, xlo, stats

    return run


def df_northstar_fused(
    op,
    b_df=None,
    *,
    rtol: float = 1e-8,
    max_passes: int = 6,
    inner_rtol: float = 1e-5,
    pcg_maxiter: int = 40,
    nu: int = 2,
    min_size: int = 4,
    coarse_iters: int = 40,
    cycle: str = "w",
) -> RefineResult:
    """Single-dispatch df-refined MG-PCG solve of ``A x = b`` to ``rtol``
    relative TRUE residual (``b = A·1`` built on device when ``b_df`` is
    None).  Returns ``RefineResult`` with ``x`` as the device (hi, lo)
    pair; no per-pass history (everything stays on-chip — that is the
    point)."""
    run = _df_fused_program(
        op, float(rtol), int(max_passes), float(inner_rtol),
        int(pcg_maxiter), int(nu), int(min_size), int(coarse_iters),
        str(cycle),
    )
    if b_df is None:
        bhi = op.mv(jnp.ones(_op_grid_dims(op), jnp.float32))
        b_df = (bhi, jnp.zeros_like(bhi))
    xhi, xlo, stats = run(*b_df)
    stats = np.asarray(stats)   # one readback for all three scalars
    rn, rn0, p = float(stats[0]), float(stats[1]), int(stats[2])
    return RefineResult(
        (xhi, xlo), p, [], rn, rn0, rn <= rtol * rn0,
    )


def _op_grid_dims(op):
    from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as om

    if isinstance(op, om.Stencil2D):
        return (op.m, op.n)
    return (op.nx, op.ny, op.nz)


def _df_out(x_df, dims, return_host: bool):
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64

    if not return_host:
        return x_df
    return df64.df_to_f64(x_df).reshape(dims)


def stencil2d_mv_np(m: int, n: int, diag: float = 4.0, off: float = -1.0):
    """Exact f64 host matvec for the 2D 5-point operator (refinement use)."""

    def mv(x):
        g = np.asarray(x, np.float64).reshape(m, n)
        y = diag * g
        y[1:, :] += off * g[:-1, :]
        y[:-1, :] += off * g[1:, :]
        y[:, 1:] += off * g[:, :-1]
        y[:, :-1] += off * g[:, 1:]
        return y.reshape(-1)

    return mv


def stencil3d_mv_np(nx: int, ny: int, nz: int, diag: float = 6.0,
                    off: float = -1.0):
    """Exact f64 host matvec for the 3D 7-point operator."""

    def mv(x):
        g = np.asarray(x, np.float64).reshape(nx, ny, nz)
        y = diag * g
        y[1:] += off * g[:-1]
        y[:-1] += off * g[1:]
        y[:, 1:, :] += off * g[:, :-1, :]
        y[:, :-1, :] += off * g[:, 1:, :]
        y[:, :, 1:] += off * g[:, :, :-1]
        y[:, :, :-1] += off * g[:, :, 1:]
        return y.reshape(-1)

    return mv
