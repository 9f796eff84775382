"""Double-float (two-f32) arithmetic for f64-accurate residuals.

Iterative refinement only needs the *residual* to be accurate to
~1e-12, while the solves run in f32.  The classic compensated-arithmetic
answer is double-float: represent each value as an unevaluated sum
``hi + lo`` of two f32s (~2^-48 ≈ 4e-15 effective relative precision) and
use error-free transformations (Knuth two-sum) for every addition.  Every
operation is a native f32 op, the whole residual pass stays one fused
bandwidth-bound expression (the hi/lo pair moves 8 bytes per element, as
native f64 would), and the numerics are proven (Dekker 1971, Knuth TAOCP
v2).  Whether native f64 residuals tie this on the device is an open
measurement; until then the df form is the only refinement residual.

Scope: the Poisson stencil family's residual ``r = b - A x`` (the only
f64-grade computation the refinement loop needs) plus the df solution
update.  Stencil coefficient products are exact or 1-ulp-compensated:
``off = -1`` is exact, ``diag`` multiplies split into power-of-two parts
(``6x = 4x + 2x``, one two-sum).

CAUTION (XLA): error-free transforms die if the compiler reassociates or
fast-maths the float graph.  XLA does not reassociate adds by default
and this module's tests pin the achieved precision; if a future XLA flag
enables fast-math, ``test_df64`` will catch it.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


DF = Tuple[jax.Array, jax.Array]  # (hi, lo), value = hi + lo


def scaled_norm(x, axes=None):
    """f32-safe 2-norm: scale by the (global) max first — squares of
    ~1e-11 values underflow the f32 range.  ``axes``: optional mesh axis
    name(s) for SPMD use (pmax/psum across devices)."""
    from jax import lax

    m = jnp.maximum(jnp.max(jnp.abs(x)), jnp.float32(1e-30))
    if axes is not None:
        m = lax.pmax(m, axes)
    ss = jnp.sum(jnp.square(x / m))
    if axes is not None:
        ss = lax.psum(ss, axes)
    return m * jnp.sqrt(ss)


def two_sum(a, b) -> DF:
    """Error-free transformation: a + b = s + e exactly (Knuth, 6 flops,
    branch-free — no magnitude ordering required)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def df_from_f64(x64) -> DF:
    """Split a host/f64 array into (hi, lo) f32 pair: hi = round(x),
    lo = round(x - hi).  Done in numpy so the device never sees f64."""
    x64 = np.asarray(x64, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)


def df_to_f64(d: DF) -> np.ndarray:
    hi, lo = d
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df_add(a: DF, b: DF) -> DF:
    """df + df -> df  (Dekker/Bailey add: ~11 flops, ~2^-48 accurate)."""
    ahi, alo = a
    bhi, blo = b
    s, e = two_sum(ahi, bhi)
    e = e + (alo + blo)
    hi, lo = two_sum(s, e)
    return hi, lo


def df_add_f32(a: DF, b) -> DF:
    ahi, alo = a
    s, e = two_sum(ahi, b)
    e = e + alo
    hi, lo = two_sum(s, e)
    return hi, lo


def df_neg(a: DF) -> DF:
    return -a[0], -a[1]


def df_scale_pow2(a: DF, c: float) -> DF:
    """Multiply by a power of two (exact in both components)."""
    return a[0] * c, a[1] * c


def df_mul_f32(a: DF, s) -> DF:
    """df * f32 scalar via Dekker split two-product (no FMA needed)."""
    ahi, alo = a
    p = ahi * s
    # Dekker split of ahi and s (f32: split at 12 bits, 2^12 + 1)
    c = jnp.float32(4097.0)
    ah = c * ahi - (c * ahi - ahi)
    at = ahi - ah
    sh = c * s - (c * s - s)
    st = s - sh
    err = ((ah * sh - p) + ah * st + at * sh) + at * st
    e = err + alo * s
    hi, lo = two_sum(p, e)
    return hi, lo


def _int_coeff_mul(x, c: float) -> DF:
    """Exact ``c * x`` for small-integer stencil coefficients, as a df.

    Decomposes |c| into at most two powers of two (covers 1..7 minus 5,7:
    1, 2, 3=2+1, 4, 6=4+2 — the Poisson family's diagonals), each product
    exact, combined with one two-sum.  Falls back to a Dekker product for
    general coefficients.
    """
    ac = abs(c)
    sign = 1.0 if c >= 0 else -1.0
    parts = []
    for p2 in (4.0, 2.0, 1.0):
        if ac >= p2:
            parts.append(p2)
            ac -= p2
    if ac != 0.0 or len(parts) > 2:
        # general path: Dekker two-product against a constant
        return df_mul_f32((x, jnp.zeros_like(x)), jnp.float32(c))
    if len(parts) == 1:
        return sign * parts[0] * x, jnp.zeros_like(x)
    hi, lo = two_sum(sign * parts[0] * x, sign * parts[1] * x)
    return hi, lo


def stencil2d_df_residual(m: int, n: int, diag: float, off: float):
    """Return ``residual((bhi, blo), (xhi, xlo)) -> (rhi, rlo)`` computing
    ``r = b - A x`` for the 2D 5-point stencil entirely in f32 df
    arithmetic (grid-shaped (m, n) arrays)."""

    def residual(b: DF, x: DF) -> DF:
        xhi, xlo = x

        def taps(g):
            p = jnp.pad(g, 1)
            return p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]

        # neighbor sum: 4-term pairwise two-sum tree on hi, f32 on lo
        p = jnp.pad(xhi, 1)
        s1, e1 = two_sum(p[:-2, 1:-1], p[2:, 1:-1])
        s2, e2 = two_sum(p[1:-1, :-2], p[1:-1, 2:])
        nh, e3 = two_sum(s1, s2)
        nl = (e1 + e2 + e3) + taps(xlo)
        ndf = _df_combine(nh, nl, off)
        ddf = _int_coeff_mul(xhi, diag)
        ddf = df_add_f32(ddf, jnp.float32(diag) * xlo)
        ax = df_add(ddf, ndf)
        return df_add(b, df_neg(ax))

    return residual


def _df_residual_core_3d(phi, plo, bhi_s, blo_s, diag: float, off: float):
    """The 3D EFT residual tree on PADDED (n+2, ny+2, nz+2) hi/lo windows
    (zero or halo boundary planes already written in) against the
    matching unpadded b slabs.  Shared by the whole-array and x-slab
    forms — identical operations, so results are bit-identical."""
    def taps(p):
        return (
            p[:-2, 1:-1, 1:-1] + p[2:, 1:-1, 1:-1]
            + p[1:-1, :-2, 1:-1] + p[1:-1, 2:, 1:-1]
            + p[1:-1, 1:-1, :-2] + p[1:-1, 1:-1, 2:]
        )

    s1, e1 = two_sum(phi[:-2, 1:-1, 1:-1], phi[2:, 1:-1, 1:-1])
    s2, e2 = two_sum(phi[1:-1, :-2, 1:-1], phi[1:-1, 2:, 1:-1])
    s3, e3 = two_sum(phi[1:-1, 1:-1, :-2], phi[1:-1, 1:-1, 2:])
    t1, e4 = two_sum(s1, s2)
    nh, e5 = two_sum(t1, s3)
    nl = (((e1 + e2) + (e3 + e4)) + e5) + taps(plo)
    ndf = _df_combine(nh, nl, off)
    xhi_c = phi[1:-1, 1:-1, 1:-1]
    xlo_c = plo[1:-1, 1:-1, 1:-1]
    ddf = _int_coeff_mul(xhi_c, diag)
    ddf = df_add_f32(ddf, jnp.float32(diag) * xlo_c)
    ax = df_add(ddf, ndf)
    return df_add((bhi_s, blo_s), df_neg(ax))


def stencil3d_df_residual(nx: int, ny: int, nz: int, diag: float, off: float):
    """As ``stencil2d_df_residual`` for the 3D 7-point stencil."""

    def residual(b: DF, x: DF) -> DF:
        xhi, xlo = x
        phi = jnp.pad(xhi, 1)
        plo = jnp.pad(xlo, 1)
        return _df_residual_core_3d(phi, plo, b[0], b[1], diag, off)

    return residual


def _df_combine(hi, lo, coeff: float) -> DF:
    """(hi + lo) * coeff as a df, exact for power-of-two/unit coeffs."""
    if abs(coeff) in (1.0, 2.0, 4.0, 0.5, 0.25):
        return hi * coeff, lo * coeff
    d = _int_coeff_mul(hi, coeff)
    return df_add_f32(d, jnp.float32(coeff) * lo)


def df_residual_for(op):
    """Residual builder for a stencil operator (Stencil2D/Stencil3D)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as om

    if isinstance(op, om.Stencil2D):
        return stencil2d_df_residual(op.m, op.n, op.diag, op.off)
    if isinstance(op, om.Stencil3D):
        return stencil3d_df_residual(op.nx, op.ny, op.nz, op.diag, op.off)
    raise TypeError(
        f"df residual supports Stencil2D/Stencil3D, got {type(op).__name__}"
    )
