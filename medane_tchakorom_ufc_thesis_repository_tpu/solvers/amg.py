"""Smoothed-aggregation algebraic multigrid preconditioner (PCGAMG
analog).

``solvers/multigrid.py`` (the PCMG analog) covers the reference's
structured Poisson grids; this module extends the same O(n)
preconditioning to ARBITRARY SPD matrices arriving through the AIJ
entry point (``create_matrix_sparse``-style assemblies with no grid,
reference ``src/utils/utils.c:139-155``).  Setup derives the hierarchy
from the matrix graph alone — Vanek smoothed aggregation:

  1. strength graph  ``|a_ij| >= theta * sqrt(a_ii a_jj)``,
  2. greedy aggregation (each seed swallows its strong neighborhood,
     stragglers join an adjacent aggregate),
  3. tentative P = normalized piecewise-constant over aggregates,
  4. smoothed ``P = (I - omega D^{-1} A) P_t`` with
     ``omega = 4 / (3 rho(D^{-1} A))`` (power-iteration estimate),
  5. Galerkin ``A_{k+1} = P^T A_k P``, recurse to a dense coarse solve.

Apply design
------------
* The V-cycle is a PYTREE program: a static tuple of levels unrolled in
  Python, so the whole PCG-with-AMG solve jits into one XLA program
  (no host round-trips per cycle) and the preconditioner travels as an
  argument through the cached ``api._jitted_ksp`` programs.
* Smoothing is damped Jacobi (one routed SpMV + an elementwise update
  per step) — symmetric, collective-free, and the same pre/post count
  keeps the cycle SPD, so it is a valid ``cg``/``minres`` preconditioner.
* P / P^T applies are gather-ELL matvecs.  The transfers touch each
  stored value once per cycle against vectors a level smaller — the
  level SpMV (routed DIA/BSR/dense) dominates.  P^T is stored as its
  OWN row-major ELL pack built host-side: no device scatter-add
  transposes anywhere.
* The dense coarse inverse is applied as one matmul at
  ``precision=HIGHEST`` (an unpinned f32 matmul may run in TF32 on the
  GPU, about three decimal digits).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import ELL

__all__ = ["AMGPreconditioner", "amg_setup"]


@dataclasses.dataclass(frozen=True)
class AMGLevel:
    """One hierarchy level: the routed operator, the damped-Jacobi
    smoother diagonal (``omega / diag``), and the transfer packs."""

    op: Any          # routed operator pytree (DIA | BSR | DenseOp | ELL)
    dinv: jax.Array  # (n_k,) omega_smooth / diag(A_k)
    P: ELL           # (n_k, n_{k+1}) smoothed prolongator
    Pt: ELL          # (n_{k+1}, n_k) its transpose, own row-major pack


jax.tree_util.register_dataclass(
    AMGLevel, data_fields=["op", "dinv", "P", "Pt"], meta_fields=[]
)


@dataclasses.dataclass(frozen=True)
class AMGPreconditioner:
    """V(nu,nu) smoothed-aggregation cycle; ``apply`` is jit-traceable
    and SPD (matched pre/post damped-Jacobi smoothing), usable as
    ``cg(..., precond=M.apply)`` / ``solve(..., pc='amg')``."""

    levels: Tuple[AMGLevel, ...]
    coarse_inv: jax.Array      # (nc, nc) dense inverse of the coarsest A
    nu: int = 1

    def apply(self, r: jax.Array) -> jax.Array:
        return self._cycle(0, r)

    def _cycle(self, k: int, r: jax.Array) -> jax.Array:
        if k == len(self.levels):
            return jnp.matmul(self.coarse_inv, r,
                              precision=jax.lax.Precision.HIGHEST)
        lvl = self.levels[k]
        x = lvl.dinv * r                       # first sweep from x = 0
        for _ in range(self.nu - 1):
            x = x + lvl.dinv * (r - lvl.op.mv(x))
        rc = lvl.Pt.mv(r - lvl.op.mv(x))
        x = x + lvl.P.mv(self._cycle(k + 1, rc))
        for _ in range(self.nu):
            x = x + lvl.dinv * (r - lvl.op.mv(x))
        return x


jax.tree_util.register_dataclass(
    AMGPreconditioner, data_fields=["levels", "coarse_inv"],
    meta_fields=["nu"],
)


def _strength_csr(A, theta: float):
    """Symmetric strength-of-connection graph as a boolean csr (no
    diagonal): ``|a_ij| >= theta * sqrt(|a_ii a_jj|)``."""
    import scipy.sparse as sp

    coo = A.tocoo()
    d = np.abs(A.diagonal())
    d[d == 0] = 1.0
    off = coo.row != coo.col
    strong = off & (np.abs(coo.data)
                    >= theta * np.sqrt(d[coo.row] * d[coo.col]))
    return sp.csr_matrix(
        (np.ones(int(strong.sum())),
         (coo.row[strong], coo.col[strong])), shape=A.shape,
    )


def _aggregate(S) -> np.ndarray:
    """Standard greedy aggregation (Vanek phase 1-3) on the strength
    graph: returns ``agg[i] in [0, n_agg)``.  Host-side Python loop over
    rows — O(nnz), a few hundred ms at 10^5 rows; setup-time only."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    agg = np.full(n, -1, np.int64)
    count = 0
    # phase 1: untouched seed + fully-untouched neighborhood
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = count
            agg[nbrs] = count
            count += 1
    # phase 2: stragglers join an adjacent aggregate
    stragglers = np.flatnonzero(agg == -1)
    snapshot = agg.copy()
    for i in stragglers:
        nbrs = indices[indptr[i]:indptr[i + 1]]
        joined = nbrs[snapshot[nbrs] != -1]
        if len(joined):
            agg[i] = snapshot[joined[0]]
    # phase 3: isolated nodes become singleton aggregates
    for i in np.flatnonzero(agg == -1):
        agg[i] = count
        count += 1
    return agg


def _rho_dinv_a(A, iters: int = 20, seed: int = 0) -> float:
    """Power-iteration estimate of ``rho(D^{-1} A)`` (host f64)."""
    d = A.diagonal().astype(np.float64)
    d[d == 0] = 1.0
    v = np.random.default_rng(seed).standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    rho = 2.0
    for _ in range(iters):
        w = (A @ v) / d
        nw = np.linalg.norm(w)
        if nw == 0:
            break
        rho, v = nw, w / nw
    return float(max(rho, 1e-12))


def amg_setup(A, *, theta: float = 0.0, nu: int = 1,
              max_levels: int = 12, coarse_n: int = 256,
              dtype=jnp.float32, max_coarse_dense: int = 4096,
              **route_kw) -> AMGPreconditioner:
    """Build the smoothed-aggregation hierarchy for a symmetric
    positive-definite ``scipy.sparse`` (or dense numpy) matrix.

    ``theta``: strength threshold (0 = every off-diagonal is strong —
    right for M-matrices like diffusion; raise toward ~0.25 for
    anisotropic problems).  ``nu``: pre = post smoothing sweeps.
    Setup runs host-side in f64 (scipy products); the returned pytree
    carries ``dtype`` device arrays and routed level operators.
    """
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        from_scipy,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.core.poisson import (
        coo_to_ell,
    )

    A = sp.csr_matrix(A).astype(np.float64)
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"amg_setup needs a square matrix, got {A.shape}")

    levels = []
    Ak = A
    while Ak.shape[0] > coarse_n and len(levels) < max_levels:
        n = Ak.shape[0]
        S = _strength_csr(Ak, theta)
        agg = _aggregate(S)
        nc = int(agg.max()) + 1
        if nc >= 0.9 * n:
            # no meaningful coarsening (diagonal-ish graph): stop here —
            # the caller still gets a valid (shallower) hierarchy as
            # long as the coarse solve below can afford this size
            break
        # tentative prolongator: piecewise constant over aggregates,
        # columns normalized (near-nullspace candidate = ones)
        sizes = np.bincount(agg, minlength=nc).astype(np.float64)
        Pt_tent = sp.csr_matrix(
            (1.0 / np.sqrt(sizes[agg]), (np.arange(n), agg)),
            shape=(n, nc),
        )
        rho = _rho_dinv_a(Ak)
        omega = 4.0 / (3.0 * rho)
        d = Ak.diagonal().copy()
        d[d == 0] = 1.0
        Dinv = sp.diags(1.0 / d)
        P = (Pt_tent - omega * (Dinv @ (Ak @ Pt_tent))).tocsr()
        P.eliminate_zeros()

        pcoo = P.tocoo()
        lvl = AMGLevel(
            op=from_scipy(Ak, dtype=dtype, **route_kw),
            dinv=jnp.asarray(omega / d, dtype),
            P=coo_to_ell(pcoo.row, pcoo.col, pcoo.data, P.shape,
                         dtype=dtype),
            Pt=coo_to_ell(pcoo.col, pcoo.row, pcoo.data,
                          (P.shape[1], P.shape[0]), dtype=dtype),
        )
        levels.append(lvl)
        Ak = (P.T @ (Ak @ P)).tocsr()
        Ak.eliminate_zeros()

    if Ak.shape[0] > max_coarse_dense:
        raise ValueError(
            f"AMG coarsening stalled at n={Ak.shape[0]} (> "
            f"max_coarse_dense={max_coarse_dense}): the strength graph "
            f"has too few connections to aggregate (theta={theta} too "
            "high, or the matrix is near-diagonal — use pc='jacobi')"
        )
    if Ak.shape[0] > coarse_n:
        warnings.warn(
            f"AMG hierarchy bottomed out at n={Ak.shape[0]} > coarse_n="
            f"{coarse_n}; using a dense coarse inverse at that size",
            UserWarning, stacklevel=2,
        )
    coarse_inv = np.linalg.pinv(Ak.toarray())
    return AMGPreconditioner(
        levels=tuple(levels),
        coarse_inv=jnp.asarray(coarse_inv, dtype),
        nu=nu,
    )
