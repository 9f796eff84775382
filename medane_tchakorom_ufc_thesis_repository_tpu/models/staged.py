"""Host-stepped multisplitting with per-stage wall timers.

The production drivers compile the WHOLE solve into one XLA program
(``models.multisplitting``, ``parallel.engine``) — the fast form, but
opaque to stage-level wall-clock attribution.  This module is the
observability twin: the same mathematics stepped from the host with a
device fence between phases, so a ``PhaseTimer`` can attribute real time
to the reference's PetscLog stages (SURVEY.md §5.1;
``synchronous-multisplitting.c:52-62`` registers stages Loading /
I_Solver / O_Solver / Last):

* ``I_Solver``    — the per-block inner Krylov sweeps,
* ``Exchange``    — publish + coupling RHS update (the MPI_Sendrecv
  analog, ``comm.c:126-141``),
* ``O_Solver``    — the s-step minimization least-squares,
* ``Convergence`` — residual norms + termination logic.

Each phase pays one dispatch and a fence, so this mode is for
*profiling*, not production — sweep counts and iterates match
``multisplit_solve`` exactly (asserted in tests), wall time does not.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from medane_tchakorom_ufc_thesis_repository_tpu.models.blockops import (
    BlockOperator,
)
from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
    InnerConfig,
    MultisplitResult,
    OuterConfig,
    _make_inner,
    _per_block,
    _solve_ls,
)
from medane_tchakorom_ufc_thesis_repository_tpu.utils.profiling import (
    PhaseTimer,
    fence,
)


def staged_multisplit_solve(
    op: BlockOperator,
    b: jax.Array,
    *,
    schedule: str = "sync",
    staleness: Union[int, Sequence[int]] = 1,
    minimization: Optional[str] = None,
    s: int = 4,
    inner=InnerConfig(),
    outer=OuterConfig(),
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    timer: Optional[PhaseTimer] = None,
) -> MultisplitResult:
    """``multisplit_solve`` semantics, host-stepped with stage timers.

    Pass a ``PhaseTimer`` to collect I_Solver / Exchange / O_Solver /
    Convergence wall shares; per-cycle residual norms are always
    recorded in ``result.history``.
    """
    if schedule not in ("sync", "async"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    is_async = schedule == "async"
    nb, bs = op.nblocks, op.block_size
    dtype = b.dtype
    if minimization is None:
        s = 1
    pt = timer if timer is not None else PhaseTimer()

    stal = jnp.asarray(
        np.broadcast_to(np.asarray(staleness, np.int32), (nb,)).copy()
    )
    if not is_async and not bool(np.all(np.asarray(staleness) == 1)):
        raise ValueError("sync schedule requires staleness == 1")

    outer_u, outer_pb = _per_block(outer, nb, "OuterConfig")
    if outer_pb is not None and minimization == "global":
        raise ValueError("per-block OuterConfig needs a blockwise scope")
    outer_eff = outer_u if outer_pb is None else outer_pb[0]

    inner_solve = jax.jit(_make_inner(op, inner))

    @jax.jit
    def exchange(x, x_vis, sweeps):
        done = (sweeps % stal) == 0
        x_vis = jnp.where(done[:, None], x, x_vis)
        rhs = b - op.coupling_mv(x_vis)
        return x_vis, rhs

    @jax.jit
    def minimize(S, rhs):
        if minimization == "local":
            Rcols = jax.vmap(op.diag_mv)(S)
            target = rhs
        else:
            Rcols = jax.vmap(op.full_mv)(S)
            target = b
        Rb = jnp.moveaxis(Rcols, 0, -1)
        Sb = jnp.moveaxis(S, 0, -1)
        if minimization == "global":
            Rf = Rb.reshape(nb * bs, s)
            alpha = _solve_ls(Rf, target.reshape(-1), outer_eff)
            # precision='highest': an unpinned f32 matmul may run in TF32
            # on the GPU; the production multisplit_solve path pins these
            # (this module's contract is exact-iterate parity with it)
            out_r = target.reshape(-1) - jnp.matmul(
                Rf, alpha, precision="highest")
            outer_rnorm = jnp.sqrt(jnp.sum(out_r * out_r))
            x_new = jnp.einsum("bns,s->bn", Sb, alpha,
                               precision="highest")
        else:
            if outer_pb is not None:
                alpha = jnp.stack([
                    _solve_ls(Rb[i], target[i], outer_pb[i])
                    for i in range(nb)
                ])
            else:
                alpha = jax.vmap(
                    lambda Rr, t: _solve_ls(Rr, t, outer_eff)
                )(Rb, target)
            if outer_eff.alpha_average:
                alpha = jnp.broadcast_to(
                    jnp.mean(alpha, axis=0, keepdims=True), alpha.shape
                )
            out_r = target - jnp.einsum("bns,bs->bn", Rb, alpha,
                                        precision="highest")
            outer_rnorm = jnp.sqrt(jnp.sum(out_r * out_r))
            x_new = jnp.einsum("bns,bs->bn", Sb, alpha,
                               precision="highest")
        return x_new, outer_rnorm

    @jax.jit
    def convergence(rhs, x):
        local_r = rhs - op.diag_mv(x)
        local_sq = jnp.sum(local_r * local_r, axis=1)
        return jnp.sqrt(local_sq), jnp.sqrt(jnp.sum(local_sq))

    x = jnp.zeros((nb, bs), dtype)
    x_vis = x
    with pt.phase("Exchange"):
        _, rhs = exchange(x, x_vis, jnp.zeros((), jnp.int32))
        fence(rhs)
    r0 = b - op.full_mv(x)
    rnorm0 = jnp.sqrt(jnp.sum(r0 * r0))
    tol_global = float(jnp.maximum(rtol * rnorm0, atol))
    tol_local = float(jnp.maximum(
        rtol / jnp.sqrt(jnp.asarray(float(nb), dtype)) * rnorm0, atol
    ))

    sweeps = 0
    cycles = 0
    inner_total = 0
    conv_count = np.zeros((nb,), np.int64)
    history = []
    outer_rnorm = float("inf")
    local_rnorms = jnp.full((nb,), jnp.inf, dtype)
    rnorm = float(rnorm0)
    converged = rnorm <= tol_global

    while not converged and sweeps < maxiter:
        S = []
        pub = np.zeros((nb,), bool)
        for _ in range(s):
            with pt.phase("I_Solver"):
                res = inner_solve(rhs, x)
                fence(res.x)
            x = res.x
            inner_total += int(jnp.sum(res.iters))
            sweeps += 1
            pub |= (sweeps % np.asarray(stal)) == 0
            with pt.phase("Exchange"):
                x_vis, rhs = exchange(
                    x, x_vis, jnp.asarray(sweeps, jnp.int32)
                )
                fence(rhs)
            S.append(x)

        if minimization is not None:
            with pt.phase("O_Solver"):
                x, o_rn = minimize(jnp.stack(S), rhs)
                fence(x)
            outer_rnorm = float(o_rn)
            with pt.phase("Exchange"):
                x_vis, rhs = exchange(
                    x, x_vis, jnp.asarray(sweeps, jnp.int32)
                )
                fence(rhs)

        with pt.phase("Convergence"):
            local_rnorms, rn = convergence(rhs, x)
            fence(rn)
        rnorm = float(rn)
        history.append(rnorm)
        cycles += 1

        if is_async:
            under = np.asarray(local_rnorms) <= tol_local
            all_pub = bool(pub.all())
            conv_count = np.where(
                ~under, 0, np.where(all_pub, conv_count + 1, conv_count)
            )
            converged = bool((conv_count >= min_convergence_count).all())
        elif minimization == "global":
            converged = outer_rnorm <= tol_global
        elif minimization is not None:
            converged = bool((np.asarray(local_rnorms) <= tol_local).all())
        else:
            converged = rnorm <= tol_global

    hist = jnp.asarray(history, dtype) if history else None
    return MultisplitResult(
        x=x, sweeps=jnp.asarray(sweeps, jnp.int32),
        cycles=jnp.asarray(cycles, jnp.int32),
        inner_iters=jnp.asarray(inner_total, jnp.int32),
        rnorm=jnp.asarray(rnorm, dtype), rnorm0=rnorm0,
        local_rnorms=local_rnorms,
        outer_rnorm=jnp.asarray(outer_rnorm, dtype),
        converged=jnp.asarray(converged), history=hist,
    )
