"""Host-driven genuinely-asynchronous multisplitting (AM / AMAM_*).

The SPMD drivers emulate asynchrony with bounded-staleness schedules
(deterministic, compilable).  This backend reproduces the reference's
*actual* execution model (``asynchronous-multisplitting_prime.c``,
SURVEY.md §3.4): each Jacobi block advances at its own pace on its own
host thread, exchanging iterates through drain-to-newest mailboxes
(the analog of ``comm_async_probe_and_receive``'s Iprobe/drain loop,
``comm.c:6-55``) and detecting termination with the decentralized
Alg-5.15 protocol (``models.convergence``).  Interleavings are genuinely
nondeterministic; convergence is guaranteed by the theory of totally
asynchronous iterations (contraction of the block Jacobi operator).

Each block's sweep is one jitted device computation; on a multi-device
backend each block is pinned to its own device so sweeps overlap for
real.  On a single chip the device queue serializes compute but the
schedule (which iterate a block sees from its peer) remains
message-driven, not lockstep.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from medane_tchakorom_ufc_thesis_repository_tpu.models.blockops import BlockOperator
from medane_tchakorom_ufc_thesis_repository_tpu.models.convergence import (
    Alg515Node,
    LocalTransport,
    State,
)
from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
    InnerConfig,
    OuterConfig,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lstsq import lstsq_qr


@dataclasses.dataclass
class HostAsyncResult:
    x: jax.Array               # (nblocks, block_size)
    sweeps_per_block: List[int]
    rnorm: float
    rnorm0: float
    converged: bool
    elapsed_s: float
    # lockstep-tail certificate (see _sync_certify): True means the
    # returned x satisfies ||b - A x|| <= rtol*||b|| exactly
    certified: bool = False
    tail_rounds: int = 0


def _sync_certify(op, b, x, tol_local, inner, *, max_rounds=50):
    """Post-verdict lockstep certification (in-process analog of
    ``net_async._certification_tail``).

    Alg-5.15 certifies each block against stale-but-fresh peer data, so
    the MERGED residual of the protocol-terminated stack can exceed
    rtol·‖b‖ by ~(1+‖A_ic‖·‖A_ii⁻¹‖).  Here all threads have joined, so
    certification is direct: measure every block's rows of the true
    global residual on the identical stack; while any block is over
    ``tol_local``, run one synchronous Jacobi round (the sync handshake
    ``comm_sync_convergence_detection``, ``comm.c:235-250``, collapsed
    to in-process lockstep).  Returns ``(x, certified, rounds)``; all
    blocks under ``tol_local = rtol*||b||/sqrt(nb)`` on the same x
    certifies the merged bound exactly."""
    nb = op.nblocks
    args = getattr(op, "diag_mv_args", None)

    def block_args(k):
        return None if args is None else jax.tree_util.tree_map(
            lambda a: a[k], args
        )

    @jax.jit
    def jacobi_round(x_stack):
        coup = op.coupling_mv(x_stack)
        rhs = b - coup
        def one(k, rhs_b, x_b):
            mv = lambda v: op.single_diag_mv(block_args(k), v)
            res = krylov.gmres(
                mv, rhs_b, x_b,
                restart=inner.restart, maxiter=inner.maxiter,
                rtol=inner.rtol, atol=inner.atol, orthog=inner.orthog,
            )
            return res.x
        return jnp.stack([one(k, rhs[k], x_stack[k]) for k in range(nb)])

    @jax.jit
    def per_block_rnorms(x_stack):
        r = b - op.full_mv(x_stack)
        return jnp.sqrt(jnp.sum(r * r, axis=1))

    for rounds in range(max_rounds + 1):
        pb = np.asarray(per_block_rnorms(x))
        if bool(np.all(pb <= tol_local)):
            return x, True, rounds
        if rounds == max_rounds:
            break
        x = jacobi_round(x)
    return x, False, max_rounds


class _Mailbox:
    """Latest-value-wins slot: publish overwrites, read drains the newest
    (exactly the reference's drain-to-newest receive semantics)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None
        self._version = 0

    def publish(self, value) -> None:
        with self._lock:
            self._value = value
            self._version += 1

    def read(self):
        with self._lock:
            return self._value, self._version


def host_async_solve(
    op: BlockOperator,
    b: jax.Array,
    *,
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    inner: InnerConfig = InnerConfig(),
    minimization: Optional[str] = None,   # None | 'local' | 'semi_local' | 'global'
    s: int = 4,
    outer: OuterConfig = OuterConfig(),
    devices: Optional[list] = None,
    sweep_delay_s: Optional[List[float]] = None,
    join_timeout_s: float = 600.0,
    intra: int = 1,
) -> HostAsyncResult:
    """Solve ``A x = b`` with one independent host thread per block.

    ``sweep_delay_s``: optional per-block artificial delay injected after
    each sweep — the analog of the reference's ``tc``-throttled WAN
    experiments (``running_bulk_test_local:322-330``) for testing
    convergence under heterogeneous block speeds.

    ``intra``: devices per block (the reference's npb ranks per block,
    ``iSolve --npb``).  With ``intra > 1`` each block thread drives a
    ``shard_map``-sharded inner GMRES over its own ``intra``-device
    sub-mesh (psum reductions + ppermute halos inside the block), so the
    genuinely-asynchronous schedule composes with intra-block SPMD
    parallelism.  Needs ``nblocks * intra`` devices; stencil block
    operators; AM only (no minimization).
    """
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    if inner.pc != "none":
        # fail loudly rather than silently dropping the PC (this
        # backend builds its own plain-GMRES sweeps)
        raise ValueError(
            "host_async backend does not implement inner "
            f"preconditioning (got pc={inner.pc!r}); use the stacked "
            "backend for --inner-pc-type"
        )
    nb, bs = op.nblocks, op.block_size
    dtype = b.dtype
    if intra > 1:
        return _host_async_intra_solve(
            op, b, rtol=rtol, atol=atol, maxiter=maxiter,
            min_convergence_count=min_convergence_count, inner=inner,
            minimization=minimization, devices=devices,
            sweep_delay_s=sweep_delay_s, join_timeout_s=join_timeout_s,
            intra=intra,
        )
    if devices is None:
        devs = jax.devices()
        devices = [devs[i % len(devs)] for i in range(nb)]
    if sweep_delay_s is None:
        sweep_delay_s = [0.0] * nb

    rnorm0 = float(jnp.linalg.norm(b.reshape(-1)))
    tol_local = max(rtol / np.sqrt(nb) * rnorm0, atol)

    # per-block jitted kernels ------------------------------------------
    args = getattr(op, "diag_mv_args", None)

    def block_args(k):
        return None if args is None else jax.tree_util.tree_map(
            lambda a: a[k], args
        )

    def make_sweep(k):
        a_k = block_args(k)
        mv = lambda v: op.single_diag_mv(a_k, v)

        @jax.jit
        def sweep(rhs_b, x_b):
            # residual of the *current* iterate against the *fresh* rhs —
            # this is the block's rows of the true global residual given
            # the latest received peer data, and is what the under-
            # threshold test must use (measuring post-solve against the
            # same rhs would always look converged once the inner solver
            # hits its tolerance, regardless of global error)
            r_pre = rhs_b - mv(x_b)
            pre_norm = jnp.sqrt(jnp.sum(r_pre * r_pre))
            res = krylov.gmres(
                mv, rhs_b, x_b,
                restart=inner.restart, maxiter=inner.maxiter,
                rtol=inner.rtol, atol=inner.atol, orthog=inner.orthog,
            )
            return res.x, pre_norm

        @jax.jit
        def minimize_local(S_cols, rhs_b):
            # R = A_ii @ S per column; direct tall-skinny LS (the
            # analog of outer_solver_lsqr on the local basis)
            R = jax.vmap(mv)(S_cols).T          # (bs, s)
            alpha = lstsq_qr(R, rhs_b)
            return jnp.matmul(S_cols.T, alpha, precision="highest")

        @jax.jit
        def gram_contrib(S_full):
            # S_full: (s, nb, bs) full-length snapshots (own x + latest
            # peer x at record time).  This block's rows of R = A S and
            # their Gram contribution — the payload the reference ships
            # in its async dense-R exchange (comm_async_*_min,
            # comm.c:288-351); here the s x s Gram is exchanged instead.
            R_rows = jax.vmap(op.full_mv)(S_full)[:, k, :]   # (s, bs)
            G = jnp.matmul(R_rows, R_rows.T, precision="highest")
            c = jnp.matmul(R_rows, b[k], precision="highest")
            return G, c

        @jax.jit
        def combine(S_own, alpha):
            return jnp.matmul(S_own.T, alpha, precision="highest")

        return sweep, minimize_local, gram_contrib, combine

    kernels = [make_sweep(k) for k in range(nb)]

    # full coupling uses the stacked op on host-merged state -------------
    def local_rhs(k, x_stack):
        coup = op.coupling_mv(x_stack)
        return b[k] - coup[k]

    # shared state -------------------------------------------------------
    mailboxes = [_Mailbox() for _ in range(nb)]   # published block iterates
    gram_boxes = [_Mailbox() for _ in range(nb)]  # published (G, c) panels
    transport = LocalTransport(nb)
    all_ranks = list(range(nb))
    nodes = [
        Alg515Node(r, [x for x in all_ranks if x != r], transport,
                   persistence=min_convergence_count)
        for r in all_ranks
    ]
    x_final = [None] * nb
    sweeps_done = [0] * nb
    zeros = jnp.zeros((bs,), dtype)
    for k in range(nb):
        mailboxes[k].publish(np.zeros((bs,), dtype))

    stop = threading.Event()
    errors: List[BaseException] = []

    def _solve_gram_np(G, c):
        # minimum-norm LS solve: early bases can be rank-deficient (near-
        # parallel iterates, zero peer parts at startup)
        G = np.asarray(G, np.float64)
        c = np.asarray(c, np.float64)
        return np.linalg.lstsq(G, c, rcond=None)[0]

    def block_worker(k: int):
        try:
            sweep, minimize_local, gram_contrib, combine = kernels[k]
            x = zeros
            node = nodes[k]
            peer_versions = {j: 0 for j in all_ranks if j != k}
            S_buf = []
            while node.state is not State.FINISHED and not stop.is_set():
                if sweeps_done[k] >= maxiter:
                    break
                # drain-to-newest: read every peer's latest published value
                stack_np = np.empty((nb, bs), dtype)
                fresh = []
                for j in range(nb):
                    if j == k:
                        stack_np[j] = 0.0
                        continue
                    val, ver = mailboxes[j].read()
                    stack_np[j] = val
                    if ver > peer_versions[j]:
                        fresh.append(j)
                        peer_versions[j] = ver
                x_stack = jnp.asarray(stack_np)
                rhs = local_rhs(k, x_stack)
                x, pre_norm = sweep(rhs, x)
                sweeps_done[k] += 1

                if minimization == "local":
                    S_buf.append(x)
                    if len(S_buf) == s:
                        x = minimize_local(jnp.stack(S_buf), rhs)
                        S_buf = []
                elif minimization in ("semi_local", "global"):
                    # full-length snapshot: own part + latest peer parts
                    snap = stack_np.copy()
                    snap[k] = np.asarray(x)
                    S_buf.append(snap)
                    if len(S_buf) == s:
                        S_full = jnp.asarray(np.stack(S_buf))  # (s, nb, bs)
                        G, c = gram_contrib(S_full)
                        if minimization == "global":
                            # async Gram exchange: publish own panel, use
                            # the newest peer panels available (stale OK —
                            # the reference's comm_async_*_min semantics)
                            gram_boxes[k].publish(
                                (np.asarray(G), np.asarray(c))
                            )
                            Gt = np.asarray(G, np.float64).copy()
                            ct = np.asarray(c, np.float64).copy()
                            for j in all_ranks:
                                if j == k:
                                    continue
                                val, _ = gram_boxes[j].read()
                                if val is not None:
                                    Gt += val[0]
                                    ct += val[1]
                            alpha = _solve_gram_np(Gt, ct)
                        else:
                            alpha = _solve_gram_np(G, c)
                        x = combine(
                            S_full[:, k, :], jnp.asarray(alpha, dtype)
                        )
                        S_buf = []

                mailboxes[k].publish(np.asarray(x))
                under = bool(pre_norm <= tol_local)
                node.step(under_threshold=under, fresh_from=fresh)
                if sweep_delay_s[k]:
                    time.sleep(sweep_delay_s[k])
            # pump remaining protocol traffic so peers can finish
            deadline = time.time() + 5.0
            while node.state is not State.FINISHED and time.time() < deadline:
                if all(
                    nodes[j].state is State.FINISHED or sweeps_done[j] >= maxiter
                    for j in all_ranks
                ):
                    break
                node.pump()
                time.sleep(0.001)
            x_final[k] = x
        except BaseException as e:  # surface worker failures to the caller
            errors.append(e)
            stop.set()

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=block_worker, args=(k,), daemon=True)
        for k in range(nb)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + join_timeout_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    elapsed = time.perf_counter() - t0
    if hung:
        stop.set()
        raise TimeoutError(
            f"host_async block workers {hung} still running after "
            f"join_timeout_s={join_timeout_s}"
        )
    if errors:
        raise errors[0]

    x = jnp.stack([
        x_final[k] if x_final[k] is not None else zeros for k in range(nb)
    ])
    converged = all(n.state is State.FINISHED for n in nodes)
    certified, tail_rounds = False, 0
    if converged:
        x, certified, tail_rounds = _sync_certify(
            op, b, x, tol_local, inner
        )
    r = b - op.full_mv(x)
    rnorm = float(jnp.linalg.norm(r.reshape(-1)))
    return HostAsyncResult(
        x=x, sweeps_per_block=list(sweeps_done), rnorm=rnorm,
        rnorm0=rnorm0, converged=converged, elapsed_s=elapsed,
        certified=certified, tail_rounds=tail_rounds,
    )


def _host_async_intra_solve(
    op, b, *, rtol, atol, maxiter, min_convergence_count, inner,
    minimization, devices, sweep_delay_s, join_timeout_s, intra,
):
    """host_async with ``intra`` devices per block: each block thread
    runs its inner GMRES as a shard_map SPMD collective over a private
    ``('intra',)`` sub-mesh (ppermute halos + psum dots inside the
    block), while blocks stay genuinely asynchronous through mailboxes —
    the execution model of the reference's npb-rank block groups
    (``iSolve --npb``, block sub-communicators ``utils.c:486-541``)."""
    from jax import lax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map  # jax>=0.8 home (was jax.experimental)

    from medane_tchakorom_ufc_thesis_repository_tpu.models.blockops import (
        StackedStencil2D,
        StackedStencil3D,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.parallel.sharded import (
        ShardedPoisson2D,
        ShardedPoisson3D,
    )

    if minimization is not None:
        raise ValueError(
            "intra>1 host_async runs AM (no minimization yet)"
        )
    if isinstance(op, StackedStencil2D):
        opcfg = ShardedPoisson2D(op.rows, op.n, op.diag, op.off)
    elif isinstance(op, StackedStencil3D):
        opcfg = ShardedPoisson3D(op.rows, op.ny, op.nz, op.diag, op.off)
    else:
        raise ValueError(
            "intra>1 host_async needs a stencil block operator"
        )
    nb, bs = op.nblocks, op.block_size
    dtype = b.dtype
    if opcfg.split_extent % intra:
        raise ValueError(
            f"block rows {opcfg.split_extent} not divisible by intra={intra}"
        )
    if devices is None:
        devices = jax.devices()
    if len(devices) < nb * intra:
        raise ValueError(
            f"need {nb * intra} devices for nblocks={nb} x intra={intra}, "
            f"have {len(devices)}"
        )
    if sweep_delay_s is None:
        sweep_delay_s = [0.0] * nb

    rows_b = opcfg.split_extent
    fdim = opcfg.fdim
    rows_loc = rows_b // intra
    lshape = (rows_loc, fdim)
    off = opcfg.off
    up = [(i, i + 1) for i in range(intra - 1)]
    dn = [(i, i - 1) for i in range(1, intra)]

    rnorm0 = float(jnp.linalg.norm(b.reshape(-1)))
    tol_local = max(rtol / np.sqrt(nb) * rnorm0, atol)

    def make_block(k):
        sub = Mesh(
            np.asarray(devices[k * intra:(k + 1) * intra]), ("intra",)
        )
        spec = P("intra", None)
        shd = NamedSharding(sub, spec)

        def diag_mv(g):
            top = lax.ppermute(g[-1, :], "intra", up)
            bot = lax.ppermute(g[0, :], "intra", dn)
            y = opcfg.interior_mv(g)
            y, top, bot = lax.optimization_barrier((y, top, bot))
            y = y.at[0, :].add(off * top)
            y = y.at[-1, :].add(off * bot)
            return y

        def body(rhs_loc, x_loc):
            r_pre = rhs_loc - diag_mv(x_loc)
            pre = jnp.sqrt(lax.psum(jnp.sum(r_pre * r_pre), "intra"))
            res = krylov.gmres(
                lambda v: diag_mv(v.reshape(lshape)).reshape(-1),
                rhs_loc.reshape(-1), x_loc.reshape(-1),
                restart=inner.restart, maxiter=inner.maxiter,
                rtol=inner.rtol, atol=inner.atol, orthog=inner.orthog,
                axis_name="intra",
            )
            return res.x.reshape(lshape), pre

        fn = jax.jit(shard_map(
            body, mesh=sub, in_specs=(spec, spec),
            out_specs=(spec, P()), check_vma=False,
        ))
        return fn, shd

    kernels = [make_block(k) for k in range(nb)]

    def local_rhs(k, x_stack):
        return (b - op.coupling_mv(x_stack))[k]

    mailboxes = [_Mailbox() for _ in range(nb)]
    transport = LocalTransport(nb)
    all_ranks = list(range(nb))
    nodes = [
        Alg515Node(r, [x for x in all_ranks if x != r], transport,
                   persistence=min_convergence_count)
        for r in all_ranks
    ]
    for k in range(nb):
        mailboxes[k].publish(np.zeros((bs,), dtype))
    x_final = [None] * nb
    sweeps_done = [0] * nb
    stop = threading.Event()
    errors: List[BaseException] = []

    def block_worker(k: int):
        try:
            fn, shd = kernels[k]
            x = jax.device_put(jnp.zeros(( rows_b, fdim), dtype), shd)
            node = nodes[k]
            peer_versions = {j: 0 for j in all_ranks if j != k}
            while node.state is not State.FINISHED and not stop.is_set():
                if sweeps_done[k] >= maxiter:
                    break
                stack_np = np.empty((nb, bs), dtype)
                fresh = []
                for j in range(nb):
                    if j == k:
                        stack_np[j] = 0.0
                        continue
                    val, ver = mailboxes[j].read()
                    stack_np[j] = val
                    if ver > peer_versions[j]:
                        fresh.append(j)
                        peer_versions[j] = ver
                rhs = jax.device_put(
                    np.asarray(
                        local_rhs(k, jnp.asarray(stack_np))
                    ).reshape(rows_b, fdim),
                    shd,
                )
                x, pre = fn(rhs, x)
                sweeps_done[k] += 1
                mailboxes[k].publish(np.asarray(x).reshape(bs))
                node.step(
                    under_threshold=bool(float(pre) <= tol_local),
                    fresh_from=fresh,
                )
                if sweep_delay_s[k]:
                    time.sleep(sweep_delay_s[k])
            deadline = time.time() + 5.0
            while node.state is not State.FINISHED and time.time() < deadline:
                if all(
                    nodes[j].state is State.FINISHED
                    or sweeps_done[j] >= maxiter
                    for j in all_ranks
                ):
                    break
                node.pump()
                time.sleep(0.001)
            x_final[k] = np.asarray(x).reshape(bs)
        except BaseException as e:
            errors.append(e)
            stop.set()

    t0 = time.perf_counter()
    threads = [
        threading.Thread(target=block_worker, args=(k,), daemon=True)
        for k in range(nb)
    ]
    for t in threads:
        t.start()
    deadline = time.monotonic() + join_timeout_s
    for t in threads:
        t.join(timeout=max(0.1, deadline - time.monotonic()))
    hung = [i for i, t in enumerate(threads) if t.is_alive()]
    elapsed = time.perf_counter() - t0
    if hung:
        stop.set()
        raise TimeoutError(
            f"host_async intra block workers {hung} still running after "
            f"join_timeout_s={join_timeout_s}"
        )
    if errors:
        raise errors[0]

    x = jnp.asarray(np.stack([
        x_final[k] if x_final[k] is not None else np.zeros((bs,), dtype)
        for k in range(nb)
    ]))
    converged = all(n.state is State.FINISHED for n in nodes)
    certified, tail_rounds = False, 0
    if converged:
        # certification runs single-device per block (no intra mesh
        # needed: any contraction sweep works, only the residual
        # measurement on the identical stack matters)
        x, certified, tail_rounds = _sync_certify(
            op, b, x, tol_local, inner
        )
    r = b - op.full_mv(x)
    rnorm = float(jnp.linalg.norm(r.reshape(-1)))
    return HostAsyncResult(
        x=x, sweeps_per_block=list(sweeps_done), rnorm=rnorm,
        rnorm0=rnorm0, converged=converged, elapsed_s=elapsed,
        certified=certified, tail_rounds=tail_rounds,
    )
