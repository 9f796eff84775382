"""Multi-process asynchronous multisplitting over TCP (AM demo).

The honest completion of the async story: one OS PROCESS per Jacobi
block (the reference runs one MPI rank group per block,
``asynchronous-multisplitting_prime.c``), iterates exchanged through
``TcpTransport`` latest-wins DATA frames (the ``comm_async_probe_and_
receive`` drain-to-newest analog, ``comm.c:6-77``), and termination
decided by the decentralized Alg-5.15 protocol (``models.convergence``)
over the SAME sockets — no shared memory, no collective, genuinely
nondeterministic interleavings across process boundaries.

Soundness (same invariants as ``models.host_async`` — do not simplify):

* the under-threshold test measures the residual of the CURRENT iterate
  against the FRESHLY-received RHS (pre-sweep), never post-solve against
  the RHS the inner solver just satisfied;
* ``local_cv`` requires persistence across pseudo-period-complete
  windows (every peer published), enforced inside ``Alg515Node``.

Run one rank: ``python -m ...models.net_async --rank 0 --ports p0,p1 ...``
or fan out locally with ``launch_net_async(...)`` (used by the tests and
the ``--net-async`` CLI demo path).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence

import numpy as np


_TAIL_BASE = 1_000_000_000  # round tag offset: never collides with sweep
                            # numbers (maxiter << 1e9, int32-safe on the
                            # native router's packed headers)


def _certification_tail(transport, rank, peers, x, tol_local, *,
                        sweep, local_rhs, stack_np, np_dtype,
                        max_rounds, deadline_s, frame_len=None):
    """Post-verdict LOCKSTEP certification of the returned iterate.

    Why this exists: Alg-5.15 certifies each block under threshold
    against *stale-but-fresh* peer data, and blocks keep sweeping while
    the verification round is in flight — so the block that terminates
    last may have moved by up to ``||A_ii^-1||*tol`` after its peers
    validated against it, inflating the MERGED final residual by
    ``~1 + ||A_ic||*||A_ii^-1||`` (observed 25x rtol on loaded hosts).
    The reference accepts that slack (its drivers print the final norm
    but never re-verify it, ``asynchronous-multisplitting_prime.c:345``);
    here a short synchronous tail closes it, replaying the sync
    handshake (``comm_sync_convergence_detection``, ``comm.c:235-250``)
    over TCP after the async phase has done all the real work.

    Protocol per round r: publish the local iterate tagged ``BASE+r``
    (sign carries the round-(r-1) under-threshold bit), collect every
    peer's round-r frame, ack it (TAIL_ACK — a publisher may only move
    to r+1 once everyone read r, so latest-wins mailboxes can never skip
    a round), then evaluate the local residual on the now-IDENTICAL
    global iterate.  All blocks under threshold on the same stack
    certifies ``||b - A x|| <= rtol*||b||`` for the returned x exactly
    (sum of nb per-block bounds of ``rtol*||b||/sqrt(nb)``).  Every rank
    sees the same ok-bits, so all stop at the same round.  Timeouts or
    skipped rounds bail out uncertified with the protocol-terminated
    iterate (today's behavior).
    """
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.models.convergence import (
        Msg,
        MsgKind,
    )

    bs = stack_np.shape[1]
    # minimization runs pad every DATA frame to a fixed length (panel
    # piggyback) — tail frames must match so latest-wins mailbox reads
    # stay shape-consistent across the async/tail boundary
    L = bs if frame_len is None else int(frame_len)
    # progress-based deadline: a WAN-emulated link (models.net.WanConfig)
    # makes each lockstep round cost 2+ RTT, so a FIXED budget starves
    # the tail exactly when it matters (100 ms links: round ≈ 0.4 s).
    # As long as rounds complete, the deadline extends; only a STALLED
    # round (peer died / never entered the tail) bails out.
    deadline = time.monotonic() + deadline_s
    cur = np.asarray(x)
    prev_stack = None
    my_ok_prev = False
    acks_seen: set = set()        # (src, round) TAIL_ACKs collected
    rounds_done = 0

    def publish(r: int, ok: bool, arr: np.ndarray) -> None:
        tag = _TAIL_BASE + r
        if L != arr.shape[0]:
            arr = np.concatenate([arr, np.zeros((L - bs,), arr.dtype)])
        for j in peers:
            transport.send_data(j, tag if ok else -tag, arr)

    def pump_acks() -> None:
        for m in transport.drain(rank):
            if m.kind is MsgKind.TAIL_ACK:
                acks_seen.add((m.src, m.phase_tag))

    def wait_frames(r: int):
        """Every peer's round-r frame, or None on timeout/skip."""
        got: dict = {}
        while time.monotonic() < deadline:
            for j in peers:
                if j in got:
                    continue
                arr, it, _ver = transport.read_data_tagged(
                    j, np_dtype, (L,))
                if arr is None or abs(it) < _TAIL_BASE:
                    continue   # pre-tail publish still in the mailbox
                rj = abs(it) - _TAIL_BASE
                if rj > r:
                    return None   # skipped a round: ack protocol broken
                if rj == r:
                    got[j] = (arr[:bs], it > 0)
            if len(got) == len(peers):
                return got
            pump_acks()
            time.sleep(0.0005)
        return None

    def wait_acks(r: int) -> bool:
        while time.monotonic() < deadline:
            pump_acks()
            if all((j, r) in acks_seen for j in peers):
                return True
            time.sleep(0.0005)
        return False

    try:
        publish(0, True, cur)
        for r in range(max_rounds):
            round_start = time.monotonic()
            frames = wait_frames(r)
            if frames is None:
                return x, False, rounds_done
            for j in peers:
                transport.send(j, Msg(
                    kind=MsgKind.TAIL_ACK, src=rank, phase_tag=r,
                    iteration=0, positive=True,
                ))
            if not wait_acks(r):
                return x, False, rounds_done
            # round completed: extend the stall deadline (see above)
            deadline = time.monotonic() + max(
                deadline_s, 8.0 * (time.monotonic() - round_start))
            stack = stack_np.copy()
            stack[rank] = cur
            for j, (arr, _okj) in frames.items():
                stack[j] = arr
            if r >= 1 and my_ok_prev and all(
                ok for _, ok in frames.values()
            ):
                # stack_{r-1} is certified: every block measured its
                # residual under tol_local on that identical iterate
                return jnp.asarray(prev_stack[rank]), True, rounds_done
            rhs = local_rhs(jnp.asarray(stack))
            x_next, pre = sweep(rhs, jnp.asarray(stack[rank]))
            my_ok_prev = bool(float(pre) <= tol_local)
            prev_stack = stack
            cur = np.asarray(x_next)
            publish(r + 1, my_ok_prev, cur)
            rounds_done = r + 1
    except OSError:
        return x, False, rounds_done
    return x, False, rounds_done


def net_async_block_solve(
    op,
    b,
    rank: int,
    transport,
    *,
    rtol: float = 1e-3,
    atol: float = 1e-100,
    maxiter: int = 10000,
    min_convergence_count: int = 4,
    inner=None,
    drain_deadline_s: float = 10.0,
    termination: str = "protocol",
    minimization: Optional[str] = None,
    s: int = 4,
    schedule: str = "async",
    sync_deadline_s: float = 600.0,
):
    """Run THIS process's block of the AM/AMAM iteration to termination.

    ``minimization``: None (plain AM) | 'local' | 'semi_local' |
    'global' — the asynchronous s-step minimization scopes
    (``AMAM_{LOCAL,SEMI_LOCAL,GLOBAL}``) over OS processes, mirroring
    ``models.host_async``'s thread implementation on the TCP wire.
    'local' minimizes over the block's own s-column basis (no extra
    traffic); 'semi_local' uses full-length snapshots but only the own
    Gram panel; 'global' sums every block's ``(s, s)`` Gram panel — the
    panels PIGGYBACK on the existing latest-wins DATA frames
    (``[x | G | c | panel_ver]``), so the wire format and the native
    router are untouched (the reference ships dense R columns instead,
    ``comm_async_*_min``, ``comm.c:288-351``).

    ``op`` is the full stacked operator (cheap, matrix-free — every
    process builds the same description); only block ``rank``'s rows are
    iterated here.  Returns a dict with the block iterate and counters.

    ``termination``:

    * ``'protocol'`` — decentralized Alg-5.15 verification over the wire
      (default; supersedes the legacy guard).
    * ``'traversal'`` — the legacy pre-protocol guard
      (``asynchronous-multisplitting.c.save:307-329``): after the local
      residual holds under threshold for ``min_convergence_count``
      sweeps, the block goes quiet for ``2 x`` the measured wire
      traversal time (startup ping-pong, ``comm.c:390-424`` →
      ``TcpTransport.rtt``); any fresh peer data that pushes the
      residual back over threshold resumes iterating, a quiet window
      with none terminates.  Heuristic — can mis-terminate under
      pathological delay, which is exactly why the reference replaced
      it with Alg-5.15; kept for capability parity.
    * ``'slcv'`` — the reference's FIRST protocol, the SLCV counter
      machine (``conv_detection.c:6-196``): consecutive-under-threshold
      counters (``sLocalCV``), spanning-tree ``sPartialCV``/``CancelCV``
      with per-neighbor iteration filtering, ``globalCV`` gossip, and
      the hold-longer-than-traversal termination guard
      (``models.convergence.SlcvNode``).  Like 'traversal' it carries
      no certificate and can mis-terminate under pathological delay —
      the historical reason for Alg-5.15.

    ``schedule``: ``'async'`` (default — the AM/AMAM behavior above) or
    ``'sync'`` — BULK-SYNCHRONOUS rounds over the same sockets: every
    sweep publishes the iterate, waits for ALL peers' same-round frames
    (acked, so latest-wins mailboxes can never skip a round — the
    ``MPI_Sendrecv`` barrier of ``comm_sync_send_and_receive``,
    ``comm.c:126-141``), and terminates on the all-blocks-under-
    threshold handshake (``comm_sync_convergence_detection``,
    ``comm.c:235-250``).  This is SM / SMSM_* over TCP — the sync
    baseline of the reference's async-vs-sync WAN study.  With
    ``minimization``, every ``s`` rounds the basis of (identical
    lockstep) global iterates is minimized LOCALLY on each rank — no
    R exchange needed because each process holds the full operator
    description, deterministic because the stacks are identical.
    Result is certified by construction (the identical-stack residual
    handshake IS the certificate).
    """
    if termination not in ("protocol", "traversal", "slcv"):
        raise ValueError(f"unknown termination {termination!r}")
    if schedule not in ("async", "sync"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if minimization not in (None, "local", "semi_local", "global"):
        raise ValueError(f"unknown minimization {minimization!r}")
    if (minimization is not None and termination != "protocol"
            and schedule == "async"):
        raise ValueError(
            "minimization runs under termination='protocol' (the legacy "
            "guards predate the reference's AMAM drivers)"
        )
    if minimization is not None and s < 1:
        # s <= 0 would make the cycle boundary unreachable: S_buf grows
        # one full snapshot per sweep and minimization never fires
        raise ValueError(f"minimization needs s >= 1, got {s}")
    import jax
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.models.convergence import (
        Alg515Node,
        State,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
        InnerConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import krylov

    inner = inner or InnerConfig()
    nb, bs = op.nblocks, op.block_size
    dtype = b.dtype
    np_dtype = np.dtype(jnp.zeros((), dtype).dtype.name)
    peers = [j for j in range(nb) if j != rank]
    node = Alg515Node(rank, peers, transport,
                      persistence=min_convergence_count)

    rnorm0 = float(jnp.linalg.norm(b.reshape(-1)))
    tol_local = max(rtol / np.sqrt(nb) * rnorm0, atol)

    args = getattr(op, "diag_mv_args", None)
    a_k = None if args is None else jax.tree_util.tree_map(
        lambda a: a[rank], args
    )
    mv = lambda v: op.single_diag_mv(a_k, v)

    @jax.jit
    def sweep(rhs_b, x_b):
        # pre-sweep residual vs the fresh RHS (soundness invariant)
        r_pre = rhs_b - mv(x_b)
        pre_norm = jnp.sqrt(jnp.sum(r_pre * r_pre))
        res = krylov.gmres(
            mv, rhs_b, x_b,
            restart=inner.restart, maxiter=inner.maxiter,
            rtol=inner.rtol, atol=inner.atol, orthog=inner.orthog,
        )
        return res.x, pre_norm

    @jax.jit
    def local_rhs(x_stack):
        return (b - op.coupling_mv(x_stack))[rank]

    # --- async s-step minimization kernels (host_async twins) ----------
    @jax.jit
    def minimize_local(S_cols, rhs_b):
        # R = A_ii @ S per column; direct tall-skinny LS
        R = jax.vmap(mv)(S_cols).T          # (bs, s)
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.lstsq import (
            lstsq_qr,
        )

        alpha = lstsq_qr(R, rhs_b)
        return jnp.matmul(S_cols.T, alpha, precision="highest")

    @jax.jit
    def gram_contrib(S_full):
        # this block's rows of R = A S and their (s, s) Gram panel —
        # the s x s exchange that replaces the reference's dense-R
        # shipping (comm_async_*_min, comm.c:288-351)
        R_rows = jax.vmap(op.full_mv)(S_full)[:, rank, :]   # (s, bs)
        G = jnp.matmul(R_rows, R_rows.T, precision="highest")
        c = jnp.matmul(R_rows, b[rank], precision="highest")
        return G, c

    @jax.jit
    def combine(S_own, alpha):
        return jnp.matmul(S_own.T, alpha, precision="highest")

    def _solve_gram_np(G, c):
        # minimum-norm LS: early bases can be rank-deficient
        return np.linalg.lstsq(np.asarray(G, np.float64),
                               np.asarray(c, np.float64), rcond=None)[0]

    # --- bulk-synchronous schedule (SM / SMSM_* over TCP) ---------------
    if schedule == "sync":
        t0 = time.perf_counter()
        stack_np = np.zeros((nb, bs), np_dtype)
        S_stacks: list = []

        @jax.jit
        def sync_gram(S_full):
            # rows of R = A S for every block — computable locally
            # because every process holds the full operator description;
            # with identical lockstep stacks, all ranks derive the SAME
            # alpha (the reference exchanges R halves instead because an
            # MPI rank only holds its own rows, comm.c:252-286)
            R = jax.vmap(op.full_mv)(S_full)          # (s, nb, bs)
            if minimization == "global":
                Rr = R.reshape(S_full.shape[0], -1)
                target = b.reshape(-1)
            else:                                     # semi_local
                Rr = R[:, rank, :]
                target = b[rank]
            return (jnp.matmul(Rr, Rr.T, precision="highest"),
                    jnp.matmul(Rr, target, precision="highest"))

        def rec_local_rhs(x_stack):
            if minimization is not None:
                S_stacks.append(np.asarray(x_stack))
            return local_rhs(x_stack)

        def sync_sweep(rhs_b, x_b):
            x_next, pre = sweep(rhs_b, x_b)
            if minimization is not None and len(S_stacks) == s:
                S_full = jnp.asarray(np.stack(S_stacks))   # (s, nb, bs)
                if minimization == "local":
                    x_next = minimize_local(S_full[:, rank, :], rhs_b)
                else:
                    G, c = sync_gram(S_full)
                    alpha = _solve_gram_np(G, c)
                    x_next = combine(
                        S_full[:, rank, :], jnp.asarray(alpha, dtype))
                S_stacks.clear()
            return x_next, pre

        x0 = jnp.zeros((bs,), dtype)
        xs, certified, rounds = _certification_tail(
            transport, rank, peers, x0, tol_local,
            sweep=sync_sweep, local_rhs=rec_local_rhs,
            stack_np=stack_np, np_dtype=np_dtype,
            max_rounds=maxiter, deadline_s=sync_deadline_s,
            frame_len=bs,
        )
        return {
            "rank": rank,
            "x_block": np.asarray(xs).tolist(),
            "sweeps": rounds,
            "converged": bool(certified),
            "phase_tag": 0,
            "certified": bool(certified),
            # sync rounds ARE the solve; the post-verdict tail concept
            # does not apply (0 keeps study tables from double-counting)
            "tail_rounds": 0,
            "rnorm0": rnorm0,
            "peer_last_versions": {str(j): rounds for j in peers},
            "elapsed_s": round(time.perf_counter() - t0, 3),
        }

    # frame layout: plain (bs,) except 'global', which piggybacks the
    # Gram panel on every DATA frame: [x | G.ravel | c | panel_ver]
    panel_tail = (s * s + s + 1) if minimization == "global" else 0
    frame_len = bs + panel_tail

    def pack_frame(xb):
        if panel_tail == 0:
            return xb
        out = np.empty((frame_len,), np_dtype)
        out[:bs] = xb
        out[bs:bs + s * s] = own_panel[0].ravel()
        out[bs + s * s:bs + s * s + s] = own_panel[1]
        out[-1] = own_panel[2]
        return out

    x = jnp.zeros((bs,), dtype)
    stack_np = np.zeros((nb, bs), np_dtype)
    peer_versions = {j: 0 for j in peers}
    # 'global' panel state: own (G, c, ver) and newest peer panels
    own_panel = (np.zeros((s, s), np.float64), np.zeros((s,), np.float64),
                 0.0)
    peer_panels = {j: None for j in peers}   # j -> (G, c, ver)
    sweeps = 0
    t0 = time.perf_counter()

    def drain_peers():
        fresh = []
        for j in peers:
            arr, ver = transport.read_data(j, np_dtype, (frame_len,))
            if arr is not None:
                stack_np[j] = arr[:bs]
                if panel_tail:
                    pv = float(arr[-1])
                    prev = peer_panels[j]
                    if pv > 0 and (prev is None or pv > prev[2]):
                        peer_panels[j] = (
                            np.asarray(arr[bs:bs + s * s], np.float64)
                              .reshape(s, s),
                            np.asarray(
                                arr[bs + s * s:bs + s * s + s], np.float64,
                            ),
                            pv,
                        )
                if ver > peer_versions[j]:
                    fresh.append(j)
                    peer_versions[j] = ver
        return fresh

    if termination == "traversal":
        # startup ping-pong: 2x the max measured wire traversal is the
        # legacy guard's quiet window (comm.c:390-424).  A message can
        # only arrive as fast as the peer COMPUTES it, so the effective
        # window also tracks the observed inter-publish gap (EMA) — a
        # loaded peer whose sweeps take 100 ms must get a >200 ms window
        # or the guard falsely concludes quiescence.
        rtt_guard = max(0.05, 2.0 * max(transport.rtt(j) for j in peers))
        gap_ema = 0.0
        last_arrival = time.monotonic()
        under_count = 0
        converged = False
        # pseudo-period gate (soundness invariant shared with every
        # async path): the persistence counter only advances on windows
        # in which EVERY peer published fresh data — without it a block
        # "converges" on its decoupled system before any peer iterate
        # arrives (false convergence)
        seen: set = set()
        ever: set = set()   # peers that have published at least once
        while sweeps < maxiter and not converged:
            fresh_now = drain_peers()
            if fresh_now:
                now = time.monotonic()
                gap_ema = 0.7 * gap_ema + 0.3 * (now - last_arrival)
                last_arrival = now
            seen |= set(fresh_now)
            ever |= set(fresh_now)
            rhs = local_rhs(jnp.asarray(stack_np))
            x, pre_norm = sweep(rhs, x)
            sweeps += 1
            xb = np.asarray(x)
            for j in peers:
                transport.send_data(j, sweeps, xb)
            if float(pre_norm) > tol_local:
                under_count = 0
            elif seen == set(peers):
                under_count += 1
                seen = set()
            # liveness release: a peer that terminated via its own quiet
            # window stops publishing, so the pseudo-period gate above
            # can never fill again and this rank would sweep to maxiter.
            # If EVERY peer has published at least once (coupling is
            # incorporated), the residual vs the freshly-exchanged RHS
            # is under threshold, and the wire has been quiet past the
            # guard window, enter the quiet-window verification directly
            # — the reference guard's own semantics (.c.save:307-329).
            quiet_release = (
                ever == set(peers)
                and float(pre_norm) <= tol_local
                and time.monotonic() - last_arrival
                    > max(rtt_guard, 4.0 * gap_ema)
            )
            if under_count >= min_convergence_count or quiet_release:
                # quiet period: stop sweeping; resume if fresh data
                # pushes the residual back over threshold
                guard_s = max(rtt_guard, 4.0 * gap_ema)
                qdeadline = time.monotonic() + guard_s
                resumed = False
                while time.monotonic() < qdeadline:
                    if drain_peers():
                        rhs = local_rhs(jnp.asarray(stack_np))
                        pre = float(jnp.linalg.norm(rhs - mv(x)))
                        if pre > tol_local:
                            resumed = True
                            break
                    time.sleep(0.005)
                if not resumed:
                    converged = True
                else:
                    under_count = 0
        final_state = converged
        phase_tag = 0
        certified, tail_rounds = None, 0   # legacy guard: no certificate
    elif termination == "slcv":
        # the reference's FIRST termination protocol
        # (conv_detection.c:6-196): sLocalCV counters + spanning-tree
        # sPartialCV/CancelCV + globalCV gossip + the
        # hold-longer-than-traversal guard
        # (asynchronous-multisplitting.c.save:307-329)
        from medane_tchakorom_ufc_thesis_repository_tpu.models.convergence import (  # noqa: E501
            SlcvNode,
        )

        snode = SlcvNode(rank, nb, transport,
                         threshold_slcv=min_convergence_count)
        max_traversal = max(0.05, max(transport.rtt(j) for j in peers))
        ever: set = set()   # peers that have published at least once —
        # the minimal soundness gate the legacy protocol lacks: without
        # it a block "converges" its decoupled system before any peer
        # iterate arrives (the repo-wide false-convergence invariant)
        done = False
        while sweeps < maxiter and not done:
            ever |= set(drain_peers())
            rhs = local_rhs(jnp.asarray(stack_np))
            x, pre_norm = sweep(rhs, x)
            sweeps += 1
            xb = np.asarray(x)
            for j in peers:
                transport.send_data(j, sweeps, xb)
            snode.step(
                under_threshold=(float(pre_norm) <= tol_local
                                 and ever == set(peers)))
            # keep iterating while globalCV holds (the guard): any
            # retraction gossip clears it and the hold restarts
            if snode.global_cv and snode.held_for() > 2.0 * max_traversal:
                done = True
        # linger to serve the tree: a non-root that terminates first
        # must keep forwarding gossip until peers observe their hold
        linger = time.monotonic() + 2.0 * max_traversal + 0.5
        while time.monotonic() < linger:
            snode.pump()
            time.sleep(0.005)
        final_state = done
        phase_tag = 0
        certified, tail_rounds = None, 0   # legacy protocol: no certificate
    else:
        S_buf: list = []
        while node.state is not State.FINISHED and sweeps < maxiter:
            fresh = drain_peers()
            rhs = local_rhs(jnp.asarray(stack_np))
            x, pre_norm = sweep(rhs, x)
            sweeps += 1

            if minimization == "local":
                S_buf.append(x)
                if len(S_buf) == s:
                    x = minimize_local(jnp.stack(S_buf), rhs)
                    S_buf = []
            elif minimization in ("semi_local", "global"):
                # full-length snapshot: own part + latest peer parts
                snap = stack_np.copy()
                snap[rank] = np.asarray(x)
                S_buf.append(snap)
                if len(S_buf) == s:
                    S_full = jnp.asarray(np.stack(S_buf))   # (s, nb, bs)
                    G, c = gram_contrib(S_full)
                    if minimization == "global":
                        own_panel = (np.asarray(G, np.float64),
                                     np.asarray(c, np.float64),
                                     own_panel[2] + 1.0)
                        Gt = own_panel[0].copy()
                        ct = own_panel[1].copy()
                        # newest peer panels, stale OK (the reference's
                        # comm_async_*_min drain-newest semantics)
                        for j in peers:
                            pp = peer_panels[j]
                            if pp is not None:
                                Gt += pp[0]
                                ct += pp[1]
                        alpha = _solve_gram_np(Gt, ct)
                    else:
                        alpha = _solve_gram_np(G, c)
                    x = combine(
                        S_full[:, rank, :], jnp.asarray(alpha, dtype)
                    )
                    S_buf = []

            xb = pack_frame(np.asarray(x))
            for j in peers:
                transport.send_data(j, sweeps, xb)
            node.step(
                under_threshold=bool(float(pre_norm) <= tol_local),
                fresh_from=fresh,
            )

        # pump remaining protocol traffic (a peer may still be verifying)
        deadline = time.monotonic() + drain_deadline_s
        while (node.state is not State.FINISHED
               and time.monotonic() < deadline):
            node.pump()
            time.sleep(0.002)
        final_state = node.state is State.FINISHED
        phase_tag = node.phase_tag

        certified, tail_rounds = False, 0
        if final_state:
            x, certified, tail_rounds = _certification_tail(
                transport, rank, peers, x, tol_local,
                sweep=sweep, local_rhs=local_rhs,
                stack_np=stack_np, np_dtype=np_dtype,
                max_rounds=maxiter, deadline_s=drain_deadline_s,
                frame_len=frame_len,
            )

    return {
        "rank": rank,
        "x_block": np.asarray(x).tolist(),
        "sweeps": sweeps,
        "converged": final_state,
        "phase_tag": phase_tag,
        # lockstep-tail certificate: True means the RETURNED stack's
        # merged residual is <= rtol*||b|| exactly (None: legacy guard)
        "certified": certified,
        "tail_rounds": tail_rounds,
        "rnorm0": rnorm0,
        # message-freshness view: newest sweep number received from each
        # peer (the reference's VecView of LastIteration_global,
        # asynchronous-multisplitting_prime.c:427)
        "peer_last_versions": {str(j): peer_versions[j] for j in peers},
        "elapsed_s": round(time.perf_counter() - t0, 3),
    }


# ---------------------------------------------------------------------------
# Worker entrypoint + local fan-out
# ---------------------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="net_async",
        description="One OS-process Jacobi block of TCP-async AM",
    )
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--ports", required=True,
                   help="comma-separated localhost ports, one per block")
    p.add_argument("--m", type=int, default=32)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--rtol", type=float, default=1e-4)
    p.add_argument("--maxiter", type=int, default=4000)
    p.add_argument("--min-convergence-count", type=int, default=4)
    p.add_argument("--inner-maxiter", type=int, default=20)
    p.add_argument("--termination", default="protocol",
                   choices=["protocol", "traversal", "slcv"])
    p.add_argument("--schedule", default="async",
                   choices=["async", "sync"],
                   help="async (AM/AMAM) or bulk-synchronous lockstep "
                        "rounds (SM/SMSM over TCP)")
    p.add_argument("--wan-latency-ms", type=float, default=0.0,
                   help="emulated one-way link latency (tc qdisc analog)")
    p.add_argument("--wan-jitter-ms", type=float, default=0.0)
    p.add_argument("--wan-drop", type=float, default=0.0,
                   help="DATA-frame drop probability in [0,1)")
    p.add_argument("--wan-bw-mbit", type=float, default=0.0,
                   help="emulated link bandwidth in Mbit/s (0=unlimited)")
    p.add_argument("--minimization", default="none",
                   choices=["none", "local", "semi_local", "global"],
                   help="async s-step minimization scope (AMAM_* parity)")
    p.add_argument("--s", type=int, default=4, help="basis depth")
    p.add_argument("--transport", default="auto",
                   choices=["auto", "python", "native"],
                   help="TCP router backend: C++ epoll (native) or "
                        "thread-per-connection (python); same wire format")
    p.add_argument("--dtype", default="float64")
    return p


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops
    from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
        InnerConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.models.net import (
        WanConfig,
        make_tcp_transport,
    )

    ports = [int(x) for x in args.ports.split(",")]
    addrs = [("localhost", pt) for pt in ports]
    op = blockops.block_poisson2d(args.m, args.n, nblocks=len(ports))
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    b = blockops.rhs_ones(op, dtype)

    wan = WanConfig(
        latency_s=args.wan_latency_ms * 1e-3,
        jitter_s=args.wan_jitter_ms * 1e-3,
        drop=args.wan_drop,
        bandwidth_bps=args.wan_bw_mbit * 1e6,
        seed=args.rank + 1,
    )
    transport = make_tcp_transport(args.rank, addrs,
                                   backend=args.transport,
                                   wan=wan if wan.active else None)
    try:
        out = net_async_block_solve(
            op, b, args.rank, transport,
            rtol=args.rtol, maxiter=args.maxiter,
            min_convergence_count=args.min_convergence_count,
            inner=InnerConfig(maxiter=args.inner_maxiter),
            termination=args.termination,
            minimization=(None if args.minimization == "none"
                          else args.minimization),
            s=args.s,
            schedule=args.schedule,
        )
    finally:
        # linger so late protocol frames from peers don't hit a dead port
        time.sleep(0.2)
        transport.close()
    print(json.dumps(out), flush=True)
    return 0


def launch_net_async(
    *,
    nblocks: int = 2,
    m: int = 32,
    n: int = 32,
    rtol: float = 1e-4,
    maxiter: int = 4000,
    min_convergence_count: int = 4,
    inner_maxiter: int = 20,
    dtype: str = "float64",
    termination: str = "protocol",
    transport: str = "auto",
    timeout_s: float = 300.0,
    minimization: Optional[str] = None,
    s: int = 4,
    schedule: str = "async",
    wan_latency_ms: float = 0.0,
    wan_jitter_ms: float = 0.0,
    wan_drop: float = 0.0,
    wan_bw_mbit: float = 0.0,
) -> List[dict]:
    """Local fan-out: one OS process per block (the mpiexec analog for
    the TCP-async path).  Returns each rank's parsed JSON result."""
    from medane_tchakorom_ufc_thesis_repository_tpu.utils.multihost import (
        free_port,
        run_ranks,
        cpu_worker_env,
    )

    env = cpu_worker_env(1)

    def attempt():
        ports = [free_port() for _ in range(nblocks)]
        cmds = [
            [
                sys.executable, "-m",
                "medane_tchakorom_ufc_thesis_repository_tpu.models.net_async",
                "--rank", str(rank),
                "--ports", ",".join(map(str, ports)),
                "--m", str(m), "--n", str(n), "--rtol", str(rtol),
                "--maxiter", str(maxiter),
                "--min-convergence-count", str(min_convergence_count),
                "--inner-maxiter", str(inner_maxiter), "--dtype", dtype,
                "--termination", termination,
                "--transport", transport,
                "--minimization", minimization or "none",
                "--s", str(s),
                "--schedule", schedule,
                "--wan-latency-ms", str(wan_latency_ms),
                "--wan-jitter-ms", str(wan_jitter_ms),
                "--wan-drop", str(wan_drop),
                "--wan-bw-mbit", str(wan_bw_mbit),
            ]
            for rank in range(nblocks)
        ]
        return run_ranks(cmds, env, timeout_s=timeout_s, label="net_async")

    try:
        return attempt()
    except RuntimeError as e:
        # free_port() races under parallel launchers: a probed port can
        # be re-bound by another process before a rank's listener comes
        # up, surfacing as a bind failure in that rank or as a
        # stolen-port send failure on the native router.  Match ONLY
        # those race symptoms — 'could not reach rank' also fires when a
        # peer dies at startup for a deterministic reason (bad flag,
        # import error), and retrying would double the failure latency
        # and mask the real traceback.
        from medane_tchakorom_ufc_thesis_repository_tpu.models.net import (
            BIND_RACE_MARKER,
            STOLEN_PORT_MARKER,
        )

        msg = str(e).lower()
        if BIND_RACE_MARKER in msg or STOLEN_PORT_MARKER in msg:
            return attempt()
        raise


if __name__ == "__main__":
    sys.exit(worker_main())
