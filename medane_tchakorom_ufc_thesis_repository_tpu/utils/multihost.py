"""Multi-process (multi-host) execution.

The analog of the reference's ``mpiexec`` fan-out: ``iSolve`` assembles a
``petscmpiexec -n $np`` command over a hostfile and every rank runs the
same binary (reference ``iSolve:347-401``, ``hostfiles/default:1-2``).
Here the same structure is:

* ``launch(...)``          — parent-side fan-out: spawn N OS processes of
  ``python -m ...utils.multihost`` with a shared coordinator address
  (the mpiexec analog; on a real cluster each host runs the worker
  command itself with its own ``--process-id``).
* ``worker_main(argv)``    — one rank: ``jax.distributed.initialize``,
  build the global ``('block', 'intra')`` mesh over ALL processes'
  devices (``make_multihost_mesh``), run the requested algorithm through
  the standard sharded entry points, print ONE JSON result line.

Every collective inside the solve (intra-block psum, cross-block
ppermute halos, global Gram psum) then really crosses the process
boundary (on CPU via Gloo).

CPU testing (the analog of the reference's 4-rank localhost MPI tests,
``makefile:185-188``): each process gets
``--xla_force_host_platform_device_count=K`` virtual devices, so
2 processes x 4 devices exercises the same 8-device mesh as the
single-process test suite, now with real inter-process transport.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def cpu_worker_env(devices_per_process: int) -> dict:
    """Environment for a CPU worker process: force the CPU platform with
    K virtual devices, so no worker opens an accelerator that its parent
    or a sibling may hold."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    flags = " ".join(
        f for f in flags.split()
        if "xla_force_host_platform_device_count" not in f
    )
    env["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={devices_per_process}"
    ).strip()
    return env


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_ranks(cmds: Sequence[Sequence[str]], env: dict, *,
              timeout_s: float, label: str) -> List[dict]:
    """Spawn one subprocess per command, collect all under a SHARED
    deadline (kill + mark on expiry), raise ``RuntimeError`` with the
    combined output if any rank fails (the analog of mpiexec's
    nonzero exit on any-rank failure), and parse each rank's last JSON
    stdout line.  Shared by the jax.distributed fan-out here and the
    TCP-async fan-out (``models.net_async.launch_net_async``)."""
    procs = [
        subprocess.Popen(
            list(cmd), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=repo_root(),
        )
        for cmd in cmds
    ]
    outs, rcs = [], []
    deadline = time.monotonic() + timeout_s
    for p in procs:
        left = max(1.0, deadline - time.monotonic())
        try:
            out, _ = p.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += "\n[parent] TIMEOUT"
        outs.append(out)
        rcs.append(p.returncode)
    if any(rc != 0 for rc in rcs):
        blob = "\n".join(
            f"--- rank {i} rc={rc}\n{o}"
            for i, (rc, o) in enumerate(zip(rcs, outs))
        )
        raise RuntimeError(f"{label} launch failed:\n{blob}")
    results = []
    for i, out in enumerate(outs):
        line = [l for l in out.splitlines() if l.startswith("{")]
        if not line:
            raise RuntimeError(f"rank {i} produced no JSON:\n{out}")
        results.append(json.loads(line[-1]))
    return results


def launch(
    worker_args: Sequence[str],
    *,
    num_processes: int = 2,
    devices_per_process: int = 4,
    timeout_s: float = 600.0,
    port: Optional[int] = None,
) -> List[dict]:
    """Spawn ``num_processes`` CPU workers running ``worker_main`` with
    the given solve flags; return each worker's parsed JSON result."""
    env = cpu_worker_env(devices_per_process)

    def attempt(p):
        cmds = [
            [
                sys.executable, "-m",
                "medane_tchakorom_ufc_thesis_repository_tpu.utils.multihost",
                "--coordinator", f"localhost:{p}",
                "--num-processes", str(num_processes),
                "--process-id", str(pid),
                *worker_args,
            ]
            for pid in range(num_processes)
        ]
        return run_ranks(cmds, env, timeout_s=timeout_s, label="multihost")

    try:
        return attempt(port or free_port())
    except RuntimeError as e:
        # free_port() is inherently racy under parallel launchers (xdist
        # workers, concurrent fan-outs): another process can bind the
        # probed port before the coordinator does.  One retry on a fresh
        # port covers the race without masking real failures.
        if port is None and "in use" in str(e).lower():
            return attempt(free_port())
        raise


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="multihost",
        description="One rank of a multi-process multisplitting solve",
    )
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--alg", default="SMSM_GLOBAL")
    p.add_argument("--dim", type=int, default=2)
    p.add_argument("--m", type=int, default=32)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--nz", type=int, default=16)
    p.add_argument("--nblocks", type=int, default=2)
    p.add_argument("--s", type=int, default=4)
    p.add_argument("--rtol", type=float, default=1e-4)
    p.add_argument("--maxiter", type=int, default=2000)
    p.add_argument("--staleness", type=int, default=2)
    # None = "not set on the command line": the multisplitting inner
    # solve and the MGPCG preconditioner have different natural defaults
    # (8/1e-6 vs 40/1e-5), so each path resolves None to its own.
    p.add_argument("--inner-maxiter", type=int, default=None)
    p.add_argument("--inner-restart", type=int, default=8)
    p.add_argument("--inner-rtol", type=float, default=None)
    p.add_argument("--inner-ksp", default="gmres")
    p.add_argument("--inner-pc-type", default="none", dest="inner_pc")
    p.add_argument("--basis-collection", default="sweep",
                   dest="basis_collection")
    p.add_argument("--outer-method", default="qr")
    p.add_argument("--outer-maxiter", type=int, default=200)
    p.add_argument("--outer-rtol", type=float, default=1e-12)
    p.add_argument("--min-convergence-count", type=int, default=4)
    p.add_argument("--dtype", default="float64")
    return p


def worker_main(argv: Optional[Sequence[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    from medane_tchakorom_ufc_thesis_repository_tpu.parallel import mesh as meshmod

    meshmod.init_multihost(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )

    import jax.numpy as jnp
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu.models.multisplitting import (
        InnerConfig,
        OuterConfig,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
        ShardedPoisson2D,
        ShardedPoisson3D,
        sharded_gmres_solve,
        sharded_multisplit_solve,
    )

    mesh = meshmod.make_multihost_mesh(nblocks=args.nblocks)
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32

    if args.dim == 2:
        opcfg = ShardedPoisson2D(args.m, args.n)
    else:
        opcfg = ShardedPoisson3D(args.m, args.n, args.nz)

    # b = A @ 1 (exact solution u = 1) built redundantly on every process
    # from the global stencil — identical across ranks, so device_put can
    # shard it onto the global mesh.
    ones = jnp.ones(opcfg.global_shape, dtype)
    b = np.asarray(_global_stencil_apply(opcfg, ones))

    alg = args.alg.upper()
    known = ("GMRES", "MGPCG", "SM", "AM", "SMSM_LOCAL", "SMSM_SEMI_LOCAL",
             "SMSM_GLOBAL", "AMAM_LOCAL", "AMAM_SEMI_LOCAL", "AMAM_GLOBAL")
    if alg not in known:
        # fail loudly: silently running a different algorithm than
        # configured corrupts experiments (same rule as
        # parallel.sharded._check_spmd_configs)
        raise SystemExit(
            f"multihost worker does not implement --alg {alg}; "
            f"supported: {', '.join(known)}"
        )
    err_override = None
    t0 = time.perf_counter()
    if alg == "GMRES":
        res = sharded_gmres_solve(
            mesh, opcfg, jnp.asarray(b),
            restart=30, maxiter=args.maxiter, rtol=args.rtol,
        )
        sweeps, cycles, inner_iters = int(res.iters), 0, int(res.iters)
        rnorm, rnorm0 = float(res.resnorm), float(res.resnorm0)
    elif alg == "MGPCG":
        # the north-star recipe across processes: MG-preconditioned CG
        # (+ df refinement below the f32 floor) over the global mesh
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
            sharded_df_northstar,
            sharded_mgpcg_solve,
        )

        # forward explicitly-set inner flags (silently running different
        # settings than requested corrupts experiments — same fail-loud
        # rule as the alg guard above)
        mg_kw = {}
        if args.inner_rtol is not None:
            mg_kw["inner_rtol"] = args.inner_rtol
        if args.inner_maxiter is not None:
            mg_kw["pcg_maxiter"] = args.inner_maxiter
        if dtype == jnp.float32 and args.rtol < 1e-5:
            res = sharded_df_northstar(mesh, opcfg, rtol=args.rtol, **mg_kw)
            sweeps, cycles, inner_iters = 0, int(res.passes), 0
            rnorm, rnorm0 = float(res.rnorm), float(res.rnorm0)
            xhi, xlo = res.x
            # (hi - 1) is exact near 1 (Sterbenz), + lo keeps df accuracy
            err_override = float(jax.jit(
                lambda h, l: jnp.max(jnp.abs((h - 1.0) + l)))(xhi, xlo))
        else:
            if mg_kw:
                raise SystemExit(
                    "--inner-rtol/--inner-maxiter configure the PCG inside "
                    "df refinement; this run takes the plain MGPCG branch "
                    "(f64 or rtol >= 1e-5) where they do not apply — use "
                    "--rtol/--maxiter"
                )
            res = sharded_mgpcg_solve(
                mesh, opcfg, jnp.asarray(b),
                rtol=args.rtol, maxiter=args.maxiter,
            )
            sweeps, cycles, inner_iters = int(res.iters), 0, int(res.iters)
            rnorm, rnorm0 = float(res.resnorm), float(res.resnorm0)
    else:
        schedule = "async" if alg.startswith("A") else "sync"
        minim = (
            None if alg in ("SM", "AM")
            else {"L": "local", "S": "semi_local", "G": "global"}[
                alg.split("_", 1)[1][0]
            ]
        )
        res = sharded_multisplit_solve(
            mesh, opcfg, jnp.asarray(b),
            schedule=schedule,
            staleness=args.staleness if schedule == "async" else 1,
            minimization=minim, s=args.s,
            inner=InnerConfig(
                method=args.inner_ksp, pc=args.inner_pc,
                restart=args.inner_restart,
                maxiter=8 if args.inner_maxiter is None
                else args.inner_maxiter,
                rtol=1e-6 if args.inner_rtol is None else args.inner_rtol,
            ),
            outer=OuterConfig(method=args.outer_method,
                              maxiter=args.outer_maxiter,
                              rtol=args.outer_rtol),
            rtol=args.rtol, maxiter=args.maxiter,
            min_convergence_count=args.min_convergence_count,
            basis_collection=args.basis_collection,
        )
        sweeps, cycles = int(res.sweeps), int(res.cycles)
        inner_iters = int(res.inner_iters)
        rnorm, rnorm0 = float(res.rnorm), float(res.rnorm0)
    elapsed = time.perf_counter() - t0

    # error vs the exact solution u = 1, reduced over the GLOBAL
    # (cross-process) array under jit
    if err_override is not None:
        err = err_override
    else:
        err = float(jax.jit(lambda x: jnp.max(jnp.abs(x - 1.0)))(res.x))

    out = {
        "alg": alg,
        "process_id": args.process_id,
        "num_processes": args.num_processes,
        "global_devices": len(jax.devices()),
        "local_devices": len(jax.local_devices()),
        "sweeps": sweeps,
        "cycles": cycles,
        "inner_iters": inner_iters,
        "rnorm": rnorm,
        "rnorm0": rnorm0,
        "converged": bool(res.converged),
        "err_vs_ones": err,
        "elapsed_s": round(elapsed, 3),
    }
    print(json.dumps(out), flush=True)
    return 0


def _global_stencil_apply(opcfg, g):
    """Full-grid stencil apply on a replicated array (for b = A @ 1)."""
    y = opcfg.interior_mv(g.reshape(opcfg.split_extent, opcfg.fdim))
    return y.reshape(g.shape)


if __name__ == "__main__":
    sys.exit(worker_main())
