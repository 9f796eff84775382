"""``isolve``-equivalent CLI: one launcher for the whole algorithm zoo.

Rebuild of the reference's ``iSolve`` bash launcher (SURVEY.md §2.6):
``./iSolve --alg SMSM_GLOBAL --np 8 --npb 4 --m 200 --n 200 --rtol 1e-3``
becomes::

    python -m medane_tchakorom_ufc_thesis_repository_tpu.utils.cli \
        --alg SMSM_GLOBAL --m 200 --n 200 --rtol 1e-3 [--backend sharded
        --nblocks 2 --intra 4]

Prints the same end-of-run report the reference binaries do
(``printResidualNorm`` / ``printElapsedTime`` / ``computeError``,
reference ``src/utils/utils.c:668-729,1045-1059``): initial/final true
residual norm, sweep + inner-iteration counts, elapsed seconds, and the
error vs the exact solution u = 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="isolve",
        description="two-stage multisplitting solver launcher",
    )
    p.add_argument("--alg", default="SM",
                   help="GMRES | CA_GMRES | MGPCG | SM | AM | "
                        "SMSM_{LOCAL,SEMI_LOCAL,GLOBAL} | "
                        "AMAM_{LOCAL,SEMI_LOCAL,GLOBAL}")
    p.add_argument("--config", default=None,
                   help="JSON config file (defaults < file < CLI)")
    p.add_argument("--dim", type=int, default=None, help="2 or 3")
    p.add_argument("--matrix", default=None, metavar="PATH",
                   help="solve a user-supplied square sparse matrix "
                        "(.npz from scipy.sparse.save_npz, or "
                        "MatrixMarket .mtx) instead of the Poisson "
                        "generators; b = A*1. Works with GMRES (stacked "
                        "+ row-sharded), CA_GMRES (stacked; Lanczos-"
                        "estimated interval), and the multisplitting "
                        "algorithms; the block split auto-routes to "
                        "DIA/BSR/ELL (create_matrix_sparse parity)")
    p.add_argument("--m", type=int, default=None, help="grid rows (2D) / nx (3D)")
    p.add_argument("--n", type=int, default=None, help="grid cols (2D) / ny (3D)")
    p.add_argument("--nz", type=int, default=None, help="nz (3D)")
    p.add_argument("--s", type=int, default=None, help="basis depth")
    p.add_argument("--rtol", type=float, default=None)
    p.add_argument("--maxiter", type=int, default=None, help="sweep budget")
    p.add_argument("--min-convergence-count", type=int, default=None,
                   dest="min_convergence_count")
    p.add_argument("--staleness", type=int, default=None,
                   help="async publish period (sweeps)")
    p.add_argument("--basis-collection", default=None,
                   dest="basis_collection", choices=["sweep", "publish"],
                   help="async s-step basis: per-sweep (thesis-faithful) "
                        "or per-publish (staleness-robust)")
    p.add_argument("--nblocks", type=int, default=None,
                   help="Jacobi blocks (np/npb analog)")
    p.add_argument("--intra", type=int, default=None,
                   help="devices per block (sharded backend)")
    # the reference launcher's exact decomposition flags (iSolve:118-194):
    # --np total workers, --npb workers per block => nblocks = np/npb,
    # intra = npb.  Aliases for users switching from ./iSolve.
    p.add_argument("--np", type=int, default=None, dest="np_flag",
                   help="iSolve parity: total workers (= nblocks*npb)")
    p.add_argument("--npb", type=int, default=None, dest="npb_flag",
                   help="iSolve parity: workers per block (= intra)")
    p.add_argument("--backend", default=None,
                   choices=["stacked", "sharded", "tiled", "host_async"])
    p.add_argument("--ir", type=int, default=None,
                   help="row tiles per block (tiled backend)")
    p.add_argument("--ic", type=int, default=None,
                   help="column tiles (tiled backend)")
    p.add_argument("--dtype", default=None, choices=["float32", "float64"])
    p.add_argument("--pc-type", default=None, dest="pc_type",
                   choices=["none", "jacobi", "bjacobi", "amg"],
                   help="whole-system PC for the GMRES baseline on a "
                        "user matrix (--alg GMRES --matrix): jacobi = "
                        "diagonal scaling; bjacobi = batched dense "
                        "block inverses (PCBJACOBI analog); amg = "
                        "smoothed-aggregation multigrid (PCGAMG analog, "
                        "SPD systems; stacked backend)")
    p.add_argument("--pc-block-size", type=int, default=None,
                   dest="pc_block_size",
                   help="bjacobi diagonal-block size (default 64)")
    p.add_argument("--inner-restart", type=int, default=None, dest="inner_restart")
    p.add_argument("--inner-maxiter", type=int, default=None, dest="inner_maxiter")
    p.add_argument("--inner-rtol", type=float, default=None, dest="inner_rtol")
    p.add_argument("--inner-ksp", default=None, dest="inner_ksp",
                   choices=["gmres", "cg", "bicgstab", "chebyshev",
                            "ca_gmres"])
    p.add_argument("--inner-pc-type", default=None, dest="inner_pc",
                   choices=["none", "jacobi", "bjacobi", "mg"])
    p.add_argument("--inner-pc-block-size", type=int, default=None,
                   dest="inner_pc_block_size",
                   help="inner pc=bjacobi diagonal-sub-block size "
                        "(default 64)")
    p.add_argument("--inner-basis", default=None, dest="inner_basis",
                   choices=["native", "bf16"],
                   help="Krylov-basis storage (bf16 halves bandwidth)")
    p.add_argument("--outer-method", default=None, dest="outer_method",
                   choices=["qr", "normal", "lsqr", "cgne"])
    p.add_argument("--outer-maxiter", type=int, default=None, dest="outer_maxiter")
    p.add_argument("--outer-rtol", type=float, default=None, dest="outer_rtol")
    # per-block prefixed KSP options — the reference's inner1_/inner2_/
    # outer1_/outer2_ PETSc prefixes (utils.c:512-541, iSolve:118-194);
    # each flag overrides the shared --inner-*/--outer-* base for that
    # block only (stacked backend)
    for blk in (1, 2):
        p.add_argument(f"--inner{blk}-ksp", default=None,
                       dest=f"inner{blk}_ksp",
                       choices=["gmres", "cg", "bicgstab", "chebyshev",
                                "ca_gmres"])
        p.add_argument(f"--inner{blk}-restart", type=int, default=None,
                       dest=f"inner{blk}_restart")
        p.add_argument(f"--inner{blk}-maxiter", type=int, default=None,
                       dest=f"inner{blk}_maxiter")
        p.add_argument(f"--inner{blk}-rtol", type=float, default=None,
                       dest=f"inner{blk}_rtol")
        p.add_argument(f"--inner{blk}-pc-type", default=None,
                       dest=f"inner{blk}_pc",
                       choices=["none", "jacobi", "bjacobi", "mg"])
        p.add_argument(f"--outer{blk}-method", default=None,
                       dest=f"outer{blk}_method",
                       choices=["qr", "normal", "lsqr", "cgne"])
        p.add_argument(f"--outer{blk}-maxiter", type=int, default=None,
                       dest=f"outer{blk}_maxiter")
        p.add_argument(f"--outer{blk}-rtol", type=float, default=None,
                       dest=f"outer{blk}_rtol")
    p.add_argument("--show-config", action="store_true", dest="show_config",
                   help="print the fully-resolved run configuration "
                        "(defaults < file < CLI) before solving — the "
                        "PETSc -options_view analog")
    p.add_argument("--json", action="store_true",
                   help="emit one JSON line instead of the report")
    p.add_argument("--profile-dir", default=None,
                   help="write a jax.profiler trace here")
    p.add_argument("--stage-timers", action="store_true", dest="stage_timers",
                   help="host-stepped solve with per-stage wall timers "
                        "(I_Solver/Exchange/O_Solver/Convergence — the "
                        "PetscLog-stage analog; stacked backend)")
    p.add_argument("--flame", default=None, metavar="PATH", dest="flame",
                   help="write the stage timers: .html flamegraph, "
                        ".txt folded stacks, .xml nested-timer report "
                        "with companion XSL (-log_view ::ascii_xml "
                        "analog); otherwise a flamegraph-style "
                        "HTML artifact (the performance_xml2html.xsl / "
                        "-log_view ::ascii_flamegraph analog); implies "
                        "--stage-timers for .html, or folded-stack text "
                        "for a .txt path")
    p.add_argument("--record-history", action="store_true",
                   dest="record_history",
                   help="record + report per-cycle residual norms (the "
                        "reference's per-iteration norm printouts)")
    p.add_argument("--net-async", type=int, default=None, metavar="NPROCS",
                   dest="net_async",
                   help="run AM with NPROCS OS processes (one Jacobi "
                        "block each) exchanging iterates + Alg-5.15 "
                        "termination over TCP sockets (the reference's "
                        "inter-node async execution model)")
    p.add_argument("--transport", default=None,
                   choices=["auto", "python", "native"],
                   help="net-async wire transport: pure-Python sockets or "
                        "the C++ epoll router (native/src/comm.cpp); "
                        "auto prefers native when it builds")
    p.add_argument("--termination", default=None,
                   choices=["protocol", "traversal", "slcv"],
                   help="net-async termination: Alg-5.15 protocol, the "
                        "legacy 2x-traversal-time quiet-window guard "
                        "(asynchronous-multisplitting.c.save:307-329), or "
                        "the legacy SLCV counter protocol "
                        "(conv_detection.c:6-196)")
    p.add_argument("--wan-latency-ms", type=float, default=0.0,
                   dest="wan_latency_ms",
                   help="net-async WAN emulation: one-way link latency "
                        "(the reference's tc-qdisc study analog; see "
                        "also utils.wan_study)")
    p.add_argument("--wan-bw-mbit", type=float, default=0.0,
                   dest="wan_bw_mbit",
                   help="net-async WAN emulation: link bandwidth Mbit/s")
    p.add_argument("--multihost", type=int, default=None, metavar="NPROCS",
                   help="fan out NPROCS OS processes over jax.distributed "
                        "(the reference's mpiexec analog, iSolve:347-401); "
                        "CPU transport is Gloo, each process gets "
                        "--devices-per-process virtual devices")
    p.add_argument("--devices-per-process", type=int, default=4,
                   dest="devices_per_process",
                   help="virtual CPU devices per multihost process")
    return p


_MULTIHOST_PASSTHROUGH = {
    "alg": "--alg", "dim": "--dim", "m": "--m", "n": "--n", "nz": "--nz",
    "nblocks": "--nblocks", "s": "--s", "rtol": "--rtol",
    "maxiter": "--maxiter", "staleness": "--staleness",
    "inner_maxiter": "--inner-maxiter", "inner_restart": "--inner-restart",
    "inner_rtol": "--inner-rtol", "inner_ksp": "--inner-ksp",
    "inner_pc": "--inner-pc-type",
    "basis_collection": "--basis-collection",
    "outer_method": "--outer-method", "outer_maxiter": "--outer-maxiter",
    "outer_rtol": "--outer-rtol",
    "min_convergence_count": "--min-convergence-count", "dtype": "--dtype",
}

# solver options the worker parser does NOT implement — reject loudly
# instead of silently running a different configuration than requested
_MULTIHOST_UNSUPPORTED = ("inner_basis", "ir", "ic", "intra")


def run_multihost(args) -> dict:
    """Parent side of a multi-process run: fan out worker ranks and
    return rank 0's result (all ranks' replicated scalars agree)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.utils import multihost

    for field in _MULTIHOST_UNSUPPORTED:
        if getattr(args, field, None) is not None:
            raise SystemExit(
                f"--multihost does not implement --{field.replace('_', '-')}"
            )
    pb = [f for f in vars(args)
          if (f.startswith(("inner1_", "inner2_", "outer1_", "outer2_"))
              and getattr(args, f) is not None)]
    if pb:
        raise SystemExit(
            f"--multihost does not implement per-block flags: {pb}"
        )
    wargs = []
    for field, flag in _MULTIHOST_PASSTHROUGH.items():
        v = getattr(args, field, None)
        if v is not None:
            wargs += [flag, str(v)]
    results = multihost.launch(
        wargs,
        num_processes=args.multihost,
        devices_per_process=args.devices_per_process,
    )
    out = dict(results[0])
    out["backend"] = f"multihost({args.multihost}proc)"
    return out


_PER_BLOCK_KEYS = ("ksp", "restart", "maxiter", "rtol", "pc")
_PER_BLOCK_OUTER_KEYS = ("method", "maxiter", "rtol")


def _collect_per_block(args):
    """--inner1-*/--outer2-*-style flags -> override dict lists."""
    inner, outer = [], []
    for blk in (1, 2):
        inner.append({
            k: v for k in _PER_BLOCK_KEYS
            if (v := getattr(args, f"inner{blk}_{k}", None)) is not None
        })
        outer.append({
            k: v for k in _PER_BLOCK_OUTER_KEYS
            if (v := getattr(args, f"outer{blk}_{k}", None)) is not None
        })
    return inner, outer


def run_net_async(args) -> dict:
    """TCP-async fan-out: one OS process per Jacobi block, iterates +
    Alg-5.15 termination over sockets (models.net_async).  AM plus the
    async-minimization variants AMAM_{LOCAL,SEMI_LOCAL,GLOBAL} (Gram
    panels piggyback the latest-wins DATA frames)."""
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu.models.net_async import (
        launch_net_async,
    )

    alg = args.alg or "AM"
    minim_map = {
        "AM": (None, "async"),
        "AMAM_LOCAL": ("local", "async"),
        "AMAM_SEMI_LOCAL": ("semi_local", "async"),
        "AMAM_GLOBAL": ("global", "async"),
        # sync lockstep rounds over the same sockets (round 5): the
        # sync baselines of the WAN study (utils.wan_study)
        "SM": (None, "sync"),
        "SMSM_LOCAL": ("local", "sync"),
        "SMSM_SEMI_LOCAL": ("semi_local", "sync"),
        "SMSM_GLOBAL": ("global", "sync"),
    }
    if alg not in minim_map:
        raise SystemExit(
            "--net-async runs AM | AMAM_{LOCAL,SEMI_LOCAL,GLOBAL} "
            "(async) or SM | SMSM_{LOCAL,SEMI_LOCAL,GLOBAL} (sync "
            "lockstep over TCP)"
        )
    minimization, schedule = minim_map[alg]
    m = args.m or 64
    n = args.n or 64
    results = launch_net_async(
        nblocks=args.net_async, m=m, n=n,
        rtol=args.rtol or 1e-4, maxiter=args.maxiter or 4000,
        min_convergence_count=args.min_convergence_count or 4,
        inner_maxiter=args.inner_maxiter or 20,
        dtype=args.dtype or "float64",
        termination=args.termination or "protocol",
        transport=args.transport or "auto",
        minimization=minimization,
        s=4 if args.s is None else args.s,
        schedule=schedule,
        wan_latency_ms=args.wan_latency_ms or 0.0,
        wan_bw_mbit=args.wan_bw_mbit or 0.0,
    )
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops

    op = blockops.block_poisson2d(m, n, nblocks=args.net_async)
    b = blockops.rhs_ones(op, jnp.float64)
    x = jnp.asarray(np.stack([
        np.asarray(r["x_block"])
        for r in sorted(results, key=lambda r: r["rank"])
    ]))
    r_true = b - op.full_mv(x)
    rnorm = float(jnp.linalg.norm(r_true.reshape(-1)))
    return {
        "alg": alg, "backend": f"net_async({args.net_async}proc tcp)",
        "grid": f"{m}x{n}", "dim": 2,
        "sweeps_per_block": [r["sweeps"] for r in results],
        "converged": all(r["converged"] for r in results),
        # True: lockstep tail certified the merged residual <= rtol*||b||
        # exactly; None under the legacy traversal guard (no tail)
        "certified": (None if any(r["certified"] is None for r in results)
                      else all(r["certified"] for r in results)),
        "rnorm": rnorm, "rnorm0": results[0]["rnorm0"],
        "rel_rnorm": rnorm / results[0]["rnorm0"],
        "elapsed_s": max(r["elapsed_s"] for r in results),
        "error_vs_ones": float(jnp.max(jnp.abs(x - 1.0))),
    }


def config_from_args(args) -> "RunConfig":
    import dataclasses as _dc

    from medane_tchakorom_ufc_thesis_repository_tpu.utils.config import (
        default_config,
        load_config,
    )

    # ./iSolve parity: --np/--npb derive the mesh decomposition
    # (nblocks = np/npb, intra = npb; validation mirrors iSolve:332-338)
    if args.npb_flag is not None or args.np_flag is not None:
        if args.np_flag is None or args.npb_flag is None:
            raise SystemExit("--np and --npb must be given together")
        if args.npb_flag < 1 or args.np_flag % args.npb_flag:
            raise SystemExit(
                f"--np {args.np_flag} not divisible by --npb {args.npb_flag}"
            )
        if args.nblocks is None:
            args.nblocks = args.np_flag // args.npb_flag
        if args.intra is None:
            args.intra = args.npb_flag

    inner_pb, outer_pb = _collect_per_block(args)
    pb_keys = {
        f"{kind}{blk}_{k}"
        for blk in (1, 2)
        for kind, keys in (("inner", _PER_BLOCK_KEYS),
                           ("outer", _PER_BLOCK_OUTER_KEYS))
        for k in keys
    }
    overrides = {
        k: v for k, v in vars(args).items()
        if v is not None and k not in (
            {"config", "json", "profile_dir", "multihost",
             "devices_per_process", "stage_timers", "record_history",
             "net_async", "show_config", "np_flag", "npb_flag",
             "transport", "termination", "flame",
             "wan_latency_ms", "wan_bw_mbit"}
            | pb_keys
        )
    }
    if args.config:
        cfg = load_config(args.config, **overrides)
    else:
        cfg = default_config(**overrides)
    if any(inner_pb) or any(outer_pb):
        # pad the 1/2-indexed flag dicts to nblocks entries ({} = keep base)
        pad = [{} for _ in range(max(0, cfg.nblocks - 2))]
        cfg = _dc.replace(
            cfg,
            inner_overrides=(tuple(inner_pb[:cfg.nblocks] + pad)
                             if any(inner_pb) else None),
            outer_overrides=(tuple(outer_pb[:cfg.nblocks] + pad)
                             if any(outer_pb) else None),
        ).validate()
    return cfg


def _load_matrix_operator(path: str, nblocks: int, dtype):
    """Load a user sparse matrix and build the routed stacked operator
    (the ``create_matrix_sparse`` AIJ entry point, reference
    ``utils.c:139-155``) plus ``b = A·1`` in stacked layout."""
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sp

    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops

    if path.endswith(".npz"):
        A = sp.load_npz(path)
    elif path.endswith((".mtx", ".mtx.gz")):
        from scipy.io import mmread

        A = sp.csr_matrix(mmread(path))
    else:
        raise SystemExit(
            f"--matrix: unsupported extension on {path!r} "
            "(.npz from scipy.sparse.save_npz, or .mtx)"
        )
    if A.shape[0] != A.shape[1]:
        raise SystemExit(f"--matrix must be square, got {A.shape}")
    if A.shape[0] % nblocks:
        raise SystemExit(
            f"--matrix rows ({A.shape[0]}) not divisible by "
            f"--nblocks ({nblocks})"
        )
    coo = A.tocoo()
    a_ii, a_ic = poisson.block_split_ell(
        coo.row, coo.col, coo.data, A.shape, nblocks=nblocks, dtype=dtype,
    )
    op = blockops.as_stacked_device_operator(
        blockops.StackedELLOperator(a_ii=a_ii, a_ic=a_ic)
    )
    b = jnp.asarray(
        np.asarray(A @ np.ones(A.shape[0])), dtype
    ).reshape(nblocks, A.shape[0] // nblocks)
    return op, b, A


def run(cfg, profile_dir=None, stage_timers=False, record_history=False):
    import jax
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.models import (
        blockops,
        multisplitting as ms,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.utils.profiling import (
        PhaseTimer,
        fence,
        trace,
    )

    if stage_timers and (cfg.backend != "stacked"
                         or cfg.alg in ("GMRES", "CA_GMRES", "MGPCG")):
        raise SystemExit(
            "--stage-timers runs the host-stepped profiling driver "
            "(stacked backend, multisplitting algorithms only)"
        )
    if stage_timers and cfg.basis_collection == "publish":
        raise SystemExit(
            "--stage-timers (staged driver) does not implement "
            "--basis-collection publish — drop one of the two flags"
        )
    if cfg.dtype == "float64" and not jax.config.read("jax_enable_x64"):
        jax.config.update("jax_enable_x64", True)
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    pt = PhaseTimer()

    grid_label = (f"{cfg.m}x{cfg.n}" if cfg.dim == 2
                  else f"{cfg.m}x{cfg.n}x{cfg.nz}")
    with pt.phase("Loading"):
        if cfg.matrix:
            if cfg.backend != "stacked" and not (
                    cfg.backend == "sharded" and cfg.alg == "GMRES"):
                raise SystemExit(
                    "--matrix supports the stacked backend (all "
                    "algorithms) and --backend sharded with GMRES "
                    "(row-sharded general-sparse, parallel/general.py)"
                )
            if cfg.alg == "MGPCG":
                raise SystemExit(
                    "--matrix works with GMRES, CA_GMRES, and the "
                    "multisplitting algorithms (MGPCG is "
                    "geometric-multigrid/Poisson)"
                )
            if cfg.alg == "CA_GMRES" and cfg.backend != "stacked":
                raise SystemExit(
                    "--matrix with CA_GMRES runs on the stacked backend "
                    "(the sharded CA path is grid-structured)"
                )
            op, b, user_A = _load_matrix_operator(cfg.matrix, cfg.nblocks,
                                                  dtype)
            import os as _os

            grid_label = f"{_os.path.basename(cfg.matrix)}:{user_A.shape[0]}"
        elif cfg.dim == 2:
            op = blockops.block_poisson2d(cfg.m, cfg.n, cfg.nblocks)
            b = blockops.rhs_ones(op, dtype)
        else:
            op = blockops.block_poisson3d(cfg.m, cfg.n, cfg.nz, cfg.nblocks)
            b = blockops.rhs_ones(op, dtype)
        fence(b)

    kw = dict(
        rtol=cfg.rtol, atol=cfg.atol, maxiter=cfg.maxiter,
        inner=cfg.inner_config(), outer=cfg.outer_config(),
        min_convergence_count=cfg.min_convergence_count,
    )

    if cfg.alg == "CA_GMRES":
        # communication-avoiding whole-system baseline: one collective
        # per s matvecs (solvers/castep.py; sharded_ca_gmres_solve)
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
            ca_gmres,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
            poisson_strip_eig_bounds_2d,
            poisson_strip_eig_bounds_3d,
        )

        if cfg.matrix:
            # user matrix: estimate the interval by Lanczos (the PETSc
            # -ksp_chebyshev_esteig analog; SPD required — the Newton
            # shifts need a positive real interval)
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.eigest import (  # noqa: E501
                lanczos_bounds,
            )

            lmin, lmax = lanczos_bounds(
                op.global_mv, user_A.shape[0], dtype=dtype,
            )
        elif cfg.dim == 2:
            lmin, lmax = poisson_strip_eig_bounds_2d(cfg.m, cfg.n, 4.0, -1.0)
        else:
            lmin, lmax = poisson_strip_eig_bounds_3d(
                cfg.m, cfg.n, cfg.nz, 6.0, -1.0
            )
        if cfg.backend == "sharded":
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
                ShardedPoisson2D,
                ShardedPoisson3D,
                make_mesh,
                sharded_ca_gmres_solve,
            )

            mesh = make_mesh(nblocks=cfg.nblocks, intra=cfg.intra)
            opcfg = (ShardedPoisson2D(cfg.m, cfg.n) if cfg.dim == 2
                     else ShardedPoisson3D(cfg.m, cfg.n, cfg.nz))
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = sharded_ca_gmres_solve(
                    mesh, opcfg, b.reshape(opcfg.global_shape),
                    s=cfg.s, maxiter=cfg.maxiter, rtol=cfg.rtol,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
        elif cfg.backend == "stacked":
            solve = jax.jit(lambda bb: ca_gmres(
                op.global_mv, bb, s=cfg.s, maxiter=cfg.maxiter,
                rtol=cfg.rtol, lmin=lmin, lmax=lmax,
            ))
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = solve(b.reshape(-1))
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x
        else:
            raise SystemExit(
                "CA_GMRES supports backends 'stacked' and 'sharded'"
            )
        result = dict(sweeps=int(kres.iters), cycles=0,
                      inner_iters=int(kres.iters),
                      converged=bool(kres.converged),
                      rnorm=float(kres.resnorm), rnorm0=float(kres.resnorm0))
    elif cfg.alg == "GMRES":
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

        if cfg.backend not in ("stacked", "sharded", "tiled"):
            raise SystemExit(
                "the GMRES baseline supports backends 'stacked', "
                "'sharded', and 'tiled'"
            )
        if cfg.backend == "tiled":
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
                make_tiled_mesh,
                tiled_gmres_solve,
            )

            if cfg.dim != 2:
                raise SystemExit("tiled GMRES is 2D (use sharded for 3D)")
            tmesh = make_tiled_mesh(cfg.nblocks, cfg.ir, cfg.ic)
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = tiled_gmres_solve(
                    tmesh, cfg.m, cfg.n, b.reshape(cfg.m, cfg.n),
                    restart=cfg.inner_restart, maxiter=cfg.maxiter,
                    rtol=cfg.rtol,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
        elif cfg.backend == "sharded" and cfg.matrix:
            # row-sharded general-sparse GMRES (parallel/general.py):
            # the MPIAIJ-across-ranks analog for a user matrix
            import scipy.sparse as _sp

            from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
                make_mesh,
            )
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel.general import (
                shard_general_from_coo,
                sharded_general_solve,
            )

            mesh = make_mesh(nblocks=cfg.nblocks, intra=cfg.intra)
            ndev = cfg.nblocks * cfg.intra
            A = (_sp.load_npz(cfg.matrix) if cfg.matrix.endswith(".npz")
                 else None)
            if A is None:
                from scipy.io import mmread

                A = _sp.csr_matrix(mmread(cfg.matrix))
            coo = A.tocoo()
            import numpy as _np

            cdata = coo.data
            b_vec = b.reshape(-1)
            gpc = None
            unscale = None
            if cfg.pc_type == "jacobi":
                # exact RIGHT point-Jacobi = column-scale the system
                # host-side (zero runtime cost; convergence tests the
                # true residual; x = y / d afterwards)
                d = _np.asarray(A.diagonal(), _np.float64)
                d[d == 0] = 1.0
                cdata = coo.data / d[coo.col]
                unscale = jnp.asarray(1.0 / d, dtype)
            elif cfg.pc_type == "bjacobi":
                from medane_tchakorom_ufc_thesis_repository_tpu.parallel.general import (  # noqa: E501
                    shard_bjacobi_from_coo,
                )

                gpc = shard_bjacobi_from_coo(
                    coo.row, coo.col, coo.data, A.shape[0], ndev,
                    bs=cfg.pc_block_size, dtype=dtype,
                )
            elif cfg.pc_type == "amg":
                raise SystemExit(
                    "--pc-type amg runs on the stacked backend (its "
                    "V-cycle levels are whole-system pytrees; the "
                    "row-sharded path offers jacobi/bjacobi)"
                )
            gop = shard_general_from_coo(
                coo.row, coo.col, cdata, A.shape[0], ndev, dtype=dtype,
            )
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = sharded_general_solve(
                    mesh, gop, b_vec, method="gmres",
                    restart=cfg.inner_restart, maxiter=cfg.maxiter,
                    rtol=cfg.rtol, pc=gpc,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
            if unscale is not None:
                x_flat = unscale * x_flat
        elif cfg.backend == "sharded":
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
                ShardedPoisson2D,
                ShardedPoisson3D,
                make_mesh,
                sharded_gmres_solve,
            )

            mesh = make_mesh(nblocks=cfg.nblocks, intra=cfg.intra)
            opcfg = (ShardedPoisson2D(cfg.m, cfg.n) if cfg.dim == 2
                     else ShardedPoisson3D(cfg.m, cfg.n, cfg.nz))
            b_grid = b.reshape(opcfg.global_shape)
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = sharded_gmres_solve(
                    mesh, opcfg, b_grid, restart=cfg.inner_restart,
                    maxiter=cfg.maxiter, rtol=cfg.rtol,
                )
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x.reshape(-1)
        else:
            flat_b = b.reshape(-1)
            if cfg.matrix and cfg.pc_type != "none":
                # whole-system RIGHT PC on the user matrix (outer-KSP
                # -pc_type analog; the reference gestures at the same
                # side, utils.c:524 KSPSetPCSide PC_RIGHT): solve
                # (A M) y = b then x = M y, so the Givens estimate
                # tracks the TRUE residual — a stiff left PC can leave
                # the true residual orders of magnitude above rtol
                if cfg.pc_type == "jacobi":
                    import numpy as _np

                    d = _np.asarray(user_A.diagonal(), _np.float64)
                    d[d == 0] = 1.0
                    dinv = jnp.asarray(1.0 / d, dtype)
                    M = lambda v: dinv * v
                elif cfg.pc_type == "amg":
                    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.amg import (  # noqa: E501
                        amg_setup,
                    )

                    M = amg_setup(user_A, dtype=dtype).apply
                else:
                    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.bjacobi import (  # noqa: E501
                        block_jacobi_from_scipy,
                    )

                    M = block_jacobi_from_scipy(
                        user_A, bs=cfg.pc_block_size, dtype=dtype,
                    ).apply

                import dataclasses as _dc

                def _pc_solve(bb):
                    res = gmres(
                        lambda v: op.global_mv(M(v)), bb,
                        restart=cfg.inner_restart,
                        maxiter=cfg.maxiter, rtol=cfg.rtol,
                    )
                    return _dc.replace(res, x=M(res.x))

                solve = jax.jit(_pc_solve)
            else:
                solve = jax.jit(lambda bb: gmres(
                    op.global_mv, bb, restart=cfg.inner_restart,
                    maxiter=cfg.maxiter, rtol=cfg.rtol,
                ))
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                kres = solve(flat_b)
                fence(kres.x)
                elapsed = time.perf_counter() - t0
            x_flat = kres.x
        result = dict(sweeps=int(kres.iters), cycles=0,
                      inner_iters=int(kres.iters),
                      converged=bool(kres.converged),
                      rnorm=float(kres.resnorm), rnorm0=float(kres.resnorm0))
    elif cfg.alg == "MGPCG":
        # multigrid-preconditioned CG on the whole system (the bench.py
        # north-star recipe as a first-class algorithm): V(2,2)-cycle
        # preconditioning (solvers/multigrid.py — the PCMG analog) and,
        # for rtol below the f32 attainable-accuracy floor, double-float
        # residual refinement (solvers/df64.py) so 1e-8..1e-12 relative
        # residuals are reachable from f32 device solves
        from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import (
            cg as cg_solve,
        )

        gop = (poisson.poisson2d(cfg.m, cfg.n) if cfg.dim == 2
               else poisson.poisson3d(cfg.m, cfg.n, cfg.nz))
        gshape = ((cfg.m, cfg.n) if cfg.dim == 2
                  else (cfg.m, cfg.n, cfg.nz))
        b_grid = b.reshape(gshape)
        pcg_rtol = cfg.inner_rtol if cfg.inner_rtol is not None else 1e-5
        pcg_maxiter = cfg.inner_maxiter or 60
        want_refine = dtype == jnp.float32 and cfg.rtol < 1e-5

        if cfg.backend in ("sharded", "tiled"):
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
                ShardedPoisson2D,
                ShardedPoisson3D,
                make_mesh,
                sharded_df_northstar,
                sharded_mgpcg_solve,
            )

            if cfg.backend == "tiled":
                from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
                    make_tiled_mesh,
                )

                mesh = make_tiled_mesh(cfg.nblocks, cfg.ir, cfg.ic)
            else:
                mesh = make_mesh(nblocks=cfg.nblocks, intra=cfg.intra)
            opcfg = (ShardedPoisson2D(cfg.m, cfg.n) if cfg.dim == 2
                     else ShardedPoisson3D(cfg.m, cfg.n, cfg.nz))
            if want_refine:
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    rres = sharded_df_northstar(
                        mesh, opcfg, rtol=cfg.rtol,
                        inner_rtol=pcg_rtol, pcg_maxiter=pcg_maxiter,
                    )
                    elapsed = time.perf_counter() - t0
            else:
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    kres = sharded_mgpcg_solve(
                        mesh, opcfg, b_grid, rtol=cfg.rtol,
                        maxiter=cfg.maxiter,
                    )
                    fence(kres.x)
                    elapsed = time.perf_counter() - t0
                x_flat = kres.x.reshape(-1)
        elif cfg.backend == "stacked":
            from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
                mg_preconditioner,
            )

            M = mg_preconditioner(gop)
            if want_refine:
                from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
                    df_iterative_refinement,
                )

                solve32 = jax.jit(lambda rr: cg_solve(
                    gop.mv, rr, maxiter=pcg_maxiter, rtol=pcg_rtol,
                    precond=M,
                ).x)
                b_df = (b_grid.astype(jnp.float32),
                        jnp.zeros(gshape, jnp.float32))
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    rres = df_iterative_refinement(
                        gop, None, solve32, rtol=cfg.rtol, b_df=b_df,
                    )
                    elapsed = time.perf_counter() - t0
            else:
                solve = jax.jit(lambda bb: cg_solve(
                    gop.mv, bb, maxiter=cfg.maxiter, rtol=cfg.rtol,
                    precond=M,
                ))
                with trace(profile_dir), pt.phase("I_Solver"):
                    t0 = time.perf_counter()
                    kres = solve(b_grid)
                    fence(kres.x)
                    elapsed = time.perf_counter() - t0
                x_flat = kres.x.reshape(-1)
        else:
            raise SystemExit(
                "MGPCG supports backends 'stacked', 'sharded', and 'tiled'"
            )

        if want_refine:
            # df-refined path: report the DF true-residual norm (an f32
            # recombination of x would floor the reported residual at
            # ~1e-7 — the very limit refinement exists to beat)
            import numpy as np

            from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
                df64,
            )

            x64 = (np.asarray(rres.x, np.float64).reshape(-1)
                   if not isinstance(rres.x, tuple)
                   else df64.df_to_f64(rres.x).reshape(-1))
            err = float(np.linalg.norm(x64 - 1.0))
            result = dict(
                sweeps=0, cycles=int(rres.passes), inner_iters=0,
                converged=bool(rres.converged),
                rnorm=float(rres.rnorm), rnorm0=float(rres.rnorm0),
                refine_passes=int(rres.passes),
                residual_history=[float(h) for h in rres.rel_history],
                alg=cfg.alg, backend=cfg.backend, dim=cfg.dim,
                grid=(f"{cfg.m}x{cfg.n}" if cfg.dim == 2
                      else f"{cfg.m}x{cfg.n}x{cfg.nz}"),
                elapsed_s=round(elapsed, 4),
                final_true_rnorm=float(rres.rnorm),
                rel_rnorm=(float(rres.rnorm / rres.rnorm0)
                           if rres.rnorm0 else 0.0),
                error_vs_ones=err,
            )
            return result, pt
        result = dict(sweeps=int(kres.iters), cycles=0,
                      inner_iters=int(kres.iters),
                      converged=bool(kres.converged),
                      rnorm=float(kres.resnorm), rnorm0=float(kres.resnorm0))
    else:
        if cfg.backend == "host_async":
            from medane_tchakorom_ufc_thesis_repository_tpu.models.host_async import (
                host_async_solve,
            )

            if cfg.schedule != "async":
                raise SystemExit(
                    "host_async backend runs the async algorithms (AM/AMAM_*)"
                )
            with trace(profile_dir), pt.phase("I_Solver"):
                t0 = time.perf_counter()
                hres = host_async_solve(
                    op, b, rtol=cfg.rtol, atol=cfg.atol,
                    maxiter=cfg.maxiter,
                    min_convergence_count=cfg.min_convergence_count,
                    inner=cfg.inner_config(),
                    minimization=cfg.minimization, s=cfg.s,
                    intra=cfg.intra,
                )
                elapsed = time.perf_counter() - t0
            x_flat = hres.x.reshape(-1)
            result = dict(
                sweeps=sum(hres.sweeps_per_block), cycles=0,
                inner_iters=0, converged=bool(hres.converged),
                rnorm=hres.rnorm, rnorm0=hres.rnorm0,
                sweeps_per_block=hres.sweeps_per_block,
                certified=bool(hres.certified),
                tail_sweeps=int(hres.tail_rounds),
            )
            # report and return handled below via the common path
            r = b.reshape(-1) - op.global_mv(x_flat)
            final_norm = float(jnp.linalg.norm(r))
            err = float(jnp.linalg.norm(x_flat - 1.0))
            result.update(
                alg=cfg.alg, backend=cfg.backend, dim=cfg.dim,
                grid=(f"{cfg.m}x{cfg.n}" if cfg.dim == 2
                      else f"{cfg.m}x{cfg.n}x{cfg.nz}"),
                elapsed_s=round(elapsed, 4),
                final_true_rnorm=final_norm,
                rel_rnorm=final_norm / result["rnorm0"],
                error_vs_ones=err,
            )
            return result, pt
        if cfg.backend == "tiled":
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
                make_tiled_mesh,
                tiled_multisplit_solve,
                tiled_multisplit_solve_3d,
            )

            tmesh = make_tiled_mesh(cfg.nblocks, cfg.ir, cfg.ic)
            if cfg.dim == 2:
                b_grid = b.reshape(cfg.m, cfg.n)

                def solve():
                    return tiled_multisplit_solve(
                        tmesh, cfg.m, cfg.n, b_grid,
                        schedule=cfg.schedule,
                        staleness=(cfg.staleness if cfg.schedule == "async"
                                   else 1),
                        minimization=cfg.minimization, s=cfg.s,
                        record_history=record_history,
                        basis_collection=cfg.basis_collection, **kw,
                    )
            else:
                b_grid = b.reshape(cfg.m, cfg.n, cfg.nz)

                def solve():
                    return tiled_multisplit_solve_3d(
                        tmesh, cfg.m, cfg.n, cfg.nz, b_grid,
                        schedule=cfg.schedule,
                        staleness=(cfg.staleness if cfg.schedule == "async"
                                   else 1),
                        minimization=cfg.minimization, s=cfg.s,
                        record_history=record_history,
                        basis_collection=cfg.basis_collection, **kw,
                    )
        elif cfg.backend == "sharded":
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
                ShardedPoisson2D,
                ShardedPoisson3D,
                make_mesh,
                sharded_multisplit_solve,
            )

            mesh = make_mesh(nblocks=cfg.nblocks, intra=cfg.intra)
            opcfg = (ShardedPoisson2D(cfg.m, cfg.n) if cfg.dim == 2
                     else ShardedPoisson3D(cfg.m, cfg.n, cfg.nz))
            gshape = opcfg.global_shape
            b_grid = b.reshape(gshape)

            def solve():
                return sharded_multisplit_solve(
                    mesh, opcfg, b_grid,
                    schedule=cfg.schedule,
                    staleness=(cfg.staleness if cfg.schedule == "async" else 1),
                    minimization=cfg.minimization, s=cfg.s,
                    record_history=record_history,
                    basis_collection=cfg.basis_collection, **kw,
                )
        elif stage_timers:
            from medane_tchakorom_ufc_thesis_repository_tpu.models.staged import (
                staged_multisplit_solve,
            )

            def solve():
                return staged_multisplit_solve(
                    op, b,
                    schedule=cfg.schedule,
                    staleness=(cfg.staleness if cfg.schedule == "async" else 1),
                    minimization=cfg.minimization, s=cfg.s, timer=pt, **kw,
                )
        else:
            def solve():
                return ms.multisplit_solve(
                    op, b,
                    schedule=cfg.schedule,
                    staleness=(cfg.staleness if cfg.schedule == "async" else 1),
                    minimization=cfg.minimization, s=cfg.s,
                    record_history=record_history,
                    basis_collection=cfg.basis_collection, **kw,
                )

        with trace(profile_dir), pt.phase("I_Solver"):
            t0 = time.perf_counter()
            res = solve()
            fence(res.x)
            elapsed = time.perf_counter() - t0
        x_flat = res.x.reshape(-1)
        result = dict(sweeps=int(res.sweeps), cycles=int(res.cycles),
                      inner_iters=int(res.inner_iters),
                      converged=bool(res.converged),
                      rnorm=float(res.rnorm), rnorm0=float(res.rnorm0))
        if getattr(res, "certified", None) is not None:
            # async certification tail: bound verified on the true
            # (staleness-free) coupling
            result["certified"] = bool(res.certified)
            result["tail_sweeps"] = int(res.tail_sweeps)
        if res.history is not None:
            # per-cycle residual norms (the reference prints one per
            # iteration, asynchronous-multisplitting_prime.c:345)
            hist = [float(h) for h in res.history[:int(res.cycles)]]
            result["residual_history"] = hist

    with pt.phase("Last"):
        r = b.reshape(-1) - op.global_mv(x_flat)
        final_norm = float(jnp.linalg.norm(r))
        err = float(jnp.linalg.norm(x_flat - 1.0))
        fence(r)

    result.update(
        alg=cfg.alg, backend=cfg.backend, dim=cfg.dim,
        grid=grid_label,
        elapsed_s=round(elapsed, 4),
        final_true_rnorm=final_norm,
        rel_rnorm=final_norm / result["rnorm0"] if result["rnorm0"] else 0.0,
        error_vs_ones=err,
    )
    return result, pt


def main(argv=None) -> int:
    from medane_tchakorom_ufc_thesis_repository_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    args = build_parser().parse_args(argv)
    enable_compile_cache()
    if args.net_async:
        result = run_net_async(args)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"Algorithm          : {result['alg']} "
                  f"({result['backend']})")
            print(f"Grid               : {result['grid']}")
            print(f"Sweeps per block   : {result['sweeps_per_block']}")
            print(f"Final residual     : {result['rnorm']:.6e} "
                  f"(rel {result['rel_rnorm']:.3e})")
            print(f"Converged          : {result['converged']}")
            print(f"Certified          : {result['certified']}")
            print(f"Elapsed            : {result['elapsed_s']:.3f} s")
            print(f"Error vs u=1       : {result['error_vs_ones']:.6e}")
        return 0 if result["converged"] else 2
    if args.multihost:
        result = run_multihost(args)
        if args.json:
            print(json.dumps(result))
        else:
            print(f"Algorithm          : {result['alg']} ({result['backend']})")
            print(f"Processes/devices  : {result['num_processes']} x "
                  f"{result['local_devices']} = {result['global_devices']}")
            print(f"Initial residual   : {result['rnorm0']:.6e}")
            print(f"Final residual     : {result['rnorm']:.6e}")
            print(f"Sweeps / cycles    : {result['sweeps']} / {result['cycles']}")
            print(f"Converged          : {result['converged']}")
            print(f"Elapsed            : {result['elapsed_s']:.4f} s")
            print(f"Error vs u=1       : {result['err_vs_ones']:.6e}")
        return 0 if result["converged"] else 2
    cfg = config_from_args(args)
    if args.show_config:
        import dataclasses as _dc

        print(json.dumps(
            {"resolved_config": _dc.asdict(cfg)}, default=str
        ))
    stage_timers = args.stage_timers or bool(args.flame)
    result, pt = run(
        cfg, profile_dir=args.profile_dir,
        stage_timers=stage_timers,
        record_history=args.record_history or stage_timers,
    )

    if args.flame:
        from medane_tchakorom_ufc_thesis_repository_tpu.utils.report import (
            folded,
            render_flamegraph,
            render_xml,
            render_xml_stylesheet,
        )

        items = pt.items()
        title = f"{cfg.alg} {result.get('grid', '')} stage timers"
        with open(args.flame, "w") as f:
            if args.flame.endswith(".txt"):
                f.write(folded(items))
            elif args.flame.endswith(".xml"):
                # -log_view ::ascii_xml analog: nested-timer XML + the
                # companion XSL next to it (performance_xml2html parity)
                f.write(render_xml(items, title=title))
                import os as _os

                xsl = _os.path.join(
                    _os.path.dirname(_os.path.abspath(args.flame)),
                    "performance_xml2html.xsl")
                with open(xsl, "w") as g:
                    g.write(render_xml_stylesheet())
            else:
                f.write(render_flamegraph(items, title=title))
        print(f"wrote {args.flame}", file=sys.stderr)

    if args.json:
        print(json.dumps(result))
    else:
        print(f"Algorithm          : {result['alg']} ({result['backend']})")
        print(f"Grid               : {result['grid']} ({result['dim']}D)")
        print(f"Initial residual   : {result['rnorm0']:.6e}")
        print(f"Final true residual: {result['final_true_rnorm']:.6e} "
              f"(rel {result['rel_rnorm']:.3e})")
        print(f"Sweeps / cycles    : {result['sweeps']} / {result['cycles']}")
        print(f"Inner iterations   : {result['inner_iters']}")
        print(f"Converged          : {result['converged']}")
        print(f"Elapsed            : {result['elapsed_s']:.4f} s")
        print(f"Error vs u=1       : {result['error_vs_ones']:.6e}")
        if "residual_history" in result:
            print("Residual norms     :")
            for i, h in enumerate(result["residual_history"]):
                print(f"  cycle {i:>4d}: {h:.6e}")
        pt.report()
    return 0 if result["converged"] else 2


if __name__ == "__main__":
    sys.exit(main())
