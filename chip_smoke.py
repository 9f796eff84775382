#!/usr/bin/env python3
"""Smoke test of the solver framework on NVIDIA GPUs, at full size.

    python chip_smoke.py               # phases A-D on one card
    python chip_smoke.py --four-cards  # the sharded paths on four cards,
                                       # each against the same run on one

Phases (one process, entry points called in-process):

A. MG-PCG to 1e-8 on the 3D 512^3 Poisson problem through the CLI
   (``utils.cli.main``), with a host f64 check of the true residual.
B. SMSM_GLOBAL (the thesis's flagship) at 4096^2 through the CLI.
C. ``solve()`` on a structureless sparse matrix (routes to ``AIJ``) and on
   a block-sparse SPD matrix with block-Jacobi (routes to ``BSR``).
D. Every device operation of those paths against a numpy/scipy f64
   reference at real widths, under the default matmul precision.

Each phase prints its wall time and the time spent tracing, lowering and
compiling.  Any failure ends the run with a non-zero exit and no result
line.  Without a GPU, or without the package beside this file, it exits
non-zero before any phase.  The last line of standard output is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "medane_tchakorom_ufc_thesis_repository_tpu"

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


class SmokeFailure(RuntimeError):
    """A phase produced a wrong or unconverged result."""


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def card_line() -> str:
    """The cards as ``nvidia-smi`` names them, with their power limits."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out


class PhaseClock:
    """Wall time of a phase and, apart from it, the seconds JAX spent
    tracing, lowering and compiling inside it."""

    def __init__(self):
        self.compile_s = 0.0
        self.wall_s = 0.0

    def _listen(self, event, duration, **_):
        if event in _COMPILE_EVENTS:
            self.compile_s += duration

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._listen)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import jax

        self.wall_s = time.perf_counter() - self.t0
        jax.monitoring.unregister_event_duration_listener(self._listen)
        return False


def run_cli(argv):
    """``utils.cli.main(argv + ['--json'])`` in-process: (rc, result)."""
    from medane_tchakorom_ufc_thesis_repository_tpu.utils import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--json"])
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    if not lines:
        raise SmokeFailure(f"cli {argv} printed no JSON result")
    res = json.loads(lines[-1])
    brief = {k: v for k, v in res.items() if k != "residual_history"}
    log(f"  cli {' '.join(map(str, argv))}\n    -> rc {rc} {json.dumps(brief)}")
    return rc, res


def _rel_norm(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _rel_max(got, ref) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300))


# ---------------------------------------------------------------------------
# Phase A: MG-PCG + double-float refinement to 1e-8 at 512^3
# ---------------------------------------------------------------------------

def mgpcg_one_card(argv, n: int, rtol: float):
    """The CLI's inner MG-PCG solve for ``argv``, compiled explicitly (for
    its memory analysis) and driven through the same double-float
    refinement to a host f64 solution: (compiled, compile_s, result)."""
    import jax
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import cg
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
        mg_preconditioner,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        df_iterative_refinement,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.utils import cli

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    gop = poisson.poisson3d(n, n, n)
    M = mg_preconditioner(gop)
    solve32 = jax.jit(lambda rr: cg(
        gop.mv, rr, maxiter=cfg.inner_maxiter or 60,
        rtol=cfg.inner_rtol if cfg.inner_rtol is not None else 1e-5,
        precond=M).x)
    t0 = time.perf_counter()
    compiled = solve32.lower(
        jax.ShapeDtypeStruct((n, n, n), jnp.float32)).compile()
    compile_s = time.perf_counter() - t0
    bhi = gop.mv(jnp.ones((n, n, n), jnp.float32))  # A·1: small integers
    rres = df_iterative_refinement(
        gop, None, compiled, rtol=rtol, b_df=(bhi, jnp.zeros_like(bhi)))
    return compiled, compile_s, rres


def host_residual_3d(x64, n: int) -> float:
    """||b - A x|| / ||b|| in f64 on the host for b = A·1 at n^3."""
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        stencil3d_mv_np,
    )

    mv64 = stencil3d_mv_np(n, n, n)
    b64 = mv64(np.ones(n ** 3))
    return float(np.linalg.norm(b64 - mv64(np.reshape(x64, -1)))
                 / np.linalg.norm(b64))


def phase_a(n: int = 512, rtol: float = 1e-8) -> dict:
    import jax
    import numpy as np

    argv = ["--alg", "MGPCG", "--dim", "3", "--m", str(n), "--n", str(n),
            "--nz", str(n), "--rtol", str(rtol)]
    t0 = time.perf_counter()
    rc, res = run_cli(argv)
    cli_wall = time.perf_counter() - t0
    check(rc == 0 and res["converged"], "CLI MG-PCG converged")
    check(res["rel_rnorm"] <= rtol,
          f"CLI df residual {res['rel_rnorm']:.3e} <= {rtol:g}")

    t0 = time.perf_counter()
    compiled, compile_s, rres = mgpcg_one_card(argv, n, rtol)
    solve_s = time.perf_counter() - t0 - compile_s
    mem = compiled.memory_analysis()
    log(f"  inner PCG solve: compile {compile_s:.2f} s; "
        f"memory_analysis {mem}")
    x64 = np.asarray(rres.x, np.float64)
    rel64 = host_residual_3d(x64, n)
    err = float(np.linalg.norm(x64 - 1.0))
    log(f"  refinement: {rres.passes} passes, {solve_s:.3f} s; host f64 "
        f"relative residual {rel64:.3e}; ||x - 1|| = {err:.3e}")
    check(rres.converged and rel64 <= rtol,
          f"host f64 relative residual {rel64:.3e} <= {rtol:g}")
    peak = jax.devices()[0].memory_stats() or {}
    return {"cli_wall_s": cli_wall, "cli_elapsed_s": res["elapsed_s"],
            "passes": int(rres.passes), "rel_f64": rel64,
            "error_vs_ones": err, "inner_compile_s": compile_s,
            "refine_wall_s": solve_s,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "peak_bytes_in_use": peak.get("peak_bytes_in_use")}


# ---------------------------------------------------------------------------
# Phase B: SMSM_GLOBAL at the reference's sweep-envelope size
# ---------------------------------------------------------------------------

def phase_b(m: int = 4096, rtol: float = 1e-3) -> dict:
    rc, res = run_cli(["--alg", "SMSM_GLOBAL", "--m", str(m), "--n", str(m),
                       "--s", "4", "--rtol", str(rtol)])
    log(f"  sweeps {res['sweeps']}, true relative residual "
        f"{res['rel_rnorm']:.3e}")
    check(rc == 0 and res["converged"], "SMSM_GLOBAL converged")
    check(res["rel_rnorm"] <= rtol,
          f"true relative residual {res['rel_rnorm']:.3e} <= {rtol:g}")
    return {"sweeps": res["sweeps"], "rel_rnorm": res["rel_rnorm"],
            "elapsed_s": res["elapsed_s"]}


# ---------------------------------------------------------------------------
# Phase C: the general-sparse user path
# ---------------------------------------------------------------------------

def structureless_spd(n: int = 65536, nnz: int = 655360, seed: int = 7):
    """The structureless pattern of the AIJ cell (random rows/cols from
    ``seed``), symmetrized and shifted to strict diagonal dominance so
    that a Krylov solve converges."""
    import numpy as np
    import scipy.sparse as ssp

    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    A = ssp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
    A = (A + A.T) * 0.5
    d = np.asarray(abs(A).sum(axis=1)).ravel() + 1.0
    return (A + ssp.diags(d)).tocsr()


def block_spd(nb: int = 64, bs: int = 64, seed: int = 5):
    """Block-sparse SPD matrix: well-conditioned dense diagonal blocks and
    two weak symmetric off-diagonal blocks per block row."""
    import numpy as np
    import scipy.sparse as ssp

    rng = np.random.default_rng(seed)
    A = ssp.lil_matrix((nb * bs, nb * bs))
    for k in range(nb):
        Q, _ = np.linalg.qr(rng.standard_normal((bs, bs)))
        lam = np.logspace(0, 2, bs)
        A[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs] = (Q * lam) @ Q.T
        for c in rng.choice(nb, size=2, replace=False):
            if c != k:
                blk = 0.01 * rng.standard_normal((bs, bs))
                A[k * bs:(k + 1) * bs, c * bs:(c + 1) * bs] = blk
                A[c * bs:(c + 1) * bs, k * bs:(k + 1) * bs] = blk.T
    return A.tocsr()


def phase_c(aij_n: int = 65536, aij_nnz: int = 655360, bsr_nb: int = 64,
            bsr_bs: int = 64, rtol: float = 1e-5) -> dict:
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu import solve

    out = {}
    for name, A, kw, want in (
        ("aij", structureless_spd(aij_n, aij_nnz), {}, "AIJ"),
        ("bsr", block_spd(bsr_nb, bsr_bs),
         {"pc": "bjacobi", "pc_block_size": bsr_bs}, "BSR"),
    ):
        b = A @ np.ones(A.shape[0])
        t0 = time.perf_counter()
        x, info = solve(A, b, rtol=rtol, **kw)
        wall = time.perf_counter() - t0
        rel = float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                    / np.linalg.norm(b))
        log(f"  solve() {name}: operator {info['operator']}, "
            f"{info['iters']} iterations, host f64 relative residual "
            f"{rel:.3e}, {wall:.2f} s")
        check(info["operator"] == want, f"{name} routes to {want}")
        check(bool(info["converged"]) and rel <= rtol,
              f"{name} converged to {rel:.3e} <= {rtol:g}")
        out[name] = {"operator": info["operator"], "iters": info["iters"],
                     "rel_f64": rel, "wall_s": wall}
    return out


# ---------------------------------------------------------------------------
# Phase D: device operations against f64 host references
# ---------------------------------------------------------------------------

def _stencil3d_np(g, diag=6.0, off=-1.0):
    import numpy as np

    y = diag * g
    y[1:] += off * g[:-1]
    y[:-1] += off * g[1:]
    y[:, 1:] += off * g[:, :-1]
    y[:, :-1] += off * g[:, 1:]
    y[:, :, 1:] += off * g[:, :, :-1]
    y[:, :, :-1] += off * g[:, :, 1:]
    return np.asarray(y)


def _stencil2d_np(g, diag=4.0, off=-1.0):
    y = diag * g
    y[1:] += off * g[:-1]
    y[:-1] += off * g[1:]
    y[:, 1:] += off * g[:, :-1]
    y[:, :-1] += off * g[:, 1:]
    return y


def phase_d(n3: int = 512, n2: int = 8192, aij_n: int = 65536,
            aij_nnz: int = 655360, bsr_nb: int = 256, bsr_bpr: int = 8,
            bsr_bs: int = 128, seed: int = 0) -> dict:
    """Tolerances, each with its reason:

    * f32 stencil ops: max-abs error <= 2e-6 * max|ref| — a handful of
      f32 roundings on O(1) terms;
    * f32 dots over the grid: <= 1e-5 relative — n-term f32 sums in
      another order than numpy's;
    * bf16 paths: <= 1e-2 relative in the 2-norm — bf16 keeps 8
      significant bits and XLA may round after every operation (each of
      the ~7 roundings is up to 2^-9 of the running sum), so single
      elements can exceed 1e-2 of max|ref| while the vector is accurate
      to a few parts in a thousand;
    * df residual: <= 1e-13 relative to ||r|| — double-float carries
      ~2^-48 relative precision;
    * AIJ / BSR: <= 1e-5 relative — f32 sums in another order.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as ssp

    from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as om
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
        multigrid as mg,
    )

    rng = np.random.default_rng(seed)
    results = {}
    failures = []

    def compare(name, got, ref, tol, err=None):
        e = _rel_max(got, ref) if err is None else err
        ok = bool(np.isfinite(e) and e <= tol)
        log(f"  {'ok  ' if ok else 'FAIL'} {name}: error {e:.3e} "
            f"(tolerance {tol:g})")
        results[name] = e
        if not ok:
            failures.append(name)

    # --- Stencil2D.mv at n2^2 -------------------------------------------
    g2 = rng.random((n2, n2), dtype=np.float32)
    y = jax.jit(om.Stencil2D(n2, n2).mv)(jnp.asarray(g2))
    compare("Stencil2D.mv f32", y, _stencil2d_np(g2.astype(np.float64)),
            2e-6)
    del g2, y

    # --- Stencil3D methods at n3^3 -----------------------------------------
    A = om.Stencil3D(n3, n3, n3)
    w = (6.0 / 7.0) / 6.0
    x32 = rng.random((n3, n3, n3), dtype=np.float32)
    b32 = rng.random((n3, n3, n3), dtype=np.float32)
    x64 = x32.astype(np.float64)
    b64 = b32.astype(np.float64)
    ax64 = _stencil3d_np(x64)
    xd, bd = jnp.asarray(x32), jnp.asarray(b32)

    compare("Stencil3D.mv f32", jax.jit(A.mv)(xd), ax64, 2e-6)
    y, dot = jax.jit(A.mv_dot)(xd)
    compare("Stencil3D.mv_dot f32 (A x)", y, ax64, 2e-6)
    ref_dot = float(np.vdot(x64, ax64))
    compare("Stencil3D.mv_dot f32 (x . A x)", None, None, 1e-5,
            err=abs(float(dot) - ref_dot) / abs(ref_dot))
    sweep64 = x64 + w * (b64 - ax64)
    compare("Stencil3D.jacobi_sweep f32",
            jax.jit(lambda a, c: A.jacobi_sweep(a, c, w))(xd, bd),
            sweep64, 2e-6)
    y, dot = jax.jit(lambda a, c: A.jacobi_sweep_dot(a, c, w))(xd, bd)
    compare("Stencil3D.jacobi_sweep_dot f32 (sweep)", y, sweep64, 2e-6)
    ref_dot = float(np.vdot(b64, sweep64))
    compare("Stencil3D.jacobi_sweep_dot f32 (b . x')", None, None, 1e-5,
            err=abs(float(dot) - ref_dot) / abs(ref_dot))
    compare("Stencil3D.residual f32", jax.jit(A.residual)(xd, bd),
            b64 - ax64, 2e-6)
    del y, sweep64

    # bf16 paths (the MG cycle's precision at HBM scale)
    xb, bb = xd.astype(jnp.bfloat16), bd.astype(jnp.bfloat16)
    xbh = np.asarray(xb.astype(jnp.float32), np.float64)
    bbh = np.asarray(bb.astype(jnp.float32), np.float64)
    axb = _stencil3d_np(xbh)
    compare("Stencil3D.mv bf16", None, None, 1e-2,
            err=_rel_norm(jax.jit(A.mv)(xb), axb))
    compare("Stencil3D.jacobi_sweep bf16", None, None, 1e-2,
            err=_rel_norm(
                jax.jit(lambda a, c: A.jacobi_sweep(a, c, w))(xb, bb),
                xbh + w * (bbh - axb)))
    del xb, bb, xbh, bbh, axb

    # MG transfers at level 0
    h = n3 // 2
    rc = jax.jit(lambda r: mg._restrict(r, (n3, n3, n3)))(xd)
    compare("multigrid restriction f32", rc,
            x64.reshape(h, 2, h, 2, h, 2).mean(axis=(1, 3, 5)), 2e-6)
    e32 = rng.random((h, h, h), dtype=np.float32)
    pe = jax.jit(lambda e: mg._prolong(e, (h, h, h)))(jnp.asarray(e32))
    compare("multigrid prolongation f32", pe,
            np.repeat(np.repeat(np.repeat(e32.astype(np.float64), 2, 0),
                                2, 1), 2, 2), 2e-6)
    del rc, e32, pe

    # double-float residual: x = xhi + xlo exactly in f64
    xlo32 = (rng.random((n3, n3, n3), dtype=np.float32) - 0.5) * np.float32(
        2.0 ** -30)
    blo32 = (rng.random((n3, n3, n3), dtype=np.float32) - 0.5) * np.float32(
        2.0 ** -30)
    xf = x64 + xlo32.astype(np.float64)
    bf = b64 + blo32.astype(np.float64)
    del x64, b64, ax64
    r_ref = bf - _stencil3d_np(xf)
    del xf, bf
    res = df64.stencil3d_df_residual(n3, n3, n3, 6.0, -1.0)
    rhi, rlo = jax.jit(res)((bd, jnp.asarray(blo32)),
                            (xd, jnp.asarray(xlo32)))
    r_dev = np.asarray(rhi, np.float64) + np.asarray(rlo, np.float64)
    compare("df residual (hi, lo)", None, None, 1e-13,
            err=float(np.linalg.norm(r_dev - r_ref) / np.linalg.norm(r_ref)))
    del r_dev, r_ref, rhi, rlo, xd, bd, x32, b32, xlo32, blo32

    # --- AIJ mv / rmv on a structureless nonsymmetric pattern -------------
    ra = np.random.default_rng(7)
    r = ra.integers(0, aij_n, aij_nnz)
    c = ra.integers(0, aij_n, aij_nnz)
    v = ra.standard_normal(aij_nnz)
    S = ssp.coo_matrix((v, (r, c)), shape=(aij_n, aij_n)).tocsr()
    aij = om.AIJ.from_coo(r, c, v, (aij_n, aij_n))
    xa = ra.standard_normal(aij_n).astype(np.float32)
    compare("AIJ.mv f32", jax.jit(lambda o, s: o.mv(s))(aij, jnp.asarray(xa)),
            S @ xa.astype(np.float64), 1e-5)
    compare("AIJ.rmv f32",
            jax.jit(lambda o, s: o.rmv(s))(aij, jnp.asarray(xa)),
            S.T @ xa.astype(np.float64), 1e-5)

    # --- BSR.mv: dense blocks at random block columns ---------------------
    rb = np.random.default_rng(0)
    cols = np.stack([np.sort(rb.choice(bsr_nb, size=bsr_bpr, replace=False))
                     for _ in range(bsr_nb)])
    vals = rb.standard_normal((bsr_nb, bsr_bpr, bsr_bs, bsr_bs)).astype(
        np.float32)
    nrow = bsr_nb * bsr_bs
    bsr = om.BSR(indices=jnp.asarray(cols, jnp.int32),
                 values=jnp.asarray(vals),
                 indices_t=jnp.asarray(cols, jnp.int32),
                 values_t=jnp.asarray(vals), nrows=nrow, ncols=nrow)
    xs = rb.standard_normal(nrow).astype(np.float32)
    # blocks are stored transposed: values[r, w, j, i] = A_blk[i, j]
    xg = xs.astype(np.float64).reshape(bsr_nb, bsr_bs)[cols]
    ref = np.einsum("rwji,rwj->ri", vals.astype(np.float64), xg).reshape(-1)
    compare("BSR.mv f32", jax.jit(lambda o, s: o.mv(s))(bsr, jnp.asarray(xs)),
            ref, 1e-5)

    if failures:
        raise SmokeFailure(f"phase D comparisons failed: {failures}")
    return {"max_error": results}


# ---------------------------------------------------------------------------
# Four cards: the sharded backends against one card
# ---------------------------------------------------------------------------

def _device_set(arr):
    return sorted(d.id for d in arr.sharding.device_set)


def phase_four(m2: int = 4096, n3: int = 512, rtol3: float = 1e-8,
               rtol2: float = 1e-3) -> dict:
    """The reference's decomposition (2 Jacobi blocks x 2 ranks each) on
    ``make_mesh(nblocks=2, intra=2)``, each path against one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from medane_tchakorom_ufc_thesis_repository_tpu.models import blockops
    from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
        ShardedPoisson2D,
        ShardedPoisson3D,
        make_mesh,
        sharded_df_northstar,
        sharded_multisplit_solve,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
        _dirichlet_bounds,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.utils import cli

    mesh = make_mesh(nblocks=2, intra=2)
    ndev = mesh.devices.size
    out = {}

    def memory_in_use():
        return [(d.memory_stats() or {}).get("bytes_in_use")
                for d in mesh.devices.flat]

    # --- SMSM_GLOBAL: sharded vs stacked ----------------------------------
    sm = ["--alg", "SMSM_GLOBAL", "--m", str(m2), "--n", str(m2),
          "--s", "4", "--rtol", str(rtol2)]
    rc1, one = run_cli(sm)
    rc4, four = run_cli(sm + ["--backend", "sharded", "--nblocks", "2",
                              "--intra", "2"])
    check(rc1 == 0 and rc4 == 0 and one["converged"] and four["converged"],
          "SMSM_GLOBAL converged on one card and on four")
    check(four["rel_rnorm"] <= rtol2 and one["rel_rnorm"] <= rtol2,
          f"true residuals {one['rel_rnorm']:.3e} (one) / "
          f"{four['rel_rnorm']:.3e} (four) <= {rtol2:g}")
    check(abs(four["sweeps"] - one["sweeps"]) <= max(1, one["sweeps"] // 20),
          f"sweeps {one['sweeps']} (one) vs {four['sweeps']} (four)")
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        sm + ["--backend", "sharded", "--nblocks", "2", "--intra", "2"]))
    opcfg = ShardedPoisson2D(m2, m2)
    b = blockops.rhs_ones(blockops.block_poisson2d(m2, m2, 2), jnp.float32)
    res = sharded_multisplit_solve(
        mesh, opcfg, b.reshape(opcfg.global_shape), schedule=cfg.schedule,
        minimization=cfg.minimization, s=cfg.s, rtol=cfg.rtol,
        atol=cfg.atol, maxiter=cfg.maxiter, inner=cfg.inner_config(),
        outer=cfg.outer_config(),
        min_convergence_count=cfg.min_convergence_count,
        basis_collection=cfg.basis_collection)
    jax.block_until_ready(res.x)
    ds = _device_set(res.x)
    log(f"  SMSM_GLOBAL solution sharding device_set {ds}; "
        f"bytes in use per card {memory_in_use()}")
    check(len(ds) == ndev == 4, "SMSM_GLOBAL shards sit on four cards")
    out["smsm"] = {"sweeps_one": one["sweeps"], "sweeps_four": four["sweeps"],
                   "rel_one": one["rel_rnorm"], "rel_four": four["rel_rnorm"],
                   "elapsed_one_s": one["elapsed_s"],
                   "elapsed_four_s": four["elapsed_s"]}

    # --- MG-PCG north-star: sharded vs one card ---------------------------
    mg = ["--alg", "MGPCG", "--dim", "3", "--m", str(n3), "--n", str(n3),
          "--nz", str(n3), "--rtol", str(rtol3)]
    rc1, one = run_cli(mg)
    rc4, four = run_cli(mg + ["--backend", "sharded", "--nblocks", "2",
                              "--intra", "2"])
    check(rc1 == 0 and rc4 == 0 and one["converged"] and four["converged"],
          "MG-PCG converged on one card and on four")
    check(one["rel_rnorm"] <= rtol3 and four["rel_rnorm"] <= rtol3,
          f"df residuals {one['rel_rnorm']:.3e} (one) / "
          f"{four['rel_rnorm']:.3e} (four) <= {rtol3:g}")
    cfg = cli.config_from_args(cli.build_parser().parse_args(mg))
    inner_rtol = cfg.inner_rtol if cfg.inner_rtol is not None else 1e-5
    maxit = cfg.inner_maxiter or 60
    rres4 = sharded_df_northstar(mesh, ShardedPoisson3D(n3, n3, n3),
                                 rtol=rtol3, inner_rtol=inner_rtol,
                                 pcg_maxiter=maxit)
    ds = _device_set(rres4.x[0])
    log(f"  MG-PCG solution sharding device_set {ds}; "
        f"bytes in use per card {memory_in_use()}")
    check(len(ds) == 4, "MG-PCG shards sit on four cards")
    x4 = df64.df_to_f64(rres4.x).reshape(-1)
    _, _, rres1 = mgpcg_one_card(mg, n3, rtol3)
    x1 = np.asarray(rres1.x, np.float64).reshape(-1)
    rel4 = host_residual_3d(x4, n3)
    rel1 = host_residual_3d(x1, n3)
    lmin, lmax = _dirichlet_bounds((n3, n3, n3), 6.0, -1.0)
    bound = 2.0 * (lmax / lmin) * rtol3   # both meet rtol: ||dx|| <= 2 k rtol
    dx = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    log(f"  host f64 residuals: four {rel4:.3e}, one {rel1:.3e}; passes "
        f"four {rres4.passes} / one {rres1.passes}; "
        f"||x4 - x1|| / ||x1|| = {dx:.3e} (bound {bound:.3e})")
    check(rel4 <= rtol3 and rel1 <= rtol3, "both solutions meet rtol in f64")
    check(dx <= bound, "four-card solution matches one card")
    out["mgpcg"] = {"passes_one": one.get("refine_passes"),
                    "passes_four": four.get("refine_passes"),
                    "rel_f64_one": rel1, "rel_f64_four": rel4,
                    "dx": dx, "elapsed_one_s": one["elapsed_s"],
                    "elapsed_four_s": four["elapsed_s"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on four cards, each "
                         "against the same run on one card")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    need = 4 if args.four_cards else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} NVIDIA GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the package {PKG} is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from medane_tchakorom_ufc_thesis_repository_tpu import native
    from medane_tchakorom_ufc_thesis_repository_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    log(f"compile cache: {enable_compile_cache()}")
    log("native host library: " + ("built with g++" if native.load()
                                   is not None else "numpy fallback"))
    card = card_line()
    log(f"jax {jax.__version__}")

    phases = ([("four-cards", phase_four)] if args.four_cards else
              [("A", phase_a), ("B", phase_b), ("C", phase_c),
               ("D", phase_d)])
    for name, fn in phases:
        log(f"[phase {name}] card: {card}; devices: {jax.devices()}")
        with PhaseClock() as clock:
            summary = fn()
        log("PHASE " + json.dumps({
            "phase": name, "wall_s": round(clock.wall_s, 3),
            "compile_s": round(clock.compile_s, 3), **summary}, default=str))
    log(card)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
