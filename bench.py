"""Benchmark entry point — run on an NVIDIA GPU.

Prints the device (platform, kind, count, and the card's name and power
limit as ``nvidia-smi`` gives them), then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Primary metric (BASELINE.json): 3D Poisson 7-point SpMV throughput per
device in nnz/s.  The reference publishes no numbers (BASELINE.md), so
``vs_baseline`` is computed against an estimated PETSc MatMult rate on the
reference's laptop/Grid'5000 class hardware: a 7-point AIJ SpMV streams
~20 bytes/nnz and a 2-socket node sustains ~40 GB/s => ~2e9 nnz/s.  That
constant is recorded here so the comparison is reproducible.

Secondary metrics (same JSON object): time and sweeps for an SMSM_GLOBAL
multisplitting solve of 3D Poisson to 1e-5 relative residual, GMRES and
CA-GMRES baselines on the same system, the general-sparse BSR and AIJ
SpMV rates, the ``solve()`` user path, and the north-star 3D Poisson
solves to 1e-8 at 64^3, 256^3 and 512^3.

Exits non-zero without a GPU: no number here is measured on the CPU.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

REFERENCE_SPMV_NNZ_PER_S = 2.0e9  # estimated PETSc MatMult on 2-socket CPU


def _fence(arr):
    import jax

    return jax.block_until_ready(arr)


def _time_ondevice_chain(step, x, iters=200, warmup=1):
    """Time ``iters`` chained applications of ``step`` inside ONE jitted
    ``fori_loop`` — a single dispatch, so dispatch latency cannot pollute
    per-op timing, and the chain dependency defeats any result caching."""
    import jax
    from jax import lax

    @jax.jit
    def chain(v):
        return lax.fori_loop(0, iters, lambda i, s: step(s), v)

    for _ in range(warmup):
        _fence(chain(x))
    t0 = time.perf_counter()
    _fence(chain(x))
    return (time.perf_counter() - t0) / iters


def _slope_time(step, x, i1=100, i2=300, reps=3):
    """Honest per-apply cost: slope between two chained-loop lengths.

    Subtracts every fixed cost (dispatch, fence) by construction.
    ``lax.optimization_barrier`` between iterations stops XLA fusing
    consecutive applies into one pass (an unbarriered axpy chain
    collapses to one read+write).
    """
    import jax
    from jax import lax

    def make(iters):
        @jax.jit
        def chain(v):
            return lax.fori_loop(
                0, iters,
                lambda i, s: lax.optimization_barrier(step(s)), v
            )
        return chain

    c1, c2 = make(i1), make(i2)
    _fence(c1(x))
    _fence(c2(x))

    def best(c):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _fence(c(x))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return (best(c2) - best(c1)) / (i2 - i1)


def _device() -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py: needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": card}


def main():
    import jax
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    device = _device()
    print(json.dumps({"device": device}), flush=True)
    enable_compile_cache()

    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu.models import (
        blockops,
        multisplitting as ms,
    )

    # --- primary: 3D Poisson stencil SpMV nnz/s per device -------------
    # Grid-shaped state, barriered-slope timing (see _slope_time).
    nx = ny = nz = 256
    op = poisson.poisson3d(nx, ny, nz)
    x = jnp.ones((nx, ny, nz), jnp.float32)
    # scale by 1/8 each application (spectral radius < 8) so the chained
    # values stay bounded; the scalar multiply fuses into the stencil pass
    dt = _slope_time(lambda v: op.mv(v) * jnp.float32(0.125), x)
    nnz_per_s = op.nnz / dt

    # A pure r1w1 axpy over the same array under the same method: the
    # measured streaming rate SpMV could reach with zero extra traffic
    dt_axpy = _slope_time(
        lambda v: v * jnp.float32(1.0001) + jnp.float32(0.5), x
    )
    nbytes = x.size * x.dtype.itemsize
    stream_gb_s = 2 * nbytes / dt_axpy / 1e9
    # a 7-point stencil must move >= one read + one write of the array
    spmv_min_traffic_gb_s = 2 * nbytes / dt / 1e9
    spmv_axpy_units = dt / dt_axpy

    # 512^3 (537 MB/vector): the large-problem SpMV rate per device
    op512 = poisson.poisson3d(512, 512, 512)
    x512 = jnp.ones((512, 512, 512), jnp.float32)
    dt512 = _slope_time(
        lambda v: op512.mv(v) * jnp.float32(0.125), x512, i1=20, i2=60
    )
    nnz512_per_s = op512.nnz / dt512

    # --- general-sparse (AIJ-parity) SpMV: BSR block-ELL -----------------
    # random block-sparse matrix (dense 128x128 blocks at random block
    # positions, 33.5M values): block-row gathers + batched sub-block
    # matvecs — the unstructured-sparsity path (core.operators.BSR).
    # Structure-only build (pack correctness pinned in tests/test_bsr.py).
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        BSR,
    )
    import numpy as _bnp

    _rngb = _bnp.random.default_rng(0)
    _nb, _bs, _bpr = 256, 128, 8
    _cols = _bnp.stack([
        _bnp.sort(_rngb.choice(_nb, size=_bpr, replace=False))
        for _ in range(_nb)
    ])
    _bvals = _rngb.standard_normal((_nb, _bpr, _bs, _bs)).astype(_bnp.float32)
    bsr = BSR(
        indices=jnp.asarray(_cols, jnp.int32), values=jnp.asarray(_bvals),
        indices_t=jnp.asarray(_cols, jnp.int32),
        values_t=jnp.asarray(_bvals),
        nrows=_nb * _bs, ncols=_nb * _bs,
    )
    xb = jnp.asarray(_rngb.standard_normal(_nb * _bs), jnp.float32)
    _bsr_nnz = _nb * _bpr * _bs * _bs
    dt_bsr = _slope_time(
        lambda v: bsr.mv(v) * jnp.float32(0.125), xb, i1=20, i2=60
    )
    bsr_nnz_per_s = _bsr_nnz / dt_bsr

    # --- structureless AIJ SpMV: Clos-routed gather ----------------------
    # random pattern, NO band/block structure — the PETSc-AIJ capability
    # case.
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        AIJ,
    )

    _ra = _bnp.random.default_rng(7)
    _an, _annz = 65536, 655360
    aij = AIJ.from_coo(
        _ra.integers(0, _an, _annz), _ra.integers(0, _an, _annz),
        _ra.standard_normal(_annz), (_an, _an), with_rmv=False,
    )
    xa = jnp.asarray(_ra.standard_normal(_an), jnp.float32)
    dt_aij = _slope_time(
        lambda v: aij.mv(v) * jnp.float32(1e-3), xa, i1=30, i2=90
    )
    aij_nnz_per_s = aij.nnz / dt_aij

    # --- secondary: SMSM_GLOBAL solve of 3D Poisson to 1e-5 -------------
    # CHEBYSHEV inner solves (analytic Dirichlet strip bounds, a pure
    # matvec chain — no dots, no Givens)
    sop = blockops.block_poisson3d(64, 64, 64)
    b = blockops.rhs_ones(sop, jnp.float32)
    solve = jax.jit(
        lambda bb: ms.smsm(
            sop, bb, scope="global", s=4, rtol=1e-5, maxiter=400,
            inner=ms.InnerConfig(method="chebyshev", maxiter=20),
        )
    )
    res = solve(b)  # compile + run
    _fence(res.x)
    b2 = b * jnp.float32(1.0 + 1e-6)  # distinct input defeats result caching
    t0 = time.perf_counter()
    res = solve(b2)
    _fence(res.x)
    solve_s = time.perf_counter() - t0
    rel = float(
        jnp.linalg.norm(b.reshape(-1) - sop.global_mv(res.x.reshape(-1)))
        / res.rnorm0
    )
    # continuity metric: the round-1..4 gmres-inner config
    solve_g = jax.jit(
        lambda bb: ms.smsm(
            sop, bb, scope="global", s=4, rtol=1e-5, maxiter=400,
            inner=ms.InnerConfig(restart=30, maxiter=30, rtol=1e-8),
        )
    )
    res_g = solve_g(b)
    _fence(res_g.x)
    t0 = time.perf_counter()
    res_g = solve_g(b2)
    _fence(res_g.x)
    solve_gmres_s = time.perf_counter() - t0

    # --- secondary: GMRES baseline on the same 3D system ----------------
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers import gmres

    gop = poisson.poisson3d(64, 64, 64)
    gb = poisson.rhs_for_exact_ones(gop)
    gsolve = jax.jit(
        lambda bb: gmres(gop.mv, bb, restart=30, maxiter=3000, rtol=1e-6)
    )
    gres = gsolve(gb)
    _fence(gres.x)
    gb2 = gb * jnp.float32(1.0 + 1e-6)
    t0 = time.perf_counter()
    gres = gsolve(gb2)
    _fence(gres.x)
    gmres_s = time.perf_counter() - t0

    # --- CA-GMRES on the same 3D system: s-step Newton basis, ONE Gram
    # reduction per s matvecs (the communication-avoiding baseline;
    # analytic Poisson spectral interval) --------------------------------
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.castep import (
        ca_gmres,
    )
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.chebyshev import (
        poisson_strip_eig_bounds_3d,
    )

    clmin, clmax = poisson_strip_eig_bounds_3d(64, 64, 64)
    casolve = jax.jit(
        lambda bb: ca_gmres(gop.mv, bb, s=16, maxiter=3000, rtol=1e-6,
                            lmin=clmin, lmax=clmax)
    )
    cres = casolve(gb)
    _fence(cres.x)
    t0 = time.perf_counter()
    cres = casolve(gb2)
    _fence(cres.x)
    ca_gmres_s = time.perf_counter() - t0

    # --- one-call routed solve: the AIJ user path end-to-end ------------
    # scipy block-sparse SPD matrix -> from_scipy routes to BSR ->
    # block-Jacobi right-PC GMRES.  Wall time includes routing, PC
    # factorization, tracing, and the solve — the whole user experience.
    from medane_tchakorom_ufc_thesis_repository_tpu import solve as _solve
    import scipy.sparse as _ssp

    _rs = _bnp.random.default_rng(5)
    _snb, _sbs = 64, 64
    _sA = _ssp.lil_matrix((_snb * _sbs, _snb * _sbs))
    for _k in range(_snb):
        _Q, _ = _bnp.linalg.qr(_rs.standard_normal((_sbs, _sbs)))
        _lam = _bnp.logspace(0, 2, _sbs)
        _sA[_k * _sbs:(_k + 1) * _sbs, _k * _sbs:(_k + 1) * _sbs] = (
            (_Q * _lam) @ _Q.T
        )
        for _c in _rs.choice(_snb, size=2, replace=False):
            if _c != _k:
                _blk = 0.01 * _rs.standard_normal((_sbs, _sbs))
                _sA[_k * _sbs:(_k + 1) * _sbs,
                    _c * _sbs:(_c + 1) * _sbs] = _blk
                _sA[_c * _sbs:(_c + 1) * _sbs,
                    _k * _sbs:(_k + 1) * _sbs] = _blk.T
    _sA = _sA.tocsr()
    _sb = _bnp.asarray(_sA @ _bnp.ones(_sA.shape[0]))
    t0 = time.perf_counter()
    _sx, _sinfo = _solve(_sA, _sb, rtol=1e-5, pc="bjacobi",
                         pc_block_size=_sbs)
    solve_api_s = time.perf_counter() - t0
    # warm repeat on a PERTURBED matrix (same shape/config): the jitted
    # solver program is cached, so this is the serving-pattern cost —
    # routing + PC factorization + one warm dispatch
    _sA2 = (_sA + _ssp.eye(_sA.shape[0]) * 0.01).tocsr()
    _sb2 = _bnp.asarray(_sA2 @ _bnp.ones(_sA2.shape[0]))
    t0 = time.perf_counter()
    _sx2, _sinfo2 = _solve(_sA2, _sb2, rtol=1e-5, pc="bjacobi",
                           pc_block_size=_sbs)
    solve_api_warm_s = time.perf_counter() - t0

    # --- north-star: 3D Poisson to 1e-8 relative residual --------------
    # (BASELINE.json: "wall-time + iters to 1e-8 residual on 3D Poisson")
    # f32 device solves + f64 host residuals via iterative refinement
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        iterative_refinement,
        stencil3d_mv_np,
    )
    import numpy as _np

    mv64 = stencil3d_mv_np(64, 64, 64)
    b64 = mv64(_np.ones(64 ** 3))
    refine_solve = jax.jit(
        lambda rr: gmres(gop.mv, rr, restart=30, maxiter=3000, rtol=1e-5).x
    )
    _ = refine_solve(jnp.asarray(b64 / _np.linalg.norm(b64), jnp.float32))
    _fence(_)
    t0 = time.perf_counter()
    rres_host = iterative_refinement(refine_solve, mv64, b64, rtol=1e-8)
    refine_host_s = time.perf_counter() - t0

    # the SHIPPED 64^3 recipe: the same single-dispatch fused MG-PCG +
    # double-float refinement program used at 256^3/512^3 below — the
    # host-loop GMRES number above stays as a secondary (observability
    # driver) metric
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        df_northstar_fused as _df_fused,
    )

    def _median_of(fn, reps=3):
        """Median wall time over ``reps`` runs, and the last result."""
        ts, res = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            res = fn()
            _fence(res.x[0])
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2], res

    b64hi = gop.mv(jnp.ones((64, 64, 64), jnp.float32))  # exact integers
    b64_df = (b64hi, jnp.zeros_like(b64hi))
    _df_fused(gop, b64_df, rtol=1e-8)  # compile
    refine_s, rres = _median_of(lambda: _df_fused(gop, b64_df, rtol=1e-8))

    # --- north-star at scale: 3D 256^3 (16.8M unknowns) to 1e-8 ---------
    # Single-dispatch fused program (solvers/refine.df_northstar_fused):
    # W-cycle-preconditioned f32 CG + DOUBLE-FLOAT residual refinement
    # (two-f32 error-free transforms, solvers/df64.py), the whole pass
    # loop inside ONE lax.while_loop — only final scalars reach the host.
    # b = A·1 has small-integer entries, exactly representable on device.
    from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
        df_northstar_fused,
    )

    def _northstar(opx, b_df):
        df_northstar_fused(opx, b_df, rtol=1e-8, inner_rtol=1e-4)  # compile
        return _median_of(lambda: df_northstar_fused(
            opx, b_df, rtol=1e-8, inner_rtol=1e-4))

    b256hi = op.mv(jnp.ones((nx, ny, nz), jnp.float32))  # exact (integers)
    b256_df = (b256hi, jnp.zeros_like(b256hi))
    refine256_s, rres256 = _northstar(op, b256_df)

    # --- north-star at 512^3 (134M unknowns, 537 MB per f32 array) -------
    b512hi = op512.mv(jnp.ones((512, 512, 512), jnp.float32))
    b512_df = (b512hi, jnp.zeros_like(b512hi))
    refine512_s, rres512 = _northstar(op512, b512_df)

    # measured CPU reference on this host: scipy CSR SpMV (the PETSc-AIJ
    # class of kernel the reference runs), single thread
    cpu_nnz_per_s = None
    try:
        import numpy as _np
        import scipy.sparse as _sp

        rows, cols, vals, shape = poisson.poisson3d_coo(128, 128, 128)
        A = _sp.csr_matrix((vals, (rows, cols)), shape=shape)
        xc = _np.ones(shape[0])
        xc = A @ xc
        t0 = time.perf_counter()
        for _ in range(10):
            xc = A @ xc * 0.125
        cpu_nnz_per_s = A.nnz / ((time.perf_counter() - t0) / 10)
    except Exception:
        pass

    print(json.dumps({
        "metric": "3d_poisson_spmv_throughput_per_device",
        "device": device,
        "value": round(nnz_per_s / 1e9, 3),
        "unit": "Gnnz/s",
        "vs_baseline": round(nnz_per_s / REFERENCE_SPMV_NNZ_PER_S, 2),
        "measured_cpu_csr_gnnz_per_s": (
            round(cpu_nnz_per_s / 1e9, 3) if cpu_nnz_per_s else None
        ),
        "vs_measured_cpu_core": (
            round(nnz_per_s / cpu_nnz_per_s, 1) if cpu_nnz_per_s else None
        ),
        "spmv_grid": f"{nx}x{ny}x{nz}",
        "spmv_ms": round(dt * 1e3, 4),
        "stream_axpy_ms": round(dt_axpy * 1e3, 4),
        "stream_ceiling_gb_s": round(stream_gb_s, 1),
        "spmv_min_traffic_gb_s": round(spmv_min_traffic_gb_s, 1),
        "spmv_cost_in_axpy_units": round(spmv_axpy_units, 2),
        "spmv_hbm_512_ms": round(dt512 * 1e3, 4),
        "spmv_hbm_512_gnnz_per_s": round(nnz512_per_s / 1e9, 3),
        "bsr_blocksparse_gnnz_per_s": round(bsr_nnz_per_s / 1e9, 3),
        "bsr_values_read_gb_s": round(
            (_nb * _bpr * _bs * _bs) * 4 / dt_bsr / 1e9, 1
        ),
        "aij_structureless_65536_gnnz_per_s": round(
            aij_nnz_per_s / 1e9, 3),
        "aij_fill": round(aij.fill, 2),
        "smsm_global_3d_64_solve_s": round(solve_s, 3),
        "smsm_global_3d_64_inner": "chebyshev(20)",
        "smsm_global_3d_64_gmres_inner_s": round(solve_gmres_s, 3),
        "smsm_global_3d_64_sweeps": int(res.sweeps),
        "smsm_global_3d_64_rel_residual": f"{rel:.2e}",
        "smsm_global_3d_64_converged": bool(res.converged),
        "gmres_3d_64_solve_s": round(gmres_s, 3),
        "gmres_3d_64_iters": int(gres.iters),
        "ca_gmres_s16_3d_64_solve_s": round(ca_gmres_s, 3),
        "ca_gmres_s16_3d_64_iters": int(cres.iters),
        "ca_gmres_s16_3d_64_converged": bool(cres.converged),
        "solve_api_bsr_bjacobi_end_to_end_s": round(solve_api_s, 3),
        "solve_api_warm_repeat_s": round(solve_api_warm_s, 3),
        "solve_api_warm_converged": bool(_sinfo2["converged"]),
        "solve_api_operator": _sinfo["operator"],
        "solve_api_iters": _sinfo["iters"],
        "solve_api_rel_residual": f"{_sinfo['rel_residual']:.2e}",
        "solve_api_converged": bool(_sinfo["converged"]),
        "northstar_3d_64_to_1e8_s": round(refine_s, 3),
        "northstar_3d_64_rel_residual": f"{rres.rnorm / rres.rnorm0:.2e}",
        "northstar_3d_64_refine_passes": rres.passes,
        "northstar_3d_64_converged": bool(rres.converged),
        "northstar_3d_64_hostloop_gmres_s": round(refine_host_s, 3),
        "northstar_3d_64_hostloop_converged": bool(rres_host.converged),
        "northstar_3d_256_to_1e8_s": round(refine256_s, 3),
        "northstar_3d_256_rel_residual": (
            f"{rres256.rnorm / rres256.rnorm0:.2e}"
        ),
        "northstar_3d_256_refine_passes": rres256.passes,
        "northstar_3d_256_converged": bool(rres256.converged),
        "northstar_3d_512_to_1e8_s": round(refine512_s, 3),
        "northstar_3d_512_rel_residual": (
            f"{rres512.rnorm / rres512.rnorm0:.2e}"
        ),
        "northstar_3d_512_converged": bool(rres512.converged),
    }))


if __name__ == "__main__":
    main()
