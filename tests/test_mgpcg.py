"""Sharded MG-PCG + double-float refinement (parallel/mgpcg.py).

The multi-chip north-star path: multigrid-preconditioned CG over the
('block', 'intra') mesh with df residual refinement — the sharded twin
of the bench.py 256^3/512^3 north-star recipe (BASELINE.json wall-time
to 1e-8 on 3D Poisson).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
    ShardedPoisson2D,
    ShardedPoisson3D,
)
from medane_tchakorom_ufc_thesis_repository_tpu.parallel import mgpcg
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.krylov import cg
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.multigrid import (
    mg_preconditioner,
)
from medane_tchakorom_ufc_thesis_repository_tpu.solvers.refine import (
    stencil3d_mv_np,
)


class TestPlan:
    def test_levels_stop_at_one_plane_per_device(self):
        plan = mgpcg.plan_sharded(ShardedPoisson3D(64, 64, 64), 8)
        # 64/8 = 8 local planes: 8 -> 4 -> 2 -> 1, stop (x cannot halve)
        assert plan.dims == (
            (64, 64, 64), (32, 32, 32), (16, 16, 16), (8, 8, 8))

    def test_levels_respect_min_size(self):
        plan = mgpcg.plan_sharded(ShardedPoisson2D(64, 8), 2, min_size=4)
        # n: 8 -> 4 then 4//2 < min_size stops further coarsening
        assert plan.dims == ((64, 8), (32, 4))

    def test_indivisible_grid_raises(self):
        with pytest.raises(ValueError, match="not divisible"):
            mgpcg.plan_sharded(ShardedPoisson3D(12, 16, 16), 8)


class TestShardedMGPCG:
    def test_3d_matches_single_device_pcg_iterations(self, mesh8):
        """Same math, different layout: the sharded MG-PCG must take the
        same iteration count (+-1 roundoff) as the single-device
        cg(precond=mg_preconditioner) on the identical problem."""
        op = ShardedPoisson3D(32, 32, 32)
        b = poisson.rhs_for_exact_ones(
            poisson.poisson3d(32, 32, 32)
        ).astype(jnp.float32).reshape(32, 32, 32)
        res = mgpcg.sharded_mgpcg_solve(mesh8, op, b, rtol=1e-5, maxiter=40)
        assert bool(res.converged)

        gop = poisson.poisson3d(32, 32, 32)
        ref = cg(gop.mv, b, rtol=1e-5, maxiter=40,
                 precond=mg_preconditioner(gop))
        assert abs(int(res.iters) - int(ref.iters)) <= 1
        # true residual at the f32 attainable-accuracy floor
        r = np.asarray(b) - np.asarray(gop.mv(res.x))
        assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b)) < 5e-5

    def test_2d_converges_grid_independent(self, mesh8):
        iters = []
        for m in (32, 64):
            op = ShardedPoisson2D(m, m)
            b = jnp.asarray(
                np.random.RandomState(0).rand(m, m), jnp.float32)
            res = mgpcg.sharded_mgpcg_solve(
                mesh8, op, b, rtol=1e-5, maxiter=40)
            assert bool(res.converged)
            iters.append(int(res.iters))
        # MG-preconditioned iteration counts must not grow with the grid
        assert iters[1] <= iters[0] + 2


class TestAgglomerator:
    @pytest.mark.parametrize("which", ["strip", "tile"])
    def test_gather_slice_roundtrip(self, which, mesh8):
        """slice_local(gather(g)) must be the identity on every device's
        tile — the correctness core of coarse-grid agglomeration."""
        import jax
        from jax import shard_map  # jax>=0.8 home (was jax.experimental)
        from jax.sharding import NamedSharding

        if which == "strip":
            mesh = mesh8
            splits = (8, 1, 1)
        else:
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
                make_tiled_mesh,
            )

            mesh = make_tiled_mesh(2, 2, 2)
            splits = (4, 2, 1)
        dims = (8, 8, 4)
        local = tuple(d // s for d, s in zip(dims, splits))
        gather, slice_local = mgpcg._make_agglomerator(mesh, splits)
        spec = mgpcg._grid_spec(mesh, 3)

        g = jnp.asarray(
            np.arange(np.prod(dims), dtype=np.float32).reshape(dims))
        g_sh = jax.device_put(g, NamedSharding(mesh, spec))

        def body(x):
            return slice_local(gather(x), local)

        out = shard_map(
            body, mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False,
        )(g_sh)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(g))


class TestDFSlabResidual:
    def test_matches_host_f64(self, mesh8):
        """The halo-corrected df slab residual must agree with the exact
        host f64 residual to ~double-float precision."""
        rng = np.random.RandomState(7)
        nx = ny = nz = 16
        x64 = rng.rand(nx, ny, nz)
        b64 = rng.rand(nx, ny, nz)
        op = ShardedPoisson3D(nx, ny, nz)

        from jax.sharding import NamedSharding, PartitionSpec as P
        import jax

        spec = P(("block", "intra"), None, None)
        put = lambda a: jax.device_put(a, NamedSharding(mesh8, spec))
        bhi, blo = df64.df_from_f64(b64)
        xhi, xlo = df64.df_from_f64(x64)

        diag, off = float(op.diag), float(op.off)
        _mv, halos, _sweep = mgpcg._make_halo_mv(mesh8, diag, off)
        from jax import shard_map  # jax>=0.8 home (was jax.experimental)

        def body(bh, bl, xh, xl):
            (th, bh_), = halos(xh)
            (tl, bl_), = halos(xl)
            return mgpcg._df_slab_residual(
                (bh, bl), (xh, xl), (th, tl), (bh_, bl_), diag, off)

        rhi, rlo = shard_map(
            body, mesh=mesh8, in_specs=(spec,) * 4,
            out_specs=(spec, spec), check_vma=False,
        )(put(bhi), put(blo), put(xhi), put(xlo))

        mv64 = stencil3d_mv_np(nx, ny, nz)
        r_exact = (b64.reshape(-1) - mv64(x64.reshape(-1))).reshape(
            nx, ny, nz)
        r_df = (np.asarray(rhi, np.float64)
                + np.asarray(rlo, np.float64))
        err = np.abs(r_df - r_exact).max() / np.abs(r_exact).max()
        assert err < 1e-13, err


class TestFusedShardedNorthstar:
    @pytest.mark.parametrize("which", ["strip", "tile"])
    def test_single_dispatch(self, which, mesh8):
        """sharded_df_northstar_fused: the whole multi-chip north-star in
        ONE jitted SPMD program — must match the host-loop driver and the
        exact-ones solution, host-f64-verified."""
        if which == "strip":
            mesh = mesh8
        else:
            from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
                make_tiled_mesh,
            )

            mesh = make_tiled_mesh(2, 2, 2)
        nx = ny = nz = 16
        op = ShardedPoisson3D(nx, ny, nz)
        res = mgpcg.sharded_df_northstar_fused(mesh, op, rtol=1e-8)
        assert res.converged
        assert res.passes <= 3
        x64 = df64.df_to_f64(res.x)
        mv64 = stencil3d_mv_np(nx, ny, nz)
        b64 = mv64(np.ones(nx * ny * nz))
        rel = (np.linalg.norm(b64 - mv64(x64.reshape(-1)))
               / np.linalg.norm(b64))
        assert rel <= 1e-8, rel
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)


class TestTiledMGPCG:
    """The same solvers over the 2-D-tiled ('block','ir','ic') mesh —
    perimeter halos (parallel/tiled.py layout)."""

    @pytest.fixture(scope="class")
    def tmesh(self):
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
            make_tiled_mesh,
        )

        return make_tiled_mesh(2, 2, 2)  # 2 blocks x 2 row x 2 col tiles

    def test_plan_respects_both_split_axes(self, tmesh):
        plan = mgpcg.plan_sharded(
            ShardedPoisson3D(32, 32, 32),
            mgpcg._axis_splits(tmesh, 3),
        )
        # rows_loc (4-way split): 8->4->2, stops when halving would give
        # a fractional plane; cols_loc (2-way): 16->8->4 (not binding)
        assert plan.dims == (
            (32, 32, 32), (16, 16, 16), (8, 8, 8), (4, 4, 4))

    def test_3d_matches_strip_mesh(self, mesh8, tmesh):
        """Identical math on both mesh topologies: same iteration count
        and the same solution (different collective pattern only)."""
        op = ShardedPoisson3D(32, 32, 32)
        b = jnp.asarray(
            np.random.RandomState(3).rand(32, 32, 32), jnp.float32)
        res_t = mgpcg.sharded_mgpcg_solve(tmesh, op, b, rtol=1e-5,
                                          maxiter=40)
        res_s = mgpcg.sharded_mgpcg_solve(mesh8, op, b, rtol=1e-5,
                                          maxiter=40)
        assert bool(res_t.converged)
        assert abs(int(res_t.iters) - int(res_s.iters)) <= 1
        np.testing.assert_allclose(
            np.asarray(res_t.x), np.asarray(res_s.x), rtol=2e-4, atol=2e-5)

    def test_northstar_column_only_split(self):
        """Regression: a tiled mesh whose LEADING axis is unsplit
        (block*ir == 1, ic > 1) must still feed the column halos into
        the df residual — the positional pairing by count-of-splits
        silently dropped them and certified a wrong-operator residual."""
        from medane_tchakorom_ufc_thesis_repository_tpu.parallel.tiled import (
            make_tiled_mesh,
        )

        mesh = make_tiled_mesh(1, 1, 2)
        nx = ny = nz = 16
        op = ShardedPoisson3D(nx, ny, nz)
        res = mgpcg.sharded_df_northstar(mesh, op, rtol=1e-8)
        assert res.converged
        x64 = df64.df_to_f64(res.x)
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)
        mv64 = stencil3d_mv_np(nx, ny, nz)
        b64 = mv64(np.ones(nx * ny * nz))
        rel = (np.linalg.norm(b64 - mv64(x64.reshape(-1)))
               / np.linalg.norm(b64))
        assert rel <= 1e-8, rel

    def test_northstar_tiled(self, tmesh):
        nx = ny = nz = 16
        op = ShardedPoisson3D(nx, ny, nz)
        res = mgpcg.sharded_df_northstar(tmesh, op, rtol=1e-8)
        assert res.converged
        x64 = df64.df_to_f64(res.x)
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)

        mv64 = stencil3d_mv_np(nx, ny, nz)
        b64 = mv64(np.ones(nx * ny * nz))
        rel = (np.linalg.norm(b64 - mv64(x64.reshape(-1)))
               / np.linalg.norm(b64))
        assert rel <= 1e-8, rel


class TestShardedNorthstar:
    def test_3d_to_1e8(self, mesh8):
        """The full multi-chip north-star: b = A·1 on-mesh, MG-PCG +
        df refinement to 1e-8 relative TRUE residual, verified on the
        host in f64 against the exact operator."""
        nx = ny = nz = 32
        op = ShardedPoisson3D(nx, ny, nz)
        res = mgpcg.sharded_df_northstar(mesh8, op, rtol=1e-8)
        assert res.converged
        assert res.passes <= 3
        x64 = df64.df_to_f64(res.x)
        np.testing.assert_allclose(x64, 1.0, atol=1e-7)

        mv64 = stencil3d_mv_np(nx, ny, nz)
        b64 = mv64(np.ones(nx * ny * nz))
        rel = (np.linalg.norm(b64 - mv64(x64.reshape(-1)))
               / np.linalg.norm(b64))
        assert rel <= 1e-8, rel
        # the reported rnorm must match the host-verified one
        np.testing.assert_allclose(
            res.rnorm / res.rnorm0, rel, rtol=1e-2, atol=1e-15)


class TestCyclePrecisionSharded:
    def test_bf16_cycle_converges_on_mesh(self, monkeypatch):
        """Force the bf16 cycle threshold down: the sharded MG-PCG still
        converges with iteration counts in the grid-independent regime
        (the multi-chip analog of the measured single-chip 1.39x win —
        halo ppermutes inside the cycle also halve their bytes)."""
        import jax.numpy as jnp

        from medane_tchakorom_ufc_thesis_repository_tpu.parallel import (
            ShardedPoisson3D,
            make_mesh,
            sharded_mgpcg_solve,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.solvers import (
            multigrid as mgm,
        )
        from medane_tchakorom_ufc_thesis_repository_tpu.utils import multihost

        monkeypatch.setattr(mgm, "_BF16_CYCLE_BYTES", 1)
        mesh = make_mesh(nblocks=2, intra=4)
        cfg = ShardedPoisson3D(16, 16, 16)
        b = jnp.asarray(
            multihost._global_stencil_apply(
                cfg, jnp.ones(cfg.global_shape, jnp.float32)
            )
        )
        res = sharded_mgpcg_solve(mesh, cfg, b, rtol=1e-5, maxiter=40)
        assert bool(res.converged)
        assert int(res.iters) <= 20
