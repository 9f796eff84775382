"""The plain ``jax.numpy`` device paths against f64 numpy references.

Every stencil method, MG transfer and double-float residual has exactly
one implementation, chosen by nothing but its inputs; these tests pin each
against an independent dense/numpy f64 reference, in f64, f32 and bf16.
They also pin the routing facts that keep it so: no module imports a
TPU-only Pallas backend, and the general-sparse ``AIJ`` apply lowers to
plain XLA operations under ``jit``.
"""

import os
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import operators as om
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import df64
from medane_tchakorom_ufc_thesis_repository_tpu.solvers import multigrid as mg

PKG_DIR = pathlib.Path(om.__file__).resolve().parents[1]
OMEGA = (6.0 / 7.0) / 6.0


def _stencil3d_np(g, diag=6.0, off=-1.0):
    y = diag * g
    y[1:] += off * g[:-1]
    y[:-1] += off * g[1:]
    y[:, 1:] += off * g[:, :-1]
    y[:, :-1] += off * g[:, 1:]
    y[:, :, 1:] += off * g[:, :, :-1]
    y[:, :, :-1] += off * g[:, :, 1:]
    return y


def _stencil2d_np(g, diag=4.0, off=-1.0):
    y = diag * g
    y[1:] += off * g[:-1]
    y[:-1] += off * g[1:]
    y[:, 1:] += off * g[:, :-1]
    y[:, :-1] += off * g[:, 1:]
    return y


def _method_ref(method, x, b):
    """(value, dot) of each Stencil3D method on f64 host arrays."""
    ax = _stencil3d_np(x)
    if method == "mv":
        return ax, None
    if method == "mv_dot":
        return ax, float(np.vdot(x, ax))
    if method == "residual":
        return b - ax, None
    sweep = x + OMEGA * (b - ax)
    if method == "jacobi_sweep":
        return sweep, None
    return sweep, float(np.vdot(b, sweep))


def _call(method, op, x, b):
    if method == "mv":
        return op.mv(x), None
    if method == "mv_dot":
        return op.mv_dot(x)
    if method == "residual":
        return op.residual(x, b), None
    if method == "jacobi_sweep":
        return op.jacobi_sweep(x, b, OMEGA), None
    return op.jacobi_sweep_dot(x, b, OMEGA)


METHODS = ["mv", "mv_dot", "jacobi_sweep", "jacobi_sweep_dot", "residual"]
SHAPES_3D = [(4, 6, 8), (16, 8, 8), (8, 16, 32)]


@pytest.mark.parametrize("flat", [False, True], ids=["grid", "flat"])
@pytest.mark.parametrize("shape", SHAPES_3D, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("method", METHODS)
def test_stencil3d_method_matches_dense_f64(method, shape, flat):
    """Each surviving Stencil3D method, flat or grid-shaped, against the
    dense operator in f64 (exact up to a few roundings)."""
    rng = np.random.default_rng(len(method) + sum(shape))
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    op = om.Stencil3D(*shape)
    dense = np.asarray(op.to_dense())
    np.testing.assert_allclose(_stencil3d_np(x).reshape(-1),
                               dense @ x.reshape(-1), atol=1e-12)
    xin = jnp.asarray(x.reshape(-1) if flat else x)
    bin_ = jnp.asarray(b.reshape(-1) if flat else b)
    got, dot = jax.jit(lambda u, v: _call(method, op, u, v))(xin, bin_)
    want, want_dot = _method_ref(method, x, b)
    assert got.shape == xin.shape
    np.testing.assert_allclose(np.asarray(got).reshape(shape), want,
                               rtol=0, atol=1e-12)
    if want_dot is not None:
        assert float(dot) == pytest.approx(want_dot, rel=1e-6)


@pytest.mark.parametrize("method", ["mv", "jacobi_sweep", "residual"])
def test_stencil3d_bf16_inputs(method):
    """bf16 storage (the MG cycle's precision on large grids): within
    bf16's 8 significant bits of the f64 result on the rounded inputs."""
    rng = np.random.default_rng(3)
    shape = (8, 8, 16)
    xb = jnp.asarray(rng.random(shape), jnp.bfloat16)
    bb = jnp.asarray(rng.random(shape), jnp.bfloat16)
    op = om.Stencil3D(*shape)
    got, _ = _call(method, op, xb, bb)
    assert got.dtype == jnp.bfloat16
    x = np.asarray(xb.astype(jnp.float32), np.float64)
    b = np.asarray(bb.astype(jnp.float32), np.float64)
    want, _ = _method_ref(method, x, b)
    err = np.max(np.abs(np.asarray(got.astype(jnp.float32)) - want))
    assert err <= 1e-2 * np.max(np.abs(want))


def test_jacobi_sweep_out_dtype():
    """``out_dtype`` rounds the sweep once, at the end."""
    rng = np.random.default_rng(4)
    shape = (8, 8, 8)
    x = jnp.asarray(rng.random(shape), jnp.bfloat16)
    b = jnp.asarray(rng.random(shape), jnp.bfloat16)
    op = om.Stencil3D(*shape)
    y = op.jacobi_sweep(x, b, OMEGA, out_dtype=jnp.float32)
    assert y.dtype == jnp.float32
    y2, d = op.jacobi_sweep_dot(x, b, OMEGA, out_dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y2))
    assert float(d) == pytest.approx(
        float(np.vdot(np.asarray(b.astype(jnp.float32), np.float64),
                      np.asarray(y, np.float64))), rel=1e-5)


@pytest.mark.parametrize("flat", [False, True], ids=["grid", "flat"])
@pytest.mark.parametrize("shape", [(5, 7), (16, 8), (32, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_stencil2d_mv_matches_dense_f64(shape, flat):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape)
    op = om.Stencil2D(*shape)
    dense = np.asarray(op.to_dense())
    got = op.mv(jnp.asarray(x.reshape(-1) if flat else x))
    np.testing.assert_allclose(np.asarray(got).reshape(-1),
                               dense @ x.reshape(-1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(got).reshape(shape),
                               _stencil2d_np(x), atol=1e-12)


@pytest.mark.parametrize("dims", [(8, 16), (8, 16, 32)],
                         ids=["2d", "3d"])
def test_mg_restriction_is_the_cell_mean(dims):
    rng = np.random.default_rng(5)
    r = rng.standard_normal(dims)
    got = np.asarray(mg._restrict(jnp.asarray(r), dims))
    half = []
    for n in dims:
        half += [n // 2, 2]
    want = r.reshape(half).mean(axis=tuple(range(1, 2 * len(dims), 2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("dims", [(4, 8), (4, 8, 16)], ids=["2d", "3d"])
def test_mg_prolongation_is_replication(dims):
    rng = np.random.default_rng(6)
    e = rng.standard_normal(dims)
    got = np.asarray(mg._prolong(jnp.asarray(e), dims))
    want = e
    for ax in range(len(dims)):
        want = np.repeat(want, 2, axis=ax)
    np.testing.assert_array_equal(got, want)


def test_mg_transfers_are_adjoint():
    """R = Pᵀ / 2^d keeps the V-cycle symmetric (a valid CG
    preconditioner)."""
    rng = np.random.default_rng(7)
    fine, coarse = (8, 8, 16), (4, 4, 8)
    r = jnp.asarray(rng.standard_normal(fine))
    e = jnp.asarray(rng.standard_normal(coarse))
    lhs = float(jnp.vdot(mg._restrict(r, fine), e))
    rhs = float(jnp.vdot(r, mg._prolong(e, coarse))) / 8.0
    assert lhs == pytest.approx(rhs, rel=1e-12)


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 8, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_df_residual_3d_matches_f64(shape):
    """Double-float residual of f32 (hi, lo) pairs against the f64
    residual of the exact sums: ~2^-48 relative."""
    rng = np.random.default_rng(8)
    xhi = rng.standard_normal(shape).astype(np.float32)
    xlo = (rng.standard_normal(shape) * 2.0 ** -30).astype(np.float32)
    bhi = rng.standard_normal(shape).astype(np.float32)
    blo = (rng.standard_normal(shape) * 2.0 ** -30).astype(np.float32)
    x = xhi.astype(np.float64) + xlo
    b = bhi.astype(np.float64) + blo
    want = b - _stencil3d_np(x)
    res = df64.stencil3d_df_residual(*shape, 6.0, -1.0)
    rhi, rlo = jax.jit(res)((jnp.asarray(bhi), jnp.asarray(blo)),
                            (jnp.asarray(xhi), jnp.asarray(xlo)))
    got = np.asarray(rhi, np.float64) + np.asarray(rlo, np.float64)
    assert rhi.dtype == jnp.float32
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)


def test_df_residual_2d_matches_f64():
    rng = np.random.default_rng(9)
    shape = (16, 24)
    xhi = rng.standard_normal(shape).astype(np.float32)
    xlo = (rng.standard_normal(shape) * 2.0 ** -30).astype(np.float32)
    bhi = rng.standard_normal(shape).astype(np.float32)
    x = xhi.astype(np.float64) + xlo
    want = bhi.astype(np.float64) - _stencil2d_np(x)
    res = df64.stencil2d_df_residual(*shape, 4.0, -1.0)
    rhi, rlo = res((jnp.asarray(bhi), jnp.zeros(shape, jnp.float32)),
                   (jnp.asarray(xhi), jnp.asarray(xlo)))
    got = np.asarray(rhi, np.float64) + np.asarray(rlo, np.float64)
    assert np.linalg.norm(got - want) <= 1e-13 * np.linalg.norm(want)


# --- routing: one plain path per job ----------------------------------------

def _package_sources():
    return sorted(PKG_DIR.rglob("*.py"))


def test_no_module_imports_a_tpu_backend():
    offenders = [
        str(p.relative_to(PKG_DIR)) for p in _package_sources()
        if "pallas.tpu" in p.read_text() or "pltpu" in p.read_text()
    ]
    assert offenders == []


def test_no_route_branches_on_the_backend():
    """Routes follow shapes and dtypes, never a backend probe."""
    offenders = [
        str(p.relative_to(PKG_DIR)) for p in _package_sources()
        if "default_backend()" in p.read_text()
        or "interpret=" in p.read_text()
    ]
    assert offenders == []


def test_aij_mv_under_jit_lowers_to_plain_xla():
    rng = np.random.default_rng(10)
    n, nnz = 3000, 15000
    rows, cols = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    op = om.AIJ.from_coo(rows, cols, vals, (n, n), with_rmv=False)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    jaxpr = str(jax.make_jaxpr(lambda o, v: o.mv(v))(op, x))
    assert "pallas_call" not in jaxpr
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    got = np.asarray(jax.jit(lambda o, v: o.mv(v))(op, x), np.float64)
    np.testing.assert_allclose(got, dense @ np.asarray(x, np.float64),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_large_stencil3d_is_one_whole_array_expression(method):
    """At 512^3 (above any on-chip size) every method traces to the same
    whole-array form as a small grid: no kernel call and no loop."""
    spec = jax.ShapeDtypeStruct((512, 512, 512), jnp.float32)
    op = om.Stencil3D(512, 512, 512)
    jaxpr = str(jax.make_jaxpr(lambda u, v: _call(method, op, u, v))(
        spec, spec))
    assert "pallas_call" not in jaxpr
    assert "while" not in jaxpr


# --- compile cache ------------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_the_environment(monkeypatch, tmp_path,
                                               restore_cache_dir):
    from medane_tchakorom_ufc_thesis_repository_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other path is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_defaults_to_a_fixed_ignored_path(monkeypatch,
                                                        restore_cache_dir):
    from medane_tchakorom_ufc_thesis_repository_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path
    root = PKG_DIR.parent
    assert pathlib.Path(path) == root / ".jax_cache"
    ignored = (root / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    # the same path on every call: never a temp name, pid or time
    assert compile_cache.enable_compile_cache() == path


def test_cli_main_enables_the_cache(monkeypatch, restore_cache_dir):
    from medane_tchakorom_ufc_thesis_repository_tpu.utils import (
        cli,
        compile_cache,
    )

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    assert cli.main(["--alg", "SM", "--m", "8", "--n", "8", "--json"]) == 0
    assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR


def test_profiling_fence_waits_on_pytrees():
    from medane_tchakorom_ufc_thesis_repository_tpu.utils.profiling import (
        fence,
    )

    out = (jnp.ones(4) * 2, {"a": jnp.zeros(3)})
    fence(out)
    assert float(out[0][0]) == 2.0


def test_readme_names_the_card_commands():
    readme = (PKG_DIR.parent / "README.md").read_text()
    assert "chip_smoke.py" in readme
    assert os.path.exists(PKG_DIR.parent / "chip_smoke.py")
