"""Measure operator-routing constants on the CURRENT device.

The routing cost model (``core.operators`` / ``core.calibration``) ships
with constants measured on an NVIDIA H100.  This module re-measures them
on whatever device JAX is running on — the autotuning step SURVEY §7.2's
"measure nnz/s per device from day one" stance implies once several
representations compete — and saves them where ``core.calibration``
looks:

    python -m medane_tchakorom_ufc_thesis_repository_tpu.utils.calibrate \
        [--save] [--out PATH] [--stored 4194304] [--n 8192]

Measured quantities (all barriered-slope, the repo-standard method that
subtracts dispatch fixed costs and defeats cross-iteration fusion —
``bench.py:_slope_time``):

* ``bsr_bs_penalty`` — per-stored-value BSR SpMV cost by block size,
  relative to the best block size, at a fixed stored-value budget;
* ``ell_relative_cost`` — gather-ELL SpMV per-nonzero cost relative to
  DIA on the same banded matrix (the bar other formats must beat);
* ``max_dense_n`` — largest tested n where the dense matvec beats
  gather-ELL on a 1%-density random matrix (capped at the shipped value:
  above that the n² storage cost dominates the routing decision);
* ``aij_relative_cost`` — the Clos-routed AIJ SpMV per-nonzero cost
  relative to the same DIA baseline (random structureless n=65536
  d=10) — the bar high-fill BSR must undercut before it beats AIJ.

Without ``--save`` this is a dry run: it prints the JSON so the numbers
can be inspected before they start steering routing decisions.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

__all__ = ["measure_calibration", "main"]


def _fence(arr):
    import jax

    return jax.block_until_ready(arr)


def _slope_time(step, x, i1=40, i2=120, reps=3, op=None):
    """Per-apply seconds: slope between two chained on-device loop
    lengths with an optimization_barrier per iteration (bench.py's
    method — fixed costs cancel, fusion across iterations is blocked).

    ``op``: operator pytree passed as a jit ARGUMENT (``step(op, v)``);
    closing over large arrays would bake them into the lowered program
    as constants."""
    import jax
    from jax import lax

    def make(iters):
        if op is None:
            @jax.jit
            def chain(v):
                return lax.fori_loop(
                    0, iters,
                    lambda i, s: lax.optimization_barrier(step(s)), v
                )
        else:
            @jax.jit
            def chain(v, o):
                return lax.fori_loop(
                    0, iters,
                    lambda i, s: lax.optimization_barrier(step(o, s)), v
                )
        return chain

    args = (x,) if op is None else (x, op)
    c1, c2 = make(i1), make(i2)
    _fence(c1(*args))
    _fence(c2(*args))

    def best(c):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            _fence(c(*args))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    # Under heavy host contention (CPU test lanes) the two best-of
    # times can invert, making the slope <= 0 — physically meaningless
    # and it poisons every downstream ratio.  Floor at 1 ns/apply.
    return max((best(c2) - best(c1)) / (i2 - i1), 1e-9)


def _random_block_coo(n: int, bs: int, stored: int, seed: int = 0):
    """COO of a random block-sparse pattern: ``width`` dense (bs, bs)
    blocks per block row, ~``stored`` values total, diagonal included
    (keeps the spectrum harmless for repeated applies)."""
    rng = np.random.default_rng(seed)
    nbr = n // bs
    width = max(1, int(round(stored / (n * bs))))
    bcols = np.empty((nbr, width), np.int64)
    bcols[:, 0] = np.arange(nbr)                     # diagonal block
    if width > 1:
        bcols[:, 1:] = rng.integers(0, nbr, (nbr, width - 1))
    ij = np.arange(bs)
    rr = (np.repeat(np.arange(nbr), width * bs * bs) * bs
          + np.tile(np.repeat(ij, bs), nbr * width))
    cc = (np.repeat(bcols.reshape(-1), bs * bs) * bs
          + np.tile(ij, nbr * width * bs))
    vv = rng.standard_normal(rr.shape[0]) * 1e-3
    return rr, cc, vv


def measure_calibration(stored: int = 32 << 20, n: int = 32768,
                        block_sizes=(8, 16, 32, 64, 128),
                        ell_grid: int = 2048, dense_ns=(1024, 2048, 4096),
                        aij_n: int = 65536, aij_nnz: int = 655360,
                        seed: int = 0, log=print) -> dict:
    """Run the microbenchmarks and return a calibration dict
    (``core.calibration.save`` persists it).

    The defaults reproduce the regime the SHIPPED constants describe —
    working sets that stream from device memory, because that is how
    the routed operators run at the sizes where routing matters.  Shrunk
    sizes fit in on-chip caches and rank the formats differently.
    """
    import jax
    import jax.numpy as jnp

    from medane_tchakorom_ufc_thesis_repository_tpu.core import poisson
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        BSR,
        DenseOp,
    )

    dev = jax.devices()[0]
    dtype = jnp.float32
    rng = np.random.default_rng(seed)

    # --- BSR block-size penalties (equal stored-value budget) ---------
    per_value = {}
    for bs in block_sizes:
        rr, cc, vv = _random_block_coo(n, bs, stored, seed)
        op = BSR.from_coo(rr, cc, vv, (n, n), bs=bs, dtype=dtype)
        x = jnp.asarray(rng.standard_normal(n), dtype)
        t = _slope_time(lambda o, s: o.mv(s), x, op=op)
        per_value[bs] = t / op.nnz
        log(f"  BSR bs={bs:<4} {op.nnz/1e6:6.1f}M stored  "
            f"{op.nnz / t / 1e9:7.1f} Gval/s")
    tbest = min(per_value.values())
    penalty = {bs: round(t / tbest, 2) for bs, t in per_value.items()}

    # --- gather-ELL cost vs DIA on the same banded matrix -------------
    ell = poisson.poisson2d_ell(ell_grid, ell_grid, dtype=dtype)
    dia = ell.to_dia()
    x = jnp.asarray(rng.standard_normal(ell.shape[0]), dtype)
    t_ell = _slope_time(lambda o, s: o.mv(s), x, i1=4, i2=12, op=ell)
    t_dia = _slope_time(lambda o, s: o.mv(s), x, op=dia)
    ell_cost = round(t_ell / t_dia, 1)
    log(f"  ELL {t_ell*1e3:.3f} ms vs DIA {t_dia*1e3:.3f} ms "
        f"({ell_grid}^2): {ell_cost}x")

    # --- dense-vs-ELL crossover (1% density) --------------------------
    max_dense = 0
    for dn in dense_ns:
        nnz = max(dn, int(0.01 * dn * dn))
        r = rng.integers(0, dn, nnz)
        c = rng.integers(0, dn, nnz)
        v = rng.standard_normal(nnz) * 1e-3
        dense = np.zeros((dn, dn), np.float64)
        np.add.at(dense, (r, c), v)
        dop = DenseOp(a=jnp.asarray(dense, dtype))
        eop = poisson.coo_to_ell(r, c, v, (dn, dn), dtype=dtype)
        xd = jnp.asarray(rng.standard_normal(dn), dtype)
        t_d = _slope_time(lambda o, s: o.mv(s), xd, op=dop)
        t_e = _slope_time(lambda o, s: o.mv(s), xd, i1=10, i2=30, op=eop)
        log(f"  dense n={dn:<5} {t_d*1e3:.3f} ms vs ELL {t_e*1e3:.3f} ms")
        if t_d < t_e:
            max_dense = dn
    # never raise past the shipped cap — above it the n^2 storage (and
    # the O(n^2) matvec reads) dominate the routing decision regardless
    # of the measured crossover at test sizes
    from medane_tchakorom_ufc_thesis_repository_tpu.core.calibration import (
        SHIPPED,
    )

    max_dense = min(max_dense or SHIPPED["max_dense_n"],
                    SHIPPED["max_dense_n"])

    # --- Clos-routed AIJ cost vs DIA (structureless routing bar) ------
    # random n=65536 d=10 against the SAME DIA per-nonzero baseline the
    # other bars use
    from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (
        AIJ,
    )

    an, annz = aij_n, aij_nnz
    aop = AIJ.from_coo(rng.integers(0, an, annz),
                       rng.integers(0, an, annz),
                       rng.standard_normal(annz), (an, an),
                       with_rmv=False)
    xa = jnp.asarray(rng.standard_normal(an), dtype)
    t_aij = _slope_time(lambda o, s: o.mv(s) * jnp.float32(1e-3), xa,
                        i1=10, i2=30, op=aop)
    aij_cost = round((t_aij / aop.nnz) / (t_dia / dia.nnz), 1)
    log(f"  AIJ {t_aij*1e3:.3f} ms ({aop.nnz/1e6:.1f}M nnz): "
        f"{aij_cost}x DIA per nonzero")

    return {
        "device_kind": dev.device_kind.replace(" ", "_").replace("/", "_"),
        "platform": dev.platform,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "stored_budget": stored,
        "bsr_bs_penalty": penalty,
        "ell_relative_cost": ell_cost,
        "aij_relative_cost": aij_cost,
        "max_dense_n": int(max_dense),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="measure routing calibration on the current device")
    p.add_argument("--save", action="store_true",
                   help="persist to the per-device-kind cache path")
    p.add_argument("--out", default=None,
                   help="explicit output path (implies --save)")
    p.add_argument("--stored", type=int, default=32 << 20,
                   help="BSR stored-value budget per block size "
                        "(default matches the shipped HBM-bound regime)")
    p.add_argument("--n", type=int, default=32768,
                   help="matrix dimension for the BSR sweep")
    args = p.parse_args(argv)

    cal = measure_calibration(stored=args.stored, n=args.n)
    print(json.dumps(cal, indent=2, sort_keys=True))
    if args.save or args.out:
        from medane_tchakorom_ufc_thesis_repository_tpu.core import (
            calibration,
        )

        path = calibration.save(cal, args.out)
        print(f"saved: {path}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
