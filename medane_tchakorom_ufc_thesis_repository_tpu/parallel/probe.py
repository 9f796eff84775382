"""Communication probes: collective latency / bandwidth measurement.

The analog of the reference's startup ping-pong
(``comm_sync_measure_latency_between_two_nodes``,
``src/utils/comm.c:390-424``), which measures the inter-node RTT that the
legacy async termination guard uses.  Here the measured link is the mesh
collective fabric (NVLink between the cards of a GPU host, the host
interconnect on the CPU backend): we time chained ``ppermute`` rounds inside
one jitted ``fori_loop`` so dispatch latency cannot pollute the number.
"""

from __future__ import annotations

import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map  # jax>=0.8 home (was jax.experimental)


def measure_collective_latency(
    mesh: Mesh,
    axis: str = "block",
    payload_floats: int = 1024,
    rounds: int = 100,
) -> Dict[str, float]:
    """Time ``rounds`` chained ppermute ring-shifts of a payload along
    ``axis``; returns per-round latency and effective bandwidth."""
    n = mesh.shape[axis]
    if n < 2:
        return {"per_round_us": 0.0, "gbytes_per_s": float("inf"),
                "rounds": 0, "payload_bytes": payload_floats * 4}
    pairs = [(i, (i + 1) % n) for i in range(n)]
    other = [ax for ax in mesh.axis_names if ax != axis]

    def body(x_local):
        def one(i, v):
            return lax.ppermute(v, axis, pairs) * 1.0000001  # defeat CSE
        return lax.fori_loop(0, rounds, one, x_local)

    spec = P()  # replicated payload; ppermute moves full copies
    run = jax.jit(shard_map(
        body, mesh=mesh,
        in_specs=(spec,), out_specs=spec, check_vma=False,
    ))
    x = jnp.ones((payload_floats,), jnp.float32)
    x = jax.device_put(x, NamedSharding(mesh, spec))
    np.asarray(run(x).ravel()[:1])  # compile + warm
    t0 = time.perf_counter()
    np.asarray(run(x).ravel()[:1])
    dt = time.perf_counter() - t0
    per_round = dt / rounds
    nbytes = payload_floats * 4
    return {
        "per_round_us": per_round * 1e6,
        "gbytes_per_s": nbytes / per_round / 1e9,
        "rounds": rounds,
        "payload_bytes": nbytes,
    }


def measure_dispatch_latency(samples: int = 20) -> Dict[str, float]:
    """Host->device dispatch + readback round-trip (the per-call overhead
    every eager op pays)."""
    f = jax.jit(lambda v: v + 1.0)
    x = jnp.zeros((8,), jnp.float32)
    np.asarray(f(x))  # compile
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        np.asarray(f(x))
        times.append(time.perf_counter() - t0)
    arr = np.asarray(times)
    return {
        "median_us": float(np.median(arr) * 1e6),
        "p90_us": float(np.percentile(arr, 90) * 1e6),
        "samples": samples,
    }
