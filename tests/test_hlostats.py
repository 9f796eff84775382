"""Structural weak-scaling: collective traffic accounted from compiled
SPMD HLO stays (near-)constant per device as the mesh grows.

Wall-clock weak scaling on oversubscribed virtual CPU devices measures
host contention, not collectives; this is the harness-level evidence for
the >=80% north-star that does not need hardware:
fixed per-device load, growing mesh, count the collectives and their
per-device byte volumes in the optimized HLO.
"""

import numpy as np

from medane_tchakorom_ufc_thesis_repository_tpu.utils import (
    hlostats,
    scaling,
)


class TestHloParser:
    def test_shape_bytes(self):
        assert hlostats._shape_bytes("f32[4,8]{1,0}") == 128
        assert hlostats._shape_bytes("(f32[4]{0}, bf16[2,2]{1,0})") == 24
        assert hlostats._shape_bytes("f64[]") == 8
        assert hlostats._shape_bytes("token[]") == 0

    def test_collective_lines(self):
        hlo = """
  %cp = f32[1,64]{1,0} collective-permute(f32[1,64]{1,0} %x), source_target_pairs={{0,1}}
  %ar = f32[] all-reduce(f32[] %s), replica_groups={}, to_apply=%add
  %ag = f32[8,64]{1,0} all-gather(f32[1,64]{1,0} %y), dimensions={0}
  %notacoll = f32[2]{0} add(f32[2]{0} %a, f32[2]{0} %b)
"""
        st = hlostats.collective_stats(hlo)
        assert st["collective-permute"] == {"count": 1, "bytes": 256}
        assert st["all-reduce"] == {"count": 1, "bytes": 4}
        assert st["all-gather"] == {"count": 1, "bytes": 2048}
        assert hlostats.total_collective_count(st) == 3


class TestStructuralWeakScaling:
    def test_sm_bytes_per_device_flat(self):
        recs = scaling.run_structural(
            rows_per_device=8, n=64, device_counts=[2, 4, 8], alg="SM",
        )
        assert len(recs) == 3
        assert all(r["collectives"]["collective-permute"]["count"] > 0
                   for r in recs)
        base = recs[0]["bytes_per_device"]
        for r in recs:
            # nearest-neighbor halos + scalar reductions: flat to <20%
            # (the 8-device mesh has both intra-neighbor classes
            # populated, which the 2-device strip elides)
            assert r["bytes_per_device"] <= 1.2 * base

    def test_mgpcg_bytes_per_device_near_flat(self):
        recs = scaling.run_structural(
            rows_per_device=8, n=32, device_counts=[2, 4, 8], alg="MGPCG",
        )
        assert len(recs) == 3
        base = recs[0]["bytes_per_device"]
        for r in recs:
            # one extra MG level per doubling adds a geometrically-
            # decaying halo plane: measured 1.0 -> 1.002 -> 1.041
            assert r["bytes_per_device"] <= 1.15 * base
        # reductions stay O(1) scalars regardless of mesh size
        ar = [r["collectives"]["all-reduce"]["bytes"] for r in recs]
        assert max(ar) == min(ar)
