"""Chip-calibrated routing constants (core/calibration.py +
utils/calibrate.py): shipped H100 defaults, per-device override file,
and the routing code honoring the override."""

import json

import numpy as np
import pytest

import jax.numpy as jnp

from medane_tchakorom_ufc_thesis_repository_tpu.core import calibration


@pytest.fixture(autouse=True)
def _fresh_cache():
    calibration.reset_cache()
    yield
    calibration.reset_cache()


def _blockable_coo(nbr=16, c=16, seed=2):
    rng = np.random.default_rng(seed)
    n = nbr * c
    rows, cols, vals = [], [], []
    for k in range(nbr):
        for j in (k, (k + 1 + (k % 7)) % nbr):
            blk = rng.standard_normal((c, c))
            if j == k:
                blk += np.eye(c) * 8.0
            r, cc = np.divmod(np.arange(c * c), c)
            rows.append(k * c + r)
            cols.append(j * c + cc)
            vals.append(blk.reshape(-1))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals), (n, n))


class TestStore:
    def test_shipped_defaults_without_file(self, monkeypatch, tmp_path):
        monkeypatch.setenv("MEDANE_CALIBRATION",
                           str(tmp_path / "missing.json"))
        assert calibration.load()["bsr_bs_penalty"] == \
            calibration.SHIPPED["bsr_bs_penalty"]
        assert calibration.ell_relative_cost() == \
            calibration.SHIPPED["ell_relative_cost"]
        assert calibration.default_max_dense_n() == \
            calibration.SHIPPED["max_dense_n"]

    def test_save_load_roundtrip(self, monkeypatch, tmp_path):
        path = tmp_path / "cal.json"
        monkeypatch.setenv("MEDANE_CALIBRATION", str(path))
        cal = {"device_kind": "TestChip", "bsr_bs_penalty": {"16": 2.5},
               "ell_relative_cost": 50.0, "max_dense_n": 512}
        calibration.save(cal)
        loaded = calibration.load()
        assert loaded["bsr_bs_penalty"] == {16: 2.5}   # int keys
        assert loaded["ell_relative_cost"] == 50.0
        assert loaded["max_dense_n"] == 512
        assert loaded["source"] == str(path)

    def test_corrupt_file_warns_and_falls_back(self, monkeypatch,
                                               tmp_path):
        path = tmp_path / "cal.json"
        path.write_text("{not json")
        monkeypatch.setenv("MEDANE_CALIBRATION", str(path))
        with pytest.warns(UserWarning, match="unreadable calibration"):
            loaded = calibration.load()
        assert loaded["ell_relative_cost"] == \
            calibration.SHIPPED["ell_relative_cost"]

    def test_partial_file_merges_over_shipped(self, monkeypatch,
                                              tmp_path):
        path = tmp_path / "cal.json"
        path.write_text(json.dumps({"max_dense_n": 1024}))
        monkeypatch.setenv("MEDANE_CALIBRATION", str(path))
        loaded = calibration.load()
        assert loaded["max_dense_n"] == 1024
        assert loaded["bsr_bs_penalty"] == \
            calibration.SHIPPED["bsr_bs_penalty"]

    def test_default_path_is_per_device_kind(self, monkeypatch):
        monkeypatch.delenv("MEDANE_CALIBRATION", raising=False)
        p = calibration.calibration_path("FooChip_v9")
        assert p.endswith("calibration-FooChip_v9.json")


class TestRoutingHonorsCalibration:
    def test_penalty_override_changes_bsr_routing(self, monkeypatch,
                                                  tmp_path):
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (  # noqa: E501
            operator_from_coo,
        )

        rows, cols, vals, shape = _blockable_coo()
        path = tmp_path / "cal.json"
        monkeypatch.setenv("MEDANE_CALIBRATION", str(path))

        # default: cleanly blockable -> BSR (dense route disabled to
        # isolate the BSR decision)
        op = operator_from_coo(rows, cols, vals, shape,
                               dtype=jnp.float64, max_dense_n=0,
                               max_bsr_cost=16.0)
        assert type(op).__name__ == "BSR"

        # calibration that prices EVERY block size above the bar ->
        # same matrix now refuses BSR (falls through to the Clos AIJ;
        # aij bar lowered too so the high-fill last resort can't catch
        # it)
        calibration.save({
            "bsr_bs_penalty": {str(b): 1000.0
                               for b in (8, 16, 32, 64, 128)},
            "aij_relative_cost": 1.0,
        })
        op2 = operator_from_coo(rows, cols, vals, shape,
                                dtype=jnp.float64, max_dense_n=0,
                                max_bsr_cost=16.0)
        assert type(op2).__name__ == "AIJ"

    def test_max_dense_n_default_from_calibration(self, monkeypatch,
                                                  tmp_path):
        from medane_tchakorom_ufc_thesis_repository_tpu.core.operators import (  # noqa: E501
            operator_from_coo,
        )

        rows, cols, vals, shape = _blockable_coo(nbr=8, c=16)
        path = tmp_path / "cal.json"
        monkeypatch.setenv("MEDANE_CALIBRATION", str(path))
        # price BSR out so the decision is dense-vs-ELL, then shrink
        # the calibrated dense cutoff below this matrix's size
        calibration.save({
            "bsr_bs_penalty": {str(b): 1000.0
                               for b in (8, 16, 32, 64, 128)},
            "aij_relative_cost": 1.0,   # disarm the high-fill fallback
            "max_dense_n": 64,
        })
        op = operator_from_coo(rows, cols, vals, shape,
                               dtype=jnp.float64)
        assert type(op).__name__ == "AIJ"
        calibration.save({"max_dense_n": 4096,
                          "bsr_bs_penalty": {str(b): 1000.0
                                             for b in (8, 16, 32, 64,
                                                       128)}})
        op2 = operator_from_coo(rows, cols, vals, shape,
                                dtype=jnp.float64)
        assert type(op2).__name__ == "DenseOp"


class TestMeasure:
    def test_smoke_small_cpu(self):
        """measure_calibration end-to-end at tiny sizes (structure of
        the output; CPU numbers are not meaningful, just finite)."""
        from medane_tchakorom_ufc_thesis_repository_tpu.utils.calibrate import (  # noqa: E501
            measure_calibration,
        )

        cal = measure_calibration(stored=1 << 14, n=512,
                                  block_sizes=(8, 16), ell_grid=24,
                                  dense_ns=(128,), aij_n=2048,
                                  aij_nnz=8000, log=lambda *a: None)
        assert set(cal) >= {"device_kind", "platform", "bsr_bs_penalty",
                            "ell_relative_cost", "max_dense_n"}
        pens = cal["bsr_bs_penalty"]
        assert set(pens) == {8, 16}
        assert min(pens.values()) == 1.0
        assert all(v >= 1.0 and np.isfinite(v) for v in pens.values())
        assert cal["ell_relative_cost"] > 0
        assert cal["aij_relative_cost"] > 0
        assert 0 < cal["max_dense_n"] <= 4096
