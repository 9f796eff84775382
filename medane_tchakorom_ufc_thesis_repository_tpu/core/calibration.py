"""Routing-constant calibration store (autotuned thresholds).

The operator-routing cost model (``core.operators``: BSR block-size
penalties, the gather-ELL cost bar, the AIJ cost bar, the dense-route
cutoff) ships with constants measured on an NVIDIA H100.  Relative costs
shift across devices — gather throughput, small-block efficiency and the
dense crossover are all microarchitectural.  ``utils.calibrate``
re-measures them on the current device and saves a JSON; this module
loads that file (per device kind) and serves the constants to the
routing code, falling back to the shipped table.

This replaces nothing in the reference — PETSc's AIJ has one format and
no routing — it is the knob SURVEY §7.2's "measure nnz/s per device from
day one" stance implies once more than one representation competes.

Lookup order:
  1. ``MEDANE_CALIBRATION`` env var (explicit file path),
  2. ``$XDG_CACHE_HOME/medane_tchakorom_ufc_thesis_repository_tpu/
     calibration-<device_kind>.json``,
  3. the shipped constants.
"""

from __future__ import annotations

import json
import os
import warnings

__all__ = [
    "SHIPPED",
    "bsr_bs_penalty",
    "calibration_path",
    "aij_relative_cost",
    "default_max_dense_n",
    "ell_relative_cost",
    "load",
    "reset_cache",
    "save",
]

# ``python -m ...utils.calibrate`` on an NVIDIA H100 80GB HBM3 with a
# 400 W power limit (barriered-slope timing):
#   * bsr_bs_penalty: per-stored-value BSR SpMV cost relative to the best
#     block size (552/566/548/592/621 Gval/s for bs=8/16/32/64/128 at a
#     33.6M stored-value budget);
#   * ell_relative_cost: gather-ELL SpMV per-nonzero cost relative to DIA
#     on the same banded 2048^2 matrix (0.189 vs 0.059 ms);
#   * aij_relative_cost: Clos-routed AIJ SpMV per-nonzero cost relative
#     to the same DIA baseline (random structureless n=65536, 0.7M nnz:
#     0.067 ms) — the bar a high-fill BSR must undercut before it beats
#     AIJ;
#   * max_dense_n: largest tested n where the dense matvec beat gather-ELL
#     on a 1%-density random matrix (2048; ELL won at 4096).
SHIPPED = {
    "bsr_bs_penalty": {8: 1.13, 16: 1.1, 32: 1.13, 64: 1.05, 128: 1.0},
    "ell_relative_cost": 3.2,
    "aij_relative_cost": 36.2,
    "max_dense_n": 2048,
}

_loaded = None


def _device_kind() -> str:
    import jax

    return jax.devices()[0].device_kind.replace(" ", "_").replace("/", "_")


def calibration_path(kind: str | None = None) -> str:
    env = os.environ.get("MEDANE_CALIBRATION")
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.expanduser("~/.cache"))
    return os.path.join(
        base, "medane_tchakorom_ufc_thesis_repository_tpu",
        f"calibration-{kind or _device_kind()}.json",
    )


def load() -> dict:
    """Constants for the current device: saved calibration merged over
    the shipped defaults (cached after the first call; ``reset_cache``
    after saving a new calibration in-process)."""
    global _loaded
    if _loaded is None:
        out = {k: (dict(v) if isinstance(v, dict) else v)
               for k, v in SHIPPED.items()}
        path = calibration_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                pen = {int(k): float(v)
                       for k, v in data.get("bsr_bs_penalty", {}).items()}
                if pen:
                    out["bsr_bs_penalty"] = pen
                if "ell_relative_cost" in data:
                    out["ell_relative_cost"] = float(
                        data["ell_relative_cost"])
                if "aij_relative_cost" in data:
                    out["aij_relative_cost"] = float(
                        data["aij_relative_cost"])
                if "max_dense_n" in data:
                    out["max_dense_n"] = int(data["max_dense_n"])
                out["source"] = path
            except (OSError, ValueError) as e:
                warnings.warn(
                    f"ignoring unreadable calibration file {path!r}: {e}",
                    UserWarning,
                )
        _loaded = out
    return _loaded


def reset_cache() -> None:
    global _loaded
    _loaded = None


def bsr_bs_penalty() -> dict:
    return load()["bsr_bs_penalty"]


def ell_relative_cost() -> float:
    return load()["ell_relative_cost"]


def aij_relative_cost() -> float:
    return load()["aij_relative_cost"]


def default_max_dense_n() -> int:
    return load()["max_dense_n"]


def save(cal: dict, path: str | None = None) -> str:
    """Persist a measured calibration (``utils.calibrate`` output) and
    reset the in-process cache so routing picks it up immediately."""
    path = path or calibration_path(cal.get("device_kind"))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cal, f, indent=2, sort_keys=True)
    reset_cache()
    return path
