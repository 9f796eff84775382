"""``chip_smoke.py``: refuses to run without a GPU, and each of its phases
runs end to end at a tiny size on the CPU (the card runs them at full
size: ``python chip_smoke.py``)."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _run(cwd, script, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=240,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)],
                         ids=["one-card", "four-cards"])
def test_exits_nonzero_without_a_gpu(args):
    proc = _run(ROOT, os.path.join(ROOT, "chip_smoke.py"), *args)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs" in proc.stderr


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_a_tiny():
    out = chip_smoke.phase_a(n=16)
    assert out["rel_f64"] <= 1e-8
    assert out["passes"] >= 1


def test_phase_b_tiny():
    out = chip_smoke.phase_b(m=64)
    assert out["rel_rnorm"] <= 1e-3
    assert out["sweeps"] > 0


def test_phase_c_tiny():
    out = chip_smoke.phase_c(aij_n=8192, aij_nnz=40960, bsr_nb=16,
                             bsr_bs=32)
    assert out["aij"]["operator"] == "AIJ"
    assert out["bsr"]["operator"] == "BSR"


def test_phase_d_tiny():
    out = chip_smoke.phase_d(n3=16, n2=64, aij_n=4096, aij_nnz=20480,
                             bsr_nb=8, bsr_bpr=3, bsr_bs=16)
    assert len(out["max_error"]) == 16


def test_phase_four_tiny():
    """The four-card phase on four of the suite's virtual CPU devices."""
    out = chip_smoke.phase_four(m2=64, n3=16)
    assert out["smsm"]["sweeps_four"] > 0
    assert out["mgpcg"]["rel_f64_four"] <= 1e-8


def test_check_raises_on_failure():
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check(False, "deliberately false")


@pytest.mark.gpu
def test_phase_d_on_the_card(gpu_device):
    """Phase D at a moderate size on the GPU (run on the card with
    ``python -m pytest tests -m gpu``)."""
    out = chip_smoke.phase_d(n3=128, n2=1024, aij_n=16384, aij_nnz=163840,
                             bsr_nb=64, bsr_bpr=4, bsr_bs=64)
    assert len(out["max_error"]) == 16
