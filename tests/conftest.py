"""Test configuration: force an 8-device virtual CPU mesh + float64.

Unit tests (including the multi-device sharding tests) run on the CPU
backend with ``--xla_force_host_platform_device_count=8`` so
``Mesh(('block','intra'))`` paths execute without an accelerator — the
analog of the reference running its 4-rank MPI test binary on one laptop
(``makefile:185-188``).  Tests that need the GPU carry the ``gpu``
marker and request the ``gpu_device`` fixture, which skips them here.
"""

import os
import sys

# Must happen before any jax backend is initialized: XLA_FLAGS is read
# lazily at CPU-client init, and the platform is pinned through
# jax.config (an environment variable set here could come after jax's
# import).
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# the CLI entry point turns the persistent compile cache on; parallel
# test workers must not share one cache directory
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running tests (multi-process spawns)"
    )
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU test lane"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device, or a skip when JAX runs without one.

    Decided here at run time, never at import or collection, so every
    test worker collects the same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return devs[0]


@pytest.fixture(scope="session")
def mesh8():
    import numpy as np
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    return Mesh(devs, ("block", "intra"))
