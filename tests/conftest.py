"""Test env: CPU backend with 8 fake devices (SURVEY.md §4 'Distributed').

The suite runs on the CPU whatever the environment says:
``jax.config.update("jax_platforms", "cpu")`` after importing jax pins
it, so the byte-exact goldens never run on a card by accident. XLA_FLAGS
must be set before the CPU client initializes to get the 8-device fake
mesh.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere (the
``gpu_device`` fixture decides, at test time). Selecting exactly them,
``python -m pytest -m gpu tests/`` on a machine with the card, adds the
CUDA platform. ``chip_smoke.py`` covers the same ground end to end.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the entry points enable a persistent compile cache inside the checkout;
# test processes compile tiny shapes and write none
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped where there is none")
    if config.getoption("markexpr", "").strip() == "gpu":
        # no backend has started yet: tests are not collected
        jax.config.update("jax_platforms", "cuda,cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU in this process: run `python -m pytest "
                    "-m gpu tests/` on a machine with the card")


@pytest.fixture(scope="session")
def micro_mesh():
    """Tiny deterministic mesh (~320 tris) so tests never need a real OBJ."""
    from tpurt import meshgen

    return meshgen.blob(subdiv=2, seed=7)


@pytest.fixture(scope="session")
def rays_random():
    """A deterministic batch of unit rays aimed at the origin region."""
    rs = np.random.default_rng(123)
    o = rs.uniform(-3, 3, size=(256, 3)).astype(np.float32)
    target = rs.uniform(-0.8, 0.8, size=(256, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)
