# tests/conftest.py
# Test bootstrap: the CPU backend with 8 virtual devices, so sharding paths
# are exercised without accelerators. An explicit JAX_PLATFORMS is
# respected (e.g. JAX_PLATFORMS=cuda,cpu to run the `gpu`-marked tests on
# a card).
#
# Mirrors the reference's GPU-gating strategy (tests self-skip when no
# hardware; tests/_terrain_runtime.py:98-165): tests that need a GPU carry
# the `gpu` marker, and a fixture skips them when JAX has no GPU device.
# chip_smoke.py runs the same checks on the card at full size.

import os
import sys

# Must happen before jax configures its backends.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: requires an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    """Decide at run time (never at import or collection, so every xdist
    worker collects the same tests) whether a `gpu` test can run."""
    if request.node.get_closest_marker("gpu") is not None:
        if not any(d.platform == "gpu" for d in jax.devices()):
            pytest.skip("needs a GPU device; chip_smoke.py runs this check "
                        "on the card")
    yield


@pytest.fixture(autouse=True)
def _reset_global_state():
    """Keep the degradation sink and memory ledger test-isolated."""
    yield
    from forge3d_tpu.degradation import clear_native_degradations
    from forge3d_tpu.mem import global_tracker

    clear_native_degradations()
    global_tracker().reset()
    global_tracker().set_policy("enforce")
    global_tracker().set_budget(512 * 1024 * 1024)
