import os

# Tests run on a virtual 8-device CPU mesh unless JAX_PLATFORMS says
# otherwise (the `gpu`-marked tests run on the card with
# JAX_PLATFORMS=cuda). The CPU device count must be set before any backend
# initializes (they init lazily on first use).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

try:
    jax.config.update("jax_num_cpu_devices", 8)
except Exception:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    # bounds live-executable accumulation inside one test process
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU. Decided here, at run
    time, never while modules are imported."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX_PLATFORMS=cuda); "
                    f"found {dev.platform}")
    return dev
