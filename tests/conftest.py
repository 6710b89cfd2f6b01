import os

# Tests run on the CPU with 8 virtual devices, so sharding paths are
# exercised without a GPU.  Set before jax initializes its backends.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from saigegds_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE = "/root/reference"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips (with its reason) "
        "where there is none")
