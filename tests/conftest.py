"""Test configuration: force the CPU backend with 8 virtual devices so the
multi-chip sharding paths are exercised without TPU hardware (the
"fake the mesh, not the math" strategy from SURVEY.md §4).

Note: on this image the JAX_PLATFORMS env var is ignored by the installed
plugin, so the backend must be pinned via jax.config before first use.
"""
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the fast tier compiles dozens of
# executables whose build dominates wall time; caching them across runs
# cuts the tier from ~400 s to minutes on a warm cache (VERDICT r4 #10).
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(os.path.dirname(__file__), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the CUDA kernels of "
        "mobileraytracer_tpu_torch); skipped where torch.cuda is unavailable")
