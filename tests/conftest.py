"""Test configuration: JAX on a virtual 8-device CPU mesh, in float64.

The environment is set before jax is imported anywhere. float64 lets the
vectorized device code be compared against exact scalar/NumPy oracles at
tight tolerances; tests of the float32 path the GPU runs switch x64 off
locally (``jax.enable_x64(False)``).

Tests that need the GPU carry the ``gpu`` marker (registered in
pytest.ini) and skip through the ``gpu_device`` fixture when no GPU is
present; on a machine with one, run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from letf_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

# Release JIT code mappings between modules. Every compiled XLA:CPU
# executable holds ~9 small anonymous mappings (4-16 KB LLVM code pages);
# a full-suite process accumulates 45k+ mappings and the next LARGE
# compile/deserialize blows vm.max_map_count (65530) — mmap fails and XLA
# segfaults. clear_caches() + gc drops dead executables and returns the
# count to baseline; the persistent compile cache makes the cross-module
# recompiles cheap.


import gc  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _release_jit_map_pressure():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with -m gpu on a machine with one)")
