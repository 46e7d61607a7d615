"""Test harness.

The default run (``python -m pytest tests``) is CPU-only: it pins JAX to
the CPU with 8 virtual devices, so the multi-device tests (sharded-vs-
unsharded bitwise equality, halo exchange) run on fake devices (SURVEY.md
§4).  Tests of code that runs only on an NVIDIA GPU carry the ``gpu``
marker and skip there; ``python -m pytest tests -m gpu`` on a machine with
a GPU leaves JAX on its default platform and runs them on the card.
"""

import os

import pytest


def _gpu_run(config) -> bool:
    return (config.getoption("markexpr", "") or "").strip() == "gpu"


def pytest_configure(config):
    import jax

    jax.config.update("jax_threefry_partitionable", True)
    if _gpu_run(config):
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    # fp64 available on CPU for exact-answer cross-checks; framework code
    # pins its own dtypes explicitly (cfg.dtype), so this only affects test
    # math.
    jax.config.update("jax_enable_x64", True)
    # persistent compile cache of the CPU tests: a directory of its own, so
    # entries compiled for a device never mix with the tests' CPU entries
    cache = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache_cpu",
    )
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    assert len(jax.devices()) == 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()} — XLA_FLAGS "
        "was read before conftest could set it"
    )


@pytest.fixture
def gpu():
    """The first JAX device, which must be an NVIDIA GPU; skips otherwise.
    Decided here, at test time, never while modules are imported."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run `python -m pytest tests -m gpu` on "
            "a machine with one"
        )
    return dev
