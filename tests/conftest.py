"""Test config: CPU with 8 virtual devices, so the multi-device sharding
paths (mesh/shard_map) run without GPUs.

The platform is flipped through ``jax.config`` before any backend is
initialized (an environment variable set after JAX was imported would be
too late). Tests that need an NVIDIA GPU carry the ``gpu`` marker and skip
here through the ``gpu_device`` fixture; ``chip_smoke.py`` runs the same
checks on the card.
"""

import os

import jax
import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache (utils/compile_cache: JAX_COMPILATION_CACHE_DIR
# if set, else <checkout>/.jax_cache): the slowest tests are compile-bound
# (sharded refine/grad graphs on the virtual 8-device mesh), so repeat runs
# of an unchanged graph pay ~0. The cache key hashes the HLO and compile
# options; code changes miss and recompile.
from pointcloudprocessor_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable(min_compile_time_secs=5.0)


@pytest.fixture
def gpu_device():
    """The first CUDA device, or skip. Decided here, at test time — never
    while a module is imported, so every test worker collects the same
    tests."""
    try:
        devices = jax.devices("cuda")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run chip_smoke.py on the card)")
    return devices[0]
