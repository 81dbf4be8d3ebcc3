"""Test-suite environment: CPU backend with 8 virtual devices.

Per SURVEY.md §4.5 (the standard JAX trick), all tests run on the CPU
backend with `--xla_force_host_platform_device_count=8` so Mesh/shard_map/
psum paths are exercised without multi-GPU hardware, and the Pallas
kernels run in interpret mode. Threefry is bit-exact across backends, so
the sampled paths are the same on the CPU and the GPU at the same seeds.
Tests marked `gpu` need a CUDA GPU and skip elsewhere (see the `gpu`
fixture).

This file must set the environment BEFORE jax is imported anywhere, which
pytest guarantees by importing conftest first.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# CPU unless the caller picks a platform (JAX_PLATFORMS=cuda for the
# GPU-marked tests on the card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402
import pytest  # noqa: E402

# Persistent compile cache: CPU test compiles of the traversal/engine
# programs take minutes; cache them across runs.
from pathtracer.utils.cache import enable as _enable_cache  # noqa: E402

_enable_cache()


@pytest.fixture
def gpu():
    """The first CUDA GPU; skips the test where there is none.

    Decided at run time, never at import, so every pytest-xdist worker
    collects the same tests. On the card, run them with
    `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a CUDA GPU (compiled kernel); none here")
    return devs[0]
