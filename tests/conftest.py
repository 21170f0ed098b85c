"""Test configuration: CPU backend with 8 virtual devices + fp64.

The reference tests multi-node behavior with real ``jsrun`` launches on LLNL
machines (reference: test_all.py:136-161); our stand-in is an 8-device
virtual CPU mesh (``--xla_force_host_platform_device_count=8``), which
exercises the full SPMD sharding/ppermute code paths without GPUs.  Pallas
kernels run in interpret mode there (ops/pallas/__init__.py).  fp64 is
enabled because the golden CG trajectories are exact-integer doubles
(reference: test_all.py:130-133).

These env vars must be set before jax initializes its backends, hence here.

Tests marked ``gpu`` need an NVIDIA GPU: the ``gpu_device`` fixture skips
them elsewhere.  Run them on a GPU machine with
``python -m pytest tests/ -m gpu -p no:xdist`` (with ``LEGIONSOLVERS_GPU_TESTS=1``
so that this file leaves the platform to JAX).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Force CPU (the golden tests need 8 virtual devices, which only the CPU
# backend provides) unless the run is the GPU test pass; the live jax
# config is updated too, in case jax was imported before this file.
ON_GPU = bool(os.environ.get("LEGIONSOLVERS_GPU_TESTS"))
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)"
    )


@pytest.fixture
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform})")
    return dev


@pytest.fixture
def mesh4():
    """4-shard mesh — the reference tests' piece count (Test05: -vp 4)."""
    from legionsolvers_tpu.parallel.mesh import make_mesh

    return make_mesh(4)


@pytest.fixture
def mesh8():
    from legionsolvers_tpu.parallel.mesh import make_mesh

    return make_mesh(8)
