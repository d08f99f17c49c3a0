"""Test configuration: force CPU with 8 virtual devices for sharding tests.

Mirrors the survey's multi-host test recipe (SURVEY.md §4): multi-chip
sharding is validated on a virtual CPU mesh via
``--xla_force_host_platform_device_count``.  The platform is pinned to
``cpu`` through the live JAX config before any backend is initialized, so
the suite runs the jnp kernels even on a machine with a GPU.  The tests
that need the card (marker ``gpu``, tests/test_cuda.py) run with
``ASTARPA_TEST_GPU=1``, which leaves the platform to JAX:

    ASTARPA_TEST_GPU=1 python -m pytest tests/test_cuda.py -m gpu
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("ASTARPA_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
