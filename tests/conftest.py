"""Test configuration: run on the CPU with an 8-device virtual mesh, so the
multi-device sharding paths are exercised without accelerators.

Tests marked ``gpu`` need a card: they start a child process with this CPU pin
stripped and skip when the child finds no GPU (run them with
``python -m pytest tests/ -m gpu`` on a machine with one).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
