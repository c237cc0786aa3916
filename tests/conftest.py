"""Test configuration: every test runs on the CPU backend, with 8 virtual
devices so the multi-device sharding tests run without accelerators.

The platform is pinned through jax.config as well as the environment, so it
holds even when jax was imported before this file.  The GPU path runs
through `python chip_smoke.py` on a machine with a card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
