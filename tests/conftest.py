"""Test harness: 8 virtual CPU devices, float64 enabled.

Tests run on the CPU (sharding on a virtual CPU mesh).  Tests marked
`gpu` need the card and skip elsewhere; run them on a GPU machine with
`JAX_PLATFORMS=cuda python -m pytest tests -m gpu`.
"""

import os

import jax

jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
