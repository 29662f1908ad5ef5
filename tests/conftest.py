"""Test configuration.

Tests run on the CPU with a virtual 8-device platform, so the sharded
engine is exercised on an 8-device mesh without an accelerator.  The
program's run on the GPU is ``python chip_smoke.py`` (``--mesh 4`` for the
four-card sharded path), not a pytest marker.  The platform is fixed here,
before any backend initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# NO persistent compile cache for tests, whatever the environment says:
# (de)serializing the sharded (8-virtual-device) CPU executable has crashed
# this jax build, and CPU compiles are cheap.
jax.config.update("jax_enable_compilation_cache", False)
