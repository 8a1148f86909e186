"""Test harness: force an 8-device virtual CPU mesh (SURVEY.md §4).

Multi-device sharding logic is validated on virtual CPU devices exactly the
way the driver's ``dryrun_multichip`` does.

Tests marked ``gpu`` need the card: run them there with
``PBRT_TEST_GPU=1 python -m pytest -m gpu tests/`` (chip_smoke.py does).
Without that variable the harness forces the CPU backend before any
backend initialises, and the ``gpu`` tests skip from their fixture.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ON_GPU = os.environ.get("PBRT_TEST_GPU") == "1"
if not ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

from physically_based_ray_tracer_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

enable_compile_cache()
