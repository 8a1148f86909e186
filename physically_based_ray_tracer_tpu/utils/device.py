"""Which device a measurement ran on.

Every speed number this repo prints names its device: JAX's platform,
device kind and count, and the card's name and power limit as
``nvidia-smi`` reports them (a card set below its maximum power runs
slower under load). A measurement that finds no GPU stops instead of
timing the CPU.
"""

from __future__ import annotations

import subprocess


def nvidia_smi_line() -> str:
    """``name, power.limit`` of each card, one per line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def device_stamp() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """The device stamp; raises SystemExit (status 1) unless JAX's device
    is a GPU."""
    stamp = device_stamp()
    if stamp["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX's device is {stamp}; refusing to "
                         "report device numbers from another backend")
    return stamp
