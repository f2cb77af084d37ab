"""What the program runs on: the JAX device and, on NVIDIA cards, the card's
name and power limit (a card set below its maximum power runs slower under
load, so every timing is reported beside its limit)."""

from __future__ import annotations

import subprocess


def nvidia_smi() -> str | None:
    """``name, power.limit`` of each card as nvidia-smi prints them, one line
    per card, or None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def describe() -> dict:
    """The first JAX device's platform and kind, and the device count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu() -> dict:
    """describe(), raising unless the first device is a GPU: a measurement
    must not quietly fall back to the CPU."""
    info = describe()
    if info["platform"] != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {info['platform']} "
            f"({info['kind']})")
    return info
