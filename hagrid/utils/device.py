"""The accelerator a measurement runs on.

Every number bench.py and chip_smoke.py print names the card it came
from. A measurement path that finds no GPU fails; it never falls back to
the CPU.
"""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> list:
    """JAX's devices, or RuntimeError when they are not GPUs."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found {devs[0].platform} devices "
                           f"({devs[0].device_kind})")
    return devs


def describe(devs) -> dict:
    """Platform, kind and count as JAX reports them."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them (one
    line per card, joined with '; ')."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())
