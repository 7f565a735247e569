"""The one place that says which device JAX computes on.

Every routing decision (BPE engine choice, Unigram E-step placement)
asks this module instead of reading JAX's backend itself, so the
decisions stay in step and a test can stand in an accelerator with one
monkeypatch.  ``backend="device"`` in the configs means JAX's default
device, whatever :func:`platform` reports.
"""

from __future__ import annotations

import jax


def platform() -> str:
    """JAX's default platform: "gpu", "cpu", ..."""
    return jax.default_backend()


def is_accelerator() -> bool:
    """True when JAX computes on something other than the host CPU."""
    return platform() != "cpu"


def describe() -> dict:
    """Platform, device kind and device count, as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
