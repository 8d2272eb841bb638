"""Process set-up shared by the scripts: compile cache and device facts.

``enable_compile_cache`` keeps JAX's persistent compilation cache where
``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX reads the
variable itself, so nothing else is set), and otherwise under
``<checkout>/.jax_cache`` — a fixed path, since the path is part of the
cache key.  ``device_info`` names the device every printed result ran
on.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card() -> str | None:
    """The GPU's name and power limit as nvidia-smi reports them, or
    None where there is no nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_info() -> dict:
    """Platform, kind and count of the default devices, plus the card."""
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "card": card()}
