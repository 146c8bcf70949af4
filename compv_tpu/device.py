"""Where programs of this repository run, and where they cache compilations.

``require_gpu`` is the one check that measurement entry points (chip_smoke.py,
bench.py) make before they time anything: with no GPU they stop, so no CPU
number is ever printed under a device metric's name. ``enable_compile_cache``
is the one place that chooses the persistent compilation cache directory.
"""
from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["CACHE_DIR", "enable_compile_cache", "require_gpu", "gpu_info"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already uses it and this
    sets nothing. Otherwise the cache lives at one fixed path inside the
    checkout (``.jax_cache``, git-ignored): the path is part of the cache
    key, so it never contains a temporary name, a pid or a time."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu() -> dict:
    """Return the device description, or raise RuntimeError unless JAX's
    default backend (the platform of ``jax.devices()``) is a GPU. There is
    no CPU fallback."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {devs[0].platform!r}; "
            "this program measures the GPU only")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_info() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
