"""Process set-up for the scripts that run on an accelerator.

``chip_smoke.py``, ``bench.py``, ``profile.py`` and ``tools/bench_batched.py``
call these helpers at start-up; importing the library does not.

- :func:`enable_compile_cache` points JAX's persistent compilation cache at
  ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and otherwise at the fixed
  path ``<repo>/.jax_cache`` (listed in ``.gitignore``). The path is part of
  the cache's key, so it must not move between runs.
- :func:`require_gpu` refuses a process whose devices are not all GPUs: a
  measurement taken on the CPU is never reported as a device number.
- :func:`gpu_card` reads the card's name and power limit from ``nvidia-smi``
  without touching JAX.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["compile_cache_dir", "enable_compile_cache", "require_gpu",
           "gpu_card", "describe_devices"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ=None) -> str:
    """The persistent compile-cache directory this process should use."""
    environ = os.environ if environ is None else environ
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and this
    sets no other directory."""
    import jax

    path = compile_cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices=None):
    """Return ``devices`` (default ``jax.devices()``) if every one is a GPU;
    raise ``RuntimeError`` otherwise."""
    if devices is None:
        import jax

        devices = jax.devices()
    platforms = sorted({d.platform for d in devices})
    if not devices or platforms != ["gpu"]:
        raise RuntimeError(
            f"no GPU: JAX sees platform(s) {platforms or ['none']}; this "
            "script measures the card and does not fall back to the CPU")
    return devices


def gpu_card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per card
    (a child process: never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def describe_devices(devices) -> dict:
    """The device as JAX reports it, for the record every result carries."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}
