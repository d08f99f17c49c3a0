"""Device-side settings shared by the CLI, the benchmark and the smoke run."""

from __future__ import annotations

import os
import subprocess

from .build import REPO_ROOT

#: Used when ``JAX_COMPILATION_CACHE_DIR`` is not set (gitignored).
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set, else the fixed in-checkout
    directory (a fixed path, so one run's entries are found by the next)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    and return it.  When the environment variable is set JAX already reads
    it, and nothing else is set."""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


def gpu_name_power() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them (run
    in a child process that never imports JAX).  Raises RuntimeError if
    nvidia-smi cannot answer."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"nvidia-smi failed: {exc}") from exc
    return r.stdout.strip()
