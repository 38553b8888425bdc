"""Persistent compile cache for every entry point (CLI, bench, tools, tests).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
module sets nothing.  Otherwise the cache goes to a fixed ``.jax_cache/``
in the checkout: the path is part of what makes a cache hit, so it must
not move between runs.

CPU runs get one more level, a subdirectory keyed by the host's CPU
features and the jax version: XLA:CPU executables encode the compiling
machine's feature set, and loading one on a host with other features
aborts with "Machine type used for XLA:CPU compilation doesn't match the
machine type for execution".  GPU executables carry no such dependence,
so GPU runs never use the subdirectory.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import platform

_REPO = pathlib.Path(__file__).resolve().parents[1]


def _host_fingerprint() -> str:
    """Short stable id for (CPU feature set, jax version) pairs."""
    bits = [platform.machine(), platform.system()]
    try:
        import jax

        bits.append(jax.__version__)
    except Exception:
        pass
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    bits.append(" ".join(sorted(line.split(":", 1)[1].split())))
                    break
    except OSError:
        pass
    return hashlib.sha256("|".join(bits).encode()).hexdigest()[:12]


def compile_cache_dir(jax_platform: str) -> str | None:
    """The cache directory this module would set for ``jax_platform``, or
    None when ``JAX_COMPILATION_CACHE_DIR`` already places it."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    base = _REPO / ".jax_cache"
    if jax_platform == "cpu":
        base = base / _host_fingerprint()
    return str(base)


def enable_compile_cache() -> None:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`
    for the default backend (call it after any ``jax.distributed``
    initialisation, which must precede the backends).

    Safe to call from any entry point, any number of times."""
    import jax

    path = compile_cache_dir(jax.default_backend())
    if path is None:
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
