"""Executable caches: the bounded in-process ones and the persistent one.

The driver-level jitted-step caches are keyed by id(params)-bearing
tuples and hold the executables alive; they must be LRU-bounded so
long-lived processes sweeping configurations don't accumulate compiled
executables forever.  The persistent compile cache (cache.py) goes where
JAX_COMPILATION_CACHE_DIR says, else to a fixed directory.
"""

import pathlib

import numpy as np
import pytest

from cloudsc2jax import drivers
from cloudsc2jax.drivers import _LRUCache, run_nl
from cloudsc2jax.state import Cloudsc2State


def test_lru_cache_bounded_and_lru_ordered():
    c = _LRUCache(maxsize=8)
    for i in range(100):
        c[("cfg", i)] = i
    assert len(c) == 8
    assert c.get(("cfg", 99)) == 99
    assert c.get(("cfg", 0)) is None
    # a get refreshes recency: key 92 survives the next insertion
    assert c.get(("cfg", 92)) == 92
    c[("cfg", 100)] = 100
    assert c.get(("cfg", 92)) == 92
    assert c.get(("cfg", 93)) is None


def test_run_nl_cache_stays_bounded_under_config_sweep():
    st = Cloudsc2State.synthetic(ngptot=8, nlev=3)
    inputs = st.kernel_inputs(dtype=np.float32)
    maxsize = drivers._NL_CACHE.maxsize
    # sweep more distinct configs (fresh params objects -> fresh keys)
    # than the cache holds
    for i in range(maxsize + 4):
        params = st.params.replace(ptsphy=3600.0 + i)
        out = run_nl(inputs, params)
        assert np.isfinite(np.asarray(out.tenl_t)).all()
    assert len(drivers._NL_CACHE) <= maxsize


def test_run_nl_cache_hit_reuses_entry():
    st = Cloudsc2State.synthetic(ngptot=8, nlev=3)
    inputs = st.kernel_inputs(dtype=np.float32)
    run_nl(inputs, st.params)
    n = len(drivers._NL_CACHE)
    run_nl(inputs, st.params)  # same params object: must hit, not grow
    assert len(drivers._NL_CACHE) == n


@pytest.mark.parametrize("platform,keyed", [("cpu", True), ("gpu", False)])
def test_compile_cache_dir_without_env(monkeypatch, platform, keyed):
    """Unset JAX_COMPILATION_CACHE_DIR: a fixed .jax_cache/ in the
    checkout; CPU runs only add the host-feature subdirectory."""
    from cloudsc2jax import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = pathlib.Path(cache.compile_cache_dir(platform))
    root = pathlib.Path(__file__).resolve().parents[1] / ".jax_cache"
    if keyed:
        assert path.parent == root and len(path.name) == 12
    else:
        assert path == root


def test_compile_cache_env_sets_nothing(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX already uses it, the program
    sets no other."""
    import jax

    from cloudsc2jax import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir("cpu") is None
    assert cache.compile_cache_dir("gpu") is None
    before = jax.config.jax_compilation_cache_dir
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_uses_the_cpu_dir(monkeypatch):
    import jax

    from cloudsc2jax import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    cache.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == \
        cache.compile_cache_dir("cpu")
