"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins; otherwise the
fixed repository path."""

import jax

from husky_rover_mppi.utils import cache


def _restore(value):
    jax.config.update("jax_compilation_cache_dir", value)


def test_env_var_is_honored(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets nothing
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        _restore(before)


def test_repo_path_when_unset(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.enable_compile_cache()
        assert path == str(cache.REPO_CACHE)
        assert cache.REPO_CACHE.name == ".jax_cache"
        assert (cache.REPO_CACHE.parent / "run.py").exists()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        _restore(before)
