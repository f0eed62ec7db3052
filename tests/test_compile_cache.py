"""The persistent compilation cache helper (utils/cache.py)."""
import pathlib

import jax

from mcmc_jl.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _restore():
    old = jax.config.jax_compilation_cache_dir
    return lambda: jax.config.update("jax_compilation_cache_dir", old)


def test_env_dir_is_used_and_nothing_is_set(monkeypatch, tmp_path):
    restore = _restore()
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        restore()


def test_checkout_dir_without_env(monkeypatch):
    restore = _restore()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        restore()


def test_checkout_dir_is_ignored_by_git():
    assert cache.CHECKOUT_CACHE.parent == ROOT
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
