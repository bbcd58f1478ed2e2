"""Compile-cache placement (``icp_tpu/utils/cache.py``)."""

import os

import jax
import pytest

from icp_tpu.utils import cache

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def config_updates(monkeypatch):
    """Record jax.config.update calls instead of changing this process's
    cache settings."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_set_leaves_the_cache_to_jax(monkeypatch, config_updates,
                                             tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert cache.cache_dir() == str(tmp_path)
    assert config_updates == []  # JAX reads the variable itself


def test_env_var_unset_uses_the_checkout_root(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO_ROOT, ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]


def test_cache_path_is_fixed_and_ignored(monkeypatch, config_updates):
    # the path is part of the cache key: same on every call, never built
    # from a temporary name, a process id or the time
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    paths = {cache.cache_dir() for _ in range(3)}
    assert len(paths) == 1
    path = paths.pop()
    assert str(os.getpid()) not in path and "tmp" not in path.lower()
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_empty_env_var_counts_as_unset(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    assert cache.enable_compile_cache() == os.path.join(REPO_ROOT,
                                                        ".jax_cache")
    assert len(config_updates) == 1
