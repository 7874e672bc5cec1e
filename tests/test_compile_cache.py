"""The persistent-compilation-cache helper every entry point calls."""

import os

import jax

from fibers_tpu.utils import compile_cache


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_var_set_is_used_and_nothing_else_set(monkeypatch, tmp_path):
    calls = _spy(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert not [c for c in calls if c[0] == "jax_compilation_cache_dir"]


def test_env_var_unset_uses_fixed_path_in_checkout(monkeypatch):
    calls = _spy(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls
