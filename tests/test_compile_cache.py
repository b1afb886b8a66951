"""Where the persistent compilation cache goes (utils/compile_cache.py)."""

import os

import jax

from lightpycl_tpu.utils import compile_cache


def _spy(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    return calls


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    calls = _spy(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_fallback_is_inside_the_checkout(monkeypatch):
    calls = _spy(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_fallback_is_gitignored():
    root = compile_cache.CHECKOUT
    with open(root / ".gitignore") as f:
        assert ".jax_cache/" in f.read().split()
