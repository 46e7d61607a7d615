"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set and otherwise sits at <checkout>/.jax_cache — never a temporary or
per-process path."""

import os

from stochquant import compile_cache


def _capture(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_env_directory_is_left_to_jax(monkeypatch, tmp_path):
    calls = _capture(monkeypatch)
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cache"))
    assert compile_cache.configure() == str(tmp_path / "cache")
    assert calls == []


def test_default_directory_is_the_checkout_cache(monkeypatch):
    calls = _capture(monkeypatch)
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    path = compile_cache.configure()
    root = os.path.dirname(os.path.dirname(os.path.abspath(compile_cache.__file__)))
    assert path == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    assert compile_cache.configure() == path  # fixed, not per call


def test_gitignore_lists_the_default_directory():
    root = os.path.dirname(os.path.dirname(os.path.abspath(compile_cache.__file__)))
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
