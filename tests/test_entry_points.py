"""Process-level contracts of the entry points: where the persistent
compile cache lives, and that the GPU smoke test refuses to run anywhere
but on a GPU."""

import os
import subprocess
import sys

import jax

from longreadmapper_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_uses_env_dir_when_set(monkeypatch, tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself; the helper returns it
    and sets no other directory."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout_dir(monkeypatch):
    """Unset: one fixed, git-ignored directory inside the checkout."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        d = compile_cache.enable_compile_cache()
        assert d == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == d
        assert compile_cache.enable_compile_cache() == d   # fixed path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_chip_smoke_fails_without_gpu():
    """On the CPU backend chip_smoke.py stops at its device phase with a
    non-zero exit and prints no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode != 0
    assert "[device] FAILED" in r.stdout, r.stdout[-2000:]
    assert '"ok"' not in r.stdout
