"""The persistent compilation cache honours JAX_COMPILATION_CACHE_DIR and
otherwise lands at the fixed ``<checkout>/.jax_cache``."""
import os

import jax

from uob_raytracer_tpu import cache


def _record_updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.__setitem__(name, value))
    return calls


def test_cache_dir_from_env(monkeypatch, tmp_path):
    calls = _record_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls   # JAX's own setting
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_cache_dir_default(monkeypatch):
    calls = _record_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(cache.__file__)))
    assert path == os.path.join(checkout, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path
