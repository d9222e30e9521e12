"""``utils.compile_cache``: the one place that turns on JAX's cache."""

import os

import jax
import pytest

from ai_safety_gridworlds_tpu.utils import compile_cache


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_variable_set_leaves_the_cache_to_jax(monkeypatch, tmp_path,
                                              restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_variable_unset_uses_the_repo_directory(monkeypatch,
                                                restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path == compile_cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.dirname(path) == compile_cache.REPO_ROOT
    assert os.path.isfile(
        os.path.join(compile_cache.REPO_ROOT, "chip_smoke.py")
    )


def test_repo_cache_directory_is_ignored_by_git():
    with open(os.path.join(compile_cache.REPO_ROOT, ".gitignore")) as f:
        ignored = {line.strip() for line in f}
    name = os.path.basename(compile_cache.DEFAULT_DIR)
    assert name + "/" in ignored or name in ignored
