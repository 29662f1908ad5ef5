"""Entry points: ``__graft_entry__`` and the compile-cache helper."""

import os

import jax
import numpy as np
import pytest

import __graft_entry__ as graft
from probly_search_tpu.utils import compile_cache


def test_entry_runs():
    fn, args = graft.entry()
    scores, docs = jax.jit(fn)(*args)
    assert np.asarray(scores).shape == np.asarray(docs).shape
    assert np.asarray(scores).shape[-1] == 10
    assert (np.asarray(docs) >= 0).any()


def test_dryrun_multichip_raises_with_too_few_devices():
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(len(jax.devices()) * 2)


def test_dryrun_multichip_on_four_devices():
    assert len(jax.devices()) >= 4
    graft.dryrun_multichip(4)


@pytest.fixture
def restore_cache_config():
    prev = (
        jax.config.jax_compilation_cache_dir,
        jax.config.jax_persistent_cache_min_compile_time_secs,
    )
    yield
    jax.config.update("jax_compilation_cache_dir", prev[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", prev[1])


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX's own setting


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    want = os.path.join(os.path.dirname(os.path.dirname(__file__)), ".jax_cache")
    assert compile_cache.compile_cache_dir() == want
    assert compile_cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
