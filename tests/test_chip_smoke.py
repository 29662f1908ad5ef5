"""``chip_smoke.py``'s phases at a tiny size on the CPU (its own run on the
card is the full-size check), and its refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_phase_fails_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.device_phase()


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def bm25_index():
    return chip_smoke.bm25_phase(
        3000, vocab_size=500, window=128, n_windows=2, n_check=32
    )


def test_bm25_phase_tiny(bm25_index):
    assert bm25_index.num_fields == 1
    assert len(bm25_index.docs) == 3000


def test_prefix_phase_tiny(bm25_index):
    # The heavy-query cache threshold scaled to the tiny corpus.
    bm25_index.config.heavy_cache_min_chunks = 4
    chip_smoke.prefix_phase(bm25_index, ["t004", "t003 t004"], heavy="t")


@pytest.fixture(scope="module")
def z2o_index():
    return chip_smoke.z2o_phase(400, window=64, n_windows=2, n_check=24)


def test_z2o_phase_tiny(z2o_index):
    ix, query = z2o_index
    assert ix.num_fields == 2 and len(query.split()) == 2


def test_mutate_phase_tiny(z2o_index):
    ix, _query = z2o_index
    chip_smoke.mutate_phase(ix, "w0000 w0100")


@pytest.mark.parametrize("phase", ["bm25", "z2o"])
def test_mesh_phases_tiny(phase):
    """The ``--mesh`` path: the same phases through the doc-sharded engine
    on a (1, 4) mesh of virtual CPU devices."""
    import jax

    from probly_search_tpu.parallel import make_mesh

    mesh = make_mesh(data=1, docs=4, devices=jax.devices()[:4])
    if phase == "bm25":
        ix = chip_smoke.bm25_phase(
            2000, vocab_size=400, window=64, n_windows=2, n_check=24, mesh=mesh
        )
    else:
        ix, _q = chip_smoke.z2o_phase(300, window=64, n_windows=2, n_check=24, mesh=mesh)
    assert ix.sharded_index().n_shards == 4
