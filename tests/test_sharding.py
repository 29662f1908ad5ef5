"""Multi-chip doc-sharded query path on a virtual 8-device CPU mesh.

Validates that the sharded SPMD program (host-precomputed global dfs,
all-gathered top-k) returns exactly what the single-device device path and
the f64 host oracle return, across shape classes and with host fallback.
"""

import random

import numpy as np
import pytest

import jax

from probly_search_tpu import Index, bm25
from probly_search_tpu.parallel import ShardedDeviceIndex, make_mesh
from .util import Doc, build_test_index, title_extract, tokenizer

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _corpus_index(n=300, seed=5):
    import random

    rng = random.Random(seed)
    vocab = ["".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 5))) for _ in range(150)]
    ix = Index(1)
    for i in range(n):
        text = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 10)))
        ix.add_document([title_extract], tokenizer, i, Doc(id=i, title=text))
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(17)]
    queries += [rng.choice(vocab)[:2] for _ in range(5)]
    return ix, queries


def _assert_rows_match(sharded_rows, oracle_rows, k):
    for sh, orc in zip(sharded_rows, oracle_rows):
        orc = orc[:k]
        assert len(sh) == len(orc)
        sh_scores = {r.key: r.score for r in sh}
        for r in orc:
            assert r.key in sh_scores or any(
                abs(r.score - o.score) < 1e-5 for o in orc
            ), (sh, orc)
        for a, b in zip(sh, sh[1:]):
            assert a.score >= b.score - 1e-6


@pytest.mark.parametrize("data,docs", [(1, 8), (2, 4), (4, 2)])
def test_sharded_matches_oracle(data, docs):
    ix, queries = _corpus_index()
    mesh = make_mesh(data=data, docs=docs)
    sdix = ShardedDeviceIndex(ix, mesh)
    rows = sdix.query_batch(queries, bm25.new(), top_k=10)
    oracle = [ix.query(q, bm25.new(), tokenizer, [1.0]) for q in queries]
    _assert_rows_match(rows, oracle, 10)
    # score closeness per doc
    for sh, orc in zip(rows, oracle):
        om = {r.key: r.score for r in orc}
        for r in sh:
            np.testing.assert_allclose(r.score, om[r.key], rtol=2e-5, atol=1e-6)


def test_sharded_with_deletes():
    ix, queries = _corpus_index(n=120, seed=9)
    for i in range(20, 45):
        ix.remove_document(i)
    mesh = make_mesh(data=2, docs=4)
    sdix = ShardedDeviceIndex(ix, mesh)
    rows = sdix.query_batch(queries[:8], bm25.new(), top_k=10)
    oracle = [ix.query(q, bm25.new(), tokenizer, [1.0]) for q in queries[:8]]
    _assert_rows_match(rows, oracle, 10)


def test_sharded_empty_and_nomatch():
    ix = build_test_index(["abc def", "ghi"])
    mesh = make_mesh(data=1, docs=8)
    sdix = ShardedDeviceIndex(ix, mesh)
    rows = sdix.query_batch(["", "zzz", "abc"], bm25.new(), top_k=5)
    assert rows[0] == [] and rows[1] == []
    assert len(rows[2]) == 1 and rows[2][0].key == 0


def test_sharded_multiple_shape_classes_one_window():
    """A batch mixing light and heavy queries must split into several shape
    classes inside ONE window program, each with correct results."""
    rng = random.Random(2)
    ix = Index(1)
    # 'heavy' matches every doc (8 chunks/shard at 12k docs over 4 shards);
    # light terms ~30 docs each, randomly spread over shards.
    n = 12000
    texts = [f"heavy light{rng.randrange(80)}" for i in range(n)]
    ix.add_documents_columnar(list(range(n)), [texts])
    mesh = make_mesh(data=2, docs=4)
    sdix = ShardedDeviceIndex(ix, mesh)
    queries = ["light3", "heavy", "light7 heavy", "light1 light2"]
    planned, fb = sdix.plan_batch(queries, tokenizer, bm25.new())
    assert fb == []
    _, _, max_chunks, _, _ = planned
    # The queries land in different nc buckets (the prefix query needs 11
    # one-chunk jobs, the heavy term 8 chunks in one job) — several shape
    # classes inside one window program.
    from probly_search_tpu.index.device import _bucket

    buckets = {_bucket(int(c), sdix.NC_BUCKETS, 4) for c in max_chunks}
    assert len(buckets) >= 2, max_chunks
    rows = sdix.query_batch(queries, bm25.new(), top_k=10)
    oracle = [ix.query(q, bm25.new(), tokenizer, [1.0]) for q in queries]
    _assert_rows_match(rows, oracle, 10)


def test_sharded_host_fallback_in_batch():
    """Cap-exceeding queries inside a sharded batch degrade to the host
    path; in-cap queries still run on the mesh."""
    from probly_search_tpu import IndexConfig

    ix = Index(1, config=IndexConfig(max_query_terms=4))
    ix.add_documents_columnar(
        list(range(50)), [[f"w{i % 10} shared" for i in range(50)]]
    )
    mesh = make_mesh(data=1, docs=8)
    sdix = ShardedDeviceIndex(ix, mesh)
    big_q = " ".join(f"w{i % 10}" for i in range(6))
    rows = sdix.query_batch([big_q, "shared"], bm25.new(), top_k=5)
    oracle0 = ix.query(big_q, bm25.new(), tokenizer, [1.0], top_k=5)
    assert [r.key for r in rows[0]] == [r.key for r in oracle0]
    assert len(rows[1]) == 5


def test_sharded_get_arrays_columnar():
    """The sharded columnar drain matches the object API row for row."""
    import numpy as np

    ix, qpool = _corpus_index(n=120, seed=5)
    mesh = make_mesh(data=1, docs=8)
    sdix = ShardedDeviceIndex(ix, mesh)
    queries = [qpool[0], qpool[1][:2], "zzz", ""]
    h = sdix.query_batch_async(queries, bm25.new(), top_k=5)
    scores, slots, keys = h.get_arrays()
    rows = sdix.query_batch(queries, bm25.new(), top_k=5)
    for qi, row in enumerate(rows):
        valid = np.isfinite(scores[qi])
        assert int(valid.sum()) == len(row)
        for j, r in enumerate(row):
            assert keys[qi, j] == r.key
            assert abs(scores[qi, j] - r.score) < 1e-6
            assert slots[qi, j] >= 0


def test_long_jobs_split_instead_of_raise(monkeypatch):
    """A term whose per-shard posting list exceeds the packed job length is
    split into parts (mirroring index/device.py), not rejected."""
    from probly_search_tpu.parallel import dist_query

    monkeypatch.setattr(dist_query, "_MAX_JOB_LEN", 8)
    ix = Index(1)
    for i in range(200):  # per-shard ~25 postings for "tt" > 8
        ix.add_document([title_extract], tokenizer, i, Doc(id=i, title="tt xx" if i % 2 else "tt"))
    mesh = make_mesh(data=1, docs=8)
    sdix = ShardedDeviceIndex(ix, mesh)
    queries = ["tt", "tt xx", "xx"]
    rows = sdix.query_batch(queries, bm25.new(), top_k=10)
    for q, sh in zip(queries, rows):
        full = {r.key: r.score for r in ix.query(q, bm25.new(), tokenizer, [1.0])}
        top10 = sorted(ix.query(q, bm25.new(), tokenizer, [1.0], top_k=10),
                       key=lambda r: -r.score)
        assert len(sh) == len(top10)
        # Same score profile (ties may resolve to different members)...
        for a, b in zip(sh, top10):
            assert abs(a.score - b.score) < 1e-5 * max(1.0, abs(b.score))
        # ...and every returned key carries its own oracle score.
        for a in sh:
            assert abs(a.score - full[a.key]) < 1e-5 * max(1.0, abs(full[a.key]))


class TestUnifiedRouting:
    def test_attach_mesh_routes_query_batch(self):
        ix, queries = _corpus_index(n=120, seed=9)
        mesh = make_mesh(data=2, docs=4)
        ix.attach_mesh(mesh)
        rows = ix.query_batch(queries[:6], bm25.new(), tokenizer, top_k=10)
        oracle = [ix.query(q, bm25.new(), tokenizer, [1.0], top_k=10) for q in queries[:6]]
        for sh, orc in zip(rows, oracle):
            assert len(sh) == len(orc)
            for a, b in zip(sh, orc):
                assert abs(a.score - b.score) < 1e-5 * max(1.0, abs(b.score))
        # detach: back to single-chip serving
        ix.attach_mesh(None)
        rows2 = ix.query_batch(queries[:2], bm25.new(), tokenizer, top_k=10)
        assert len(rows2) == 2

    def test_sharded_snapshot_cache_and_invalidation(self):
        ix, _ = _corpus_index(n=60, seed=11)
        mesh = make_mesh(data=1, docs=8)
        ix.attach_mesh(mesh)
        s1 = ix.sharded_index()
        assert ix.sharded_index() is s1  # cache hit, no rebuild
        victim = next(iter(ix.docs))
        ix.remove_document(victim)
        s2 = ix.sharded_index()
        assert s2 is not s1  # mutation invalidates
        rows = ix.query_batch(["a"], bm25.new(), tokenizer, top_k=50)
        assert all(r.key != victim for r in rows[0])

    def test_capacity_overflow_autoshards(self, monkeypatch):
        from probly_search_tpu.index.core import Index as CoreIndex

        ix, queries = _corpus_index(n=80, seed=13)

        def boom(self):
            raise ValueError("doc slots exceed the packed int32 merge-key capacity")

        monkeypatch.setattr(CoreIndex, "device_index", boom)
        rows = ix.query_batch(queries[:3], bm25.new(), tokenizer, top_k=10)
        oracle = [ix.query(q, bm25.new(), tokenizer, [1.0], top_k=10) for q in queries[:3]]
        for sh, orc in zip(rows, oracle):
            assert len(sh) == len(orc)
            for a, b in zip(sh, orc):
                assert abs(a.score - b.score) < 1e-5 * max(1.0, abs(b.score))
        from probly_search_tpu.utils.metrics import metrics

        assert metrics.counters["auto_sharded_batches"] >= 1


class TestShardedZeroToOne:
    """Sharded zero-to-one (fast program + host-lockstep fallback)."""

    def _two_field_index(self, n=240, seed=17):
        import random as _r

        from probly_search_tpu import whitespace_tokenizer

        rng = _r.Random(seed)
        vocab = ["".join(rng.choice("abcd") for _ in range(rng.randint(1, 4)))
                 for _ in range(50)]
        ix = Index(2)
        for i in range(n):
            t = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3)))
            b = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 5)))
            ix.add_document(
                [lambda d: [d[0]], lambda d: [d[1]]], whitespace_tokenizer, i, (t, b)
            )
        for i in range(0, n, 13):
            ix.remove_document(i)
        return ix, vocab

    def _assert_z2o_rows(self, ix, queries, rows, k=10):
        from probly_search_tpu import zero_to_one, whitespace_tokenizer

        for q, row in zip(queries, rows):
            oracle = ix.query(
                q, zero_to_one.new(), whitespace_tokenizer, [1.0] * ix.num_fields
            )[:k]
            assert len(row) == len(oracle), (q, row, oracle)
            np.testing.assert_allclose(
                sorted(r.score for r in row),
                sorted(r.score for r in oracle),
                rtol=1e-5, atol=1e-7, err_msg=q,
            )
            full = {
                r.key: r.score
                for r in ix.query(
                    q, zero_to_one.new(), whitespace_tokenizer, [1.0] * ix.num_fields
                )
            }
            for r in row:
                np.testing.assert_allclose(r.score, full[r.key], rtol=1e-5, atol=1e-7)

    def test_sharded_z2o_matches_oracle(self):
        import random as _r

        from probly_search_tpu import zero_to_one

        ix, vocab = self._two_field_index()
        rng = _r.Random(23)
        queries = [
            " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3)))
            for _ in range(12)
        ]
        queries += ["", "zzzz", vocab[0][:1]]
        t = vocab[3]
        queries += [f"{t} {t}", f"{t[:1]} {t}"]  # shared-node -> host lockstep
        mesh = make_mesh(data=2, docs=4)
        sdix = ShardedDeviceIndex(ix, mesh)
        rows = sdix.query_batch_z2o(queries, zero_to_one.new(), top_k=10).get()
        self._assert_z2o_rows(ix, queries, rows)

    def test_sharded_z2o_wide_schema_runs_on_device(self):
        """F=12 z2o on the mesh: fields ride as sort
        VALUES in the fast program, so wide schemas must run on-device —
        not fall back to host wholesale."""
        import random as _r

        from probly_search_tpu import whitespace_tokenizer, zero_to_one
        from probly_search_tpu.utils.metrics import metrics

        F = 12
        rng = _r.Random(41)
        vocab = ["".join(rng.choice("abcd") for _ in range(rng.randint(1, 4)))
                 for _ in range(40)]
        ix = Index(F)
        accs = [(lambda f: (lambda d: [d[f]]))(f) for f in range(F)]
        for i in range(90):
            row = tuple(
                " ".join(rng.choice(vocab) for _ in range(rng.randint(0, 3)))
                for _ in range(F)
            )
            ix.add_document(accs, whitespace_tokenizer, i, row)
        for i in range(0, 90, 11):
            ix.remove_document(i)

        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", vocab[3][:1], ""]
        metrics.reset()
        sdix = ShardedDeviceIndex(ix, make_mesh(data=2, docs=4))
        rows = sdix.query_batch_z2o(queries, zero_to_one.new(), top_k=10).get()
        snap = metrics.snapshot()["counters"]
        # the non-empty queries must NOT have degraded to host
        assert snap.get("device_fallback_queries", 0) == 0, snap
        assert snap.get("z2o_host_vectorized_queries", 0) == 0, snap
        self._assert_z2o_rows(ix, queries, rows)

    def test_sharded_z2o_shared_node_runs_lockstep_on_device(self):
        """Shared-node queries (duplicate terms / overlapping expansions)
        run the exact lockstep program PER SHARD —
        only cap-exceeding queries may fall back to host."""
        from probly_search_tpu import whitespace_tokenizer, zero_to_one
        from probly_search_tpu.utils.metrics import metrics

        ix, vocab = self._two_field_index(n=160, seed=37)
        t = vocab[2]
        queries = [
            f"{t} {t}",            # duplicate term -> one shared node
            f"{t[:1]} {t}",        # prefix overlap -> shared node
            f"{t} {vocab[5]} {t}",
            vocab[7],              # plain fast-program query in the same batch
        ]
        metrics.reset()
        sdix = ShardedDeviceIndex(ix, make_mesh(data=2, docs=4))
        rows = sdix.query_batch_z2o(queries, zero_to_one.new(), top_k=10).get()
        snap = metrics.snapshot()["counters"]
        assert snap.get("z2o_sharded_lockstep_queries", 0) >= 3, snap
        assert snap.get("device_fallback_queries", 0) == 0, snap
        self._assert_z2o_rows(ix, queries, rows)

    def test_attach_mesh_routes_z2o(self):
        from probly_search_tpu import zero_to_one

        ix, vocab = self._two_field_index(n=120, seed=29)
        ix.attach_mesh(make_mesh(data=1, docs=8))
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}"]
        rows = ix.query_batch(queries, zero_to_one.new(), top_k=10)
        self._assert_z2o_rows(ix, queries, rows)

    def test_sharded_z2o_get_arrays(self):
        from probly_search_tpu import zero_to_one

        ix, vocab = self._two_field_index(n=100, seed=31)
        sdix = ShardedDeviceIndex(ix, make_mesh(data=1, docs=8))
        queries = [vocab[0], ""]
        h = sdix.query_batch_z2o(queries, zero_to_one.new(), top_k=5)
        scores, slots, keys = h.get_arrays()
        rows = sdix.query_batch_z2o(queries, zero_to_one.new(), top_k=5).get()
        valid = np.isfinite(scores[0])
        assert int(valid.sum()) == len(rows[0])
        for j, r in enumerate(rows[0]):
            assert keys[0, j] == r.key
            assert abs(scores[0, j] - r.score) < 1e-6


def test_sharded_term_range_jobs():
    """Expansion-heavy queries run on the mesh via per-shard range jobs."""
    from probly_search_tpu import IndexConfig

    rng = random.Random(41)
    prefixed = ["qq" + "".join(rng.choice("rstu") for _ in range(j % 3 + 1))
                for j in range(30)]
    vocab = sorted(set(prefixed)) + ["zz1", "zz2"]
    ix = Index(1, config=IndexConfig(range_min_expansions=4))
    texts = [" ".join(rng.choice(vocab) for _ in range(4)) for _ in range(400)]
    ix.add_documents_columnar(list(range(400)), [texts])
    for i in range(0, 400, 23):
        ix.remove_document(i)
    mesh = make_mesh(data=2, docs=4)
    sdix = ShardedDeviceIndex(ix, mesh)
    queries = ["qq", "qqr", "qq zz1", "zz2", "q"]
    planned, fb = sdix.plan_batch(queries, tokenizer, bm25.new())
    assert fb == []
    assert list(planned[4]) == [True, True, True, False, True]  # has_range
    rows = sdix.query_batch(queries, bm25.new(), top_k=10)
    for q, sh in zip(queries, rows):
        full = {r.key: r.score for r in ix.query(q, bm25.new(), tokenizer, [1.0])}
        want = ix.query(q, bm25.new(), tokenizer, [1.0], top_k=10)
        assert len(sh) == len(want), q
        for a, b in zip(sh, want):
            assert abs(a.score - b.score) < 2e-5 * max(1.0, abs(b.score)), q
        for a in sh:
            assert abs(a.score - full[a.key]) < 2e-5 * max(1.0, abs(full[a.key])), q


class TestShardedFusedInterpret:
    """The per-shard query programs under ``shard_map`` with n_shards > 1
    and the default varying-mesh-axes check: the staged BM25 step and the
    z2o fast program, per shard on the 8-device CPU mesh, against the f64
    oracle."""

    def test_sharded_bm25_fused_matches_oracle(self):
        ix, queries = _corpus_index(n=260, seed=13)
        mesh = make_mesh(data=2, docs=4)
        sdix = ShardedDeviceIndex(ix, mesh)
        assert sdix.n_shards == 4
        rows = sdix.query_batch(queries, bm25.new(), top_k=10)
        oracle = [ix.query(q, bm25.new(), tokenizer, [1.0]) for q in queries]
        _assert_rows_match(rows, oracle, 10)
        for sh, orc in zip(rows, oracle):
            om = {r.key: r.score for r in orc}
            for r in sh:
                np.testing.assert_allclose(r.score, om[r.key], rtol=2e-5, atol=1e-6)

    def test_sharded_z2o_fused_matches_oracle(self):
        import random as _r

        from probly_search_tpu import zero_to_one

        rng = _r.Random(37)
        vocab = ["".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 5)))
                 for _ in range(150)]
        ix = Index(1)
        texts = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 8)))
                 for _ in range(240)]
        ix.add_documents_columnar(list(range(240)), [texts])
        queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3)))
                   for _ in range(10)] + [vocab[0][:2], ""]
        mesh = make_mesh(data=2, docs=4)
        sdix = ShardedDeviceIndex(ix, mesh)
        rows = sdix.query_batch_z2o(queries, zero_to_one.new(), top_k=10).get()
        for q, row in zip(queries, rows):
            want = ix.query(q, zero_to_one.new(), tokenizer, [1.0], top_k=10)
            assert len(row) == len(want), q
            for a, b in zip(row, want):
                assert abs(a.score - b.score) < 1e-5 * max(1.0, abs(b.score)), q


# ---------------------------------------------------------------------- #
# r4: serving parity with the single-chip engine                          #
# ---------------------------------------------------------------------- #


class TestShardedResultFormats:
    """Every result format serves through the sharded window: rankings
    identical to the oracle; slots formats carry no
    scores; compact's f16-quantized scores stay within ~5e-4."""

    @pytest.mark.parametrize("fmt", ["f32", "compact", "slots", "slots20"])
    def test_format_matches_oracle(self, fmt):
        from probly_search_tpu.config import IndexConfig
        from probly_search_tpu import whitespace_tokenizer

        ix, queries = _corpus_index(n=220, seed=11)
        ix.config.result_format = fmt
        mesh = make_mesh(data=2, docs=4)
        sdix = ShardedDeviceIndex(ix, mesh)
        h = sdix.query_batch_async(queries, bm25.new(), top_k=10)
        scores, slots, keys = h.get_arrays()
        assert slots.shape == (len(queries), 10)
        if fmt.startswith("slots"):
            assert scores is None
        for qi, q in enumerate(queries):
            want = ix.query(q, bm25.new(), tokenizer, [1.0], top_k=10)
            got_keys = [int(kk) for kk, sl in zip(keys[qi], slots[qi]) if sl >= 0]
            want_keys = [r.key for r in want]
            # Ties may order differently across engines; compare score-
            # equivalence classes via the oracle's scores.
            oracle_by_key = {r.key: r.score for r in want}
            assert len(got_keys) == len(want_keys), (q, got_keys, want_keys)
            # every returned doc must score within the oracle's top-k range
            if want:
                kth = want[-1].score
                for kk in got_keys:
                    full = ix.query(q, bm25.new(), tokenizer, [1.0])
                    by_key = {r.key: r.score for r in full}
                    assert by_key[kk] >= kth - 1e-6
            if scores is not None:
                tol = 1e-3 if fmt == "compact" else 2e-5
                got_scores = [
                    float(s) for s, sl in zip(scores[qi], slots[qi]) if sl >= 0
                ]
                for gs, r in zip(got_scores, want):
                    assert abs(gs - r.score) <= tol * max(1.0, abs(r.score)), q

    def test_slots_get_raises(self):
        from probly_search_tpu.config import IndexConfig

        ix, queries = _corpus_index(n=60, seed=3)
        ix.config.result_format = "slots"
        sdix = ShardedDeviceIndex(ix, make_mesh(data=1, docs=8))
        h = sdix.query_batch_async(queries[:4], bm25.new(), top_k=5)
        with pytest.raises(ValueError, match="slots"):
            h.get()

    def test_z2o_sharded_formats(self):
        from probly_search_tpu import zero_to_one
        from probly_search_tpu.models.zero_to_one import vectorized_query

        for fmt in ("slots", "f32"):
            ix, _ = _corpus_index(n=120, seed=9)
            ix.config.result_format = fmt
            queries = ["ab", "abc d", "ba"]
            sdix = ShardedDeviceIndex(ix, make_mesh(data=1, docs=8))
            h = sdix.query_batch_z2o(queries, tokenizer=tokenizer, top_k=10)
            scores, slots, keys = h.get_arrays()
            for qi, q in enumerate(queries):
                want = vectorized_query(ix, q, tokenizer, top_k=10)
                got = [int(kk) for kk, sl in zip(keys[qi], slots[qi]) if sl >= 0]
                assert len(got) == len(want), (fmt, q)
                if scores is not None and want:
                    by_key = dict(zip(got, scores[qi][slots[qi] >= 0]))
                    for r in want:
                        if r.key in by_key:
                            assert abs(by_key[r.key] - r.score) < 2e-5


class TestShardedPlanCache:
    def test_repeated_queries_skip_replanning(self, monkeypatch):
        ix, queries = _corpus_index(n=100, seed=21)
        sdix = ShardedDeviceIndex(ix, make_mesh(data=1, docs=8))
        r1 = sdix.query_batch(queries, bm25.new(), top_k=5)
        # Second window with the same queries must assemble purely from the
        # pool — a fresh planning pass would call _plan_batch_impl.
        def boom(*a, **k):
            raise AssertionError("replanned a cached query")

        monkeypatch.setattr(sdix, "_plan_batch_impl", boom)
        r2 = sdix.query_batch(queries, bm25.new(), top_k=5)
        for a_row, b_row in zip(r1, r2):
            assert [r.key for r in a_row] == [r.key for r in b_row]
            for a, b in zip(a_row, b_row):
                assert a.score == b.score

    def test_pool_mixes_new_and_cached(self):
        ix, queries = _corpus_index(n=100, seed=22)
        sdix = ShardedDeviceIndex(ix, make_mesh(data=2, docs=4))
        half = queries[: len(queries) // 2]
        sdix.query_batch(half, bm25.new(), top_k=5)
        rows = sdix.query_batch(queries, bm25.new(), top_k=5)
        for q, row in zip(queries, rows):
            want = ix.query(q, bm25.new(), tokenizer, [1.0], top_k=5)
            assert [r.key for r in row] == [r.key for r in want], q


def test_sharded_pad_row_trim():
    # >256 queries in one class: b_pad rounds to a power of two, b_out trims
    # the fetch to 256-row granularity.  Parity must hold under the trim.
    rng = random.Random(31)
    vocab = ["w%02d" % i for i in range(40)]
    ix = Index(1)
    texts = [" ".join(rng.choice(vocab) for _ in range(4)) for _ in range(400)]
    ix.add_documents_columnar(list(range(400)), [texts])
    queries = [rng.choice(vocab) + "x" for _ in range(10)]  # no-match filler
    queries += [rng.choice(vocab) for _ in range(590)]
    sdix = ShardedDeviceIndex(ix, make_mesh(data=1, docs=8))
    h = sdix.query_batch_async(queries, bm25.new(), top_k=5)
    # The packed result must carry FEWER rows than the pow-2 b_pad sum.
    total_rows = int(np.asarray(h._packed).shape[2])
    scores, slots, keys = h.get_arrays()
    sample = list(range(0, len(queries), 37))
    from probly_search_tpu import whitespace_tokenizer
    for qi in sample:
        want = ix.query(queries[qi], bm25.new(), whitespace_tokenizer, [1.0], top_k=5)
        got = [int(kk) for kk, sl in zip(keys[qi], slots[qi]) if sl >= 0]
        assert got == [r.key for r in want], queries[qi]
    # 590 real queries in the dominant class: b_pad 1024, b_out 768.
    assert total_rows < 1024


class TestShardedPruning:
    """Sharded block-max pruning (index/prune.py prune_plan_sharded):
    trim-only, exact — rows must be IDENTICAL (keys + bit-equal f32
    scores) with pruning on and off, and the skewed corpus must actually
    trim (`prune/sharded_trimmed_chunks` counter)."""

    def _skewed(self, prune, n=1200, fields=1):
        from probly_search_tpu.config import IndexConfig

        ix = Index(
            fields, config=IndexConfig(chunk_size=128, prune_blocks=prune)
        )
        col = []
        for i in range(n):
            if i < 10:
                col.append("common common common common")
            else:
                col.append(f"common f{i % 97} g{i % 89} h{i % 83} j{i % 79}")
        cols = [col] + [["x"] * n for _ in range(fields - 1)]
        ix.add_documents_columnar(list(range(n)), cols)
        return ix

    def _trimmed(self):
        from probly_search_tpu.utils.metrics import metrics

        return metrics.snapshot()["counters"].get(
            "prune/sharded_trimmed_chunks", 0
        )

    def test_trims_and_stays_bit_equal(self):
        ix_on = self._skewed(True)
        ix_off = self._skewed(False)
        mesh = make_mesh(data=2, docs=4)
        s_on = ShardedDeviceIndex(ix_on, mesh)
        s_off = ShardedDeviceIndex(ix_off, mesh)
        queries = ["common", "common f10", "f11 g12", "zzz", "", "common h3 j4"]
        before = self._trimmed()
        r_on = s_on.query_batch(queries, bm25.new(), top_k=3)
        assert self._trimmed() > before, "skewed mix must trim chunks"
        r_off = s_off.query_batch(queries, bm25.new(), top_k=3)
        for q, a_row, b_row in zip(queries, r_on, r_off):
            assert [r.key for r in a_row] == [r.key for r in b_row], q
            for a, b in zip(a_row, b_row):
                assert a.score == b.score, (q, a.key)
        # and matches the f64 oracle ranking
        from probly_search_tpu import whitespace_tokenizer

        for q, row in zip(queries, r_on):
            want = ix_on.query(q, bm25.new(), whitespace_tokenizer, [1.0], top_k=3)
            assert [r.key for r in row] == [r.key for r in want], q

    def test_per_call_toggle_and_boosts(self):
        ix = self._skewed(True, fields=2)
        sdix = ShardedDeviceIndex(ix, make_mesh(data=1, docs=8))
        queries = ["common", "common f10"]
        for boost in ([1.0, 1.0], [2.0, 0.5], [0.0, 1.0]):
            r_on = sdix.query_batch(queries, bm25.new(), fields_boost=boost, top_k=3)
            sdix.config.prune_blocks = False
            r_off = sdix.query_batch(queries, bm25.new(), fields_boost=boost, top_k=3)
            sdix.config.prune_blocks = True
            for q, a_row, b_row in zip(queries, r_on, r_off):
                assert [r.key for r in a_row] == [r.key for r in b_row], (q, boost)
                for a, b in zip(a_row, b_row):
                    assert a.score == b.score, (q, boost)

    def test_repeat_window_rides_cache(self):
        # Second serve of the same window must splice memoized trims
        # (prune/sharded_cache_fills stays flat) and return identical
        # rows (index/prune.py prune_plan_sharded_cached).
        from probly_search_tpu.utils.metrics import metrics

        def fills():
            return metrics.snapshot()["counters"].get(
                "prune/sharded_cache_fills", 0
            )

        ix = self._skewed(True)
        sdix = ShardedDeviceIndex(ix, make_mesh(data=2, docs=4))
        queries = ["common", "common f10", "f11 g12", "common"]
        first = sdix.query_batch(queries, bm25.new(), top_k=3)
        filled = fills()
        assert filled > 0
        again = sdix.query_batch(queries, bm25.new(), top_k=3)
        assert fills() == filled, "repeat window must not refill"
        assert (
            metrics.snapshot()["counters"].get(
                "prune/sharded_cache_splices", 0
            )
            > 0
        ), "the skewed mix has trimmed queries, so repeats must splice"
        for q, a_row, b_row in zip(queries, first, again):
            assert [r.key for r in a_row] == [r.key for r in b_row], q
            for a, b in zip(a_row, b_row):
                assert a.score == b.score, (q, a.key)

    def test_k_gate_and_mutation_resnapshot(self):
        # k above prune_max_top_k must not prune; after mutation the new
        # snapshot's bounds still give identical answers.
        from probly_search_tpu import whitespace_tokenizer

        ix = self._skewed(True)
        sdix = ShardedDeviceIndex(ix, make_mesh(data=2, docs=4))
        before = self._trimmed()
        sdix.query_batch(["common"], bm25.new(), top_k=ix.config.prune_max_top_k + 1)
        assert self._trimmed() == before, "k above the ladder must not prune"
        # mutate + fresh sharded snapshot
        ix.remove_document(3)
        ix.add_document(
            [lambda d: [d]], whitespace_tokenizer, 5000, "common common common"
        )
        ix._flush_pending()
        sdix2 = ShardedDeviceIndex(ix, make_mesh(data=2, docs=4))
        r = sdix2.query_batch(["common", "common f10"], bm25.new(), top_k=3)
        for q, row in zip(["common", "common f10"], r):
            want = ix.query(q, bm25.new(), whitespace_tokenizer, [1.0], top_k=3)
            assert [x.key for x in row] == [x.key for x in want], q
