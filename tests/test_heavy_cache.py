"""Heavy-query result cache: queries whose plan spans
a huge posting range are answered from a snapshot-static per-(scorer,
job-table, boosts) top-k cache — exact because the job table IS the
device-program input."""

import random

import numpy as np

from probly_search_tpu import Index, bm25, whitespace_tokenizer
from probly_search_tpu.config import IndexConfig
from probly_search_tpu.utils.metrics import metrics


def _index(cfg, n=400, seed=13):
    rng = random.Random(seed)
    vocab = [
        "aa" + "".join(rng.choice("bcd") for _ in range(rng.randint(0, 3)))
        for _ in range(40)
    ] + ["zz%d" % i for i in range(20)]
    ix = Index(1, config=cfg)
    texts = [
        " ".join(rng.choice(vocab) for _ in range(5)) for _ in range(n)
    ]
    ix.add_documents_columnar(list(range(n)), [texts])
    return ix


def _oracle(ix, q, k=10):
    return [r.key for r in ix.query(q, bm25.new(), whitespace_tokenizer, [1.0])[:k]]


class TestHeavyCache:
    def test_hit_matches_oracle_and_counts(self):
        # min_chunks=1: every planned device query routes through the cache.
        ix = _index(IndexConfig(heavy_cache_min_chunks=1))
        dix = ix.device_index()
        queries = ["aa", "a", "aab zz1", "zz1"]
        metrics.reset()
        r1 = dix.query_batch(queries, bm25.new(), top_k=10)
        snap1 = metrics.snapshot()["counters"]
        r2 = dix.query_batch(queries, bm25.new(), top_k=10)
        snap2 = metrics.snapshot()["counters"]
        assert snap1.get("heavy_cache_misses", 0) >= 1
        assert snap2.get("heavy_cache_hits", 0) >= snap1.get("heavy_cache_hits", 0) + 1
        for q, row_a, row_b in zip(queries, r1, r2):
            want = _oracle(ix, q)
            assert [r.key for r in row_a] == want, q
            assert [r.key for r in row_b] == want, q
            for a, b in zip(row_a, row_b):
                assert a.score == b.score

    def test_mixed_window_cached_and_live(self):
        # Threshold catches only the prefix-expansion query; the rest run
        # the normal packed window alongside the cached row.
        ix = _index(IndexConfig(heavy_cache_min_chunks=2))
        dix = ix.device_index()
        queries = ["a", "zz1", "zz2 zz3", ""]
        dix.query_batch(queries, bm25.new(), top_k=10)  # populate
        rows = dix.query_batch(queries, bm25.new(), top_k=10)
        for q, row in zip(queries, rows):
            assert [r.key for r in row] == _oracle(ix, q), q

    def test_get_arrays_with_cached_rows(self):
        ix = _index(IndexConfig(heavy_cache_min_chunks=1, result_format="slots"))
        dix = ix.device_index()
        h = dix.query_batch_async(["aa", "zz1"], bm25.new(), top_k=10)
        s, slots, keys = h.get_arrays()
        assert s is None
        got = [int(kk) for kk, sl in zip(keys[0], slots[0]) if sl >= 0]
        assert got == _oracle(ix, "aa")

    def test_boost_and_k_keyed(self):
        ix = _index(IndexConfig(heavy_cache_min_chunks=1))
        dix = ix.device_index()
        r1 = dix.query_batch(["aa"], bm25.new(), top_k=10)
        r2 = dix.query_batch(["aa"], bm25.new(), fields_boost=[2.0], top_k=10)
        # boost=2 doubles every score (single field), same ranking
        assert [r.key for r in r1[0]] == [r.key for r in r2[0]]
        for a, b in zip(r1[0], r2[0]):
            np.testing.assert_allclose(b.score, 2.0 * a.score, rtol=1e-6)
        # k beyond the cache depth bypasses the cache but stays correct
        big_k = dix.config.heavy_cache_top_k + 8
        r3 = dix.query_batch(["aa"], bm25.new(), top_k=big_k)
        assert [r.key for r in r3[0]][:10] == [r.key for r in r1[0]]

    def test_disabled(self):
        ix = _index(IndexConfig(heavy_cache_min_chunks=0))
        dix = ix.device_index()
        metrics.reset()
        rows = dix.query_batch(["aa", "zz1"], bm25.new(), top_k=10)
        assert metrics.snapshot()["counters"].get("heavy_cache_misses", 0) == 0
        assert [r.key for r in rows[0]] == _oracle(ix, "aa")


class TestHeavyCacheLRU:
    def test_repeated_stream_mostly_hits(self):
        # A long heavy-query stream whose working set
        # fits the cache must never recompute more than ~20% of repeats.
        ix = _index(IndexConfig(heavy_cache_min_chunks=1))
        dix = ix.device_index()
        rng = random.Random(7)
        hot = ["aa", "aab zz1", "zz1", "zz2", "aab", "zz3 aa"]
        stream = [rng.choice(hot) for _ in range(5000)]
        metrics.reset()
        for s0 in range(0, len(stream), 250):
            dix.query_batch(stream[s0 : s0 + 250], bm25.new(), top_k=10)
        c = metrics.snapshot()["counters"]
        hits = c.get("heavy_cache_hits", 0)
        misses = c.get("heavy_cache_misses", 0)
        assert misses <= len(hot)  # one compute per distinct query
        assert hits >= 0.8 * (hits + misses)

    def test_lru_keeps_hot_entry_under_eviction(self, monkeypatch):
        ix = _index(IndexConfig(heavy_cache_min_chunks=1))
        dix = ix.device_index()
        monkeypatch.setattr(type(dix), "_HEAVY_CACHE_CAP", 3)
        cold = ["zz%d" % i for i in range(12)]
        dix.query_batch(["aa"], bm25.new(), top_k=10)  # populate hot
        metrics.reset()
        # Interleave: the hot query between cold ones.  LRU keeps "aa"
        # resident (it is touched every other window); clear-all would
        # recompute it after every wraparound.
        for i, c in enumerate(cold):
            dix.query_batch(["aa"], bm25.new(), top_k=10)
            dix.query_batch([c], bm25.new(), top_k=10)
        counters = metrics.snapshot()["counters"]
        # "aa" hits every one of its 12 windows; only cold queries miss.
        assert counters.get("heavy_cache_hits", 0) >= len(cold)
        assert counters.get("heavy_cache_misses", 0) <= len(cold)
        assert len(dix._heavy_cache) <= 3
