"""Per-query plan cache: repeated query strings must
plan to byte-identical job tables through the pooled cache, and mixed
hit/miss windows must assemble correctly."""

import random



from probly_search_tpu import Index, bm25
from probly_search_tpu.utils.tokenizers import whitespace_tokenizer


def _index(n=400, seed=11):
    rng = random.Random(seed)
    vocab = [
        "".join(rng.choice("abcdefgh") for _ in range(rng.randint(1, 5)))
        for _ in range(150)
    ]
    ix = Index(1)
    texts = [
        " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 6)))
        for _ in range(n)
    ]
    ix.add_documents_columnar(list(range(n)), [texts])
    return ix, vocab


class TestPlanCache:
    def test_replan_is_identical(self):
        ix, vocab = _index()
        dix = ix.device_index()
        scorer = bm25.new()
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "a", "", vocab[0]]
        p1, fb1 = dix.plan_batch(queries, whitespace_tokenizer, scorer)
        p2, fb2 = dix.plan_batch(queries, whitespace_tokenizer, scorer)
        assert fb1 == fb2
        assert (p1.words == p2.words).all()
        assert (p1.jquery == p2.jquery).all()
        assert (p1.nchunks == p2.nchunks).all()
        assert (p1.njobs == p2.njobs).all()
        assert (p1.has_range == p2.has_range).all()

    def test_mixed_hit_miss_window_matches_fresh(self):
        ix, vocab = _index()
        scorer = bm25.new()
        qa = [vocab[3], f"{vocab[4]} {vocab[5]}"]
        qb = [vocab[6], qa[0], f"{vocab[7]} {vocab[8]}"]
        # dix1 plans qa (warming those), then the mixed window qb.
        dix1 = ix.device_index()
        dix1.plan_batch(qa, whitespace_tokenizer, scorer)
        p_mixed, fb_m = dix1.plan_batch(qb, whitespace_tokenizer, scorer)
        # A fresh snapshot planning qb cold must agree.
        ix2, _ = _index()
        dix2 = ix2.device_index()
        p_cold, fb_c = dix2.plan_batch(qb, whitespace_tokenizer, scorer)
        assert fb_m == fb_c
        assert (p_mixed.words == p_cold.words).all()
        assert (p_mixed.jquery == p_cold.jquery).all()

    def test_cached_fallback_flag_sticks(self):
        ix, vocab = _index()
        dix = ix.device_index()
        scorer = bm25.new()
        big = " ".join(vocab[i % len(vocab)] for i in range(40))  # > max terms
        _, fb1 = dix.plan_batch([big], whitespace_tokenizer, scorer)
        _, fb2 = dix.plan_batch([big, vocab[0]], whitespace_tokenizer, scorer)
        assert fb1 == [0] and fb2 == [0]

    def test_end_to_end_repeat_queries(self):
        ix, vocab = _index()
        dix = ix.device_index()
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "ab"]
        r1 = dix.query_batch(queries, bm25.new(), top_k=10)
        r2 = dix.query_batch(queries, bm25.new(), top_k=10)
        for a_row, b_row in zip(r1, r2):
            assert [(r.key, r.score) for r in a_row] == [
                (r.key, r.score) for r in b_row
            ]

    def test_pool_reset_on_overflow(self):
        ix, vocab = _index()
        dix = ix.device_index()
        scorer = bm25.new()
        dix.plan_batch([vocab[0]], whitespace_tokenizer, scorer)
        key, qp = next(iter(dix._qplan_pools.items()))
        # Force the cap and confirm a fresh pool replaces it (and still
        # plans correctly).
        type(dix)._QPLAN_MAX_QUERIES_SAVED = type(dix)._QPLAN_MAX_QUERIES
        try:
            type(dix)._QPLAN_MAX_QUERIES = 0
            p, fb = dix.plan_batch([vocab[1]], whitespace_tokenizer, scorer)
            assert vocab[1] in dix._qplan_pools[key]["ids"]
            assert vocab[0] not in dix._qplan_pools[key]["ids"]
        finally:
            type(dix)._QPLAN_MAX_QUERIES = type(dix)._QPLAN_MAX_QUERIES_SAVED
            del type(dix)._QPLAN_MAX_QUERIES_SAVED


class TestZ2oPlanCache:
    """z2o per-query plan cache: pooled plans must be byte-identical to
    cold ones, including shared-node flags and cap fallbacks."""

    def _plan(self, dix, queries):
        from probly_search_tpu.ops.z2o_device import plan_batch_z2o

        return plan_batch_z2o(dix, queries, whitespace_tokenizer)

    def test_replan_is_identical(self):
        ix, vocab = _index()
        dix = ix.device_index()
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "a", "", vocab[0]]
        r1 = self._plan(dix, queries)
        r2 = self._plan(dix, queries)
        for a, b in zip(r1, r2):
            if a is None or isinstance(a, list):
                assert a == b
            else:
                assert (a == b).all()

    def test_mixed_hit_miss_matches_cold(self):
        ix, vocab = _index()
        dix1 = ix.device_index()
        qb = [vocab[6], vocab[3], f"{vocab[7]} {vocab[8]} {vocab[8]}"]
        self._plan(dix1, [vocab[3], f"{vocab[4]} {vocab[5]}"])  # warm subset
        mixed = self._plan(dix1, qb)
        ix2, _ = _index()
        cold = self._plan(ix2.device_index(), qb)
        for a, b in zip(mixed, cold):
            if a is None or isinstance(a, list):
                assert a == b
            else:
                assert (a == b).all()

    def test_shared_flag_cached(self):
        ix, vocab = _index()
        dix = ix.device_index()
        dup = f"{vocab[0]} {vocab[0]}"  # duplicate term -> shared node
        for _ in range(2):
            res = self._plan(dix, [dup, vocab[1]])
            shared = res[6]
            assert shared is not None and shared[0] and not shared[1]

    def test_fallback_flag_cached(self):
        ix, vocab = _index()
        dix = ix.device_index()
        big = " ".join(vocab[i % len(vocab)] for i in range(40))
        for _ in range(2):
            res = self._plan(dix, [big, vocab[0]])
            assert res[5] == [0]

    def test_end_to_end_repeat_queries(self):
        from probly_search_tpu import zero_to_one

        ix, vocab = _index()
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "ab", f"{vocab[0]} {vocab[0]}"]
        r1 = ix.query_batch(queries, zero_to_one.new(), top_k=10, backend="device")
        r2 = ix.query_batch(queries, zero_to_one.new(), top_k=10, backend="device")
        for a_row, b_row in zip(r1, r2):
            assert [(r.key, r.score) for r in a_row] == [
                (r.key, r.score) for r in b_row
            ]
