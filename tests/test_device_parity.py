"""Device-path parity: the batched device query program must agree with the
exact f64 host oracle on every corpus — same doc sets, same ordering for
well-separated scores, scores within f32 tolerance (SURVEY §7 hard part 1).
"""

import random

import numpy as np

from probly_search_tpu import Index, bm25
from .util import Doc, build_test_index, title_extract, tokenizer

RTOL = 2e-5
ATOL = 1e-6


def assert_parity(index: Index, queries, k=10, fields_boost=None, scorer=None):
    scorer = scorer or bm25.new()
    device_rows = index.query_batch(
        queries, scorer, tokenizer, fields_boost, top_k=k, backend="device"
    )
    for q, dev in zip(queries, device_rows):
        oracle = index.query(q, bm25.new(), tokenizer, fields_boost)[:k]
        dev_by_key = {r.key: r.score for r in dev}
        oracle_by_key = {r.key: r.score for r in oracle}
        # When k truncates, the boundary can swap under f32 ties; compare the
        # clearly-in set and score values for the intersection.
        assert len(dev) == len(oracle), (q, dev, oracle)
        if oracle:
            kth = oracle[-1].score
            must_have = {r.key for r in oracle if r.score > kth * (1 + RTOL) + ATOL}
            assert must_have <= set(dev_by_key), (q, dev, oracle)
        for key in set(dev_by_key) & set(oracle_by_key):
            np.testing.assert_allclose(
                dev_by_key[key], oracle_by_key[key], rtol=RTOL, atol=ATOL, err_msg=q
            )
        # Ordering: equal for score gaps beyond tolerance.
        for (a, b) in zip(dev, dev[1:]):
            assert a.score >= b.score - ATOL


def test_small_corpus_exact_terms():
    x = build_test_index(["a b c", "c d e", "b e f", "a a a"])
    assert_parity(x, ["a", "b", "c", "a d", "b c e", "zzz", ""], k=10)


def test_prefix_expansion_parity():
    x = build_test_index(["abc", "abcd", "abcde", "xyz abc", "ab", "abq abr abs"])
    assert_parity(x, ["ab", "abc", "a", "x", "abcd abc"], k=10)


def test_multi_field_boost_parity():
    index = Index(2)
    docs = [
        Doc(id=1, title="a b c", text="hello world"),
        Doc(id=2, title="c d e", text="lorem ipsum"),
        Doc(id=3, title="hello c", text="a b"),
    ]
    from .util import text_extract

    for doc in docs:
        index.add_document([title_extract, text_extract], tokenizer, doc.id, doc)
    assert_parity(index, ["c", "hello", "a d", "h"], fields_boost=[2.0, 0.5])


def test_latent_delete_parity():
    x = build_test_index(["abc", "abd", "abe abc", "abf"])
    x.remove_document(1)
    assert_parity(x, ["ab", "abc", "abd"])
    x.vacuum()
    assert_parity(x, ["ab", "abc", "abd"])


def test_multi_segment_df_grouping():
    # Force multiple delta segments so one term's postings span segments;
    # the df group must sum across them for a single correct idf.
    x = Index(1)
    for i in range(6):
        x.add_document([title_extract], tokenizer, i, Doc(id=i, title="shared t%d" % i))
        x._flush_pending()  # one segment per doc
    assert x.num_segments > 1
    assert_parity(x, ["shared", "t1", "s"])


def test_random_corpus_parity():
    rng = random.Random(1234)
    alphabet = "abcdefgh"

    def word():
        return "".join(rng.choice(alphabet) for _ in range(rng.randint(1, 5)))

    x = Index(1)
    vocab = [word() for _ in range(200)]
    for i in range(300):
        text = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 12)))
        x.add_document([title_extract], tokenizer, i, Doc(id=i, title=text))
    for i in range(40, 60):
        x.remove_document(i)
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 4))) for _ in range(20)]
    queries += [rng.choice(vocab)[:2] for _ in range(10)]  # prefixes
    assert_parity(x, queries, k=10)


def test_duplicate_query_terms_double():
    # "abc abc" sums the same term twice (disjunction across query terms).
    x = build_test_index(["abc", "abc xyz"])
    single = x.query_batch(["abc"], bm25.new(), top_k=5, backend="device")[0]
    double = x.query_batch(["abc abc"], bm25.new(), top_k=5, backend="device")[0]
    for s, d in zip(single, double):
        assert s.key == d.key
        np.testing.assert_allclose(d.score, 2 * s.score, rtol=RTOL)


def test_top_k_truncation():
    x = build_test_index([f"common w{i}" for i in range(50)])
    rows = x.query_batch(["common"], bm25.new(), top_k=7, backend="device")
    assert len(rows[0]) == 7
    full = x.query(("common"), bm25.new(), tokenizer, [1.0])
    assert len(full) == 50


def test_empty_and_no_match_batch():
    x = build_test_index(["abc"])
    rows = x.query_batch(["", "   ", "zzz", "abc"], bm25.new(), top_k=3, backend="device")
    assert rows[0] == [] and rows[1] == [] and rows[2] == []
    assert len(rows[3]) == 1


def test_get_arrays_matches_get():
    """The raw columnar serving API returns exactly what the object API
    returns (including host-fallback rows and empty queries)."""
    from probly_search_tpu import IndexConfig

    ix = Index(1, config=IndexConfig(max_query_terms=4))
    ix.add_documents_columnar(
        list(range(200)), [[f"g{i % 17} h{i % 5} всем common" for i in range(200)]]
    )
    dix = ix.device_index()
    qs = ["g3 h2", "common", "", "zzz", " ".join(f"g{i}" for i in range(6))]
    rows = dix.query_batch(qs, bm25.new(), top_k=7)
    scores, slots, keys = dix.query_batch_async(qs, bm25.new(), top_k=7).get_arrays()
    assert scores.shape == (len(qs), 7)
    assert keys.dtype == np.int64  # homogeneous int keys -> fast path
    for qi, row in enumerate(rows):
        got = [
            (int(keys[qi, j]), float(scores[qi, j]))
            for j in range(7)
            if np.isfinite(scores[qi, j])  # the validity mask
        ]
        want = [(r.key, r.score) for r in row]
        assert len(got) == len(want), (qi, got, want)
        for (gk, gs), (wk, ws) in zip(got, want):
            assert gk == wk and abs(gs - ws) < 1e-6 * max(1.0, abs(ws)), qi


def test_get_arrays_object_keys():
    ix = Index(1)
    ix.add_document([lambda d: [d]], lambda s: s.split(" "), "strkey", "alpha")
    ix.add_document([lambda d: [d]], lambda s: s.split(" "), 7, "alpha beta")
    dix = ix.device_index()
    scores, slots, keys = dix.query_batch_async(
        ["alpha", "beta", "none"], bm25.new(), top_k=4
    ).get_arrays()
    assert keys.dtype == object
    row0 = [keys[0, j] for j in range(4) if np.isfinite(scores[0, j])]
    assert set(row0) == {"strkey", 7}
    assert all(k is None for k, s in zip(keys[2], scores[2]) if not np.isfinite(s))


def test_index_query_batch_async_public_api():
    """Index.query_batch_async routes every engine and matches the
    blocking API."""
    import numpy as np

    from probly_search_tpu import Index, bm25, zero_to_one

    ix = Index(1)
    ix.add_documents_columnar(
        list(range(200)), [[f"a{i % 7} b{i % 3} c" for i in range(200)]]
    )
    queries = ["a3 b1", "c", "zzz"]
    # BM25 single-chip
    h = ix.query_batch_async(queries, bm25.new(), top_k=5)
    scores, slots, keys = h.get_arrays()
    rows = ix.query_batch(queries, bm25.new(), top_k=5)
    for qi, row in enumerate(rows):
        assert int(np.isfinite(scores[qi]).sum()) == len(row)
        for j, r in enumerate(row):
            assert keys[qi, j] == r.key
    # zero-to-one single-chip
    hz = ix.query_batch_async(queries, zero_to_one.new(), top_k=5)
    zrows = ix.query_batch(queries, zero_to_one.new(), top_k=5)
    got = hz.get()
    for a_row, b_row in zip(got, zrows):
        assert [r.key for r in a_row] == [r.key for r in b_row]
    # default scorer is BM25
    assert len(ix.query_batch_async(["c"]).get()) == 1
    # host-only scorer has no async path
    from probly_search_tpu.models.base import BaseScoreCalculator

    class HostOnly(BaseScoreCalculator):
        def score(self, *a, **kw):
            return 1.0

    try:
        ix.query_batch_async(["c"], HostOnly())
        raise AssertionError("expected ValueError")
    except ValueError:
        pass


def test_index_query_batch_async_sharded(monkeypatch):
    import jax
    import pytest as _pytest

    if len(jax.devices()) < 8:
        _pytest.skip("needs 8 virtual devices")
    from probly_search_tpu import Index, bm25, make_mesh, zero_to_one

    ix = Index(1)
    ix.add_documents_columnar(
        list(range(160)), [[f"m{i % 5} shared" for i in range(160)]]
    )
    ix.attach_mesh(make_mesh(data=1, docs=8))
    h = ix.query_batch_async(["m2 shared"], bm25.new(), top_k=5)
    rows = h.get()
    want = ix.query("m2 shared", bm25.new(), top_k=5)
    full = {r.key: r.score for r in ix.query("m2 shared", bm25.new())}
    assert len(rows[0]) == len(want)
    for a, b in zip(rows[0], want):  # same score profile; ties may differ
        assert abs(a.score - b.score) < 1e-5 * max(1.0, abs(b.score))
    for a in rows[0]:
        assert abs(a.score - full[a.key]) < 1e-5 * max(1.0, abs(full[a.key]))
    hz = ix.query_batch_async(["m2"], zero_to_one.new(), top_k=5)
    zwant = ix.query("m2", zero_to_one.new(), top_k=5)
    assert len(hz.get()[0]) == len(zwant)
