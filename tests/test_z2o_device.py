"""zero-to-one device execution (ops/z2o_device.py) vs the f64 host oracle.

The oracle is the exact host path, itself pinned to the reference goldens
(`/root/reference/src/score/default/zero_to_one.rs:129-405`) by
tests/test_zero_to_one_golden.py.  Device scores are f32: equality to
~1e-6 relative with identical rankings (modulo exact-score ties).
"""

import random

import numpy as np
import pytest

from probly_search_tpu import Index, zero_to_one
from .util import Doc, build_test_index, title_extract, text_extract, tokenizer


def _assert_matches_oracle(ix, queries, top_k=10):
    rows = ix.query_batch(queries, zero_to_one.new(), tokenizer, top_k=top_k, backend="device")
    for q, row in zip(queries, rows):
        oracle = ix.query(q, zero_to_one.new(), tokenizer, [1.0] * ix.num_fields)
        oracle = oracle[:top_k]
        assert len(row) == len(oracle), (q, row, oracle)
        # score multisets match (ties may reorder keys)
        np.testing.assert_allclose(
            sorted(r.score for r in row),
            sorted(r.score for r in oracle),
            rtol=1e-5,
            atol=1e-7,
            err_msg=q,
        )
        # every returned key's score equals that key's exact score
        full = {
            r.key: r.score
            for r in ix.query(q, zero_to_one.new(), tokenizer, [1.0] * ix.num_fields)
        }
        for r in row:
            assert r.key in full
            np.testing.assert_allclose(r.score, full[r.key], rtol=1e-5, atol=1e-7)


def test_golden_corpus_device():
    ix = build_test_index(["abc", "abcefg", "abcefghij"])
    _assert_matches_oracle(ix, ["abc", "abcefg", "abcefghij", "abc abcefg", "a ab abc"])


def test_repeated_query_terms_device():
    # Repeated query terms are penalized (consumed-index rule).
    ix = build_test_index(["abc abc", "abc"])
    _assert_matches_oracle(ix, ["abc abc", "abc abc abc", "abc"])


def test_df_pool_device():
    # Pool rule: a node's df pool bounds how many query terms it can serve.
    ix = build_test_index(["a a a", "a"])
    _assert_matches_oracle(ix, ["a a", "a a a a", "a"])


def test_multi_field_max_device():
    ix = Index(2)
    docs = [
        Doc(id=0, title="abc def", text="xyz"),
        Doc(id=1, title="xyz", text="abc def ghi"),
        Doc(id=2, title="abc", text="abc"),
    ]
    for d in docs:
        ix.add_document([title_extract, text_extract], tokenizer, d.id, d)
    _assert_matches_oracle(ix, ["abc", "abc def", "xyz abc", "ghi"])


def test_latent_delete_device():
    ix = build_test_index(["abc", "abd", "abe"])
    ix.remove_document(1)
    _assert_matches_oracle(ix, ["ab", "abc", "abd"])


def test_empty_tokens_in_query_device():
    # query_terms_len counts BEFORE empty filtering (query.rs:32) and feeds
    # the normalization denominator.
    ix = build_test_index(["abc def"])
    _assert_matches_oracle(ix, ["abc  def", " abc", "abc   "])


def test_random_corpus_device():
    rng = random.Random(11)
    vocab = ["".join(rng.choice("abcde") for _ in range(rng.randint(1, 4))) for _ in range(60)]
    ix = Index(1)
    for i in range(150):
        text = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 7)))
        ix.add_document([title_extract], tokenizer, i, Doc(id=i, title=text))
    for i in range(20, 40):
        ix.remove_document(i)
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(12)]
    queries += [rng.choice(vocab)[:1] for _ in range(4)]  # heavy prefix expansion
    queries += ["", "zzzz"]
    _assert_matches_oracle(ix, queries, top_k=10)


def test_random_two_field_device():
    rng = random.Random(3)
    vocab = ["".join(rng.choice("abcd") for _ in range(rng.randint(1, 3))) for _ in range(30)]
    ix = Index(2)
    for i in range(80):
        t = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 4)))
        x = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 6)))
        ix.add_document([title_extract, text_extract], tokenizer, i, Doc(id=i, title=t, text=x))
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(10)]
    _assert_matches_oracle(ix, queries, top_k=8)


def test_z2o_backend_device_accepted():
    ix = build_test_index(["abc"])
    rows = ix.query_batch(["abc"], zero_to_one.new(), tokenizer, top_k=3, backend="device")
    assert rows[0][0].key == 0
    assert rows[0][0].score == pytest.approx(1.0, abs=1e-6)


def test_shared_node_detection():
    """Routing: duplicate query terms or overlapping prefix expansions mark
    a query shared-node (lockstep program); plain queries take the fast
    loop-free program."""
    from probly_search_tpu.ops.z2o_device import plan_batch_z2o

    ix = build_test_index(["abc def", "abcx", "ab"])
    dix = ix.device_index()
    queries = [
        "abc def",   # distinct terms, disjoint expansions -> fast
        "abc abc",   # duplicate query term -> shared
        "ab abc",    # "ab" expands to {ab, abc, abcx}, "abc" to {abc, abcx} -> shared
        "def",       # single term -> fast
    ]
    *_, fallback, shared = plan_batch_z2o(dix, queries, tokenizer)
    assert fallback == []
    assert list(shared) == [False, True, True, False]


def test_mixed_fast_slow_batch_matches_oracle():
    rng = random.Random(7)
    vocab = ["".join(rng.choice("abcd") for _ in range(rng.randint(1, 4))) for _ in range(40)]
    ix = Index(1)
    for i in range(300):
        ix.add_document(
            [title_extract], tokenizer, i,
            Doc(id=i, title=" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 6)))),
        )
    queries = []
    for _ in range(10):
        queries.append(" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))))
    for _ in range(5):
        t = rng.choice(vocab)
        queries.append(f"{t} {t}")        # shared via duplicates
        queries.append(f"{t[:1]} {t}")    # shared via overlapping prefixes (often)
    _assert_matches_oracle(ix, queries)


def test_wide_schema_routes_to_host_lockstep():
    """The z2o sort keys pack field indices into 3 bits; 9+ fields must run
    the bit-exact vectorized host lockstep instead."""
    F = 9
    ix = Index(F)
    accessors = [lambda d, j=j: [d[j]] for j in range(F)]
    for i in range(12):
        ix.add_document(accessors, tokenizer, i,
                        tuple(f"w{(i + j) % 5}" for j in range(F)))
    queries = ["w1", "w2 w3"]
    rows = ix.query_batch(queries, zero_to_one.new(), tokenizer, top_k=5,
                          backend="device")
    for q, row in zip(queries, rows):
        oracle = ix.query(q, zero_to_one.new(), tokenizer, [1.0] * F)[:5]
        assert len(row) == len(oracle)
        for a, b in zip(row, oracle):
            assert a.key == b.key and a.score == pytest.approx(b.score, abs=1e-12)


def test_result_formats_match_f32_ranking():
    # compact/slots narrow only the score REPORT: the packed top-k is
    # computed in f32 before any narrowing, so slots/keys must be
    # IDENTICAL to the f32 window's, and compact scores f16-close.
    from probly_search_tpu.ops.z2o_device import z2o_query_batch_async

    rng = random.Random(5)
    vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4))) for _ in range(60)]
    n = 300
    ix = Index(2)
    ix.add_documents_columnar(
        list(range(n)),
        [
            [" ".join(rng.choice(vocab) for _ in range(3)) for _ in range(n)],
            [" ".join(rng.choice(vocab) for _ in range(6)) for _ in range(n)],
        ],
    )
    dix = ix.device_index()
    queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "a", f"{vocab[3]} {vocab[3]}", ""]
    s_f32, sl_f32, k_f32 = z2o_query_batch_async(
        dix, queries, tokenizer, 10, fmt="f32"
    ).get_arrays()
    s_c, sl_c, k_c = z2o_query_batch_async(
        dix, queries, tokenizer, 10, fmt="compact"
    ).get_arrays()
    s_s, sl_s, k_s = z2o_query_batch_async(
        dix, queries, tokenizer, 10, fmt="slots"
    ).get_arrays()
    assert (sl_c == sl_f32).all() and (sl_s == sl_f32).all()
    assert s_s is None
    valid = sl_f32 >= 0
    np.testing.assert_allclose(s_c[valid], s_f32[valid], rtol=2e-3, atol=1e-4)
    assert (np.asarray(k_c)[valid] == np.asarray(k_f32)[valid]).all()
    assert (np.asarray(k_s)[valid] == np.asarray(k_f32)[valid]).all()
    # And the f32 ranking itself matches the exact oracle.
    _assert_matches_oracle(ix, [q for q in queries if q.strip()])
