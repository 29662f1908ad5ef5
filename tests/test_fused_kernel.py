"""The device BM25 query program (gather + score + pre-sorted-runs merge +
top-k, index/device.py ``_query_step_impl``) vs the f64 host oracle, over
the shape classes the serving path builds: multi-chunk classes, fine
(non-pow2) chunk-count classes and multi-field indexes with deletes."""

import numpy as np

from probly_search_tpu import Index, bm25
from .util import Doc, title_extract, tokenizer


def _corpus(n=120, seed=3):
    import random

    rng = random.Random(seed)
    vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4))) for _ in range(60)]
    ix = Index(1)
    for i in range(n):
        ix.add_document(
            [title_extract], tokenizer, i,
            Doc(id=i, title=" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 8)))),
        )
    queries = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(10)]
    queries += [rng.choice(vocab)[:1] for _ in range(3)]
    return ix, queries


def test_fused_matches_oracle():
    ix, queries = _corpus()
    rows = ix.query_batch(queries, bm25.new(), top_k=8, backend="device")
    for q, row in zip(queries, rows):
        oracle = ix.query(q, bm25.new(), tokenizer, [1.0])[:8]
        assert len(row) == len(oracle), q
        o = {r.key: r.score for r in oracle}
        for r in row:
            assert r.key in o or any(abs(r.score - x.score) < 1e-5 for x in oracle), (q, r)
            if r.key in o:
                np.testing.assert_allclose(r.score, o[r.key], rtol=2e-5, atol=1e-6)


def test_wide_class_lanes_path():
    """Multi-chunk classes: at a 128-lane chunk width every class spans
    several pre-sorted runs, so the merge sorts across runs; rankings and
    scores must equal the oracle."""
    from probly_search_tpu import IndexConfig

    ix, queries = _corpus(n=200, seed=7)
    ix.config = IndexConfig(chunk_size=128)
    dix = ix.device_index()
    plan, _fb = dix.plan_batch(queries, tokenizer, bm25.new())
    assert max(d[2] for d in dix.pack_dispatches(len(queries), plan)) > 1
    rows = ix.query_batch(queries, bm25.new(), top_k=8, backend="device")
    for q, row in zip(queries, rows):
        oracle = ix.query(q, bm25.new(), tokenizer, [1.0])[:8]
        assert [r.key for r in row] == [r.key for r in oracle], q
        for a, b in zip(row, oracle):
            np.testing.assert_allclose(a.score, b.score, rtol=2e-5, atol=1e-6)


def test_fused_fine_nc_classes():
    """Non-pow2 NC classes (fine buckets): a hot-term corpus with a small
    chunk width lands queries in NC in {2, 3, 6, 12}; the merge over a
    non-pow2 number of runs must stay oracle-equal."""
    import random

    from probly_search_tpu import IndexConfig

    rng = random.Random(13)
    vocab = ["hot%d" % i for i in range(4)] + [
        "".join(rng.choice("abcdef") for _ in range(3)) for _ in range(30)
    ]
    ix = Index(1, config=IndexConfig(chunk_size=128, fine_nc_buckets=True))
    for i in range(700):
        # hot terms appear in most docs -> multi-chunk posting lists at C=128
        toks = [rng.choice(vocab[:4])] + [rng.choice(vocab) for _ in range(3)]
        ix.add_document([title_extract], tokenizer, i, Doc(id=i, title=" ".join(toks)))
    queries = [
        "hot0",  # 1 job, several chunks
        "hot0 hot1 hot2",  # 3 multi-chunk jobs
        "hot0 %s %s" % (vocab[10], vocab[11]),  # mixed spans
        "%s %s" % (vocab[12], vocab[13]),  # 2 single-chunk jobs -> NC=2
    ]
    dix = ix.device_index()
    plan, fallback = dix.plan_batch(queries, tokenizer, bm25.new())
    assert plan is not None and not fallback
    ncs = sorted(
        {d[2] for d in dix.pack_dispatches(len(queries), plan)}
    )
    assert any(nc not in (1, 2, 4, 8, 16) for nc in ncs), ncs  # fine classes hit
    rows = ix.query_batch(queries, bm25.new(), top_k=10, backend="device")
    for q, row in zip(queries, rows):
        oracle = ix.query(q, bm25.new(), tokenizer, [1.0])[:10]
        assert [r.key for r in row] == [r.key for r in oracle], q
        for a, b in zip(row, oracle):
            np.testing.assert_allclose(a.score, b.score, rtol=2e-5, atol=1e-6)


def test_fused_multifield_deletes():
    from .util import text_extract

    ix = Index(2)
    docs = [
        Doc(id=1, title="a b c", text="hello world"),
        Doc(id=2, title="c d e", text="lorem ipsum"),
        Doc(id=3, title="hello c", text="a b"),
    ]
    for d in docs:
        ix.add_document([title_extract, text_extract], tokenizer, d.id, d)
    ix.remove_document(2)
    rows = ix.query_batch(
        ["c", "hello", "a d"], bm25.new(), fields_boost=[2.0, 0.5], top_k=5, backend="device"
    )
    for q, row in zip(["c", "hello", "a d"], rows):
        oracle = ix.query(q, bm25.new(), tokenizer, [2.0, 0.5])[:5]
        assert [r.key for r in row] == [r.key for r in oracle], q
        for a, b in zip(row, oracle):
            np.testing.assert_allclose(a.score, b.score, rtol=2e-5, atol=1e-6)


def test_fetch_windows_jointly_parity():
    """Joint (one-round-trip) drain of several windows decodes bit-identical
    results to individual fetches, across result formats."""
    from probly_search_tpu import IndexConfig
    from probly_search_tpu.index.device import fetch_windows_jointly

    for fmt in ("f32", "slots20"):
        import random

        rng = random.Random(11)
        vocab = [
            "".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4)))
            for _ in range(60)
        ]
        ix = Index(1, config=IndexConfig(result_format=fmt))
        for i in range(150):
            ix.add_document(
                [title_extract], tokenizer, i,
                Doc(id=i, title=" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 8)))),
            )
        qs = [" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 3))) for _ in range(12)]
        dix = ix.device_index()
        w1, w2 = qs[:6], qs[6:]
        # individual drains
        a1 = dix.query_batch_async(w1, bm25.new(), top_k=5).get_arrays()
        a2 = dix.query_batch_async(w2, bm25.new(), top_k=5).get_arrays()
        # joint drain
        h1 = dix.query_batch_async(w1, bm25.new(), top_k=5)
        h2 = dix.query_batch_async(w2, bm25.new(), top_k=5)
        fetch_windows_jointly([h1, h2])
        assert h1._packed_host is not None and h2._packed_host is not None
        b1, b2 = h1.get_arrays(), h2.get_arrays()
        for (sa, la, ka), (sb, lb, kb) in ((a1, b1), (a2, b2)):
            np.testing.assert_array_equal(la, lb)
            np.testing.assert_array_equal(ka, kb)
            if sa is None:
                assert sb is None
            else:
                np.testing.assert_array_equal(sa, sb)
