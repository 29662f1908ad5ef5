"""Expansion-heavy queries and host-fallback paths.

The reference serves single-char prefix queries through the same trie DFS
as everything else (`/root/reference/src/query.rs:260-292`); here they tile
through the device job machinery by default (max_expansions=0), and any
query that does leave the device path lands on the scorer's vectorized
numpy host path — never a per-posting Python walk inside a serving batch.
"""

import random

import numpy as np
import pytest

from probly_search_tpu import Index, bm25, whitespace_tokenizer
from probly_search_tpu.config import IndexConfig

from .util import Doc, title_extract, tokenizer


def _rand_index(n=500, two_field=False, seed=3):
    rng = random.Random(seed)
    vocab = [
        "".join(rng.choice("abcdef") for _ in range(rng.randint(1, 5)))
        for _ in range(120)
    ]
    F = 2 if two_field else 1
    ix = Index(F)
    for i in range(n):
        title = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 6)))
        if two_field:
            text = " ".join(rng.choice(vocab) for _ in range(rng.randint(0, 8)))
            ix.add_document(
                [lambda d: [d[0]], lambda d: [d[1]]],
                whitespace_tokenizer,
                i,
                (title, text),
            )
        else:
            ix.add_document([title_extract], tokenizer, i, Doc(id=i, title=title))
    for i in range(0, n, 17):
        ix.remove_document(i)
    return ix, vocab


class TestVectorizedBM25:
    def test_matches_exact_oracle(self):
        ix, vocab = _rand_index(two_field=True)
        rng = random.Random(5)
        queries = ["a", "b", "ab", ""]
        queries += [
            " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 4)))
            for _ in range(20)
        ]
        queries += [rng.choice(vocab)[:1] for _ in range(5)]
        for boost in ([1.0, 1.0], [2.0, 0.5], [0.0, 1.0]):
            for q in queries:
                want = ix.query(q, bm25.new(), whitespace_tokenizer, boost)
                got = bm25.new().vectorized_query(
                    ix, q, whitespace_tokenizer, fields_boost=boost
                )
                assert [r.key for r in got] == [r.key for r in want], (q, boost)
                for g, w in zip(got, want):
                    assert g.score == pytest.approx(w.score, abs=1e-9), (q, boost)

    def test_top_k_and_params(self):
        ix, vocab = _rand_index()
        scorer = bm25.new(bm25k1=0.9, bm25b=0.3)
        q = vocab[0][:1]
        want = ix.query(q, scorer, tokenizer, [1.0], top_k=7)
        got = scorer.vectorized_query(ix, q, tokenizer, top_k=7)
        assert [(r.key, round(r.score, 10)) for r in got] == [
            (r.key, round(r.score, 10)) for r in want
        ]

    def test_subclass_with_custom_score_uses_exact_path(self):
        class Doubled(bm25.BM25):
            def score(self, *a, **kw):
                s = super().score(*a, **kw)
                return None if s is None else 2.0 * s

        ix, vocab = _rand_index(n=60)
        q = vocab[1]
        want = ix.query(q, Doubled(), tokenizer, [1.0])
        got = Doubled().vectorized_query(ix, q, tokenizer)
        assert [(r.key, r.score) for r in got] == [(r.key, r.score) for r in want]


class TestExpansionTiling:
    def test_single_char_query_runs_on_device(self):
        """Expansion-heavy queries stay on the device path by default."""
        ix, vocab = _rand_index(n=800)
        dix = ix.device_index()
        plan, fallback = dix.plan_batch(["a", "b c", vocab[0]], tokenizer, bm25.new())
        assert fallback == []
        rows = ix.query_batch(["a"], bm25.new(), tokenizer, top_k=10)[0]
        full = {r.key: r.score for r in ix.query("a", bm25.new(), tokenizer, [1.0])}
        want = ix.query("a", bm25.new(), tokenizer, [1.0], top_k=10)
        assert len(rows) == len(want)
        for a, b in zip(rows, want):
            assert abs(a.score - b.score) < 2e-5 * max(1.0, abs(b.score))
        for a in rows:
            assert abs(a.score - full[a.key]) < 2e-5 * max(1.0, abs(full[a.key]))

    def test_configured_cap_falls_back_vectorized(self):
        cfg = IndexConfig(max_expansions=2)
        _, vocab = _rand_index(n=50)
        rng = random.Random(3)
        ix2 = Index(1, config=cfg)
        for i in range(300):
            ix2.add_document(
                [title_extract],
                tokenizer,
                i,
                Doc(id=i, title=" ".join(rng.choice(vocab) for _ in range(3))),
            )
        from probly_search_tpu.utils.metrics import metrics

        before = metrics.counters["device_fallback_queries"]
        rows = ix2.query_batch(["a", vocab[0]], bm25.new(), tokenizer, top_k=10)
        assert metrics.counters["device_fallback_queries"] > before
        want = ix2.query("a", bm25.new(), tokenizer, [1.0], top_k=10)
        assert [r.key for r in rows[0]] == [r.key for r in want]
        for a, b in zip(rows[0], want):
            assert a.score == pytest.approx(b.score, rel=1e-9)

    def test_lane_budget_guard(self, monkeypatch):
        from probly_search_tpu.index.device import DeviceIndex

        ix, vocab = _rand_index(n=400)
        monkeypatch.setattr(DeviceIndex, "LANES_PER_DISPATCH", 4096)
        ix._device_cache = None  # rebuild snapshot under the tiny budget
        rows = ix.query_batch(["a"], bm25.new(), tokenizer, top_k=10)[0]
        want = ix.query("a", bm25.new(), tokenizer, [1.0], top_k=10)
        assert [r.key for r in rows] == [r.key for r in want]
        for a, b in zip(rows, want):
            assert a.score == pytest.approx(b.score, rel=1e-9)


class TestTermRangeJobs:
    """Term-range jobs: expansion-heavy terms become one CSR-range job per
    segment, with idf/term-length read from the aux record array on device."""

    def _index(self, n=400, segments=1, seed=11, config=None):
        rng = random.Random(seed)
        # 30 terms sharing the "aa" prefix + unrelated terms.
        prefixed = ["aa" + "".join(rng.choice("bcde") for _ in range(j % 3 + 1))
                    for j in range(30)]
        other = ["zz" + str(j) for j in range(10)] + ["aa"]
        vocab = sorted(set(prefixed)) + other
        cfg = config or IndexConfig(range_min_expansions=4)
        ix = Index(1, config=cfg)
        per_seg = n // segments
        for s in range(segments):
            keys = list(range(s * per_seg, (s + 1) * per_seg))
            texts = [
                " ".join(rng.choice(vocab) for _ in range(rng.randint(2, 6)))
                for _ in keys
            ]
            ix.add_documents_columnar(keys, [texts])
            ix._flush_pending()
        return ix, vocab

    def _check(self, ix, queries):
        rows = ix.query_batch(queries, bm25.new(), tokenizer, top_k=10)
        for q, row in zip(queries, rows):
            full = {r.key: r.score for r in ix.query(q, bm25.new(), tokenizer, [1.0])}
            want = ix.query(q, bm25.new(), tokenizer, [1.0], top_k=10)
            assert len(row) == len(want), q
            for a, b in zip(row, want):
                assert abs(a.score - b.score) < 2e-5 * max(1.0, abs(b.score)), q
            for a in row:
                assert abs(a.score - full[a.key]) < 2e-5 * max(1.0, abs(full[a.key])), q

    def test_plan_marks_range_queries(self):
        ix, vocab = self._index()
        dix = ix.device_index()
        plan, fb = dix.plan_batch(["aa", "zz1", "aa zz1"], tokenizer, bm25.new())
        assert fb == []
        assert list(plan.has_range) == [True, False, True]
        # the "aa" jobs collapsed into O(segments) range jobs, not one per
        # expansion
        assert plan.njobs[0] <= ix.num_segments + 1

    def test_range_queries_match_oracle(self):
        ix, vocab = self._index()
        self._check(ix, ["aa", "a", "aab", "aa zz1", "zz1", "aa aab zz2"])

    def test_range_across_segments_and_deletes(self):
        ix, vocab = self._index(segments=3)
        for i in range(0, 120, 7):
            ix.remove_document(i)
        self._check(ix, ["aa", "aab", "aa zz3"])

    def test_range_vs_per_expansion_same_scores(self):
        """The same corpus planned with and without range jobs agrees."""
        ix1, _ = self._index(seed=21)
        ix2, _ = self._index(seed=21, config=IndexConfig(range_min_expansions=0))
        q = ["aa", "aab zz1", "a"]
        r1 = ix1.query_batch(q, bm25.new(), tokenizer, top_k=10)
        r2 = ix2.query_batch(q, bm25.new(), tokenizer, top_k=10)
        for a_row, b_row in zip(r1, r2):
            assert [r.key for r in a_row] == [r.key for r in b_row]
            for a, b in zip(a_row, b_row):
                assert abs(a.score - b.score) < 2e-5 * max(1.0, abs(b.score))


class TestCompactResults:
    def test_compact_matches_f32_rankings(self):
        cfg = IndexConfig(compact_results=True)
        rng = random.Random(5)
        vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4)))
                 for _ in range(60)]
        texts = [" ".join(rng.choice(vocab) for _ in range(4)) for _ in range(500)]
        ix_c = Index(1, config=cfg)
        ix_c.add_documents_columnar(list(range(500)), [texts])
        ix_f = Index(1)
        ix_f.add_documents_columnar(list(range(500)), [texts])
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "a", "zzz", ""]
        hc = ix_c.device_index().query_batch_async(queries, bm25.new(), top_k=10)
        hf = ix_f.device_index().query_batch_async(queries, bm25.new(), top_k=10)
        sc, slc, kc = hc.get_arrays()
        sf, slf, kf = hf.get_arrays()
        assert sc.dtype == np.float32
        # identical rankings (top-k computed in f32 on device either way)
        assert (np.isfinite(sc) == np.isfinite(sf)).all()
        m = np.isfinite(sf)
        assert (slc[m] == slf[m]).all()
        np.testing.assert_allclose(sc[m], sf[m], rtol=2e-3)
        # object API decodes identically
        rows_c = hc.get()
        rows_f = hf.get()
        for a_row, b_row in zip(rows_c, rows_f):
            assert [r.key for r in a_row] == [r.key for r in b_row]


class TestSlotsResults:
    """result_format="slots": int8 slot bytes only, no scores (30 B/query
    at k=10)."""

    def _corpus(self, cfg=None):
        rng = random.Random(5)
        vocab = ["".join(rng.choice("abcdef") for _ in range(rng.randint(1, 4)))
                 for _ in range(60)]
        texts = [" ".join(rng.choice(vocab) for _ in range(4)) for _ in range(500)]
        ix = Index(1, config=cfg) if cfg else Index(1)
        ix.add_documents_columnar(list(range(500)), [texts])
        return ix, vocab

    def test_slots_match_f32_rankings(self):
        ix_s, vocab = self._corpus(IndexConfig(result_format="slots"))
        ix_f, _ = self._corpus()
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "a", "zzz", ""]
        hs = ix_s.device_index().query_batch_async(queries, bm25.new(), top_k=10)
        hf = ix_f.device_index().query_batch_async(queries, bm25.new(), top_k=10)
        ss, sls, ks = hs.get_arrays()
        sf, slf, kf = hf.get_arrays()
        assert ss is None  # no scores shipped
        # identical ranked slots; -1 sentinel decodes through the 3 bytes
        assert (sls == np.where(np.isfinite(sf), slf, -1)).all()
        m = sls >= 0
        assert (ks[m] == kf[m]).all()

    def test_slots_get_raises(self):
        ix, vocab = self._corpus(IndexConfig(result_format="slots"))
        h = ix.device_index().query_batch_async([vocab[0]], bm25.new(), top_k=5)
        with pytest.raises(ValueError, match="slots"):
            h.get()

    def test_slots20_matches_slots_rankings(self):
        # 20-bit nibble-packed slots (25 B/query at k=10): bit-identical
        # ranked slots vs the 3-byte format, including the -1 sentinel
        # (packed as 0xFFFFF) and an odd k (pad nibble path).
        ix20, vocab = self._corpus(IndexConfig(result_format="slots20"))
        ix_s, _ = self._corpus(IndexConfig(result_format="slots"))
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "a", "zzz", ""]
        for k in (10, 5, 1):
            h20 = ix20.device_index().query_batch_async(
                queries, bm25.new(), top_k=k
            )
            hs = ix_s.device_index().query_batch_async(
                queries, bm25.new(), top_k=k
            )
            s20, sl20, k20 = h20.get_arrays()
            ss, sls, ks = hs.get_arrays()
            assert s20 is None
            np.testing.assert_array_equal(sl20, sls)
            m = sl20 >= 0
            assert (k20[m] == ks[m]).all()

    def test_slots20_z2o_matches_slots(self):
        from probly_search_tpu.ops.z2o_device import z2o_query_batch_async

        ix, vocab = self._corpus()
        queries = [vocab[0], f"{vocab[1]} {vocab[2]}", "zzz"]
        dix = ix.device_index()
        h20 = z2o_query_batch_async(dix, queries, whitespace_tokenizer, 7, fmt="slots20")
        hs = z2o_query_batch_async(dix, queries, whitespace_tokenizer, 7, fmt="slots")
        s20, sl20, _ = h20.get_arrays()
        _, sls, _ = hs.get_arrays()
        assert s20 is None
        np.testing.assert_array_equal(sl20, sls)

    def test_resolve_result_format_gates(self):
        from probly_search_tpu.index.device import resolve_result_format

        assert resolve_result_format("slots20", (1 << 20) - 1) == "slots20"
        assert resolve_result_format("slots20", 1 << 20) == "slots"
        assert resolve_result_format("slots20", 1 << 23) == "compact"
        assert resolve_result_format("slots", 1 << 23) == "compact"
        assert resolve_result_format("slots", (1 << 23) - 1) == "slots"
        assert resolve_result_format("f32", 1 << 24) == "f32"
        assert resolve_result_format("compact", 1 << 24) == "compact"

    def test_host_fallback_policy(self):
        """IndexConfig.host_fallback: "allow" serves silently (default),
        "warn" emits a RuntimeWarning, "error" raises HostFallbackError —
        the guard for the measured 664x z2o adversarial degradation
        (benchmarks/z2o_adversarial.py)."""
        import warnings

        from probly_search_tpu import HostFallbackError
        from probly_search_tpu.ops.z2o_device import z2o_query_batch_async

        big = " ".join(f"w{i}" for i in range(40))  # > max_query_terms
        for policy, expect in (("allow", None), ("warn", "warns"),
                               ("error", "raises")):
            ix, vocab = self._corpus(IndexConfig(host_fallback=policy))
            dix = ix.device_index()
            if expect == "raises":
                with pytest.raises(HostFallbackError, match="degraded"):
                    dix.query_batch_async([big, vocab[0]], bm25.new(), top_k=5)
                # the z2o engine honors the same knob
                with pytest.raises(HostFallbackError, match="degraded"):
                    z2o_query_batch_async(dix, [big], whitespace_tokenizer, 5)
            elif expect == "warns":
                with pytest.warns(RuntimeWarning, match="host-speed"):
                    h = dix.query_batch_async([big, vocab[0]], bm25.new(), top_k=5)
                h.get_arrays()
            else:
                with warnings.catch_warnings():
                    warnings.simplefilter("error")
                    h = dix.query_batch_async([big, vocab[0]], bm25.new(), top_k=5)
                h.get_arrays()

    def test_slots_host_fallback_rows_are_valid(self):
        # An over-cap query (> max_query_terms) falls back to the host; its
        # row must keep the ``slots >= 0`` validity contract.
        ix, vocab = self._corpus(IndexConfig(result_format="slots"))
        big = " ".join(vocab[i % len(vocab)] for i in range(40))
        h = ix.device_index().query_batch_async([big, vocab[0]], bm25.new(), top_k=10)
        s, slots, keys = h.get_arrays()
        assert s is None
        assert (slots[0] >= 0).any()
        oracle = ix.query(big, bm25.new(), whitespace_tokenizer, [1.0])[:10]
        got = [int(k) for k, sl in zip(keys[0], slots[0]) if sl >= 0]
        assert got == [r.key for r in oracle]
