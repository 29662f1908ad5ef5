"""The zero-to-one fast device program (ops/z2o_device.py
``z2o_fast_step``) vs the exact lockstep program and the exact host
oracle."""

import random

import numpy as np

import probly_search_tpu.ops.z2o_device as z2o_dev
from probly_search_tpu import Index, zero_to_one
from probly_search_tpu.utils.tokenizers import whitespace_tokenizer

from .util import Doc, title_extract, tokenizer


def _corpus(n=150, two_field=True, seed=9):
    rng = random.Random(seed)
    vocab = [
        "".join(rng.choice("abcdefg") for _ in range(rng.randint(1, 5)))
        for _ in range(80)
    ]
    F = 2 if two_field else 1
    ix = Index(F)
    from .util import text_extract

    for i in range(n):
        d = Doc(
            id=i,
            title=" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 4))),
            text=" ".join(rng.choice(vocab) for _ in range(rng.randint(1, 9))),
        )
        accs = [title_extract, text_extract][:F]
        ix.add_document(accs, tokenizer, i, d)
    # distinct-term queries (fast path) incl. prefix-expanding ones
    queries = []
    while len(queries) < 12:
        a, b = rng.choice(vocab), rng.choice(vocab)
        if a != b and not a.startswith(b) and not b.startswith(a):
            queries.append(f"{a} {b}")
    queries += [v[:2] for v in (vocab[0], vocab[7])]  # prefix expansion
    return ix, queries


def _check(ix, queries, top_k=8):
    """Rankings equal modulo exact-score ties (reference tie order is
    unspecified — query.rs:103): score multisets match, and every
    returned key carries its exact oracle score."""
    rows = ix.query_batch(queries, zero_to_one.new(), top_k=top_k, backend="device")
    for q, row in zip(queries, rows):
        nf = ix.num_fields
        oracle = ix.query(q, zero_to_one.new(), whitespace_tokenizer, [1.0] * nf)
        full = {r.key: r.score for r in oracle}
        oracle = oracle[:top_k]
        assert len(row) == len(oracle), q
        np.testing.assert_allclose(
            sorted(r.score for r in row),
            sorted(r.score for r in oracle),
            rtol=2e-5,
            atol=1e-7,
            err_msg=q,
        )
        for r in row:
            assert r.key in full, (q, r.key)
            np.testing.assert_allclose(r.score, full[r.key], rtol=2e-5, atol=1e-7)


def test_fused_z2o_matches_oracle():
    ix, queries = _corpus()
    _check(ix, queries)


def test_fused_z2o_single_field():
    ix, queries = _corpus(two_field=False, seed=4)
    _check(ix, queries)


def test_fused_z2o_with_deletes():
    ix, queries = _corpus(seed=5)
    for i in range(0, 150, 11):
        ix.remove_document(i)
    _check(ix, queries)


def test_fused_z2o_score_tie_order():
    """Two same-length expansions of one prefix (equal entry scores) hitting
    the same doc with different tfs: the oracle's stable sort keeps the
    earliest-enumerated expansion; the fast program's stable sort must
    too."""
    ix = Index(1)
    docs = {
        1: "abx aby aby",
        2: "abx abx abx aby",
        3: "abx q",
        4: "aby aby q q",
    }
    for k, t in docs.items():
        ix.add_document([title_extract], tokenizer, k, Doc(id=k, title=t))
    _check(ix, ["ab", "ab q", "q ab"])


def test_fused_z2o_matches_staged(monkeypatch):
    """The fast program and the exact lockstep program agree on rankings
    for queries with no shared expansion nodes (routing every query to the
    lockstep program by marking it shared)."""
    ix, queries = _corpus(seed=6)
    dix = ix.device_index()
    h1 = z2o_dev.z2o_query_batch_async(dix, queries, whitespace_tokenizer, 8)
    s1, l1, k1 = h1.get_arrays()
    plan = z2o_dev.plan_batch_z2o

    def all_shared(dix_, queries_, tokenizer_):
        out = plan(dix_, queries_, tokenizer_)
        assert out[-1] is not None and not out[-1].any()
        return out[:-1] + (np.ones_like(out[-1]),)

    monkeypatch.setattr(z2o_dev, "plan_batch_z2o", all_shared)
    h2 = z2o_dev.z2o_query_batch_async(dix, queries, whitespace_tokenizer, 8)
    s2, l2, k2 = h2.get_arrays()
    m = np.isfinite(s2)
    assert (np.isfinite(s1) == m).all()
    assert (l1[m] == l2[m]).all()
    np.testing.assert_allclose(s1[m], s2[m], rtol=1e-6)
