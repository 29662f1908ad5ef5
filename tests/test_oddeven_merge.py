"""The pre-sorted-runs merge scheme (ops/merge.py).

Posting chunks arrive as ascending key runs (index/segment.py invariant).
These tests drive ``merge_scores_topk_presorted(run=C)`` against a NumPy
oracle of the ``max_score_merger`` rule (/root/reference/src/query.rs:
150-164) over randomized runs containing all three lane kinds: leading pads
(key -1), trailing pads (INVALID_KEY), and latently-dead docs (ordered
keys, score -inf).
"""

import numpy as np
import pytest

from probly_search_tpu.ops.merge import INVALID_KEY, merge_scores_topk_presorted

QB = 4  # qterm bits


def _oracle_topk(key_row, score_row, k, excl):
    """max within (doc, qterm) runs, sum across qterms, drop sentinels."""
    per_key = {}
    for key, s in zip(key_row, score_row):
        if key < 0 or key == INVALID_KEY:
            continue
        per_key[key] = max(per_key.get(key, -np.inf), s)
    totals = {}
    for key, m in per_key.items():
        doc = key >> QB
        totals[doc] = totals.get(doc, 0.0) + m
    items = [(d, t) for d, t in totals.items() if np.isfinite(t) or t == -np.inf]
    items = [(d, t) for d, t in items if t > -np.inf]
    if excl:
        items = [(d, t) for d, t in items if t > 0.0]
    items.sort(key=lambda x: (-x[1], x[0]))
    return items[:k]


def _make_rows(rng, rows, n_runs, run, excl):
    """Random ascending runs with pads and dead docs."""
    L = n_runs * run
    key = np.full((rows, L), INVALID_KEY, np.int32)
    val = rng.standard_normal((rows, L)).astype(np.float32)
    if excl:
        # bm25-style inputs: caller clamps nonpositive scores to 0.
        val = np.where(val > 0, val, 0.0).astype(np.float32)
    for r in range(rows):
        for c in range(n_runs):
            skip = int(rng.integers(0, run // 4 + 1))
            length = int(rng.integers(0, run - skip + 1))
            qterm = int(rng.integers(0, 3))
            docs = np.sort(rng.choice(200, size=length, replace=False)).astype(np.int32)
            lo, hi = c * run, (c + 1) * run
            key[r, lo : lo + skip] = -1
            key[r, lo + skip : lo + skip + length] = (docs << QB) | qterm
            # Latent deletes: a few docs poisoned with -inf (dead docs keep
            # their ordered keys; all their lanes are dead together).
            dead = rng.random(length) < 0.1
            val[r, lo + skip : lo + skip + length] = np.where(
                dead, -np.inf, val[r, lo + skip : lo + skip + length]
            )
            val[r, lo : lo + skip] = 0.0
            val[r, lo + skip + length : hi] = 0.0
    return key, val


@pytest.mark.parametrize("excl", [False, True])
# Non-pow2 run counts (3, 6, 12) are the fine NC bucket classes.
@pytest.mark.parametrize("n_runs", [2, 3, 4, 6, 8, 12])
def test_presorted_runs_merge_matches_oracle(excl, n_runs):
    rng = np.random.default_rng(42 + n_runs)
    rows, run, k = 4, 128, 8
    key, val = _make_rows(rng, rows, n_runs, run, excl)
    # Dead docs must be dead in EVERY run of the row: rebuild consistency by
    # masking any doc that got -inf anywhere in the row.
    for r in range(rows):
        doc = key[r] >> QB
        dead_docs = set(doc[(val[r] == -np.inf)].tolist())
        sel = np.isin(doc, list(dead_docs)) & (key[r] >= 0) & (key[r] != INVALID_KEY)
        val[r, sel] = -np.inf

    s, d = merge_scores_topk_presorted(key, val, k, QB, run, excl)
    s, d = np.asarray(s), np.asarray(d)
    for r in range(rows):
        want = _oracle_topk(key[r], val[r], k, excl)
        got = [(int(dd), float(ss)) for ss, dd in zip(s[r], d[r]) if dd >= 0]
        assert len(got) == len(want), (r, got, want)
        for (gd, gs), (wd, ws) in zip(got, want):
            assert gs == pytest.approx(ws, rel=1e-6), (r, got, want)
        # doc sets match per score tier (ties may order differently)
        assert {g[0] for g in got} == {w[0] for w in want} or all(
            abs(g[1] - w[1]) < 1e-6 for g, w in zip(got, want)
        )


def test_single_run_already_sorted():
    rng = np.random.default_rng(7)
    rows, run, k = 2, 256, 5
    key, val = _make_rows(rng, rows, 1, run, excl=False)
    s, d = merge_scores_topk_presorted(key, val, k, QB, run, False)
    s, d = np.asarray(s), np.asarray(d)
    for r in range(rows):
        want = _oracle_topk(key[r], val[r], k, excl=False)
        got = [(int(dd), float(ss)) for ss, dd in zip(s[r], d[r]) if dd >= 0]
        assert [g[0] for g in got] == [w[0] for w in want] or [
            round(g[1], 5) for g in got
        ] == [round(w[1], 5) for w in want]
