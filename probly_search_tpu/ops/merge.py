"""Sort-based segmented merge + top-k.

Implements the reference's score-combination rule (`max_score_merger`,
`/root/reference/src/query.rs:150-164`) as a data-parallel program:

1. sort lanes of each query by a packed (doc, query-term) key,
2. segmented MAX over equal (doc, query-term) runs — "max within a query
   term" (covers multiple expansions and duplicate postings),
3. segmented SUM over doc runs of the per-term maxima — "sum across query
   terms" (disjunction),
4. ``lax.top_k`` over the doc-run representatives — replacing the full sort
   of the result vec (`query.rs:103`).

Everything is static-shaped: invalid lanes carry an INT32_MAX key, sort to
the end, and are masked to -inf before top-k.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INVALID_KEY = jnp.iinfo(jnp.int32).max


def _shift_right(x, fill):
    """x shifted one lane right along the last axis; first lane = fill."""
    pad = jnp.full_like(x[..., :1], fill)
    return jnp.concatenate([pad, x[..., :-1]], axis=-1)


def _shift_left(x, fill):
    pad = jnp.full_like(x[..., :1], fill)
    return jnp.concatenate([x[..., 1:], pad], axis=-1)


def segmented_scan(op, values, head_flags):
    """Inclusive segmented scan along the last axis.

    ``head_flags[i]`` True marks the start of a segment; the scan restarts
    there.  Classic (flag, value) associative combiner, O(log L) steps.
    """

    def combine(a, b):
        af, av = a
        bf, bv = b
        return (af | bf, jnp.where(bf, bv, op(av, bv)))

    _, out = jax.lax.associative_scan(combine, (head_flags, values), axis=-1)
    return out


def merge_scores_topk_presorted(key, score, k: int, qterm_bits: int, run: int, excl: bool):
    """merge_scores_topk for the pre-sorted-runs scheme: ``key`` is a row
    of ``run``-lane ascending runs (posting chunks, CSR order).  Key
    sentinels are ``-1`` (leading pads, sort low) and ``INVALID_KEY``
    (trailing pads); dead docs carry ordered keys with score ``-inf``;
    ``excl`` drops doc totals that are not > 0 (the caller already clamped
    nonpositive posting scores to 0).

    The sort is ``lax.sort`` even though the runs are pre-sorted: an
    unrolled merge network expressed in XLA writes every stage to device
    memory, where the native sort does not.  A single run skips the sort."""
    if run < key.shape[-1]:
        with jax.named_scope("merge_sort"):
            key_s, score_s = jax.lax.sort(
                (key, score), dimension=key.ndim - 1, num_keys=1
            )
    else:
        key_s, score_s = key, score

    with jax.named_scope("merge_scan"):
        head1 = key_s != _shift_right(key_s, -1)
        run_max = segmented_scan(jnp.maximum, score_s, head1)
        tail1 = key_s != _shift_left(key_s, -1)
        contrib = jnp.where(tail1, run_max, 0.0)

        doc = key_s >> qterm_bits
        head2 = doc != _shift_right(doc, -1)
        doc_sum = segmented_scan(jnp.add, contrib, head2)
        tail2 = doc != _shift_left(doc, -1)

        live = (key_s != INVALID_KEY) & (key_s >= 0)
        keep = tail2 & live
        if excl:
            keep = keep & (doc_sum > 0.0)
        final = jnp.where(keep, doc_sum, -jnp.inf)
    with jax.named_scope("topk"):
        top_scores, top_lanes = jax.lax.top_k(final, k)
        top_docs = jnp.take_along_axis(doc, top_lanes, axis=-1).astype(jnp.int32)
        top_docs = jnp.where(jnp.isfinite(top_scores), top_docs, -1)
    return top_scores, top_docs


def merge_scores_topk(key, score, k: int, qterm_bits: int):
    """Merge per-lane scores into per-doc totals and select top-k.

    Args:
      key:   int32[..., L] — packed ``doc << qterm_bits | qterm`` per lane;
             INVALID_KEY marks padding/dead lanes.
      score: f32[..., L] — per-lane score.
      k:     static top-k.
      qterm_bits: static number of bits holding the query-term index.

    Returns:
      (top_scores f32[..., k], top_docs int32[..., k]) — missing entries have
      doc -1 and score -inf.
    """
    key_s, score_s = jax.lax.sort((key, score), dimension=key.ndim - 1, num_keys=1)

    # Stage 1: max over runs of equal (doc, qterm).
    head1 = key_s != _shift_right(key_s, -1)
    run_max = segmented_scan(jnp.maximum, score_s, head1)
    tail1 = key_s != _shift_left(key_s, -1)
    contrib = jnp.where(tail1, run_max, 0.0)

    # Stage 2: sum per-term maxima over runs of equal doc.
    doc = key_s >> qterm_bits
    head2 = doc != _shift_right(doc, -1)
    doc_sum = segmented_scan(jnp.add, contrib, head2)
    tail2 = doc != _shift_left(doc, -1)

    live = key_s != INVALID_KEY
    final = jnp.where(tail2 & live, doc_sum, -jnp.inf)
    top_scores, top_lanes = jax.lax.top_k(final, k)
    top_docs = jnp.take_along_axis(doc, top_lanes, axis=-1).astype(jnp.int32)
    top_docs = jnp.where(jnp.isfinite(top_scores), top_docs, -1)
    return top_scores, top_docs
