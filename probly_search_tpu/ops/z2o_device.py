"""zero-to-one scorer on device (SURVEY §7 M4).

The reference's zero-to-one finalize (`/root/reference/src/score/default/
zero_to_one.rs:84-126`) is a per-(doc, field) sequential consumption loop:
sort recorded entries by score desc, then greedily accept each entry unless
its query term was already consumed or its trie node's df pool (initialized
``tf - 1``, decremented on reuse) is exhausted; accepted entries contribute
``min(score/tf, 1) * tf / max(field_length, query_terms_len)``; the doc
score is the max over fields of the pool sums.

Device formulation (one XLA program per shape class):

* Per-job constants are computed at plan time: the entry score
  ``1 - |len(exp) - len(term)| / len(exp)`` (byte lengths, zero_to_one.rs:
  57-58) and the node id (one id per DISTINCT expanded term per query —
  the arena index identity, zero_to_one.rs:75).
* On device: chunk-expand jobs, slice-gather postings, emit one entry lane
  per (posting, field) with tf > 0, and sort lanes by
  (packed (doc, field) segment, score desc, enumeration seq) — the exact
  stable order of the host oracle.
* TWO device programs, routed at plan time:

  - ``z2o_fast_step`` (the serving path): when no expansion node is
    claimed by two query-term instances, each node has at most one entry
    per (doc, field) segment, the df pool can never exhaust, and the
    consumption loop reduces exactly to "accept the best-scoring entry
    per (doc, field, qterm)" — one stable sort + segmented reduces, the
    same data-parallel shape as the BM25 merge, with no NJ-step loop.
    Fields ride as sort VALUES (one masked-contribution operand per field over
    POSTING lanes), not as extra lanes — see its docstring.
  - ``z2o_step`` (the exact general program) for shared-node queries
    (duplicate query terms / overlapping prefix expansions).

* In ``z2o_step`` the sequential consumption becomes a LOCKSTEP loop:
  step ``e`` processes the e-th entry of every (doc, field) segment
  simultaneously.  The pool rule "init tf-1, decrement, skip when
  exhausted" is equivalent to "accept at most tf entries per (segment,
  node)", so the state is
  - ``consumed``: per-segment bitmask over query-term indices, carried in
    every lane of the segment and propagated with a segmented bitwise-OR
    scan (monotone, so later steps only add bits);
  - ``counts``: accepted count per (segment, node), stored at the
    segment-node's first lane (``pool_slot``) and accessed with
    gather/scatter-add.
* Post-loop: segmented sum of accepted contributions per segment, max over
  the segments of each doc, ``top_k``.

The loop length is the class's padded job count (a segment has at most one
entry per (query term, node) job), so cost is O(jobs * lanes) vector work.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .merge import segmented_scan, _shift_left, _shift_right

_I32_MAX = np.iinfo(np.int32).max
_LEN_BITS = 26
_QT_BITS = 4


def z2o_step(
    chunk: int,
    k: int,
    num_fields: int,
    num_chunks: int,
    rec,
    jobs_flat,
    qlen,
):
    """One z2o dispatch.

    Args:
      jobs_flat: int32[B * NJ * 4] — words (start, len | qterm << 26,
        node_id, score_f32_bits) per job.
      qlen: f32[B] — query_terms_len per query (INCLUDING empty tokens,
        query.rs:32; the normalization denominator, zero_to_one.rs:119).

    Returns (top_scores f32[B, k], top_docs int32[B, k]).
    """
    F = num_fields
    C = chunk
    NC = num_chunks
    jobs = jobs_flat.reshape(-1, jobs_flat.shape[-1] // 4, 4)
    B, NJ, _ = jobs.shape
    L = NC * C

    jstart = jobs[..., 0]
    w1 = jobs[..., 1]
    jlen = w1 & ((1 << _LEN_BITS) - 1)
    jqterm = (w1 >> _LEN_BITS) & ((1 << _QT_BITS) - 1)
    jnode = jobs[..., 2]
    jscore = jax.lax.bitcast_convert_type(jobs[..., 3], jnp.float32)

    # --- chunk expansion + gather (as in index/device.py) ---------------- #
    # Stride-C contiguous chunks off one aligned per-job base (matches
    # index/device.py's expansion: only the first chunk pays the < 128-lane
    # alignment skip; every other chunk carries a full C payload).
    base = (jstart // 128) * 128
    skip0 = jstart - base
    njc = jnp.where(jlen > 0, (skip0 + jlen + (C - 1)) // C, 0)
    cum = jnp.cumsum(njc, axis=1)
    chunk_ids = jax.lax.broadcasted_iota(jnp.int32, (B, NC), dimension=1)
    # Broadcast compare-sum == searchsorted(cum, id, right) (see
    # index/device.py chunk expansion).
    chunk_job = jnp.sum(
        (cum[:, None, :] <= chunk_ids[:, :, None]).astype(jnp.int32), axis=-1
    )
    jc = jnp.minimum(chunk_job, NJ - 1)

    def take(a):
        return jnp.take_along_axis(a, jc, axis=1)

    within = chunk_ids - (take(cum) - take(njc))
    c_start = take(base) + within * C
    off = within * C
    c_skip = jnp.clip(take(skip0) - off, 0, C)
    c_end = jnp.clip(take(skip0) + take(jlen) - off, 0, C)
    c_len = jnp.maximum(c_end - c_skip, 0)
    c_valid = chunk_ids < cum[:, -1:]
    c_len = jnp.where(c_valid, c_len, 0)
    c_start = jnp.where(c_valid, c_start, 0)
    c_skip = jnp.where(c_valid, c_skip, 0)
    c_qterm = take(jqterm)
    c_node = take(jnode)
    c_score = take(jscore)

    R = rec.shape[0]

    def one(s):
        return jax.lax.dynamic_slice(rec, (0, s), (R, C))

    g = jax.vmap(jax.vmap(one))(c_start)
    doc = g[:, :, 0, :]  # [B, NC, C]
    tf = g[:, :, 1 : 1 + F, :].astype(jnp.float32)  # [B, NC, F, C]
    flen = jax.lax.bitcast_convert_type(g[:, :, 1 + F : 1 + 2 * F, :], jnp.float32)
    alive = g[:, :, 1 + 2 * F, :]  # liveness row (index/device.py rec layout)

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, NC, C), dimension=2)
    live = (
        (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None]) & (alive > 0)
    )

    # --- entries: one lane per (posting, field) with tf > 0 -------------- #
    # [B, F, NC, C] with field-major seq is fine: ties needing the stable
    # enumeration order only occur WITHIN one (doc, field) segment.
    def fexp(a):  # [B, NC, C] -> [B, F, L]
        return jnp.broadcast_to(a[:, None], (B, F, NC, C)).reshape(B, F, L)

    tf_e = jnp.moveaxis(tf, 2, 1).reshape(B, F, L)
    flen_e = jnp.moveaxis(flen, 2, 1).reshape(B, F, L)
    doc_e = fexp(doc)
    mask = fexp(live) & (tf_e > 0)
    fidx = jax.lax.broadcasted_iota(jnp.int32, (B, F, L), dimension=1)
    # Packed (doc, field) segment key; doc < 2^27 and F <= 8 by capacity
    # checks, so the shift is safe in int32.
    k1 = jnp.where(mask, (doc_e << 3) | fidx, _I32_MAX)
    s_e = fexp(jnp.broadcast_to(c_score[..., None], (B, NC, C)))
    q_e = fexp(jnp.broadcast_to(c_qterm[..., None], (B, NC, C)))
    n_e = fexp(jnp.broadcast_to(c_node[..., None], (B, NC, C)))
    # Contribution if accepted (zero_to_one.rs:118-120).
    contrib = (
        jnp.minimum(s_e / tf_e, 1.0) * tf_e / jnp.maximum(flen_e, qlen[:, None, None])
    )
    contrib = jnp.where(mask, contrib, 0.0)

    FL = F * L
    # Sort by (segment, score desc); lax.sort is STABLE (the default), so
    # the enumeration order that the oracle's python sort preserves for
    # ties needs no explicit sequence key.  qterm and node id pack into one
    # word (qterm < 16, node id < NJ <= 2^16) — 5 sort operands, 2 keys,
    # instead of the original 7/3.
    qn = (q_e << 16) | n_e
    ops = [a.reshape(B, FL) for a in (k1, -s_e, qn, tf_e, contrib)]
    k1s, negs, qns, tfs, contribs = jax.lax.sort(
        tuple(ops), dimension=1, num_keys=2
    )
    qs = qns >> 16
    ns = qns & 0xFFFF

    # --- segment structure ------------------------------------------------ #
    head = (k1s != _shift_right(k1s, -1)).astype(jnp.int32)  # [B, FL]
    ones = jnp.ones_like(head)
    pos_in_seg = segmented_scan(jnp.add, ones, head > 0) - 1

    # pool_slot: position of the FIRST lane with the same (segment, node).
    posg = jax.lax.broadcasted_iota(jnp.int32, (B, FL), dimension=1)
    k1b, nb, _pb, origb = jax.lax.sort((k1s, ns, posg, posg), dimension=1, num_keys=3)
    headb = ((k1b != _shift_right(k1b, -1)) | (nb != _shift_right(nb, -1)))
    firstb = segmented_scan(jnp.maximum, jnp.where(headb, _pb, -1), headb)
    pool_slot = jnp.zeros((B, FL), jnp.int32).at[
        jax.lax.broadcasted_iota(jnp.int32, (B, FL), 0), origb
    ].set(firstb)

    valid = k1s != _I32_MAX

    # --- lockstep consumption loop (zero_to_one.rs:98-121) --------------- #
    def body(e, state):
        consumed, counts, accepted = state
        active = (pos_in_seg == e) & valid
        bit = jnp.left_shift(jnp.int32(1), qs)
        ok = active & ((consumed & bit) == 0)
        cnt_ps = jnp.take_along_axis(counts, pool_slot, axis=1)
        take_ = ok & (cnt_ps < tfs)
        rows = jax.lax.broadcasted_iota(jnp.int32, (B, FL), 0)
        counts = counts.at[rows, pool_slot].add(jnp.where(take_, 1.0, 0.0))
        delta = jnp.where(take_, bit, 0)
        consumed = consumed | segmented_scan(jnp.bitwise_or, delta, head > 0)
        accepted = accepted | take_.astype(jnp.int32)
        return consumed, counts, accepted

    # Zeros derived from ``head`` so the loop carry varies over the same
    # mesh axes as the loop body's values when run under shard_map.
    consumed0 = head * 0
    counts0 = consumed0.astype(jnp.float32)
    accepted0 = consumed0
    _, _, accepted = jax.lax.fori_loop(0, NJ, body, (consumed0, counts0, accepted0))

    # --- pool sums per (doc, field); doc score = max over fields ---------- #
    val = jnp.where(accepted > 0, contribs, 0.0)
    seg_sum = segmented_scan(jnp.add, val, head > 0)
    tail1 = k1s != jnp.concatenate([k1s[:, 1:], jnp.full_like(k1s[:, :1], -1)], axis=1)
    dock = jnp.where(valid, k1s >> 3, _I32_MAX)
    # Per-field pool sum sits at each segment tail; docs always score >= 0
    # (the provisional 0 from score(), zero_to_one.rs:81).
    field_val = jnp.where(tail1 & valid, jnp.maximum(seg_sum, 0.0), -jnp.inf)
    head_d = (dock != _shift_right(dock, -1)) & valid
    doc_max = segmented_scan(jnp.maximum, field_val, head_d)
    tail_d = dock != jnp.concatenate(
        [dock[:, 1:], jnp.full_like(dock[:, :1], -1)], axis=1
    )
    final = jnp.where(tail_d & valid, doc_max, -jnp.inf)
    top_scores, top_lanes = jax.lax.top_k(final, k)
    top_docs = jnp.take_along_axis(dock, top_lanes, axis=1)
    top_docs = jnp.where(jnp.isfinite(top_scores), top_docs, -1)
    return top_scores, top_docs


def z2o_fast_step(
    chunk: int,
    k: int,
    num_fields: int,
    num_chunks: int,
    rec,
    jobs_flat,
    qlen,
):
    """Fast zero-to-one program for queries with NO shared expansion nodes.

    When every expansion node is claimed by at most one query-term instance
    (the overwhelmingly common case — a shared node needs duplicate query
    terms or overlapping prefix expansions), each node has at most one entry
    per (doc, field) segment: the df pool (capacity ``tf >= 1``) can never
    exhaust, and the sequential consumption loop (zero_to_one.rs:98-121)
    reduces exactly to "accept the best-scoring entry per (doc, field,
    query term), ties to the earliest-enumerated expansion".  That is one
    stable sort + segmented reduces — the same data-parallel shape as the
    BM25 merge — with no NJ-step lockstep loop and no per-element
    gather/scatter state.  Routing is decided at plan time
    (``plan_batch_z2o`` returns per-query ``shared`` flags).

    FIELDS RIDE AS VALUES, NOT LANES: the entry score ``s = 1 -
    |len(exp) - len(term)| / len(exp)`` (zero_to_one.rs:57-58) does not
    depend on the field, so the best-entry choice per (doc, field, qterm)
    is "first lane with tf_field > 0" in (s desc, enumeration) order — one
    sort of [B, L] lanes keyed by (doc << 4 | qterm, s desc) carrying one
    masked-contribution operand PER FIELD, then a per-field first-valid
    segmented scan.  Halves the lane count at F=2 vs the previous
    [B, F*L] entry expansion, and lifts the F <= 8 / doc < 2^24 packing
    cliffs (key needs only doc << 4, so doc < 2^27 like BM25).

    Same 4-word job layout as ``z2o_step`` (word 2, the node id, unused).
    """
    F = num_fields
    C = chunk
    NC = num_chunks
    jobs = jobs_flat.reshape(-1, jobs_flat.shape[-1] // 4, 4)
    B, NJ, _ = jobs.shape
    L = NC * C

    jstart = jobs[..., 0]
    w1 = jobs[..., 1]
    jlen = w1 & ((1 << _LEN_BITS) - 1)
    jqterm = (w1 >> _LEN_BITS) & ((1 << _QT_BITS) - 1)
    jscore = jax.lax.bitcast_convert_type(jobs[..., 3], jnp.float32)

    # --- chunk expansion + gather (as in z2o_step) ------------------------ #
    # Stride-C contiguous chunks off one aligned per-job base (matches
    # index/device.py's expansion: only the first chunk pays the < 128-lane
    # alignment skip; every other chunk carries a full C payload).
    base = (jstart // 128) * 128
    skip0 = jstart - base
    njc = jnp.where(jlen > 0, (skip0 + jlen + (C - 1)) // C, 0)
    cum = jnp.cumsum(njc, axis=1)
    chunk_ids = jax.lax.broadcasted_iota(jnp.int32, (B, NC), dimension=1)
    # Broadcast compare-sum == searchsorted(cum, id, right) (see
    # index/device.py chunk expansion).
    chunk_job = jnp.sum(
        (cum[:, None, :] <= chunk_ids[:, :, None]).astype(jnp.int32), axis=-1
    )
    jc = jnp.minimum(chunk_job, NJ - 1)

    def take(a):
        return jnp.take_along_axis(a, jc, axis=1)

    within = chunk_ids - (take(cum) - take(njc))
    c_start = take(base) + within * C
    off = within * C
    c_skip = jnp.clip(take(skip0) - off, 0, C)
    c_end = jnp.clip(take(skip0) + take(jlen) - off, 0, C)
    c_len = jnp.maximum(c_end - c_skip, 0)
    c_valid = chunk_ids < cum[:, -1:]
    c_len = jnp.where(c_valid, c_len, 0)
    c_start = jnp.where(c_valid, c_start, 0)
    c_skip = jnp.where(c_valid, c_skip, 0)
    c_qterm = take(jqterm)
    c_score = take(jscore)

    R = rec.shape[0]

    def one(s):
        return jax.lax.dynamic_slice(rec, (0, s), (R, C))

    g = jax.vmap(jax.vmap(one))(c_start)
    doc = g[:, :, 0, :]  # [B, NC, C]
    tf = g[:, :, 1 : 1 + F, :].astype(jnp.float32)  # [B, NC, F, C]
    flen = jax.lax.bitcast_convert_type(g[:, :, 1 + F : 1 + 2 * F, :], jnp.float32)
    alive = g[:, :, 1 + 2 * F, :]

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, NC, C), dimension=2)
    live = (
        (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None]) & (alive > 0)
    )

    # --- per-field masked contributions on the POSTING lanes -------------- #
    # One lane per posting (not per (posting, field)): the entry score s is
    # field-independent, so field f's accepted entry for a (doc, qterm)
    # group is the FIRST lane with tf_f > 0 in (s desc, enumeration) order.
    # contrib_f = min(s/tf_f, 1) * tf_f / max(flen_f, qlen)
    # (zero_to_one.rs:118-120); -1 marks "no entry for this field".
    s_l = jnp.broadcast_to(c_score[..., None], (B, NC, C))  # [B, NC, C]
    live_f = live[:, :, None, :] & (tf > 0)  # [B, NC, F, C]
    contrib = (
        jnp.minimum(s_l[:, :, None, :] / tf, 1.0)
        * tf
        / jnp.maximum(flen, qlen[:, None, None, None])
    )
    contrib = jnp.where(live_f, contrib, -1.0)

    # Sort lanes by ((doc << 4 | qterm), s desc); lax.sort is stable, so
    # ties resolve to the earliest-enumerated lane = the oracle's
    # enumeration order (query term asc is in the key; expansion
    # lexicographic asc is the job order).  doc < 2^27 (the same packed
    # int32 capacity as the BM25 merge key).
    k1 = jnp.where(live, (doc << _QT_BITS) | c_qterm[..., None], _I32_MAX)
    ops = [k1.reshape(B, L), (-s_l).reshape(B, L)] + [
        contrib[:, :, f, :].reshape(B, L) for f in range(F)
    ]
    sorted_ops = jax.lax.sort(tuple(ops), dimension=1, num_keys=2)
    k1s = sorted_ops[0]
    contribs = sorted_ops[2:]
    valid = k1s != _I32_MAX

    # Per field: first valid contribution in each (doc, qterm) group
    # ("first non-negative" is an associative combiner), then the group
    # tail carries the accepted contribution; per-doc pool sum per field;
    # doc score = max over fields (fields with no entries contribute 0,
    # which never beats a real pool sum — every candidate doc has one).
    head1 = k1s != _shift_right(k1s, -1)
    tail1 = k1s != _shift_left(k1s, -1)
    dock = jnp.where(valid, k1s >> _QT_BITS, _I32_MAX)
    head_d = (dock != _shift_right(dock, -1)) & valid
    tail_d = dock != _shift_left(dock, -1)

    def first_valid(a, b):
        return jnp.where(a >= 0.0, a, b)

    doc_best = None
    for cf in contribs:
        first = segmented_scan(first_valid, cf, head1)
        sel = jnp.where(tail1 & (first >= 0.0), first, 0.0)
        pool = segmented_scan(jnp.add, sel, head_d)
        doc_best = pool if doc_best is None else jnp.maximum(doc_best, pool)

    final = jnp.where(tail_d & valid, jnp.maximum(doc_best, 0.0), -jnp.inf)
    top_scores, top_lanes = jax.lax.top_k(final, k)
    top_docs = jnp.take_along_axis(dock, top_lanes, axis=1)
    top_docs = jnp.where(jnp.isfinite(top_scores), top_docs, -1)
    return top_scores, top_docs


def plan_batch_z2o(dix, queries, tokenizer):
    """Plan a z2o batch into 4-word job tables (pooled per query string).

    Returns ``(jquery, words int32[NJOBS, 4], qlen f32[B], nchunks, njobs,
    fallback, shared)``.  The per-query plan (job rows, qlen, chunk totals,
    shared-node flag, cap fallbacks) is snapshot-static AND query-local —
    every cap check in the impl groups by query — so it pools per
    (DeviceIndex, tokenizer) exactly like the BM25 query-plan cache
    (index/device.py plan_batch): repeated queries cost one dict lookup
    plus a CSR gather; only first-seen queries pay the tokenize + probe +
    node-id assembly on the serving main thread.
    """
    from ..index.device import _segment_arange

    with dix._plan_lock:
        pools = dix._z2o_qplans
        pool = pools.get(tokenizer)
        if pool is None or (
            len(pool["ids"]) > dix._QPLAN_MAX_QUERIES
            or len(pool["words"]) > dix._QPLAN_MAX_ROWS
        ):
            pool = {
                "ids": {},  # query string -> dense qid
                "off": np.zeros(1, dtype=np.int64),
                "words": np.zeros((0, 4), dtype=np.int32),
                "qlen": np.zeros(0, dtype=np.float32),
                "nchunks": np.zeros(0, dtype=np.int64),
                "njobs": np.zeros(0, dtype=np.int64),
                "shared": np.zeros(0, dtype=bool),
                "fallback": np.zeros(0, dtype=bool),
            }
            pools[tokenizer] = pool
        ids = pool["ids"]
        B = len(queries)
        qids = np.fromiter((ids.get(q, -1) for q in queries), np.int64, count=B)
        if (qids < 0).any():
            miss = sorted({queries[i] for i in np.flatnonzero(qids < 0)})
            _z2o_qplan_insert(dix, pool, miss, tokenizer)
            qids = np.fromiter((ids[q] for q in queries), np.int64, count=B)
        qlen = pool["qlen"][qids]
        fallback = [int(i) for i in np.flatnonzero(pool["fallback"][qids])]
        nj = pool["njobs"][qids]
        if int(nj.sum()) == 0:
            return None, None, qlen, None, None, fallback, None
        jquery = np.repeat(np.arange(B, dtype=np.int64), nj)
        rows = np.repeat(pool["off"][qids], nj) + _segment_arange(nj)
        return (
            jquery,
            pool["words"][rows],
            qlen,
            pool["nchunks"][qids],
            nj,
            fallback,
            pool["shared"][qids],
        )


def _z2o_qplan_insert(dix, pool, miss, tokenizer):
    """Plan first-seen queries through the full path and pool the per-query
    job rows (rows of query i are contiguous: the impl's ``jquery`` is
    grouped ascending by construction — jobs are built in term-instance
    order and every filter preserves it)."""
    jquery, words, qlen, nchunks, njobs, fb, shared = _plan_batch_z2o_impl(
        dix, miss, tokenizer
    )
    M = len(miss)
    fb_m = np.zeros(M, dtype=bool)
    fb_m[list(fb)] = True
    if jquery is None:
        njobs_m = np.zeros(M, dtype=np.int64)
        words_m = np.zeros((0, 4), dtype=np.int32)
        nchunks_m = np.zeros(M, dtype=np.int64)
        shared_m = np.zeros(M, dtype=bool)
    else:
        assert (np.diff(jquery) >= 0).all()
        njobs_m = njobs.astype(np.int64)
        words_m = words
        nchunks_m = nchunks
        shared_m = shared
    base = len(pool["off"]) - 1
    for i, q in enumerate(miss):
        pool["ids"][q] = base + i
    pool["off"] = np.concatenate([pool["off"], pool["off"][-1] + np.cumsum(njobs_m)])
    pool["words"] = np.concatenate([pool["words"], words_m])
    pool["qlen"] = np.concatenate([pool["qlen"], qlen.astype(np.float32)])
    pool["nchunks"] = np.concatenate([pool["nchunks"], nchunks_m])
    pool["njobs"] = np.concatenate([pool["njobs"], njobs_m])
    pool["shared"] = np.concatenate([pool["shared"], shared_m])
    pool["fallback"] = np.concatenate([pool["fallback"], fb_m])


def _plan_batch_z2o_impl(dix, queries, tokenizer):
    """The full (uncached) z2o planning pass — see plan_batch_z2o."""
    from ..index.device import _MAX_CHAR, _segment_arange

    cfg = dix.config
    B = len(queries)
    fallback = []

    tok_lists = [list(tokenizer(q)) for q in queries]
    qlen = np.array([len(t) for t in tok_lists], dtype=np.float32)  # incl. empties
    filt = [[t for t in toks if t] for toks in tok_lists]
    max_terms = min(cfg.max_query_terms, 1 << _QT_BITS)
    for qi, toks in enumerate(filt):
        if len(toks) > max_terms:
            fallback.append(qi)
            filt[qi] = []
    counts = np.array([len(t) for t in filt], dtype=np.int64)
    total_terms = int(counts.sum())
    if total_terms == 0 or dix.num_postings == 0:
        return None, None, qlen, None, None, fallback, None
    flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
    flat_qterm = _segment_arange(counts)
    from ..index.segment import probe_terms_fixed

    flat_terms, flat_blen = probe_terms_fixed([t for toks in filt for t in toks])
    flat_upper = np.char.add(flat_terms, _MAX_CHAR)

    parts = []
    for si in range(len(dix.segments)):
        terms = dix.seg_terms[si]
        if len(terms) == 0:
            continue
        lo = np.searchsorted(terms, flat_terms, side="left")
        hi = np.searchsorted(terms, flat_upper, side="left")
        nexp = hi - lo
        if nexp.max(initial=0) == 0:
            continue
        tid = np.repeat(lo, nexp) + _segment_arange(nexp)
        jidx = np.repeat(np.arange(total_terms, dtype=np.int64), nexp)
        offs = dix.seg_offsets[si]
        local = offs[tid].astype(np.int64)
        length = (offs[tid + 1] - offs[tid]).astype(np.int64)
        cum = dix.seg_live_cum[si]
        ldf = cum[local + length] - cum[local]
        parts.append(
            (
                jidx,
                dix.seg_base[si] + local,
                length,
                terms[tid],
                dix.seg_term_lens[si][tid].astype(np.int64),
                ldf,
                np.full(len(tid), si, np.int64),
            )
        )
    if not parts:
        return None, None, qlen, None, None, fallback, None
    jidx, jstart, jlen, jexp, jblen, jldf, jseg = (
        np.concatenate([p[i] for p in parts]) for i in range(7)
    )
    keep = jlen > 0
    jidx, jstart, jlen, jexp, jblen, jldf, jseg = (
        a[keep] for a in (jidx, jstart, jlen, jexp, jblen, jldf, jseg)
    )
    if len(jidx) == 0:
        return None, None, qlen, None, None, fallback, None

    # df over segments per (query term, expansion); df == 0 never scored
    # (query.rs:48).
    order = np.lexsort((jseg, jexp, jidx))
    jidx, jstart, jlen, jexp, jblen, jldf, jseg = (
        a[order] for a in (jidx, jstart, jlen, jexp, jblen, jldf, jseg)
    )
    new_g = np.ones(len(jidx), dtype=bool)
    new_g[1:] = (jidx[1:] != jidx[:-1]) | (jexp[1:] != jexp[:-1])
    gid = np.cumsum(new_g) - 1
    gdf = np.bincount(gid, weights=jldf.astype(np.float64))
    keep2 = gdf[gid] > 0
    jidx, jstart, jlen, jexp, jblen = (
        a[keep2] for a in (jidx, jstart, jlen, jexp, jblen)
    )
    new_g = new_g[keep2]
    if len(jidx) == 0:
        return None, None, qlen, None, None, fallback, None

    per_term_exp = np.bincount(jidx[new_g], minlength=total_terms)
    jquery = flat_query[jidx]
    bad = (
        set(
            int(q)
            for q in flat_query[np.flatnonzero(per_term_exp > cfg.max_expansions)]
        )
        if cfg.max_expansions
        else set()
    )
    if bad:
        fallback.extend(sorted(bad))
        keepq = ~np.isin(jquery, np.fromiter(bad, dtype=np.int64))
        jidx, jstart, jlen, jexp, jblen, jquery = (
            a[keepq] for a in (jidx, jstart, jlen, jexp, jblen, jquery)
        )
        if len(jidx) == 0:
            return None, None, qlen, None, None, fallback, None

    # Node ids: one per distinct expansion per QUERY (keyed by the expanded
    # term alone — shared across query terms, zero_to_one.rs:75).
    o2 = np.lexsort((jexp, jquery))
    newn = np.ones(len(jidx), dtype=bool)
    newn[1:] = (jquery[o2][1:] != jquery[o2][:-1]) | (jexp[o2][1:] != jexp[o2][:-1])
    nid_sorted = np.cumsum(newn) - 1
    qfirst = np.zeros(B + 1, dtype=np.int64)
    np.add.at(qfirst, jquery[o2][newn] + 1, 1)
    qfirst = np.cumsum(qfirst)
    node_local_sorted = nid_sorted - qfirst[jquery[o2]]
    node_local = np.empty(len(jidx), np.int64)
    node_local[o2] = node_local_sorted

    # The packed sort operand (q << 16 | node) recovers node ids with a
    # 16-bit mask; a config with max_expansions large enough to mint >=2^16
    # node ids per query would silently corrupt qterm/node recovery — route
    # such queries to the host path like the other caps.
    if node_local.max(initial=0) >= (1 << 16):
        wide = np.unique(jquery[node_local >= (1 << 16)])
        fallback.extend(int(q) for q in wide)
        keepw = ~np.isin(jquery, wide)
        jidx, jstart, jlen, jexp, jblen, jquery, node_local = (
            a[keepw]
            for a in (jidx, jstart, jlen, jexp, jblen, jquery, node_local)
        )
        if len(jidx) == 0:
            return None, None, qlen, None, None, fallback, None

    # Entry score: 1 - |len(exp) - len(term)| / len(exp), byte lengths
    # (zero_to_one.rs:57-58); expansions never shorten, so always in (0, 1].
    score = (1.0 - np.abs(jblen - flat_blen[jidx]) / jblen.astype(np.float64)).astype(
        np.float32
    )

    words = np.empty((len(jidx), 4), dtype=np.int32)
    words[:, 0] = jstart
    words[:, 1] = jlen | (flat_qterm[jidx] << _LEN_BITS)
    words[:, 2] = node_local
    words[:, 3] = score.view(np.int32)

    # Shared-node detection: a node (distinct expansion per query) claimed
    # by >= 2 distinct query-term instances makes the df-pool interaction
    # real — those queries need the lockstep program (z2o_step); everyone
    # else takes the loop-free fast program (z2o_fast_step).
    jqt = flat_qterm[jidx]
    o3 = np.lexsort((jqt, jexp, jquery))
    samegrp = (jquery[o3][1:] == jquery[o3][:-1]) & (jexp[o3][1:] == jexp[o3][:-1])
    diffq = jqt[o3][1:] != jqt[o3][:-1]
    shared = np.zeros(B, dtype=bool)
    shared[jquery[o3][1:][samegrp & diffq]] = True

    # Stride-C contiguous chunks (must match the on-device expansion).
    C_ = dix.CHUNK
    job_chunks = np.where(jlen > 0, (jstart % 128 + jlen + C_ - 1) // C_, 0)
    nchunks = np.bincount(jquery, weights=job_chunks.astype(np.float64), minlength=B)
    njobs = np.bincount(jquery, minlength=B)
    return jquery, words, qlen, nchunks.astype(np.int64), njobs, fallback, shared


_Z2O_STEP_CACHE = {}


def _z2o_window_step_impl(
    rec, words_flat, qlen_flat, *, chunk, k, num_fields, class_specs,
    fmt="f32",
):
    """Every z2o shape class of a batch in ONE device program.

    Mirrors the BM25 window step (index/device.py `_window_step_impl`):
    one jit call over one packed job buffer, one packed [sum(b_out), 2, k]
    result — the whole batch pays a single dispatch and one D2H fetch
    instead of one per class.

    ``fmt`` composes the packed result exactly like the BM25 window via
    the shared :func:`~probly_search_tpu.index.device.pack_result_rows`
    ("f32" / "compact" / "slots" / "slots20").  Ranking is fixed in f32 by
    top_k before any narrowing.
    """
    import jax.numpy as jnp

    from ..index.device import pack_result_rows

    outs = []
    off = 0
    qoff = 0
    for b_pad, b_out, nj, nc, fast in class_specs:
        n = b_pad * nj * 4
        jobs = words_flat[off : off + n].reshape(b_pad, nj * 4)
        off += n
        ql = qlen_flat[qoff : qoff + b_pad]
        qoff += b_pad
        kk = min(k, nc * chunk * num_fields)
        if fast:
            s, d = z2o_fast_step(
                chunk=chunk,
                k=kk,
                num_fields=num_fields,
                num_chunks=nc,
                rec=rec,
                jobs_flat=jobs,
                qlen=ql,
            )
        else:
            s, d = z2o_step(
                chunk=chunk,
                k=kk,
                num_fields=num_fields,
                num_chunks=nc,
                rec=rec,
                jobs_flat=jobs,
                qlen=ql,
            )
        s = s[:b_out]
        d = d[:b_out]
        if kk < k:
            s = jnp.pad(s, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
            d = jnp.pad(d, ((0, 0), (0, k - kk)), constant_values=-1)
        outs.append(pack_result_rows(s, d, fmt))
    return jnp.concatenate(outs, axis=0)


def _get_z2o_window_step():
    fn = _Z2O_STEP_CACHE.get("window")
    if fn is None:
        fn = jax.jit(
            _z2o_window_step_impl,
            static_argnames=(
                "chunk", "k", "num_fields", "class_specs", "fmt",
            ),
        )
        _Z2O_STEP_CACHE["window"] = fn
    return fn


def z2o_query_batch(dix, queries, tokenizer, top_k, scorer=None):
    """Blocking convenience over :func:`z2o_query_batch_async`.

    Honors ``IndexConfig.serving_window`` exactly like the BM25 blocking
    path (index/device.py DeviceIndex.query_batch): oversized batches are
    split into pipelined sub-windows at ``serving_depth`` — identical
    results, bounded per-dispatch footprint.
    """
    sw = getattr(dix.config, "serving_window", 0)
    if not sw or len(queries) <= sw:
        return z2o_query_batch_async(dix, queries, tokenizer, top_k, scorer=scorer).get()
    depth = max(1, getattr(dix.config, "serving_depth", 4))
    out = []
    inflight = []
    for s in range(0, len(queries), sw):
        inflight.append(
            z2o_query_batch_async(
                dix, queries[s : s + sw], tokenizer, top_k, scorer=scorer
            )
        )
        while len(inflight) >= depth:
            out.extend(inflight.pop(0).get())
    for h in inflight:
        out.extend(h.get())
    return out


def z2o_query_batch_async(dix, queries, tokenizer, top_k, scorer=None, fmt=None):
    """Plan + dispatch a zero-to-one batch without blocking.

    Returns the same :class:`~probly_search_tpu.index.device.PendingBatch`
    handle as the BM25 engine (the packed result formats are shared), so
    z2o serving gets the columnar drain (``get_arrays``) and window
    pipelining for free.  Cap-exceeding / shared-node-over-budget queries
    degrade to the vectorized host lockstep.

    ``fmt`` overrides ``IndexConfig.result_format`` for this batch
    ("f32" | "compact" | "slots" | "slots20"); rankings are computed on device in f32
    identically in every mode (only the score REPORT narrows).
    """
    from ..index import device as _dev_mod
    from ..index.device import PendingBatch, _bucket, _bucket_vec, _segment_arange
    from ..models import zero_to_one as _z2o
    from ..utils.metrics import metrics

    B = len(queries)
    k = top_k or dix.config.default_top_k
    from ..index.device import resolve_result_format

    if fmt is None:
        fmt = dix.config.effective_result_format()
    fmt = resolve_result_format(fmt, dix.num_slots)
    host_rows = {}
    with metrics.timer("z2o/plan"):
        jquery, words, qlen, nchunks, njobs, fallback, shared = plan_batch_z2o(
            dix, queries, tokenizer
        )
    if fallback:
        # Cap-exceeding queries run the vectorized host lockstep —
        # bit-identical to the exact oracle, milliseconds instead of a
        # per-posting Python walk.  A z2o SUBCLASS with overridden scoring
        # keeps the exact path (its semantics are its own).
        metrics.inc("device_fallback_queries", len(fallback))
        _dev_mod._host_fallback_policy(
            dix.config, len(fallback), "z2o device plan caps exceeded"
        )
        plain = scorer is None or type(scorer) is _z2o.ZeroToOne
        for qi in fallback:
            host_rows[qi] = (
                _z2o.ZeroToOne.vectorized_query(
                    dix._index, queries[qi], tokenizer, top_k=k
                )
                if plain
                else dix._index.query(
                    queries[qi], scorer, tokenizer, [1.0] * dix.num_fields, top_k=k
                )
            )
    if jquery is None:
        return PendingBatch(dix, B, [], host_rows=host_rows, k=k)

    C = dix.CHUNK
    F = max(dix.num_fields, 1)
    nc_bucket = _bucket_vec(nchunks, dix.nc_buckets, dix.nc_min)
    # Routing: queries with no shared expansion nodes take the loop-free
    # fast program (z2o_fast_step; posting lanes only — fields ride as
    # sort VALUES, so any F works and doc slots just need the same < 2^27
    # packed-key capacity as BM25).  Shared-node queries need the exact
    # lockstep program, which packs field into 3 key bits (F <= 8) and is
    # capped at 16384 entry lanes — bigger or wider shared-node queries go
    # to the vectorized host lockstep (models/zero_to_one.py).
    fast_ok = dix.num_slots < (1 << 27)
    fastq = (~shared) & fast_ok if shared is not None else np.zeros(B, bool)
    lanes = np.where(fastq, nc_bucket * C, nc_bucket * C * F)
    max_fl = 16384
    huge = (
        (~fastq & ((lanes > max_fl) | (F > 8)))
        | (fastq & (lanes > dix.LANES_PER_DISPATCH))
    )
    if huge.any():
        metrics.inc("z2o_host_vectorized_queries", int(huge.sum()))
        _dev_mod._host_fallback_policy(
            dix.config,
            int(huge.sum()),
            "z2o shared-node queries past the lockstep compile cap",
        )
        for qi in np.flatnonzero(huge & (njobs > 0)):
            host_rows[int(qi)] = _z2o.ZeroToOne.vectorized_query(
                dix._index, queries[int(qi)], tokenizer, top_k=k
            )
        nc_bucket = np.where(huge, -1, nc_bucket)
    # Pack every class's job table + qlen vector into one flat buffer and
    # run the batch as ONE device program with one packed result fetch.
    _t_pack = metrics.timer("z2o/pack"); _t_pack.__enter__()
    class_specs = []
    layout = []  # (query_indices, row_offset)
    word_parts = []
    qlen_parts = []
    row = 0
    for fast_mode in (True, False):
        mode_sel = fastq if fast_mode else ~fastq
        for nc in np.unique(nc_bucket[(nc_bucket > 0) & mode_sel]):
            nc = int(nc)
            members = np.flatnonzero((nc_bucket == nc) & (njobs > 0) & mode_sel)
            if len(members) == 0:
                continue
            nj = _bucket(int(njobs[members].max()), dix.NJ_BUCKETS, 4)
            lane_f = 1 if fast_mode else F  # fast lanes carry no field dim
            b_cap = max(8, int(dix.LANES_PER_DISPATCH // (nc * C * lane_f)))
            if getattr(dix.config, "pow2_row_split", True):
                spans = dix._pow2_spans(len(members), b_cap)
            else:
                spans = [
                    (m, max(8, 1 << (m - 1).bit_length()))
                    for m in (
                        len(members[s : s + b_cap])
                        for s in range(0, len(members), b_cap)
                    )
                ]
            s = 0
            for Bc, B_pad in spans:
                idxs = members[s : s + Bc]
                s += Bc
                b_out = min(B_pad, -(-Bc // 256) * 256)
                jobs_flat = np.zeros((B_pad, nj, 4), dtype=np.int32)
                sel = np.isin(jquery, idxs)
                jq = jquery[sel]
                pos = _segment_arange(np.bincount(jq, minlength=B)[idxs])
                r = np.searchsorted(idxs, jq)
                jobs_flat[r, pos] = words[sel]
                qlen_pad = np.ones(B_pad, np.float32)
                qlen_pad[:Bc] = qlen[idxs]
                word_parts.append(jobs_flat.reshape(-1))
                qlen_parts.append(qlen_pad)
                class_specs.append((B_pad, b_out, nj, nc, fast_mode))
                layout.append((idxs, row))
                row += b_out
    _t_pack.__exit__(None, None, None)
    if not class_specs:
        return PendingBatch(dix, B, [], host_rows=host_rows, k=k)
    step = _get_z2o_window_step()
    with metrics.timer("z2o/dispatch"):
        packed = step(
            dix.rec,
            jnp.asarray(np.concatenate(word_parts)),
            jnp.asarray(np.concatenate(qlen_parts)),
            chunk=C,
            k=k,
            num_fields=dix.num_fields,
            class_specs=tuple(class_specs),
            fmt=fmt,
        )
    if dix.config.prefetch_results:
        # Stream the D2H behind later windows' device compute so the
        # drain's read finds the result on the host
        # (IndexConfig.prefetch_results).
        packed.copy_to_host_async()
    return PendingBatch(
        dix, B, [], packed=packed, layout=layout, host_rows=host_rows,
        fmt=fmt, k=k,
    )
