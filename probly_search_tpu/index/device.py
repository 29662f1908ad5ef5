"""Device-resident index and the batched device query path.

The reference answers one query at a time by walking trie nodes and posting
linked lists (`/root/reference/src/query.rs:21-106`).  Here a **query batch**
is the unit of work, executed as few, large, shape-homogeneous XLA
dispatches.  The execution model is built around three costs of
accelerator serving: a fixed cost per dispatch and per transfer,
host->device bytes, and on-device sort width.  Consequences:

* Queries are planned on host into **job** descriptors only — 3 int32 words
  per (query term expansion): start, len|qterm|group, boost-bits.  All
  per-posting structure (chunking, lane expansion) is derived ON DEVICE, so
  a 4096-query dispatch ships a few hundred KB, not tens of MB.
* Jobs expand on device into fixed-size C-row **chunks**; every posting
  gather is a contiguous ``dynamic_slice`` of the posting record array, so
  XLA emits one gather of whole rows rather than per-element gathers.
* Queries are bucketed by chunk count into shape classes; each class packs
  thousands of queries per dispatch to amortize the per-dispatch cost.

Device step per dispatch:
  unpack jobs -> chunk expansion (cumsum + broadcast compare-sum; chunks
                    are contiguous stride-C slices off one 128-aligned
                    base per job, so only a job's first chunk pays the
                    < 128-lane alignment skip)
  slice-gather [B, NC, R, C] posting records
  scorer.device_score_lanes — fused scoring (vectorized
                    ScoreCalculator::score, calculator.rs:58-66).  df and
                    idf never touch the device: document frequency (the
                    live-pointer count, index.rs:282-297) is static per
                    snapshot, so `device_term_scale` — the vectorized
                    before_each — premultiplies idf * expansion_boost into
                    each job's scale word on host at plan time.
  merge_scores_topk — sorted segmented max/sum merge + lax.top_k
                    (ops/merge.py; the max_score_merger rule)

Posting record layout (transposed int32[R, P + C], interleaved so one slice
fetches everything; R = (1 + 2F + 1) rounded up to 4 or a multiple of 8):
  rec[0]         doc slot — ALWAYS the true slot, even for docs dead at
                 snapshot time, so every term's posting run stays ascending
                 in key order (chunks are pre-sorted runs, see
                 ops/merge.merge_scores_topk_presorted)
  rec[1:1+F]     per-field term frequency (DocumentPointer.term_frequency)
  rec[1+F:1+2F]  per-field doc length, f32 bits (DocumentDetails)
  rec[1+2F]      doc liveness at snapshot time (0/1; snapshots are rebuilt
                 on any index mutation, so this bakes in latent deletes)

The term dictionary stays on the host (strings never cross to device).  A
query term's expansions may span several delta segments; jobs carrying the
same expanded term are grouped at plan time so idf is computed (on host)
over the term's full posting set across segments.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..models.base import QueryResult
from ..utils.tokenizers import whitespace_tokenizer

import jax
import jax.numpy as jnp

from ..ops.merge import INVALID_KEY, merge_scores_topk

_MAX_CHAR = "\U0010FFFF"  # prefix upper-bound sentinel (terms containing it
# would break the vectorized prefix range; practically nonexistent)

# Job word1 layout: len(26) | qterm(4).  (df groups no longer ship to the
# device: df — the live posting-pointer count, index.rs:282-297 — is static
# per snapshot, so idf * expansion_boost is premultiplied on host into the
# per-job scale word, the vectorized before_each.)
_LEN_BITS = 26
_QT_BITS = 4
_MAX_JOB_LEN = (1 << _LEN_BITS) - 1

from ..config import HostFallbackError


def _host_fallback_policy(config, n: int, reason: str) -> None:
    """Enforce ``IndexConfig.host_fallback`` for ``n`` degraded queries.

    Host fallbacks are exact but orders of magnitude slower than the
    device path (the z2o shared-node worst case,
    benchmarks/z2o_adversarial.py) — production servers may prefer to
    reject such queries over silently absorbing the latency.
    """
    policy = getattr(config, "host_fallback", "allow")
    if policy == "allow" or n <= 0:
        return
    msg = (
        f"{n} quer{'y' if n == 1 else 'ies'} degraded to the host-speed "
        f"path ({reason}); see IndexConfig.host_fallback"
    )
    if policy == "error":
        raise HostFallbackError(msg)
    import warnings

    warnings.warn(msg, RuntimeWarning, stacklevel=3)


@dataclass
class ScoreLanes:
    """Vectorized scoring context — the device analogue of the per-posting
    (DocumentPointer, DocumentDetails, FieldData, TermData) arguments of
    ``ScoreCalculator::score`` (calculator.rs:58-66).

    LAYOUT: the posting lane dimension C (the chunk width, a multiple of
    128) is always the MINOR axis; the field dimension F sits in front of
    it, so each field row of a chunk is one contiguous C-wide read.
    """

    tf: Any  # f32[B, NC, F, C] — per-field term frequency
    field_length: Any  # f32[B, NC, F, C] — per-field doc lengths
    field_avg: Any  # f32[F] — average field lengths
    fields_boost: Any  # f32[F]
    scale: Any  # f32[B, NC, C] — per-LANE scale.  Per-expansion jobs
    # broadcast the job's host-premultiplied scale word (device_term_scale,
    # the vectorized before_each: df-clamped idf * expansion boost for
    # BM25); term-range jobs assemble it on device from the aux record
    # array (static idf row x device_range_boost(term_len, qlen)).
    doc: Any  # int32[B, NC, C] — doc slot
    live: Any  # bool[B, NC, C] — posting is live and in-bounds
    qterm: Any  # int32[B, NC] — dense query-term index per chunk


def _query_step_impl(
    scorer,
    chunk: int,
    k: int,
    qterm_bits: int,
    num_fields: int,
    num_chunks: int,
    rec,
    field_avg,
    fields_boost,
    jobs_flat,
    aux=None,
    use_ranges: bool = False,
):
    """One dispatch: ``jobs_flat`` int32[B * NJ * 3] -> top-k per query.

    ``rec`` is the TRANSPOSED posting record array int32[R, P + C] so every
    chunk gather is a [R, C] slice with the lane dimension minor.  df / idf
    never touch the device for per-expansion jobs: they are static per
    snapshot and premultiplied into each job's scale word on host (see
    plan_batch).  TERM-RANGE jobs (word1 bit 30; expansion-heavy terms)
    cover a whole contiguous expansion range of the CSR instead, and read
    the static per-posting idf / term byte length from ``aux``
    (int32[4, P + C], DeviceIndex._aux_rec) to assemble the per-lane scale
    on device — a single-char prefix query is a handful of long jobs, not
    one padded chunk per tiny term.  ``use_ranges`` classes skip the
    pre-sorted merge (range chunks span many terms, so they are not
    globally doc-sorted).
    """
    F = num_fields
    C = chunk
    NC = num_chunks
    jobs = jobs_flat.reshape(-1, jobs_flat.shape[-1] // 3, 3)
    B, NJ, _ = jobs.shape
    L = NC * C

    jstart = jobs[..., 0]  # [B, NJ]
    w1 = jobs[..., 1]
    jlen = w1 & _MAX_JOB_LEN
    jqterm = (w1 >> _LEN_BITS) & ((1 << _QT_BITS) - 1)
    jscale = jax.lax.bitcast_convert_type(jobs[..., 2], jnp.float32)

    # --- on-device chunk expansion (all [B, NC]-small) ------------------ #
    # Chunks of a job are CONTIGUOUS stride-C slices off the job's single
    # 128-aligned base: only the first chunk pays the (< 128-lane)
    # alignment skip, so every other chunk carries a full C payload
    # postings (the older per-chunk alignment scheme paid the 128-lane
    # skip on EVERY chunk, i.e. 1/8 of all gathered lanes at C = 1024).
    # Chunk boundaries inside a job are clean posting continuations, and
    # each C-lane chunk is still one ascending run (the merge contract).
    base = (jstart // 128) * 128  # [B, NJ] per-job 128-aligned slice base
    skip0 = jstart - base  # < 128
    njc = jnp.where(jlen > 0, (skip0 + jlen + (C - 1)) // C, 0)  # [B, NJ]
    cum = jnp.cumsum(njc, axis=1)
    chunk_ids = jax.lax.broadcasted_iota(jnp.int32, (B, NC), dimension=1)
    # searchsorted(cum, id, right) == count of cum entries <= id.  NJ and
    # NC are small, so a [B, NC, NJ] broadcast compare-sum is one
    # elementwise fusion, where a vmapped searchsorted lowers to a
    # while loop per row.
    chunk_job = jnp.sum(
        (cum[:, None, :] <= chunk_ids[:, :, None]).astype(jnp.int32), axis=-1
    )
    jc = jnp.minimum(chunk_job, NJ - 1)

    def take(a):
        return jnp.take_along_axis(a, jc, axis=1)

    within = chunk_ids - (take(cum) - take(njc))  # chunk index within job
    c_start = take(base) + within * C  # [B, NC] slice start
    off = within * C  # job-lane offset of this chunk
    c_skip = jnp.clip(take(skip0) - off, 0, C)  # payload begins here
    c_end = jnp.clip(take(skip0) + take(jlen) - off, 0, C)
    c_len = jnp.maximum(c_end - c_skip, 0)
    c_valid = chunk_ids < cum[:, -1:]
    c_len = jnp.where(c_valid, c_len, 0)
    c_start = jnp.where(c_valid, c_start, 0)
    c_skip = jnp.where(c_valid, c_skip, 0)
    c_qterm = take(jqterm)
    c_scale = take(jscale)
    if use_ranges:
        c_range = (take(w1) >> 30) & 1  # [B, NC] — chunk of a range job
        c_qlenb = take(jobs[..., 2]).astype(jnp.float32)  # word2 = qterm bytes

    # --- contiguous slice-gather [B, NC, R, C] -------------------------- #
    R = rec.shape[0]

    def one(s):
        return jax.lax.dynamic_slice(rec, (0, s), (R, C))

    with jax.named_scope("gather"):
        g = jax.vmap(jax.vmap(one))(c_start)

    doc = g[:, :, 0, :]  # [B, NC, C]
    tf = g[:, :, 1 : 1 + F, :].astype(jnp.float32)  # [B, NC, F, C]
    flen = jax.lax.bitcast_convert_type(g[:, :, 1 + F : 1 + 2 * F, :], jnp.float32)
    alive = g[:, :, 1 + 2 * F, :]  # liveness row (rec layout above)

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, NC, C), dimension=2)
    live = (
        (pos >= c_skip[..., None])
        & (pos < (c_skip + c_len)[..., None])
        & (alive > 0)
    )

    scale_lanes = jnp.broadcast_to(c_scale[..., None], (B, NC, C))
    if use_ranges:
        # Per-lane scale for range chunks: static idf row x on-device
        # expansion boost (aux rows 0/1; see DeviceIndex._aux_rec).
        def one_aux(s):
            return jax.lax.dynamic_slice(aux, (0, s), (aux.shape[0], C))

        a = jax.vmap(jax.vmap(one_aux))(c_start)
        idf_lane = jax.lax.bitcast_convert_type(a[:, :, 0, :], jnp.float32)
        tlen_lane = a[:, :, 1, :].astype(jnp.float32)
        boost = scorer.device_range_boost(tlen_lane, c_qlenb[..., None])
        scale_lanes = jnp.where(c_range[..., None] > 0, idf_lane * boost, scale_lanes)

    lanes = ScoreLanes(
        tf=tf,
        field_length=flen,
        field_avg=field_avg,
        fields_boost=fields_boost,
        scale=scale_lanes,
        doc=doc,
        live=live,
        qterm=c_qterm,
    )
    with jax.named_scope("score"):
        score = scorer.device_score_lanes(lanes)  # [B, NC, C]
    excl = bool(getattr(scorer, "device_excludes_nonpositive", False))

    if (C & (C - 1)) == 0 and not use_ranges:
        # Pre-sorted-runs scheme (chunks are ascending doc runs, CSR
        # invariant): leading pads carry key -1, trailing pads INVALID_KEY,
        # dead docs their ordered key with score -inf
        # (ops/merge.merge_scores_topk_presorted).
        from ..ops.merge import merge_scores_topk_presorted

        with jax.named_scope("score"):  # lane masks (fused with the gather)
            in_pay = (pos >= c_skip[..., None]) & (pos < (c_skip + c_len)[..., None])
            alive_b = alive > 0
            if excl:
                # score() -> None postings never merge (bm25.rs:89-92).
                score = jnp.where(score > 0.0, score, 0.0)
            score = jnp.where(in_pay, score, 0.0)
            score = jnp.where(in_pay & jnp.logical_not(alive_b), -jnp.inf, score)
            key = jnp.where(
                in_pay,
                (doc << qterm_bits) | c_qterm[..., None],
                jnp.where(pos < c_skip[..., None], -1, INVALID_KEY),
            )
        return merge_scores_topk_presorted(
            key.reshape(B, L), score.reshape(B, L), k, qterm_bits, C, excl
        )

    # Non-power-of-two chunk widths: general sort-based merge.
    if excl:
        live = live & (score > 0.0)
    key = jnp.where(
        live, (doc << qterm_bits) | c_qterm[..., None], INVALID_KEY
    ).reshape(B, L)
    return merge_scores_topk(key, score.reshape(B, L), k, qterm_bits)


def _window_step_impl(
    scorer,
    rec,
    field_avg,
    fields_boost,
    words_flat,
    aux,
    *,
    chunk: int,
    k: int,
    qterm_bits: int,
    num_fields: int,
    class_specs,
    fmt: str = "f32",
):
    """Execute every shape class of a query window in ONE device program.

    Every dispatch and every host<->device array transfer pays its own
    fixed cost — so the whole window is one jit call over ONE packed input
    buffer, returning ONE packed output array:

    * ``words_flat`` int32[total] — every class's [B_pad, NJ*3] job table,
      concatenated.  ``class_specs`` = ((b_pad, b_out, nj, nc), ...)
      statically describes the layout; ``b_out <= b_pad`` is the number of
      output rows kept per class (real queries rounded up to coarse
      granularity — the pow-of-two pad rows would otherwise inflate the
      result fetch).
    * returns int32[sum(b_out), 2, k]: row 0 = scores (f32 bits), row 1 =
      doc slots — a single D2H fetch drains the window.
    """
    outs = []
    off = 0
    for spec in class_specs:
        # Light classes carry their own chunk width as a 6th element
        # (IndexConfig.light_chunk_size); legacy 5-tuples (checked-in
        # template manifests) use the window's global width.
        b_pad, b_out, nj, nc, rng = spec[:5]
        cw = spec[5] if len(spec) > 5 else chunk
        n = b_pad * nj * 3
        jobs_flat = words_flat[off : off + n].reshape(b_pad, nj * 3)
        off += n
        kk = min(k, nc * cw)
        s, d = _query_step_impl(
            scorer,
            chunk=cw,
            k=kk,
            qterm_bits=qterm_bits,
            num_fields=num_fields,
            num_chunks=nc,
            rec=rec,
            field_avg=field_avg,
            fields_boost=fields_boost,
            jobs_flat=jobs_flat,
            aux=aux,
            use_ranges=rng,
        )
        s = s[:b_out]
        d = d[:b_out]
        if kk < k:
            s = jnp.pad(s, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
            d = jnp.pad(d, ((0, 0), (0, k - kk)), constant_values=-1)
        outs.append(pack_result_rows(s, d, fmt))
    return jnp.concatenate(outs, axis=0)  # [sum(b_out), ...]


def pack_result_rows(s, d, fmt: str):
    """Pack one class's top-k rows into the window's D2H result format.

    Rankings are always fixed on device in f32 by top_k before packing;
    the formats only change how many bytes the D2H drain moves.  Shared by
    the BM25 and zero-to-one window composers.

      "f32"     int32[rows, 2, k] — f32 score bits + int32 slots (8 B/res)
      "compact" int16[rows, 3, k] — f16 score bits + slot lo/hi (6 B/res);
                only the REPORTED scores are f16-quantized
      "slots"   int8[rows, 3, k]  — slot bytes only, NO scores (3 B/res);
                the sentinel slot -1 survives as three 0xFF bytes
      "slots20" int8[rows, 2k+ceil(k/2)] — 20-bit nibble-packed slots
                (2.5 B/res), the entropy floor for top-10 of 1M docs;
                requires doc slots < 2^20.  Layout per row: k lo bytes,
                k mid bytes, ceil(k/2) packed hi nibbles (even entry in
                the low nibble).  Sentinel -1 packs to 0xFFFFF.
    """
    with jax.named_scope("pack"):
        if fmt == "compact":
            s16 = jax.lax.bitcast_convert_type(s.astype(jnp.float16), jnp.int16)
            lo = (d & 0xFFFF).astype(jnp.int16)
            hi = ((d >> 16) & 0xFFFF).astype(jnp.int16)
            return jnp.stack([s16, lo, hi], axis=1)
        if fmt == "slots":
            lo = (d & 0xFF).astype(jnp.int8)
            mid = ((d >> 8) & 0xFF).astype(jnp.int8)
            hi = ((d >> 16) & 0xFF).astype(jnp.int8)
            return jnp.stack([lo, mid, hi], axis=1)
        if fmt == "slots20":
            lo = (d & 0xFF).astype(jnp.int8)
            mid = ((d >> 8) & 0xFF).astype(jnp.int8)
            hi = (d >> 16) & 0xF  # sentinel -1 -> 0xF (arithmetic shift)
            if hi.shape[1] % 2:
                hi = jnp.pad(hi, ((0, 0), (0, 1)), constant_values=0xF)
            hp = (hi[:, 0::2] | (hi[:, 1::2] << 4)).astype(jnp.int8)
            return jnp.concatenate([lo, mid, hp], axis=1)
        return jnp.stack([jax.lax.bitcast_convert_type(s, jnp.int32), d], axis=1)


def unpack_result_rows(packed: np.ndarray, fmt: str, k: int):
    """Decode a host copy of packed result rows (pack_result_rows's inverse):
    -> (scores f32[rows, k] | None, slots int32[rows, k]).  Slots formats
    carry no scores (rankings are fixed on device; validity = slots >= 0).
    Shared by the single-chip and sharded drains."""
    if fmt == "compact":
        scores = packed[:, 0, :].view(np.float16).astype(np.float32)
        lo = packed[:, 1, :].view(np.uint16).astype(np.uint32)
        hi = packed[:, 2, :].view(np.uint16).astype(np.uint32)
        slots = (lo | (hi << 16)).view(np.int32)
    elif fmt == "slots":
        lo = packed[:, 0, :].astype(np.int32) & 0xFF
        mid = packed[:, 1, :].astype(np.int32) & 0xFF
        hi = packed[:, 2, :].astype(np.int32)  # sign-extends bit 23
        slots = lo | (mid << 8) | (hi << 16)
        scores = None
    elif fmt == "slots20":
        lo = packed[:, :k].astype(np.int32) & 0xFF
        mid = packed[:, k : 2 * k].astype(np.int32) & 0xFF
        hp = packed[:, 2 * k :].astype(np.int32) & 0xFF
        hi = np.empty((packed.shape[0], 2 * hp.shape[1]), np.int32)
        hi[:, 0::2] = hp & 0xF
        hi[:, 1::2] = hp >> 4
        slots = lo | (mid << 8) | (hi[:, :k] << 16)
        # 0xFFFFF is reserved as the -1 sentinel (the format is gated
        # to num_slots < 2^20, so no live slot can collide with it).
        slots = np.where(slots == 0xFFFFF, -1, slots).astype(np.int32)
        scores = None
    else:
        scores = packed[:, 0, :].view(np.float32)
        slots = packed[:, 1, :]
    return scores, slots


def resolve_result_format(fmt: str, num_slots: int) -> str:
    """Downgrade a requested result format to one that can address every
    doc slot: slots20 needs < 2^20 slots, slots < 2^23; beyond that the
    window falls back to compact (which carries full int32 slots)."""
    if fmt == "slots20" and num_slots >= (1 << 20):
        fmt = "slots"
    if fmt in ("slots", "slots20") and num_slots >= (1 << 23):
        return "compact"
    return fmt


_STEP_CACHE: Dict[Any, Any] = {}

# Placeholder aux array for windows with no range classes (the jitted
# window step takes aux positionally; a fixed tiny shape keeps the compile
# cache key stable).
_AUX_DUMMY = np.zeros((4, 8), dtype=np.int32)


def _scorer_cache_key(scorer):
    key = getattr(scorer, "device_cache_key", None)
    return key() if callable(key) else ("id", id(scorer))


def _get_step(scorer) -> Any:
    """Jitted step per scorer configuration (compile cache)."""
    key = ("single", _scorer_cache_key(scorer))
    fn = _STEP_CACHE.get(key)
    if fn is None:
        from functools import partial

        fn = jax.jit(
            partial(_query_step_impl, scorer),
            static_argnames=(
                "chunk", "k", "qterm_bits", "num_fields", "num_chunks", "use_ranges",
            ),
        )
        _STEP_CACHE[key] = fn
    return fn


def _get_window_step(scorer) -> Any:
    """Jitted whole-window step (one round trip per window)."""
    key = ("window", _scorer_cache_key(scorer))
    fn = _STEP_CACHE.get(key)
    if fn is None:
        from functools import partial

        fn = jax.jit(
            partial(_window_step_impl, scorer),
            static_argnames=(
                "chunk", "k", "qterm_bits", "num_fields", "class_specs", "fmt",
            ),
        )
        _STEP_CACHE[key] = fn
    return fn


def _class_step_impl(
    scorer,
    rec,
    field_avg,
    fields_boost,
    words_flat,
    off,
    aux,
    *,
    chunk: int,
    k: int,
    qterm_bits: int,
    num_fields: int,
    num_chunks: int,
    nj: int,
    b_pad: int,
    use_ranges: bool,
):
    """One shape class sliced out of the window's packed job buffer.

    ``off`` is a TRACED scalar and ``words_flat`` is padded to a BUCKETED
    (power-of-two) length by the caller, so the jit cache key is (class
    statics, bucketed buffer length) — without the bucketing, every new
    window composition would change ``words_flat.shape`` and silently
    retrace/recompile every class program, defeating the mode's stated
    compile economics.  A drifting workload
    therefore compiles O(distinct class shapes x buffer buckets) programs,
    not O(window compositions) — the per-class analogue of
    `_window_step_impl` (IndexConfig.per_class_dispatch)."""
    n = b_pad * nj * 3
    jobs_flat = jax.lax.dynamic_slice(words_flat, (off,), (n,))
    return _query_step_impl(
        scorer,
        chunk=chunk,
        k=k,
        qterm_bits=qterm_bits,
        num_fields=num_fields,
        num_chunks=num_chunks,
        rec=rec,
        field_avg=field_avg,
        fields_boost=fields_boost,
        jobs_flat=jobs_flat.reshape(b_pad, nj * 3),
        aux=aux,
        use_ranges=use_ranges,
    )


def _get_class_step(scorer) -> Any:
    """Jitted per-class step (IndexConfig.per_class_dispatch)."""
    key = ("class", _scorer_cache_key(scorer))
    fn = _STEP_CACHE.get(key)
    if fn is None:
        from functools import partial

        fn = jax.jit(
            partial(_class_step_impl, scorer),
            static_argnames=(
                "chunk", "k", "qterm_bits", "num_fields", "num_chunks",
                "nj", "b_pad", "use_ranges",
            ),
        )
        _STEP_CACHE[key] = fn
    return fn


def _pack_window_impl(ss, ds, *, b_outs, k: int, fmt: str):
    """Pack per-class top-k outputs into one window result buffer.

    The only per-composition program under per_class_dispatch — a trim +
    byte-pack + concat (no gathers, no sorts), so its compile is cheap
    next to a full `_window_step_impl` composition."""
    outs = []
    for s, d, b_out in zip(ss, ds, b_outs):
        s = s[:b_out]
        d = d[:b_out]
        kk = s.shape[1]
        if kk < k:
            s = jnp.pad(s, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
            d = jnp.pad(d, ((0, 0), (0, k - kk)), constant_values=-1)
        outs.append(pack_result_rows(s, d, fmt))
    return jnp.concatenate(outs, axis=0)


_PACK_STEP = jax.jit(_pack_window_impl, static_argnames=("b_outs", "k", "fmt"))


def _bucket(n: int, buckets: Sequence[int], minimum: int) -> int:
    n = max(n, minimum)
    for b in buckets:
        if b >= n:
            return b
    return 1 << (n - 1).bit_length()


def _bucket_vec(n: np.ndarray, buckets: Sequence[int], minimum: int) -> np.ndarray:
    """Vectorized ``_bucket`` (32k per-query python calls showed up in the
    host profile; planning runs on the serving main thread)."""
    n = np.maximum(np.asarray(n, dtype=np.int64), minimum)
    b = np.asarray(buckets, dtype=np.int64)
    idx = np.searchsorted(b, n, side="left")
    out = b[np.minimum(idx, len(b) - 1)]
    big = idx >= len(b)
    if big.any():
        # exact next power of two (log2 of ints is exact at powers of two)
        out[big] = 1 << np.ceil(np.log2(n[big])).astype(np.int64)
    return out


def _segment_arange(counts: np.ndarray) -> np.ndarray:
    """[0..c0), [0..c1), ... concatenated (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    out = np.arange(total, dtype=np.int64)
    out -= np.repeat(ends - counts, counts)
    return out


@dataclass
class PlannedJobs:
    """Flat job table for a batch, sorted by query."""

    jquery: np.ndarray  # int64[NJOBS]
    words: np.ndarray  # int32[NJOBS, 3] — start, len|qterm|range, scale bits
    nchunks: np.ndarray  # int64[B] — total chunks per query
    njobs: np.ndarray  # int64[B]
    has_range: np.ndarray  # bool[B] — query carries a term-range job
    # Term-plan pool row per job (indexes the pooled static bound arrays;
    # block-max pruning, index/prune.py).  None when the plan's pool rows
    # are unknown (pruning then no-ops).
    pool_rows: Optional[np.ndarray] = None
    # Query-plan pool qid per window query + the pool object they index,
    # captured under the plan lock (prune-decision memoization,
    # index/prune.py prune_plan_cached).  None when assembled outside
    # plan_batch (the cached prune then degrades to the direct pass).
    qids: Optional[np.ndarray] = None
    qp: Optional[dict] = None


class DeviceIndex:
    """Device-resident snapshot of an Index at a given version."""

    # Heavy-query result cache capacity (entries); eviction is LRU — see
    # query_batch_async.  Each entry is one top-k row (~1 KB at k=128).
    _HEAVY_CACHE_CAP = 4096

    # Postings per chunk (the gather slice width; up to 127 lanes of a
    # job's first chunk are alignment slack).  Smaller chunks waste fewer
    # lanes on short posting lists; larger chunks cut the alignment-slack
    # ratio and the chunks-per-query count.  Overridable via
    # IndexConfig.chunk_size.
    CHUNK = 1024
    LANES_PER_DISPATCH = 1 << 24  # ~16M lanes -> ~256MB gather per sub-program
    # Above 2048 the pow-2 fallthrough would waste up to half the gather on
    # pad chunks; expansion-heavy (range-job) classes are usually singleton
    # queries near the lane budget, so intermediate buckets pay for
    # themselves despite the extra compile variants.
    NC_BUCKETS = (
        4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048,
        3072, 4096, 6144, 8192, 12288, 16384,
    )
    # Fine buckets (IndexConfig.fine_nc_buckets, default on): non-pow2 lane
    # classes, so the dominant bench class (3 single-chunk terms) gathers
    # and sorts NC=3 chunks instead of a pow2 pad to NC=4.
    NC_BUCKETS_FINE = (
        2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128, 256, 512, 1024, 2048,
        3072, 4096, 6144, 8192, 12288, 16384,
    )
    NJ_BUCKETS = (4, 8, 16, 32, 64, 128, 256)

    def __init__(self, index) -> None:
        index._flush_pending()
        self.version = index.version
        self._index = index
        self.config = index.config
        self.CHUNK = int(getattr(index.config, "chunk_size", 0) or type(self).CHUNK)
        if getattr(index.config, "fine_nc_buckets", True):
            self.nc_buckets = type(self).NC_BUCKETS_FINE
            self.nc_min = 2
        else:
            self.nc_buckets = type(self).NC_BUCKETS
            self.nc_min = 4
        F = index.num_fields
        self.num_fields = F
        self.segments = list(index._segments)
        C = self.CHUNK

        # --- host-side planning structures -------------------------------
        self.seg_terms: List[np.ndarray] = []
        self.seg_term_lens: List[np.ndarray] = []
        self.seg_offsets: List[np.ndarray] = []
        self.seg_base: List[int] = []
        self.seg_live_cum: List[np.ndarray] = []  # cumulative live-occurrence
        # counts over each segment's postings — df for any posting range is
        # two lookups (df is static per snapshot; the device never sees it)
        from .segment import escape_terms_fixed

        base = 0
        doc_parts, tf_parts = [], []
        alive0 = index._alive
        for seg in self.segments:
            # Escaped <U tables: trailing-NUL terms must not alias under
            # the fixed-width conversion (segment.escape_terms_fixed).
            self.seg_terms.append(escape_terms_fixed(seg.terms))
            self.seg_term_lens.append(seg.term_lens)
            self.seg_offsets.append(seg.offsets)
            self.seg_base.append(base)
            occ_live = np.where(alive0[seg.post_doc], seg.post_occ, 0).astype(np.int64)
            cum = np.zeros(seg.num_postings + 1, dtype=np.int64)
            np.cumsum(occ_live, out=cum[1:])
            self.seg_live_cum.append(cum)
            doc_parts.append(seg.post_doc)
            tf_parts.append(seg.post_tf)
            base += seg.num_postings
        self.num_postings = base

        # --- posting record array ----------------------------------------
        S = index._next_slot
        self.num_slots = S
        self._qterm_bits = _QT_BITS
        # Capacity checks BEFORE the expensive array build, so callers can
        # catch cheaply and degrade (e.g. Index.query_batch host fallback).
        if S >= (1 << (31 - self._qterm_bits)):
            raise ValueError(
                f"doc slots ({S}) exceed the packed int32 merge-key capacity; "
                f"shard the index over more devices (parallel/)"
            )
        P = self.num_postings
        # TRANSPOSED layout [R, P + C]: chunk gathers become [R, C] slices
        # with the chunk dimension minor, so each record row of a chunk is
        # one contiguous C-wide read.  R pads to 4 when it fits, else to a
        # multiple of 8; 1 + 2F is odd, so the liveness row 1 + 2F always
        # fits inside the pad.
        R = 4 if (2 + 2 * F) <= 4 else -(-(2 + 2 * F) // 8) * 8
        rec = np.zeros((R, P + C), dtype=np.int32)
        rec[0] = -1  # slack tail: never in any job's payload range
        # Snapshot copies for block-max pruning bounds (index/prune.py):
        # bounds are built LAZILY per scorer, and index._doc_len/_alive
        # mutate (vacuum compacts them) — a stale DeviceIndex handle must
        # read its own snapshot, like rec does.
        self._post_doc_all = self._post_tf_all = None
        self._doc_len_snap = self._alive_snap = None
        self._field_avg_host = np.array(
            [fd.avg for fd in index._fields], dtype=np.float64
        )
        if P:
            post_doc = np.concatenate(doc_parts)
            post_tf = np.concatenate(tf_parts)
            alive = index._alive[:S]
            doc_len = index._doc_len[:S].astype(np.float32)
            rec[0, :P] = post_doc  # true slot even when dead: keeps runs sorted
            rec[1 : 1 + F, :P] = post_tf.T
            rec[1 + F : 1 + 2 * F, :P] = doc_len[post_doc].view(np.int32).T
            rec[1 + 2 * F, :P] = alive[post_doc]
            if getattr(index.config, "prune_blocks", True):
                self._post_doc_all = post_doc
                self._post_tf_all = post_tf
                self._alive_snap = alive.copy()
                self._doc_len_snap = index._doc_len[:S].copy()
        self.rec = jnp.asarray(rec)
        self.field_avg = jnp.asarray(
            np.array([fd.avg for fd in index._fields], dtype=np.float32)
        )
        self.n_docs = float(len(index._docs))
        self.slot_to_key = list(index._slot_to_key)
        self._key_arr: Optional[np.ndarray] = None
        # Per-(scorer key) pooled term-plan cache (see _term_plans).  The
        # lock serializes pool growth: concurrent query_batch_async callers
        # must not observe a pool whose parallel arrays are mid-update.
        self._plan_pools: Dict[Any, Dict[str, Any]] = {}
        # Per-(scorer key, tokenizer) pooled QUERY-plan cache: the fully
        # assembled job rows per query string (see plan_batch).  Planning a
        # repeated query becomes one dict lookup + CSR gather instead of a
        # tokenize + probe + gather pass on the serving main thread.
        self._qplan_pools: Dict[Any, Dict[str, Any]] = {}
        # Per-tokenizer pooled z2o query-plan cache (ops/z2o_device.py
        # plan_batch_z2o) — same shape as _qplan_pools, same lock.
        self._z2o_qplans: Dict[Any, Dict[str, Any]] = {}
        self._plan_lock = threading.RLock()
        # Aux record array (per-posting static scoring metadata for
        # term-range jobs), built lazily per scorer on the first
        # expansion-heavy query (_aux_rec).
        self._aux_cache: Dict[Any, Any] = {}
        # Heavy-query result cache: (scorer key, job-table bytes, boosts)
        # -> (scores f32[Kc] | None, slots int32[Kc]).  Snapshot-static by
        # construction (this object is rebuilt on any index mutation); the
        # job table is the query's entire device-program input, so equal
        # tables imply equal results (IndexConfig.heavy_cache_min_chunks).
        self._heavy_cache: Dict[Any, Any] = {}
        # Frozen window-composition templates (IndexConfig.
        # template_compositions): (scorer key, k, fmt, window size) ->
        # ordered [(nc, nj, row_capacity), ...].  See
        # _pack_dispatches_template.
        self._comp_templates: Dict[Any, list] = {}

    def _aux_rec(self, scorer):
        """Aux record array int32[4, P + C] for term-range jobs:

          aux[0]  f32 bits — the scorer's per-term STATIC scale part
                  (device_term_static over the term's GLOBAL live df;
                  for BM25 the df-clamped idf, bm25.rs:41-56)
          aux[1]  term utf-8 byte length (expansion boost input)
          aux[2:] row pad

        Snapshot-static per scorer configuration; built lazily because
        only expansion-heavy queries need it.
        """
        key = _scorer_cache_key(scorer)
        cached = self._aux_cache.get(key)
        if cached is not None:
            return cached
        P = self.num_postings
        C = self.CHUNK
        aux = np.zeros((4, P + C), dtype=np.int32)
        if P:
            # Global df per term string: segments may repeat a term; its df
            # (live posting-pointer count, index.rs:282-297) sums across
            # them — matching the df grouping of per-expansion planning.
            gterms = np.unique(np.concatenate(self.seg_terms))
            gdf = np.zeros(len(gterms), dtype=np.float64)
            for si, terms in enumerate(self.seg_terms):
                if len(terms) == 0:
                    continue
                gid = np.searchsorted(gterms, terms)
                offs = self.seg_offsets[si]
                cum = self.seg_live_cum[si]
                gdf[gid] += cum[offs[1:]] - cum[offs[:-1]]
            static = np.asarray(
                scorer.device_term_static(gdf, self.n_docs), dtype=np.float32
            )
            pos = 0
            for si, terms in enumerate(self.seg_terms):
                if len(terms) == 0:
                    continue
                reps = np.diff(self.seg_offsets[si]).astype(np.int64)
                n = int(reps.sum())
                gid = np.searchsorted(gterms, terms)
                aux[0, pos : pos + n] = np.repeat(static[gid], reps).view(np.int32)
                aux[1, pos : pos + n] = np.repeat(
                    np.asarray(self.seg_term_lens[si], np.int32), reps
                )
                pos += n
        arr = jnp.asarray(aux)
        self._aux_cache[key] = arr
        return arr


    # ------------------------------------------------------------------ #
    # planning (host, vectorized)                                         #
    # ------------------------------------------------------------------ #

    def _term_plans(self, uniq_terms: Sequence[str], scorer) -> None:
        """Compute + cache the per-term job plan for every term in
        ``uniq_terms`` not already cached.

        A term's plan is snapshot-static AND query-independent: the prefix
        expansion ranges per segment, the per-expansion df (grouped across
        segments; df == 0 expansions dropped, query.rs:48), the expansion
        boost (bm25.rs:44-55), and the premultiplied per-job scale (the
        vectorized before_each).  Everything lands in pooled flat arrays
        indexed by a per-term CSR, so batch assembly is pure gathers.
        """
        pool = self._plan_pools.get(_scorer_cache_key(scorer))
        if pool is None:
            pool = {
                "ids": {},  # term -> dense id
                "sorted_terms": np.zeros(0, dtype=np.str_),  # probe arrays
                "sorted_ids": np.zeros(0, dtype=np.int64),  # (see plan_batch)
                "off": np.zeros(1, dtype=np.int64),
                "start": np.zeros(0, dtype=np.int64),
                "len": np.zeros(0, dtype=np.int64),
                "scale": np.zeros(0, dtype=np.float32),
                "chunks": np.zeros(0, dtype=np.int64),  # per term
                "over_cap": np.zeros(0, dtype=bool),  # per term
                "range": np.zeros(0, dtype=bool),  # per job: term-range job
            }
            # Block-max pruning bounds ride along per job (index/prune.py).
            # The decision is frozen at pool creation so every pool row has
            # a bounds row (a mid-life config flip must not misalign them).
            if (
                getattr(self.config, "prune_blocks", True)
                and hasattr(scorer, "device_impact")
                and self._post_tf_all is not None
                and np.isfinite(self._field_avg_host).all()
            ):
                k_cap = int(getattr(self.config, "prune_max_top_k", 16))
                pool["prune_enabled"] = True
                pool["prune_ub"] = np.zeros((0, self.num_fields), np.float32)
                pool["prune_topv"] = np.zeros(
                    (0, self.num_fields, k_cap), np.float32
                )
                pool["prune_cub_off"] = np.zeros(0, np.int64)  # start per job
                pool["prune_cub"] = np.zeros((0, self.num_fields), np.float32)
                pool["prune_cub_min"] = np.zeros(
                    (0, self.num_fields), np.float32
                )
            self._plan_pools[_scorer_cache_key(scorer)] = pool
        ids = pool["ids"]
        miss = [t for t in uniq_terms if t not in ids]
        if not miss:
            return
        cfg = self.config
        from .segment import probe_terms_fixed

        # Escaped probes paired with the escaped seg_terms tables; byte
        # lengths are of the raw terms (probe_terms_fixed).
        flat_terms, flat_blen = probe_terms_fixed(miss)
        M = len(flat_terms)
        flat_upper = np.char.add(flat_terms, _MAX_CHAR)

        # Prefix ranges per segment, and TERM-RANGE eligibility: a term
        # expanding past range_min_expansions gets ONE job per segment
        # covering its whole contiguous CSR range (per-posting idf /
        # term-length read from the aux array on device) instead of one
        # padded chunk per tiny expansion.
        cfgthr = cfg.range_min_expansions
        supports_ranges = (
            cfgthr > 0
            and hasattr(scorer, "device_term_static")
            and hasattr(scorer, "device_range_boost")
        )
        seg_ranges: List[Any] = []
        nexp_total = np.zeros(M, dtype=np.int64)
        for si in range(len(self.segments)):
            terms = self.seg_terms[si]
            if len(terms) == 0:
                seg_ranges.append(None)
                continue
            lo = np.searchsorted(terms, flat_terms, side="left")
            hi = np.searchsorted(terms, flat_upper, side="left")
            seg_ranges.append((lo, hi))
            nexp_total += hi - lo
        eligible = (
            nexp_total >= cfgthr if supports_ranges else np.zeros(M, dtype=bool)
        )

        # Per segment: prefix ranges -> candidate jobs.  Each job carries
        # its live df (two lookups in the segment's live-occurrence cumsum;
        # the device analogue of count_documents, index.rs:282-297).
        job_parts = []
        for si in range(len(self.segments)):
            terms = self.seg_terms[si]
            if seg_ranges[si] is None:
                continue
            lo, hi = seg_ranges[si]
            nexp = np.where(eligible, 0, hi - lo)
            if nexp.max(initial=0) == 0:
                continue
            tid = np.repeat(lo, nexp) + _segment_arange(nexp)
            jidx = np.repeat(np.arange(M, dtype=np.int64), nexp)
            offs = self.seg_offsets[si]
            local = offs[tid].astype(np.int64)
            length = (offs[tid + 1] - offs[tid]).astype(np.int64)
            cum = self.seg_live_cum[si]
            ldf = cum[local + length] - cum[local]
            job_parts.append(
                (
                    jidx,
                    self.seg_base[si] + local,
                    length,
                    terms[tid],
                    self.seg_term_lens[si][tid].astype(np.int64),
                    ldf,
                )
            )
        if job_parts:
            jidx = np.concatenate([p[0] for p in job_parts])
            jstart = np.concatenate([p[1] for p in job_parts])
            jlen = np.concatenate([p[2] for p in job_parts])
            jexp = np.concatenate([p[3] for p in job_parts])
            jblen = np.concatenate([p[4] for p in job_parts])
            jldf = np.concatenate([p[5] for p in job_parts])
            keep = jlen > 0
            jidx, jstart, jlen, jexp, jblen, jldf = (
                jidx[keep], jstart[keep], jlen[keep], jexp[keep], jblen[keep],
                jldf[keep],
            )
        else:
            jidx = np.zeros(0, dtype=np.int64)

        if len(jidx):
            # df groups: jobs of the same (term, expanded term) across
            # segments share one df (per-group df = sum of segment dfs).
            order = np.lexsort((jexp, jidx))
            jidx, jstart, jlen, jexp, jblen, jldf = (
                jidx[order], jstart[order], jlen[order], jexp[order],
                jblen[order], jldf[order],
            )
            new_group = np.ones(len(jidx), dtype=bool)
            new_group[1:] = (jidx[1:] != jidx[:-1]) | (jexp[1:] != jexp[:-1])
            group_global = np.cumsum(new_group) - 1
            group_df = np.bincount(group_global, weights=jldf.astype(np.float64))
            jdf = group_df[group_global]

            # df == 0 expansions are never scored: drop their jobs.
            keep_df = jdf > 0
            jidx, jstart, jlen, jexp, jblen, jdf, new_group = (
                jidx[keep_df], jstart[keep_df], jlen[keep_df], jexp[keep_df],
                jblen[keep_df], jdf[keep_df], new_group[keep_df],
            )

        if len(jidx):
            per_term_groups = np.bincount(jidx[new_group], minlength=M)
            over_cap = (
                per_term_groups > cfg.max_expansions
                if cfg.max_expansions
                else np.zeros(M, dtype=bool)
            )

            # Expansion boost (bm25.rs:44-55; byte lengths), f64 until the
            # single rounding into the packed f32 scale word.
            exact = jexp == flat_terms[jidx]
            boost = np.where(
                exact, 1.0, np.log1p(1.0 / (1.0 + jblen - flat_blen[jidx]))
            )
            scale = scorer.device_term_scale(jdf, self.n_docs, boost)
        else:
            over_cap = np.zeros(M, dtype=bool)
            jstart = np.zeros(0, dtype=np.int64)
            jlen = np.zeros(0, dtype=np.int64)
            scale = np.zeros(0, dtype=np.float32)
        jrange = np.zeros(len(jidx), dtype=bool)

        # Term-range jobs for eligible terms: one per (term, segment) over
        # the whole expansion range (postings of tids [lo, hi) are
        # CONTIGUOUS in the CSR).  The scale word carries the query term's
        # byte length instead — the device assembles the per-lane scale
        # from the aux rows (idf x device_range_boost).
        if eligible.any():
            r_idx, r_start, r_len, r_qb = [], [], [], []
            for si, rng_ in enumerate(seg_ranges):
                if rng_ is None:
                    continue
                lo, hi = rng_
                offs = self.seg_offsets[si]
                for i in np.flatnonzero(eligible & (hi > lo)):
                    s, e = int(offs[lo[i]]), int(offs[hi[i]])
                    if e > s:
                        r_idx.append(i)
                        r_start.append(self.seg_base[si] + s)
                        r_len.append(e - s)
                        r_qb.append(int(flat_blen[i]))
            if r_idx:
                jidx = np.concatenate([jidx, np.asarray(r_idx, np.int64)])
                jstart = np.concatenate([jstart, np.asarray(r_start, np.int64)])
                jlen = np.concatenate([jlen, np.asarray(r_len, np.int64)])
                scale = np.concatenate(
                    [scale, np.asarray(r_qb, np.int32).view(np.float32)]
                )
                jrange = np.concatenate([jrange, np.ones(len(r_idx), bool)])

        if len(jidx):
            # Split jobs longer than the packed-length capacity (the split
            # parts share the job's scale, so scores are unchanged).
            if jlen.max(initial=0) > _MAX_JOB_LEN:
                nsplit = (jlen + _MAX_JOB_LEN - 1) // _MAX_JOB_LEN
                si_ = _segment_arange(nsplit)
                sj = np.repeat(np.arange(len(jidx), dtype=np.int64), nsplit)
                jstart = jstart[sj] + si_ * _MAX_JOB_LEN
                jlen = np.minimum(jlen[sj] - si_ * _MAX_JOB_LEN, _MAX_JOB_LEN)
                jidx = jidx[sj]
                scale = scale[sj]
                jrange = jrange[sj]
            # Over-cap terms contribute no pooled jobs (their queries fall
            # back to the host path).
            if over_cap.any():
                keep3 = ~over_cap[jidx]
                jidx, jstart, jlen, scale, jrange = (
                    jidx[keep3], jstart[keep3], jlen[keep3], scale[keep3],
                    jrange[keep3],
                )
            order2 = np.argsort(jidx, kind="stable")
            jidx, jstart, jlen, scale, jrange = (
                jidx[order2], jstart[order2], jlen[order2], scale[order2],
                jrange[order2],
            )
            nj_per_term = np.bincount(jidx, minlength=M)
        else:
            nj_per_term = np.zeros(M, dtype=np.int64)

        # Chunks per job under the stride-C contiguous scheme: one aligned
        # base per job, skip < 128 on the first chunk only (must match
        # _query_step_impl's on-device expansion exactly — class bucketing
        # and output-row layout depend on it).
        C_ = self.CHUNK
        job_chunks = np.where(jlen > 0, (jstart % 128 + jlen + C_ - 1) // C_, 0)
        term_chunks = np.bincount(
            jidx, weights=job_chunks.astype(np.float64), minlength=M
        ).astype(np.int64) if len(jidx) else np.zeros(M, dtype=np.int64)

        if pool.get("prune_enabled"):
            from .prune import build_job_bounds

            b = build_job_bounds(
                self,
                scorer,
                np.asarray(jstart, np.int64),
                np.asarray(jlen, np.int64),
                np.asarray(jrange, bool),
                C_,
                int(getattr(cfg, "prune_max_top_k", 16)),
                float(getattr(cfg, "prune_margin", 1e-4)),
            )
            assert b is not None  # gating matched at pool creation
            pool["prune_ub"] = np.concatenate([pool["prune_ub"], b["ub"]])
            pool["prune_topv"] = np.concatenate([pool["prune_topv"], b["topv"]])
            pool["prune_cub_off"] = np.concatenate(
                [
                    pool["prune_cub_off"],
                    b["cub_off"][:-1] + len(pool["prune_cub"]),
                ]
            )
            pool["prune_cub"] = np.concatenate([pool["prune_cub"], b["cub"]])
            pool["prune_cub_min"] = np.concatenate(
                [pool["prune_cub_min"], b["cub_min"]]
            )

        base = len(pool["off"]) - 1
        for i, t in enumerate(miss):
            ids[str(t)] = base + i
        pool["off"] = np.concatenate(
            [pool["off"], pool["off"][-1] + np.cumsum(nj_per_term)]
        )
        pool["start"] = np.concatenate([pool["start"], jstart])
        pool["len"] = np.concatenate([pool["len"], jlen])
        pool["scale"] = np.concatenate([pool["scale"], scale])
        pool["chunks"] = np.concatenate([pool["chunks"], term_chunks])
        pool["over_cap"] = np.concatenate([pool["over_cap"], over_cap])
        pool["range"] = np.concatenate([pool["range"], jrange])
        # Rebuild the sorted probe arrays (miss-time only; steady-state
        # planning never takes this path).  Probe arrays are escaped so
        # trailing-NUL terms keep distinct identities (ids stay raw-keyed).
        from .segment import escape_terms_fixed as _etf

        keys_raw = list(ids.keys())
        esc = _etf(keys_raw)
        order = np.argsort(esc)
        pool["sorted_terms"] = esc[order]
        vals = np.fromiter((ids[k] for k in keys_raw), dtype=np.int64, count=len(keys_raw))
        pool["sorted_ids"] = vals[order]

    # Query-plan pool caps: beyond these the pool is dropped and restarts
    # (bounds memory under adversarial all-distinct traffic; steady-state
    # serving traffic is power-law repeated, so the pool stays warm).
    _QPLAN_MAX_QUERIES = 1 << 20
    _QPLAN_MAX_ROWS = 8 << 20

    def plan_batch(self, queries: Sequence[str], tokenizer, scorer):
        """Plan a batch into a flat job table (thread-safe).

        Per-term plans (expansion ranges, df, scale) are snapshot-static
        and cached (`_term_plans`); so is the assembled per-QUERY job plan
        (this method's own pool): a repeated query string costs one dict
        lookup plus a vectorized CSR gather — tokenize / probe / per-term
        gather run only for first-seen queries.  Returns
        ``(PlannedJobs | None, fallback)`` where ``fallback`` lists queries
        exceeding a device cap (too many terms / expansions); those degrade
        to the exact host path per query — the host path has no caps,
        matching the reference.
        """
        with self._plan_lock:
            qp = self._qplan_pool(scorer, tokenizer)
            ids = qp["ids"]
            B = len(queries)
            qids = np.fromiter(
                (ids.get(q, -1) for q in queries), np.int64, count=B
            )
            if (qids < 0).any():
                miss = sorted({queries[i] for i in np.flatnonzero(qids < 0)})
                self._qplan_insert(qp, miss, tokenizer, scorer)
                qids = np.fromiter(
                    (ids[q] for q in queries), np.int64, count=B
                )
            # Assemble the batch from the pool (pure gathers).
            fb_mask = qp["fallback"][qids]
            fallback = [int(i) for i in np.flatnonzero(fb_mask)]
            nj = qp["njobs"][qids]
            total = int(nj.sum())
            if total == 0:
                return None, fallback
            jquery = np.repeat(np.arange(B, dtype=np.int64), nj)
            rows = np.repeat(qp["off"][qids], nj) + _segment_arange(nj)
            prows = qp["pool_rows"][rows]
            return PlannedJobs(
                jquery=jquery,
                words=qp["words"][rows],
                nchunks=qp["nchunks"][qids],
                njobs=nj,
                has_range=qp["has_range"][qids],
                pool_rows=None if (prows < 0).any() else prows,
                qids=qids,
                qp=qp,
            ), fallback

    def _qplan_pool(self, scorer, tokenizer):
        key = (_scorer_cache_key(scorer), tokenizer)
        qp = self._qplan_pools.get(key)
        if qp is None or (
            len(qp["ids"]) > self._QPLAN_MAX_QUERIES
            or len(qp["words"]) > self._QPLAN_MAX_ROWS
        ):
            qp = {
                "ids": {},  # query string -> dense qid
                "off": np.zeros(1, dtype=np.int64),
                "words": np.zeros((0, 3), dtype=np.int32),
                "nchunks": np.zeros(0, dtype=np.int64),
                "njobs": np.zeros(0, dtype=np.int64),
                "has_range": np.zeros(0, dtype=bool),
                "fallback": np.zeros(0, dtype=bool),
                # Term-pool row per pooled job (block-max pruning bounds
                # alignment, index/prune.py); -1 when unknown.
                "pool_rows": np.zeros(0, dtype=np.int64),
            }
            self._qplan_pools[key] = qp
        return qp

    def _qplan_insert(self, qp, miss: List[str], tokenizer, scorer) -> None:
        """Plan first-seen queries through the full path and pool the
        resulting per-query job rows (job rows of query i are contiguous:
        ``jquery`` is grouped ascending by construction)."""
        plan, fb = self._plan_batch_impl(miss, tokenizer, scorer)
        M = len(miss)
        fb_m = np.zeros(M, dtype=bool)
        fb_m[list(fb)] = True
        if plan is None:
            nj_m = np.zeros(M, dtype=np.int64)
            words_m = np.zeros((0, 3), dtype=np.int32)
            nch_m = np.zeros(M, dtype=np.int64)
            rng_m = np.zeros(M, dtype=bool)
            prows_m = np.zeros(0, dtype=np.int64)
        else:
            nj_m = plan.njobs
            words_m = plan.words
            nch_m = plan.nchunks
            rng_m = plan.has_range
            prows_m = (
                plan.pool_rows
                if plan.pool_rows is not None
                else np.full(len(words_m), -1, dtype=np.int64)
            )
        base = len(qp["off"]) - 1
        for i, q in enumerate(miss):
            qp["ids"][q] = base + i
        qp["off"] = np.concatenate(
            [qp["off"], qp["off"][-1] + np.cumsum(nj_m)]
        )
        qp["words"] = np.concatenate([qp["words"], words_m])
        qp["nchunks"] = np.concatenate([qp["nchunks"], nch_m])
        qp["njobs"] = np.concatenate([qp["njobs"], nj_m])
        qp["has_range"] = np.concatenate([qp["has_range"], rng_m])
        qp["fallback"] = np.concatenate([qp["fallback"], fb_m])
        qp["pool_rows"] = np.concatenate([qp["pool_rows"], prows_m])

    def _plan_batch_impl(self, queries: Sequence[str], tokenizer, scorer):
        B = len(queries)
        fallback: List[int] = []

        tok_lists = [[t for t in tokenizer(q) if t] for q in queries]
        max_terms = min(self.config.max_query_terms, 1 << self._qterm_bits)
        for qi, toks in enumerate(tok_lists):
            if len(toks) > max_terms:
                fallback.append(qi)
                tok_lists[qi] = []
        counts = np.array([len(t) for t in tok_lists], dtype=np.int64)
        total_terms = int(counts.sum())
        if total_terms == 0 or self.num_postings == 0:
            return None, fallback
        flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
        flat_qterm = _segment_arange(counts).astype(np.int64)
        flat_terms = [t for toks in tok_lists for t in toks]

        def lookup(pool, flat_arr):
            # Sorted-array probe instead of per-term python dict gets (49k
            # dict lookups per 16k-query window showed up in the host
            # profile; this is two vectorized searchsorted+compare passes).
            st = pool["sorted_terms"] if pool is not None else None
            if st is None or len(st) == 0:
                return np.full(len(flat_arr), -1, np.int64)
            p = np.minimum(np.searchsorted(st, flat_arr), len(st) - 1)
            return np.where(st[p] == flat_arr, pool["sorted_ids"][p], -1)

        from .segment import escape_terms_fixed as _etf

        pool = self._plan_pools.get(_scorer_cache_key(scorer))
        flat_arr = _etf(flat_terms)  # matches the escaped pool probe arrays
        tids = lookup(pool, flat_arr)
        if (tids < 0).any():  # cache misses: compute those term plans once
            miss = sorted({t for t, i in zip(flat_terms, tids) if i < 0})
            self._term_plans(miss, scorer)
            pool = self._plan_pools[_scorer_cache_key(scorer)]
            tids = lookup(pool, flat_arr)

        # Queries containing an over-cap term degrade to the host path.
        over = pool["over_cap"][tids]
        if over.any():
            bad = np.unique(flat_query[over])
            fallback.extend(int(q) for q in bad)
            keep = ~np.isin(flat_query, bad)
            flat_query, flat_qterm, tids = flat_query[keep], flat_qterm[keep], tids[keep]
            if len(tids) == 0:
                return None, fallback

        # Assemble the flat job table: CSR gather from the pooled plans.
        off = pool["off"]
        nj = off[tids + 1] - off[tids]
        rows = np.repeat(off[tids], nj) + _segment_arange(nj)
        if len(rows) == 0:
            return None, fallback
        jquery = np.repeat(flat_query, nj)
        jqterm = np.repeat(flat_qterm, nj)
        jrange = pool["range"][rows]
        words = np.empty((len(rows), 3), dtype=np.int32)
        words[:, 0] = pool["start"][rows]
        words[:, 1] = pool["len"][rows] | (jqterm << _LEN_BITS) | (jrange << 30)
        words[:, 2] = pool["scale"][rows].view(np.int32)
        has_range = (
            np.bincount(jquery, weights=jrange.astype(np.float64), minlength=B) > 0
        )

        nchunks = np.bincount(
            flat_query, weights=pool["chunks"][tids].astype(np.float64), minlength=B
        ).astype(np.int64)
        njobs = np.bincount(jquery, minlength=B)

        # Lane-budget guard: a query whose chunk total exceeds one
        # dispatch's lane budget cannot tile onto the device; it degrades
        # to the scorer's vectorized host path (milliseconds, bm25.py) —
        # the expansion TILING itself is uncapped (max_expansions=0).
        over_lanes = np.flatnonzero(nchunks > self.LANES_PER_DISPATCH // self.CHUNK)
        if len(over_lanes):
            fallback.extend(int(q) for q in over_lanes)
            keep = ~np.isin(jquery, over_lanes)
            jquery, words, rows = jquery[keep], words[keep], rows[keep]
            nchunks[over_lanes] = 0
            njobs = np.bincount(jquery, minlength=B)
            if len(jquery) == 0:
                return None, fallback
        return PlannedJobs(
            jquery=jquery,
            words=words,
            nchunks=nchunks,
            njobs=njobs.astype(np.int64),
            has_range=has_range,
            pool_rows=rows,
        ), fallback

    # ------------------------------------------------------------------ #
    # template manifest (pre-warm across processes)                       #
    # ------------------------------------------------------------------ #

    def save_templates(self, path: str) -> int:
        """Write the frozen composition templates to a JSON manifest.

        Together with the persistent compile cache this gives a cold
        process a zero-traffic warmup: `load_templates` + `prewarm`
        compiles (or cache-loads) the exact window programs the previous
        process served, before the first query arrives.  Returns the
        number of templates written.

        Cross-process prewarm needs a STABLE scorer key: templates whose
        scorer lacks ``device_cache_key`` are keyed ``('id', id(scorer))``
        — meaningless in another process — so they are skipped here with a
        warning (they would never match at ``prewarm`` time and a silent
        0-program warm is worse than a loud skip).
        """
        import json
        import warnings

        kept = {
            k: v
            for k, v in self._comp_templates.items()
            if not (isinstance(k[0], tuple) and k[0] and k[0][0] == "id")
        }
        if len(kept) < len(self._comp_templates):
            warnings.warn(
                "save_templates: skipped "
                f"{len(self._comp_templates) - len(kept)} template(s) whose "
                "scorer has no device_cache_key (process-local ('id', ...) "
                "keys cannot prewarm another process)",
                stacklevel=2,
            )
        with open(path, "w") as f:
            json.dump(
                {repr(k): [list(map(int, e)) for e in v]
                 for k, v in kept.items()},
                f,
            )
        return len(kept)

    def load_templates(self, path: str) -> int:
        """Load a template manifest written by `save_templates`."""
        import ast
        import json

        with open(path) as f:
            raw = json.load(f)
        for ks, entries in raw.items():
            self._comp_templates[ast.literal_eval(ks)] = [
                tuple(e) for e in entries
            ]
        return len(raw)

    def prewarm(self, scorer, fields_boost=None) -> int:
        """Compile (or load from the persistent compile cache) the window
        program of every frozen template matching ``scorer``, using dummy
        all-zero job tables — program identity depends only on the static
        class_specs, so the compiled artifact is exactly what live traffic
        will hit.  Returns the number of programs warmed."""
        skey = _scorer_cache_key(scorer)
        boost = jnp.asarray(
            np.asarray(
                fields_boost
                if fields_boost is not None
                else [1.0] * self.num_fields,
                dtype=np.float32,
            )
        )
        step = _get_window_step(scorer)
        n = 0
        for tkey, entries in list(self._comp_templates.items()):
            if tkey[0] != skey:
                continue
            _, k, fmt, _w = tkey
            # Entries are (nc, nj, cap[, cw]) — legacy 3-tuple manifests
            # predate light classes and imply the global chunk width.
            class_specs = tuple(
                (e[2], e[2], e[1], e[0], False,
                 e[3] if len(e) > 3 else self.CHUNK)
                for e in entries
            )
            total = sum(e[2] * e[1] * 3 for e in entries)
            packed = step(
                self.rec,
                self.field_avg,
                boost,
                jnp.zeros(total, jnp.int32),
                jnp.asarray(_AUX_DUMMY),
                chunk=self.CHUNK,
                k=k,
                qterm_bits=self._qterm_bits,
                num_fields=self.num_fields,
                class_specs=class_specs,
                fmt=fmt,
            )
            packed.block_until_ready()  # compile + execute now
            n += 1
        return n

    @staticmethod
    def _pow2_spans(n: int, cap: int, min_pad: int = 8, min_take: int = 512):
        """Split ``n`` class rows into (take, padded_rows) spans.

        Greedy largest-power-of-two slices (bounded by the class's lane-cap
        ``cap``) while at least ``min_take`` rows remain, then one padded
        tail — 2048+512+pad(78->128) instead of one pow2 pad to 4096.
        Every span's padded_rows is a power of two from the same ladder the
        single-slice packing produces, so no new program shapes appear;
        device compute drops by the pad rows saved.
        """
        cap2 = 1 << (max(cap, 1).bit_length() - 1)  # largest pow2 <= cap
        spans = []
        rem = n
        while rem > 0:
            big = min(1 << (rem.bit_length() - 1), cap2)
            if big >= min_take and big < rem:
                spans.append((big, big))
                rem -= big
            else:
                take = min(rem, cap2)
                spans.append((take, max(min_pad, 1 << (take - 1).bit_length())))
                rem -= take
        return spans

    def pack_dispatches(self, n_queries: int, plan: PlannedJobs):
        """Bucket queries into shape classes and pack dispatch job tables.

        Returns a list of (query_indices, jobs_flat int32[B*NJ*3], NC, NJ,
        use_ranges, chunk_width).  Each dispatch is capped at
        LANES_PER_DISPATCH lanes.
        Queries carrying a term-range job form separate classes (they need
        the aux gather and the full-sort merge — see _query_step_impl).
        """
        C = self.CHUNK
        nc_bucket = _bucket_vec(plan.nchunks, self.nc_buckets, self.nc_min)
        small, nc_small = self._light_classes(n_queries, plan, nc_bucket)
        # One pass: per-query class id + position within class (queries are
        # index-sorted within each class), then every job places itself by
        # direct lookup — no per-class isin/searchsorted.  The class id
        # encodes the range flag in bit 0 and the light-width flag in
        # bit 1 (light classes decompose at light_chunk_size on device).
        alive = plan.njobs > 0
        class_of_q = np.where(
            alive,
            np.where(small, nc_small, nc_bucket) * 4
            + small.astype(np.int64) * 2
            + plan.has_range.astype(np.int64),
            -1,
        )
        order = np.argsort(class_of_q, kind="stable")
        sorted_cls = class_of_q[order]
        jpos = np.zeros(n_queries, dtype=np.int64)
        np.subtract(np.cumsum(plan.njobs), plan.njobs, out=jpos)  # job row start per query

        out = []
        for cls in np.unique(class_of_q[alive]) if alive.any() else []:
            cls = int(cls)
            nc, rng = cls // 4, bool(cls & 1)
            cw = self._light_width() if cls & 2 else C
            members = order[sorted_cls == cls]
            nj = _bucket(int(plan.njobs[members].max()), self.NJ_BUCKETS, 4)
            b_cap = max(1, int(self.LANES_PER_DISPATCH // (nc * cw)))
            # Expansion-heavy classes (huge nc, usually singleton queries)
            # drop the 8-row minimum pad: an 8x pad would multiply a
            # near-budget gather into OOM.  ALL range classes pad to their
            # real query count, at most 2 rows per program: range queries
            # are rare, and each row is a wide full-sort program.
            min_pad = 1 if (rng or nc * cw > (1 << 21)) else 8
            if rng:
                b_cap = min(b_cap, 2)
            if rng or not getattr(self.config, "pow2_row_split", True):
                spans = [
                    (m, max(min_pad, 1 << (m - 1).bit_length()))
                    for m in (
                        len(members[s : s + b_cap])
                        for s in range(0, len(members), b_cap)
                    )
                ]
            else:
                spans = self._pow2_spans(len(members), b_cap, min_pad)
            s = 0
            for B, B_pad in spans:
                idxs = members[s : s + B]
                s += B
                jobs_flat = np.zeros((B_pad, nj, 3), dtype=np.int32)
                qnj = plan.njobs[idxs]
                rows = np.repeat(np.arange(B, dtype=np.int64), qnj)
                pos = _segment_arange(qnj)
                src = np.repeat(jpos[idxs], qnj) + pos
                jobs_flat[rows, pos] = plan.words[src]
                out.append(
                    (idxs, jobs_flat.reshape(B_pad, nj * 3), nc, nj, rng, cw)
                )
        return out

    def _light_width(self) -> int:
        """Effective light-class chunk width (0 = disabled; must be a
        smaller power of two than the global width, the pre-sorted merge's
        pow2 run contract)."""
        cw = int(getattr(self.config, "light_chunk_size", 0) or 0)
        if cw <= 0 or cw >= self.CHUNK or (cw & (cw - 1)) or cw % 128:
            return 0
        return cw

    def _light_classes(self, n_queries: int, plan: PlannedJobs, nc_bucket):
        """Per-query light-class choice: (small bool[B], nc_small int64[B]).

        A query goes light iff its bucketed lane count at the light width
        is strictly below its bucketed lane count at the global width —
        recomputed from the (possibly pruned) job words so the decision
        tracks exactly what the device will decompose — and it carries no
        term-range job.  nc_small is its chunk-count bucket at the light
        width (only meaningful where small).
        """
        cw = self._light_width()
        if not cw:
            z = np.zeros(n_queries, dtype=bool)
            return z, np.zeros(n_queries, dtype=np.int64)
        jstart = plan.words[:, 0].astype(np.int64)
        jlen = (plan.words[:, 1] & _MAX_JOB_LEN).astype(np.int64)
        njc_s = np.where(jlen > 0, (jstart % 128 + jlen + cw - 1) // cw, 0)
        nch_s = np.bincount(
            plan.jquery, weights=njc_s.astype(np.float64), minlength=n_queries
        ).astype(np.int64)
        # COARSE light buckets, not the fine ladder: every class entry
        # carries a fixed device cost, so every extra entry eats a lane
        # win.  At most 3 light geometries absorb (and empty) several
        # big classes, keeping the entry count ~flat.
        nc_small = _bucket_vec(nch_s, self._LIGHT_NC_BUCKETS, 4)
        small = (
            (plan.njobs > 0)
            & ~plan.has_range
            & (nch_s <= self._LIGHT_NC_BUCKETS[-1])
            & (nc_small * cw < nc_bucket * self.CHUNK)
        )
        return small, nc_small

    _LIGHT_NC_BUCKETS = (4, 8, 12)

    def _pack_dispatches_template(self, n_queries: int, plan: PlannedJobs, tkey):
        """Template-composition packing (IndexConfig.template_compositions).

        Returns (dispatches, class_specs) shaped like the composed path's,
        but with the class layout drawn from a frozen per-(scorer, k, fmt,
        window size) TEMPLATE: fixed entry order, fixed row capacities
        (b_pad == b_out), and ONE dispatch per class instead of pow2
        row-split spans (each class entry carries a fixed device cost).
        Queries that overflow an
        entry's capacity spill into the next larger eligible entry (their
        extra chunk slots are zero jobs — dead padding);
        only a window the whole template cannot hold re-freezes it, so a
        steady workload compiles ONE window program instead of one per
        composition.
        """
        from ..utils.metrics import metrics

        C = self.CHUNK
        nc_b = _bucket_vec(plan.nchunks, self.nc_buckets, self.nc_min)
        nj_b = _bucket_vec(plan.njobs, self.NJ_BUCKETS, 4)
        small, nc_small = self._light_classes(n_queries, plan, nc_b)
        nc_eff = np.where(small, nc_small, nc_b)
        lw = self._light_width()
        alive = plan.njobs > 0
        jpos = np.zeros(n_queries, dtype=np.int64)
        np.subtract(np.cumsum(plan.njobs), plan.njobs, out=jpos)

        # Distinct live query classes, ascending (width, nc, nj) — bit 30
        # is the light-width flag (no cross-width spill: a light query's
        # chunk count differs per width, so eligibility is only checked
        # against same-width entries; capacities grow per (width, nc)).
        cls = np.where(
            alive, (small.astype(np.int64) << 30) | (nc_eff << 12) | nj_b, -1
        )
        order = np.argsort(cls, kind="stable")
        scls = cls[order]
        start = int(np.searchsorted(scls, 0))
        qorder, qcls = order[start:], scls[start:]
        if len(qorder) == 0:
            return [], ()
        bounds = np.flatnonzero(np.r_[True, qcls[1:] != qcls[:-1], True])
        qclasses = [
            (
                (int(qcls[bounds[i]]) >> 12) & 0x3FFFF,
                int(qcls[bounds[i]]) & 0xFFF,
                lw if (int(qcls[bounds[i]]) >> 30) else C,
                qorder[bounds[i] : bounds[i + 1]],
            )
            for i in range(len(bounds) - 1)
        ]

        def try_assign(entries):
            remaining = [e[2] for e in entries]
            buckets = [[] for _ in entries]
            for ncq, njq, cwq, members in qclasses:
                pos = 0
                for ei, e in enumerate(entries):
                    nct, njt = e[0], e[1]
                    cwt = e[3] if len(e) > 3 else C
                    if cwt != cwq or nct < ncq or njt < njq:
                        continue
                    take = min(remaining[ei], len(members) - pos)
                    if take:
                        buckets[ei].append(members[pos : pos + take])
                        remaining[ei] -= take
                        pos += take
                    if pos == len(members):
                        break
                if pos < len(members):
                    return None
            return buckets

        entries = self._comp_templates.get(tkey)
        buckets = try_assign(entries) if entries else None
        if buckets is None:
            # (Re)freeze.  Per (width, nc) class: capacity = max(current
            # count, previous total capacity) x headroom rounded up to 8
            # rows; nj = the largest
            # bucket seen.  Capacities only grow, so refreezes converge.
            headroom = float(getattr(self.config, "template_headroom", 1.15))
            need: Dict[Any, int] = {}
            njmax: Dict[Any, int] = {}
            prev_cap: Dict[Any, int] = {}
            for ncq, njq, cwq, members in qclasses:
                key = (cwq, ncq)
                need[key] = need.get(key, 0) + len(members)
                njmax[key] = max(njmax.get(key, 0), njq)
            for e in entries or ():
                # SUM previous caps per (width, nc) (a class can span
                # several entries when b_cap splits it) so capacity is
                # monotone.
                key = (e[3] if len(e) > 3 else C, e[0])
                prev_cap[key] = prev_cap.get(key, 0) + e[2]
                njmax[key] = max(njmax.get(key, 0), e[1])
            entries = []
            for key in sorted(set(need) | set(prev_cap)):
                cw, nc = key
                # Headroom applies to the live demand; previous capacity
                # is a floor (no headroom re-compounding across refreezes).
                want = max(
                    int(need.get(key, 0) * headroom), prev_cap.get(key, 0)
                )
                cap_total = -(-want // 8) * 8
                b_cap = max(8, (self.LANES_PER_DISPATCH // (nc * cw)) // 8 * 8)
                while cap_total > 0:
                    cap = min(cap_total, b_cap)
                    entries.append((nc, njmax[key], cap, cw))
                    cap_total -= cap
            self._comp_templates[tkey] = entries
            metrics.inc("template_refreezes", 1)
            buckets = try_assign(entries)
            if buckets is None:  # capacities were sized to cover this window
                raise RuntimeError(
                    f"template refreeze failed to hold its own window: {entries}"
                )

        dispatches, class_specs = [], []
        for e, blist in zip(entries, buckets):
            nc, nj, cap = e[0], e[1], e[2]
            cw = e[3] if len(e) > 3 else C
            idxs = (
                np.concatenate(blist) if blist else np.empty(0, dtype=np.int64)
            )
            B = len(idxs)
            jobs_flat = np.zeros((cap, nj, 3), dtype=np.int32)
            if B:
                qnj = plan.njobs[idxs]
                rows = np.repeat(np.arange(B, dtype=np.int64), qnj)
                pos = _segment_arange(qnj)
                src = np.repeat(jpos[idxs], qnj) + pos
                jobs_flat[rows, pos] = plan.words[src]
            dispatches.append(
                (idxs, jobs_flat.reshape(cap, nj * 3), nc, nj, False, cw)
            )
            class_specs.append((cap, cap, nj, nc, False, cw))
        return dispatches, tuple(class_specs)

    # ------------------------------------------------------------------ #
    # execution                                                           #
    # ------------------------------------------------------------------ #

    def query_batch(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> List[List[QueryResult]]:
        """Execute a query batch (blocking convenience over the async path).

        When ``IndexConfig.serving_window`` is set and the batch exceeds
        it, the batch is split into serving_window-sized windows submitted
        as a pipeline of depth ``serving_depth`` — host planning of window
        i+1 overlaps device compute of window i, and per-dispatch device
        memory is bounded by the window size.  Queries are independent,
        so results are identical to the single-window submission.
        """
        sw = getattr(self.config, "serving_window", 0)
        if not sw or len(queries) <= sw:
            return self.query_batch_async(
                queries, scorer, tokenizer, fields_boost, top_k
            ).get()
        depth = max(1, getattr(self.config, "serving_depth", 4))
        out: List[List[QueryResult]] = []
        inflight: List[Any] = []
        for s in range(0, len(queries), sw):
            inflight.append(
                self.query_batch_async(
                    queries[s : s + sw], scorer, tokenizer, fields_boost, top_k
                )
            )
            while len(inflight) >= depth:
                out.extend(inflight.pop(0).get())
        for h in inflight:
            out.extend(h.get())
        return out

    def query_batch_async(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
        _heavy: bool = False,
    ) -> "PendingBatch":
        """Plan, transfer and dispatch a query batch without blocking.

        Submit the largest windows you can: per-dispatch overhead is paid
        once per window, and queries regroup into shape classes across
        the whole window (posting lists are power-law skewed — one heavy
        query must not pad out thousands of light ones; SURVEY §7 hard
        part 3).
        """
        from ..utils.metrics import metrics

        if fields_boost is None:
            fields_boost = [1.0] * self.num_fields
        k = top_k or self.config.default_top_k
        metrics.inc("queries_submitted", len(queries))
        with metrics.timer("query/plan"):
            plan, fallback = self.plan_batch(queries, tokenizer, scorer)
        host_rows = None
        if fallback:
            # Graceful degradation: cap-exceeding queries run on the host
            # (which has no caps) instead of failing the batch — through
            # the scorer's vectorized numpy path when it has one, so one
            # adversarial query costs milliseconds, not a per-posting
            # Python walk holding the whole window.
            metrics.inc("device_fallback_queries", len(fallback))
            _host_fallback_policy(
                self.config, len(fallback), "device plan caps exceeded"
            )
            vq = getattr(scorer, "vectorized_query", None)
            with metrics.timer("query/host_fallback"):
                host_rows = {
                    qi: (
                        vq(self._index, queries[qi], tokenizer, top_k=k,
                           fields_boost=fields_boost)
                        if vq is not None
                        else self._index.query(
                            queries[qi], scorer, tokenizer, fields_boost, top_k=k
                        )
                    )
                    for qi in fallback
                }
        fmt = resolve_result_format(
            self.config.effective_result_format(), self.num_slots
        )

        # Heavy-query result cache (IndexConfig.heavy_cache_min_chunks):
        # queries whose plan spans a huge posting range (a full-index
        # prefix scan is one very wide device sort) are answered from a
        # snapshot-static cache keyed by the query's job-table bytes — the
        # exact device-program input.  First encounter computes the row
        # once (blocking, k = heavy_cache_top_k); repeats are host lookups.
        array_rows = None
        cfg = self.config
        if (
            plan is not None
            and not _heavy
            and cfg.heavy_cache_min_chunks
            and k <= cfg.heavy_cache_top_k
        ):
            heavy = np.flatnonzero(plan.nchunks >= cfg.heavy_cache_min_chunks)
            if len(heavy):
                boosts_key = tuple(float(b) for b in fields_boost)
                skey = _scorer_cache_key(scorer)
                array_rows = {}
                for qi in heavy:
                    qi = int(qi)
                    rows_q = plan.words[plan.jquery == qi]
                    ck = (skey, rows_q.tobytes(), boosts_key)
                    hit = self._heavy_cache.get(ck)
                    if hit is None or (
                        hit[0] is None and not fmt.startswith("slots")
                    ):
                        metrics.inc("heavy_cache_misses", 1)
                        sub = self.query_batch_async(
                            [queries[qi]], scorer, tokenizer, fields_boost,
                            top_k=cfg.heavy_cache_top_k, _heavy=True,
                        )
                        s_row, sl_row, _ = sub.get_arrays(want_keys=False)
                        hit = (
                            s_row[0] if s_row is not None else None,
                            sl_row[0],
                        )
                        # LRU eviction: dict order is insertion order, and
                        # hits re-insert below, so the first key is the
                        # least-recently-used.  (Clear-all here let an
                        # adversarial mix force repeated full-scan
                        # recomputes of every hot entry.)
                        while len(self._heavy_cache) >= self._HEAVY_CACHE_CAP:
                            del self._heavy_cache[next(iter(self._heavy_cache))]
                        self._heavy_cache[ck] = hit
                    else:
                        metrics.inc("heavy_cache_hits", 1)
                        # Refresh recency (move to the dict's end).
                        self._heavy_cache[ck] = self._heavy_cache.pop(ck)
                    array_rows[qi] = hit
                hit_list = np.fromiter(array_rows, np.int64, len(array_rows))
                keep = ~np.isin(plan.jquery, hit_list)
                jq2 = plan.jquery[keep]
                nchunks2 = plan.nchunks.copy()
                nchunks2[hit_list] = 0
                plan = (
                    PlannedJobs(
                        jquery=jq2,
                        words=plan.words[keep],
                        nchunks=nchunks2,
                        njobs=np.bincount(jq2, minlength=len(queries)),
                        has_range=plan.has_range,
                        pool_rows=(
                            plan.pool_rows[keep]
                            if plan.pool_rows is not None
                            else None
                        ),
                        # Spliced queries drop to 0 jobs — the cached prune
                        # detects the pool mismatch per query and treats
                        # them as trivially unchanged (index/prune.py).
                        qids=plan.qids,
                        qp=plan.qp,
                    )
                    if len(jq2)
                    else None
                )
        # Block-max safe top-k pruning (index/prune.py): drop posting
        # chunks that provably cannot reach this request's top-k.  Runs
        # AFTER the heavy-result splice so heavy-cache keys stay pruning-
        # independent; exact — surviving top-k rows are bit-equal
        # (tests/test_prune.py).
        if plan is not None and getattr(cfg, "prune_blocks", True):
            pool = self._plan_pools.get(_scorer_cache_key(scorer))
            if pool is not None and pool.get("prune_enabled"):
                from .prune import prune_plan_cached

                with metrics.timer("query/prune"):
                    plan = prune_plan_cached(self, plan, pool, k, fields_boost)
        if plan is None:
            return PendingBatch(
                self, len(queries), [], host_rows=host_rows, k=k,
                array_rows=array_rows, fmt=fmt,
            )
        tpl_specs = None
        with metrics.timer("query/pack"):
            if (
                getattr(cfg, "template_compositions", False)
                and cfg.single_dispatch_windows
                and not getattr(cfg, "per_class_dispatch", False)
                and not bool(plan.has_range.any())
                and not bool((plan.nchunks > 2048).any())
            ):
                # Term-range windows and huge non-range classes (nc > 2048:
                # their row pads must track the real query count, see
                # pack_dispatches) keep the per-composition path; both are
                # rare, and the
                # heavy-result cache absorbs most of the latter upstream.
                tkey = (_scorer_cache_key(scorer), k, fmt, len(queries))
                dispatches, tpl_specs = self._pack_dispatches_template(
                    len(queries), plan, tkey
                )
            else:
                dispatches = self.pack_dispatches(len(queries), plan)
        if not dispatches:
            return PendingBatch(
                self, len(queries), [], host_rows=host_rows, k=k,
                array_rows=array_rows, fmt=fmt,
            )
        metrics.inc("dispatches", len(dispatches))
        boost_arr = jnp.asarray(np.asarray(fields_boost, dtype=np.float32))
        if tpl_specs is None:
            dispatches.sort(key=lambda d: (d[2], d[3], d[1].shape[0]))
        if getattr(self.config, "per_class_dispatch", False):
            # Per-class device programs + one tiny pack program, still ONE
            # packed H2D buffer and ONE packed D2H drain.  Executions
            # serialize on the device in submission order, so the window's
            # device cost is the same class programs back to back; what
            # changes vs the composed window is the compile economics (the
            # expensive programs are keyed on class shape alone — see
            # _class_step_impl) and XLA's freedom per class.
            class_specs = tuple(
                (
                    d[1].shape[0],
                    min(d[1].shape[0], -(-len(d[0]) // 256) * 256),
                    d[3],
                    d[2],
                    d[4],
                    d[5] if len(d) > 5 else self.CHUNK,
                )
                for d in dispatches
            )
            any_ranges = any(spec[4] for spec in class_specs)
            aux = (
                self._aux_rec(scorer)
                if any_ranges
                else jnp.asarray(_AUX_DUMMY)
            )
            dummy_aux = jnp.asarray(_AUX_DUMMY)
            with metrics.timer("query/h2d"):
                words_np = np.concatenate(
                    [d[1].reshape(-1) for d in dispatches]
                )
                # Pad the packed H2D buffer to a pow2 bucket so the class
                # programs' jit keys — (class statics, buffer length) — do
                # not vary per window composition (see _class_step_impl).
                want = max(1024, 1 << (len(words_np) - 1).bit_length())
                if want > len(words_np):
                    words_np = np.pad(words_np, (0, want - len(words_np)))
                words_flat = jnp.asarray(words_np)
            cstep = _get_class_step(scorer)
            ss, ds, b_outs = [], [], []
            off = 0
            with metrics.timer("query/dispatch"):
                for disp, (b_pad, b_out, nj, nc, rng, cw) in zip(
                    dispatches, class_specs
                ):
                    s, d = cstep(
                        self.rec,
                        self.field_avg,
                        boost_arr,
                        words_flat,
                        off,
                        aux if rng else dummy_aux,
                        chunk=cw,
                        k=min(k, nc * cw),
                        qterm_bits=self._qterm_bits,
                        num_fields=self.num_fields,
                        num_chunks=nc,
                        nj=nj,
                        b_pad=b_pad,
                        use_ranges=rng,
                    )
                    ss.append(s)
                    ds.append(d)
                    b_outs.append(b_out)
                    off += b_pad * nj * 3
                packed = _PACK_STEP(ss, ds, b_outs=tuple(b_outs), k=k, fmt=fmt)
            layout = []
            row = 0
            for (idxs, *_a), b_out in zip(dispatches, b_outs):
                layout.append((idxs, row))
                row += b_out
            if self.config.prefetch_results:
                packed.copy_to_host_async()
            return PendingBatch(
                self, len(queries), [], packed=packed, layout=layout,
                host_rows=host_rows, fmt=fmt, k=k, array_rows=array_rows,
            )
        if self.config.single_dispatch_windows:
            # One jitted program per window composition, one packed H2D
            # buffer, one packed D2H result: the whole window pays the
            # dispatch round trip and the per-transfer fixed costs ONCE.
            # Compiles once per composition (persistent compile cache makes
            # that a first-run cost).
            # Output rows per class: the real query count rounded up to a
            # coarse 256 granularity — fine enough to drop most pow-2 pad
            # rows from the D2H fetch, coarse enough to keep the number of
            # distinct window compositions (= compiles) small.  Template
            # packing supplies its own frozen specs (b_out == capacity).
            class_specs = tpl_specs if tpl_specs is not None else tuple(
                (
                    d[1].shape[0],
                    min(d[1].shape[0], -(-len(d[0]) // 256) * 256),
                    d[3],
                    d[2],
                    d[4],
                    d[5] if len(d) > 5 else self.CHUNK,
                )
                for d in dispatches
            )
            any_ranges = any(spec[4] for spec in class_specs)
            aux = (
                self._aux_rec(scorer)
                if any_ranges
                else jnp.asarray(_AUX_DUMMY)
            )
            with metrics.timer("query/h2d"):
                words_flat = jnp.asarray(
                    np.concatenate(
                        [d[1].reshape(-1) for d in dispatches]
                    )
                )
            step = _get_window_step(scorer)
            with metrics.timer("query/dispatch"):
                packed = step(
                    self.rec,
                    self.field_avg,
                    boost_arr,
                    words_flat,
                    aux,
                    chunk=self.CHUNK,
                    k=k,
                    qterm_bits=self._qterm_bits,
                    num_fields=self.num_fields,
                    class_specs=class_specs,
                    fmt=fmt,
                )
            layout = []
            row = 0
            for (idxs, *_a), (_, b_out, *_b) in zip(dispatches, class_specs):
                layout.append((idxs, row))
                row += b_out
            if self.config.prefetch_results:
                # Enqueue the D2H behind this window's execution so it
                # streams during later windows' device compute; the drain's
                # read then finds the result on the host
                # (IndexConfig.prefetch_results).
                packed.copy_to_host_async()
            return PendingBatch(
                self, len(queries), [], packed=packed, layout=layout,
                host_rows=host_rows, fmt=fmt, k=k, array_rows=array_rows,
            )
        step = _get_step(scorer)
        parts = []
        for idxs, jobs_flat, nc, nj, rng, *rest in dispatches:
            cw = rest[0] if rest else self.CHUNK
            top_scores, top_docs = step(
                chunk=cw,
                k=min(k, nc * cw),
                qterm_bits=self._qterm_bits,
                num_fields=self.num_fields,
                num_chunks=nc,
                rec=self.rec,
                field_avg=self.field_avg,
                fields_boost=boost_arr,
                jobs_flat=jnp.asarray(jobs_flat),
                aux=self._aux_rec(scorer) if rng else jnp.asarray(_AUX_DUMMY),
                use_ranges=rng,
            )
            parts.append((idxs, top_scores, top_docs))
        if self.config.prefetch_results:
            for _, top_scores, top_docs in parts:
                top_scores.copy_to_host_async()
                top_docs.copy_to_host_async()
        return PendingBatch(
            self, len(queries), parts, host_rows=host_rows, k=k,
            array_rows=array_rows,
        )

    def to_results(self, top_scores: np.ndarray, top_docs: np.ndarray):
        out: List[List[QueryResult]] = []
        for scores_row, docs_row in zip(top_scores.tolist(), top_docs.tolist()):
            row = [
                QueryResult(key=self.slot_to_key[d], score=s)
                for s, d in zip(scores_row, docs_row)
                if d >= 0 and s != float("-inf")
            ]
            out.append(row)
        return out

    @property
    def key_arr(self) -> np.ndarray:
        """Doc slot -> user key for vectorized lookups: an int64 ndarray
        when every key is a plain int (the common serving case — gathers at
        numpy speed with no per-key Python objects), otherwise an object
        ndarray."""
        if self._key_arr is None or len(self._key_arr) != len(self.slot_to_key):
            if self.slot_to_key and all(type(k) is int for k in self.slot_to_key):
                self._key_arr = np.asarray(self.slot_to_key, dtype=np.int64)
            else:
                arr = np.empty(len(self.slot_to_key), dtype=object)
                arr[:] = self.slot_to_key
                self._key_arr = arr
        return self._key_arr


class PendingBatch:
    """Handle for an in-flight query batch; ``.get()`` blocks and assembles."""

    def __init__(
        self, dix: "DeviceIndex", n: int, parts, packed=None, layout=None,
        host_rows=None, fmt="f32", k=None, array_rows=None,
    ) -> None:
        self._dix = dix
        self._n = n
        self._parts = parts
        self._packed = packed  # int32[rows, 2, k] / int16[rows, 3, k]
        # (compact) / int8[rows, 3, k] (slots)
        self._layout = layout  # [(query_indices, row_offset), ...]
        self._host_rows = host_rows  # {query_index: results} from fallback
        self._fmt = fmt
        # {query_index: (scores | None, slots)} from the heavy-query cache
        self._array_rows = array_rows
        # Submitted top_k: sizes the result arrays when every query fell
        # back to the host (no packed result to take k from).
        self._k = k
        # Host copy of ``packed`` planted by fetch_windows_jointly — lets
        # several windows share one D2H transfer (see that function).
        self._packed_host: Optional[np.ndarray] = None

    def _unpack(self):
        """Single D2H fetch + decode -> (scores f32[rows, k] | None, slots
        int32[rows, k]).  Compact windows decode f16 score bits and the
        lo/hi slot halves; slots windows decode the three slot bytes and
        carry NO scores (IndexConfig.result_format)."""
        from ..utils.metrics import metrics

        # Timed apart from the decode: the D2H fetch waits on the device
        # and the link while the decode is host CPU — the split tells
        # which one binds the drain.
        if self._packed_host is not None:
            packed = self._packed_host
        else:
            with metrics.timer("query/fetch"):
                packed = np.asarray(self._packed)
        return unpack_result_rows(packed, self._fmt, self._k)

    def get(self) -> List[List[QueryResult]]:
        from ..utils.metrics import metrics

        if self._fmt.startswith("slots") and (
            self._packed is not None or self._array_rows
        ):
            raise ValueError(
                "result_format='slots'/'slots20' windows carry no scores; use "
                "get_arrays() (ranked slots/keys) or a score-carrying "
                "result_format for QueryResult rows"
            )
        results: List[List[QueryResult]] = [[] for _ in range(self._n)]
        with metrics.timer("query/drain"):
            self._drain(results)
        return results

    def get_arrays(self, want_keys: bool = True):
        """Raw columnar results — the serving-engine surface.

        Returns ``(scores f32[n, k] | None, slots int32[n, k], keys[n, k])``
        in query order.  VALIDITY MASK: ``slots >= 0`` (equivalently
        ``np.isfinite(scores)`` when scores are present) — invalid entries'
        key content is undefined.  Under ``result_format="slots"`` the
        window carries no scores and ``scores`` is ``None`` (rankings are
        still exact: slot columns are in descending-score order).
        ``keys`` is an int64 array when every document key is a plain int
        (gathered at numpy speed), otherwise an object array with ``None``
        at invalid entries.  This path skips per-result Python object
        construction (which costs more than the entire device round trip on
        large windows); use :meth:`get` for ``QueryResult`` rows.
        ``want_keys=False`` skips the slot->key gather too (keys is
        ``None``) for callers that map slots themselves.
        """
        from ..utils.metrics import metrics

        with metrics.timer("query/drain"):
            slots_only = self._fmt.startswith("slots")
            if self._packed is None:
                k = self._parts[0][1].shape[-1] if self._parts else (self._k or 0)
                scores = (
                    None
                    if slots_only and not self._parts
                    else np.full((self._n, k), -np.inf, np.float32)
                )
                slots = np.full((self._n, k), -1, np.int32)
                for idxs, top_scores, top_docs in self._parts:
                    scores[idxs] = np.asarray(top_scores)[: len(idxs)]
                    slots[idxs] = np.asarray(top_docs)[: len(idxs)]
            else:
                p_scores, p_slots = self._unpack()  # single D2H fetch
                k = p_slots.shape[-1]
                scores = (
                    None
                    if slots_only
                    else np.full((self._n, k), -np.inf, np.float32)
                )
                slots = np.full((self._n, k), -1, np.int32)
                for idxs, row in self._layout:
                    if scores is not None:
                        scores[idxs] = p_scores[row : row + len(idxs)]
                    slots[idxs] = p_slots[row : row + len(idxs)]
            if self._array_rows:
                # Heavy-query cache rows (filled before the key gather so
                # keys cover them like any other row).  A row cached under
                # the slots format carries no scores; its entries stay
                # -inf (validity is the ``slots >= 0`` contract there).
                for qi, (s_row, sl_row) in self._array_rows.items():
                    m = min(slots.shape[1], len(sl_row))
                    slots[qi, :m] = sl_row[:m]
                    slots[qi, m:] = -1
                    if scores is not None and s_row is not None:
                        scores[qi, :m] = s_row[:m]
                        scores[qi, m:] = -np.inf
            keys = None
            if want_keys:
                karr = self._dix.key_arr
                if karr.dtype == object:
                    valid = slots >= 0
                    keys = np.where(valid, karr[np.where(valid, slots, 0)], None)
                else:  # int64 fast path: invalid entries masked by slot -1
                    keys = karr[np.clip(slots, 0, None)]
            if self._host_rows:
                k2s = self._dix._index._key_to_slot
                for qi, row in self._host_rows.items():
                    m = min(len(row), slots.shape[1])
                    if scores is not None:
                        scores[qi, :m] = [r.score for r in row[:m]]
                    slots[qi, :] = -1
                    # Host-fallback rows keep the ``slots >= 0`` validity
                    # contract (the only mask under result_format="slots").
                    slots[qi, :m] = [k2s.get(r.key, -1) for r in row[:m]]
                    if keys is not None:
                        if keys.dtype == object:
                            keys[qi, :] = None
                        keys[qi, :m] = [r.key for r in row[:m]]
        return scores, slots, keys

    def _drain(self, results) -> None:
        if self._host_rows:
            for qi, row in self._host_rows.items():
                results[qi] = row
        if self._array_rows:
            k = self._k or 0
            for qi, (s_row, sl_row) in self._array_rows.items():
                results[int(qi)] = self._dix.to_results(
                    s_row[None, :k], sl_row[None, :k]
                )[0]
        if self._packed is not None:
            scores, docs = self._unpack()  # single D2H fetch
            for idxs, row in self._layout:
                rows = self._dix.to_results(
                    scores[row : row + len(idxs)], docs[row : row + len(idxs)]
                )
                for i, r in zip(idxs, rows):
                    results[int(i)] = r
            return
        for idxs, top_scores, top_docs in self._parts:
            rows = self._dix.to_results(
                np.asarray(top_scores)[: len(idxs)], np.asarray(top_docs)[: len(idxs)]
            )
            for i, row in zip(idxs, rows):
                results[int(i)] = row


_JOINT_CONCAT = jax.jit(lambda *xs: jnp.concatenate(xs))


def fetch_windows_jointly(batches: Sequence["PendingBatch"]) -> None:
    """Drain several windows' packed results in ONE device->host transfer.

    Each fetch pays a fixed sync + transfer cost that dominates a window's
    drain once the payload is small (slots20 is ~415 KB per 16384-query
    window); fetching N windows per transfer amortizes it N-fold at the
    price of one extra window of drain latency.  A tiny device-side concat
    program (one copy pass over the packed buffers, enqueued after the
    windows it reads) makes the group a single buffer so the runtime
    issues a single transfer.

    Each batch's host copy is planted on the handle; its later
    ``get_arrays()`` / ``get()`` decodes from host memory with no device
    read.  Batches with no packed window (host-only) or with mismatched
    dtypes (different result formats) are left to fetch individually.
    """
    from ..utils.metrics import metrics

    live = [
        b
        for b in batches
        if b._packed is not None and b._packed_host is None
    ]
    if len(live) < 2 or len({b._packed.dtype for b in live}) != 1:
        return
    flats = [b._packed.reshape(-1) for b in live]
    with metrics.timer("query/fetch"):
        host = np.asarray(_JOINT_CONCAT(*flats))
    off = 0
    for b, f in zip(live, flats):
        n = int(f.shape[0])
        b._packed_host = host[off : off + n].reshape(b._packed.shape)
        off += n
