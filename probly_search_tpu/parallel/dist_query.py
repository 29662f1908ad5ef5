"""Doc-sharded distributed query execution over a ("data", "docs") mesh.

Layout: doc slot ``g`` lives on shard ``g % n_shards`` with local slot
``g // n_shards``; each shard holds the CSR postings of its docs for ALL
terms (classic partition-by-document).  One global sorted term dictionary is
shared; per-shard CSR offsets index each shard's posting record array.

Collective plan: ONE collective — per-shard local top-k -> ``all_gather``
over "docs" -> final top-k (replicated); only O(k) values cross the
interconnect per query.  Document frequencies (the distributed
analogue of count_documents, index.rs:282-297) are GLOBAL but static per
snapshot, so they are computed on host from the merged segment and
premultiplied into each job's scale word — no df psum at query time.

Execution mirrors the single-chip engine (index/device.py): queries bucket
into shape classes, every class's job table packs into ONE flat buffer, and
the whole window runs as ONE jitted shard_map program returning ONE packed
result array — a single dispatch and transfer pair per window.

The per-shard compute is the SAME ``_query_step_impl`` as the single-chip
path — one engine, one semantics, N chips.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..index.device import (
    _MAX_CHAR,
    _LEN_BITS,
    _MAX_JOB_LEN,
    _QT_BITS,
    _bucket,
    _bucket_vec,
    _segment_arange,
    pack_result_rows,
    resolve_result_format,
    unpack_result_rows,
)
from ..index.segment import merge_segments
from ..models.base import QueryResult
from ..utils.tokenizers import whitespace_tokenizer


class ShardedDeviceIndex:
    """Doc-sharded device snapshot of an Index over a mesh."""

    CHUNK = 1024
    NC_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
    NJ_BUCKETS = (4, 8, 16, 32, 64, 128, 256)

    def __init__(self, index, mesh) -> None:
        index._flush_pending()
        self.version = index.version
        self._index = index
        self.config = index.config
        self.CHUNK = int(getattr(index.config, "chunk_size", 0) or type(self).CHUNK)
        # Fine (non-pow2) NC buckets, same ladder as the single-chip engine
        # (per-shard compute IS _query_step_impl).
        from ..index.device import DeviceIndex as _DIX

        if getattr(index.config, "fine_nc_buckets", True):
            self.nc_buckets = _DIX.NC_BUCKETS_FINE
            self.nc_min = 2
        else:
            self.nc_buckets = type(self).NC_BUCKETS
            self.nc_min = 4
        self.mesh = mesh
        n = int(mesh.shape["docs"])
        self.n_shards = n
        F = index.num_fields
        self.num_fields = F
        C = self.CHUNK

        # One global merged segment (keeps latently-deleted postings, like
        # the single-chip snapshot).
        gseg = merge_segments(index._segments, F)
        T = gseg.num_terms
        from ..index.segment import escape_terms_fixed

        # Escaped <U table (trailing-NUL terms must not alias; segment.py).
        self.terms = escape_terms_fixed(gseg.terms)
        self.term_lens = gseg.term_lens.astype(np.int64)
        self.g_offsets = gseg.offsets.astype(np.int64)

        S = index._next_slot
        alive = index._alive[:S]
        doc_len = index._doc_len[:S].astype(np.float32) if S else np.zeros((0, F), np.float32)
        local_max = (S - 1) // n if S else 0
        self.local_slots = (local_max + 1) if S else 0
        if local_max >= (1 << (31 - _QT_BITS)):
            raise ValueError(
                f"per-shard doc slots ({local_max + 1}) exceed the packed "
                f"int32 merge-key capacity; use more shards"
            )

        # Global live-occurrence cumsum: df for any term is two lookups
        # (static per snapshot; premultiplied into job scales at plan time).
        occ_live = (
            np.where(alive[gseg.post_doc], gseg.post_occ, 0).astype(np.int64)
            if gseg.num_postings
            else np.zeros(0, np.int64)
        )
        self.g_live_cum = np.zeros(gseg.num_postings + 1, dtype=np.int64)
        np.cumsum(occ_live, out=self.g_live_cum[1:])

        # Per-shard CSR: select postings by doc % n (order within a term is
        # preserved, so per-shard postings stay doc-sorted).
        R = -(-(1 + 2 * F) // 4) * 4  # rows padded to a multiple of 4
        post_doc = gseg.post_doc
        term_of_post = np.repeat(
            np.arange(T, dtype=np.int64), np.diff(gseg.offsets).astype(np.int64)
        )
        shard_of = post_doc % n if len(post_doc) else post_doc
        offsets_sh = np.zeros((n, T + 1), dtype=np.int64)
        pmax = 0
        shard_rows = []
        for s in range(n):
            sel = np.flatnonzero(shard_of == s)
            counts = np.bincount(term_of_post[sel], minlength=T)
            np.cumsum(counts, out=offsets_sh[s, 1:])
            shard_rows.append(sel)
            pmax = max(pmax, len(sel))
        self.offsets_sh = offsets_sh
        # Global posting -> rows per shard (kept for the lazy aux build —
        # term-range jobs need per-posting statics in shard order).
        self._shard_rows = shard_rows
        self._term_of_post = term_of_post
        self._pmax = pmax
        self._aux_cache: Dict[Any, Any] = {}
        # Host posting stats retained for sharded block-max bounds
        # (index/prune.py): per-shard job bounds are computed lazily at
        # plan-pool insert from these snapshot copies (alive/doc_len are
        # copies — a later vacuum must not leak into stale bounds).
        self._post_tf_g = gseg.post_tf
        self._post_doc_g = post_doc
        self._alive_snap = alive.copy()
        self._doc_len_snap = doc_len  # f32 [S, F]; astype above copied
        self._field_avg_host = np.array(
            [fd.avg for fd in index._fields], dtype=np.float64
        )
        self._prune_views: List[Any] = [None] * n
        # Transposed per-shard record arrays [n, R, Pmax + C] (see
        # index/device.py layout note).
        rec = np.zeros((n, R, pmax + C), dtype=np.int32)
        rec[:, 0] = -1  # slack tail; payload columns overwritten below
        for s in range(n):
            sel = shard_rows[s]
            m = len(sel)
            if m:
                gdoc = post_doc[sel]
                local = gdoc // n
                # True local slot even for dead docs + liveness row — the
                # pre-sorted-runs merge scheme (see index/device.py rec).
                rec[s, 0, :m] = local
                rec[s, 1 : 1 + F, :m] = gseg.post_tf[sel].T
                rec[s, 1 + F : 1 + 2 * F, :m] = doc_len[gdoc].view(np.int32).T
                rec[s, 1 + 2 * F, :m] = alive[gdoc]

        # Place shard-major arrays on the mesh: sharded over "docs",
        # replicated over "data".
        self.rec = jax.device_put(rec, NamedSharding(mesh, P("docs", None, None)))
        self.field_avg = jax.device_put(
            np.array([fd.avg for fd in index._fields], dtype=np.float32),
            NamedSharding(mesh, P()),
        )
        self.n_docs = float(len(index._docs))
        self.slot_to_key = list(index._slot_to_key)
        self.num_slots = S  # GLOBAL slot count (result formats gate on it)
        self._qterm_bits = _QT_BITS
        self._step_cache: Dict[Any, Any] = {}
        # Per-(scorer key, tokenizer) pooled per-QUERY plan cache — the
        # sharded mirror of DeviceIndex._qplan_pools: a repeated query costs
        # one dict lookup + CSR gather instead of tokenize/probe/df/scale
        # work per window (measured 37-66 ms/window single-chip).  The lock
        # serializes pool growth under concurrent query_batch_async callers.
        import threading

        self._qplan_pools: Dict[Any, Dict[str, Any]] = {}
        self._plan_lock = threading.RLock()

    def _aux_rec(self, scorer):
        """Per-shard aux record array int32[n, 4, Pmax + C] for term-range
        jobs (mirrors DeviceIndex._aux_rec): row 0 = f32 bits of the
        scorer's static per-term scale over the GLOBAL live df, row 1 =
        term utf-8 byte length.  Built lazily; sharded over "docs"."""
        key = getattr(scorer, "device_cache_key", lambda: ("id", id(scorer)))()
        cached = self._aux_cache.get(key)
        if cached is not None:
            return cached
        n = self.n_shards
        C = self.CHUNK
        aux = np.zeros((n, 4, self._pmax + C), dtype=np.int32)
        gdf = (
            self.g_live_cum[self.g_offsets[1:]] - self.g_live_cum[self.g_offsets[:-1]]
        ).astype(np.float64)
        static = np.asarray(scorer.device_term_static(gdf, self.n_docs), np.float32)
        tlens = np.asarray(self.term_lens, np.int32)
        for s in range(n):
            sel = self._shard_rows[s]
            m = len(sel)
            if m:
                t = self._term_of_post[sel]
                aux[s, 0, :m] = static[t].view(np.int32)
                aux[s, 1, :m] = tlens[t]
        arr = jax.device_put(aux, NamedSharding(self.mesh, P("docs", None, None)))
        self._aux_cache[key] = arr
        return arr

    # ------------------------------------------------------------------ #
    # planning                                                            #
    # ------------------------------------------------------------------ #

    # Pool caps (mirror DeviceIndex): beyond these the pool restarts —
    # bounds memory under adversarial all-distinct traffic.
    _QPLAN_MAX_QUERIES = 1 << 20
    _QPLAN_MAX_ROWS = 4 << 20

    def plan_batch(
        self, queries: Sequence[str], tokenizer, scorer, with_rows: bool = False
    ):
        """Plan a batch into per-shard job tables (thread-safe, cached).

        Returns ``((jquery, words[n, NJOBS, 3], nchunks[B], njobs[B],
        has_range[B]) | None, fallback)`` — ``nchunks`` is the max over
        shards; ``fallback`` lists cap-exceeding queries that degrade to the
        host path.  The assembled per-QUERY job rows are snapshot-static and
        pooled (the sharded mirror of ``DeviceIndex.plan_batch``): repeated
        queries cost one dict lookup + a vectorized CSR gather.
        ``with_rows=True`` appends ``(rows, qp, qids)`` as a 6th element —
        the pool job-row indices, the pool object they index, and the pool
        qid per window query, all captured UNDER the plan lock (a
        concurrent pool reset replaces the pool in ``_qplan_pools``;
        re-fetching by key later could misalign rows with a fresh pool's
        bounds).  ``qids`` keys the per-query prune-decision cache
        (index/prune.py prune_plan_sharded_cached).
        """
        with self._plan_lock:
            qp = self._qplan_pool(scorer, tokenizer)
            ids = qp["ids"]
            B = len(queries)
            qids = np.fromiter((ids.get(q, -1) for q in queries), np.int64, count=B)
            if (qids < 0).any():
                miss = sorted({queries[i] for i in np.flatnonzero(qids < 0)})
                self._qplan_insert(qp, miss, tokenizer, scorer)
                qids = np.fromiter((ids[q] for q in queries), np.int64, count=B)
            fallback = [int(i) for i in np.flatnonzero(qp["fallback"][qids])]
            nj = qp["njobs"][qids]
            total = int(nj.sum())
            if total == 0:
                return None, fallback
            jquery = np.repeat(np.arange(B, dtype=np.int64), nj)
            rows = np.repeat(qp["off"][qids], nj) + _segment_arange(nj)
            planned = (
                jquery,
                qp["words"][:, rows],
                qp["nchunks"][qids],
                nj,
                qp["has_range"][qids],
            )
            if with_rows:
                planned = planned + ((rows, qp, qids),)
            return planned, fallback

    def _qplan_pool(self, scorer, tokenizer):
        key = (
            getattr(scorer, "device_cache_key", lambda: ("id", id(scorer)))(),
            tokenizer,
        )
        qp = self._qplan_pools.get(key)
        if qp is None or (
            len(qp["ids"]) > self._QPLAN_MAX_QUERIES
            or qp["words"].shape[1] > self._QPLAN_MAX_ROWS
        ):
            qp = {
                "ids": {},  # query string -> dense qid
                "off": np.zeros(1, dtype=np.int64),
                "words": np.zeros((self.n_shards, 0, 3), dtype=np.int32),
                "nchunks": np.zeros(0, dtype=np.int64),
                "njobs": np.zeros(0, dtype=np.int64),
                "has_range": np.zeros(0, dtype=bool),
                "fallback": np.zeros(0, dtype=bool),
            }
            # Sharded block-max bounds ride along per (shard, job row) —
            # the sharded mirror of DeviceIndex._term_plans' prune arrays.
            # Decision frozen at pool creation (a mid-life config flip
            # must not misalign rows and bounds).
            if (
                getattr(self.config, "prune_blocks", True)
                and hasattr(scorer, "device_impact")
                and np.isfinite(self._field_avg_host).all()
            ):
                k_cap = int(getattr(self.config, "prune_max_top_k", 16))
                F = self.num_fields
                qp["prune_sh"] = [
                    {
                        "ub": np.zeros((0, F), np.float32),
                        "topv": np.zeros((0, F, k_cap), np.float32),
                        "cub_off": np.zeros(0, np.int64),
                        "cub": np.zeros((0, F), np.float32),
                        "cub_min": np.zeros((0, F), np.float32),
                    }
                    for _ in range(self.n_shards)
                ]
            self._qplan_pools[key] = qp
        return qp

    def _qplan_insert(self, qp, miss: List[str], tokenizer, scorer) -> None:
        """Plan first-seen queries through the full path and pool the rows
        (job rows of query i are contiguous: ``_plan_batch_impl`` returns
        ``jquery`` grouped ascending by construction)."""
        planned, fb = self._plan_batch_impl(miss, tokenizer, scorer)
        M = len(miss)
        fb_m = np.zeros(M, dtype=bool)
        fb_m[list(fb)] = True
        if planned is None:
            nj_m = np.zeros(M, dtype=np.int64)
            words_m = np.zeros((self.n_shards, 0, 3), dtype=np.int32)
            nch_m = np.zeros(M, dtype=np.int64)
            rng_m = np.zeros(M, dtype=bool)
        else:
            _jq, words_m, nch_m, nj_m, rng_m = planned
        if "prune_sh" in qp:
            from ..index.prune import build_job_bounds, shard_bounds_view

            k_cap = int(getattr(self.config, "prune_max_top_k", 16))
            margin = float(getattr(self.config, "prune_margin", 1e-4))
            for s in range(self.n_shards):
                b = build_job_bounds(
                    shard_bounds_view(self, s),
                    scorer,
                    words_m[s, :, 0].astype(np.int64),
                    (words_m[s, :, 1] & _MAX_JOB_LEN).astype(np.int64),
                    ((words_m[s, :, 1] >> 30) & 1) > 0,
                    self.CHUNK,
                    k_cap,
                    margin,
                )
                assert b is not None  # gating matched at pool creation
                ps = qp["prune_sh"][s]
                ps["cub_off"] = np.concatenate(
                    [ps["cub_off"], b["cub_off"][:-1] + len(ps["cub"])]
                )
                for f in ("ub", "topv", "cub", "cub_min"):
                    ps[f] = np.concatenate([ps[f], b[f]])
        base = len(qp["off"]) - 1
        for i, q in enumerate(miss):
            qp["ids"][q] = base + i
        qp["off"] = np.concatenate([qp["off"], qp["off"][-1] + np.cumsum(nj_m)])
        qp["words"] = np.concatenate([qp["words"], words_m], axis=1)
        qp["nchunks"] = np.concatenate([qp["nchunks"], nch_m])
        qp["njobs"] = np.concatenate([qp["njobs"], nj_m])
        qp["has_range"] = np.concatenate([qp["has_range"], rng_m])
        qp["fallback"] = np.concatenate([qp["fallback"], fb_m])

    def _plan_batch_impl(self, queries: Sequence[str], tokenizer, scorer):
        """Uncached planning pass (see ``plan_batch`` for the contract)."""
        cfg = self.config
        B = len(queries)
        n = self.n_shards
        C = self.CHUNK
        fallback: List[int] = []

        tok_lists = [[t for t in tokenizer(q) if t] for q in queries]
        max_terms = min(cfg.max_query_terms, 1 << self._qterm_bits)
        for qi, toks in enumerate(tok_lists):
            if len(toks) > max_terms:
                fallback.append(qi)
                tok_lists[qi] = []
        counts = np.array([len(t) for t in tok_lists], dtype=np.int64)
        total_terms = int(counts.sum())
        if total_terms == 0 or len(self.terms) == 0:
            return None, fallback
        flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
        flat_qterm = _segment_arange(counts)
        from ..index.segment import probe_terms_fixed

        flat_terms, flat_blen = probe_terms_fixed([t for toks in tok_lists for t in toks])

        lo = np.searchsorted(self.terms, flat_terms, side="left")
        hi = np.searchsorted(self.terms, np.char.add(flat_terms, _MAX_CHAR), side="left")
        nexp = hi - lo
        if nexp.max(initial=0) == 0:
            return None, fallback
        # Term-range eligibility (mirrors index/device.py _term_plans): an
        # expansion-heavy term becomes ONE per-shard job over its whole
        # contiguous CSR range, scale assembled on device from the aux rows.
        thr = cfg.range_min_expansions
        supports_ranges = (
            thr > 0
            and hasattr(scorer, "device_term_static")
            and hasattr(scorer, "device_range_boost")
        )
        eligible = (
            nexp >= thr if supports_ranges else np.zeros(total_terms, dtype=bool)
        )
        nexp = np.where(eligible, 0, nexp)
        tid = np.repeat(lo, nexp) + _segment_arange(nexp)
        jidx = np.repeat(np.arange(total_terms, dtype=np.int64), nexp)

        # Global df per expansion (live posting pointers across all shards),
        # two lookups in the live-occurrence cumsum; df == 0 expansions are
        # never scored (query.rs:48) — drop their jobs.
        jdf = (
            self.g_live_cum[self.g_offsets[tid + 1]] - self.g_live_cum[self.g_offsets[tid]]
        ).astype(np.float64)
        keep = jdf > 0
        tid, jidx, jdf = tid[keep], jidx[keep], jdf[keep]
        # Range jobs for eligible terms (one per term over [lo, hi)).
        r_i = np.flatnonzero(eligible & (hi > lo))
        if len(tid) == 0 and len(r_i) == 0:
            return None, fallback

        # Expansion cap -> per-query host fallback (only when configured;
        # the default max_expansions=0 tiles expansions through the device).
        per_term_exp = np.bincount(jidx, minlength=total_terms)
        bad: Set[int] = (
            set(
                int(q)
                for q in flat_query[np.flatnonzero(per_term_exp > cfg.max_expansions)]
            )
            if cfg.max_expansions
            else set()
        )
        if bad:
            fallback.extend(sorted(bad))
            keep2 = ~np.isin(flat_query[jidx], np.fromiter(bad, dtype=np.int64))
            tid, jidx, jdf = tid[keep2], jidx[keep2], jdf[keep2]
            if len(tid) == 0 and len(r_i) == 0:
                return None, fallback
        jquery = flat_query[jidx]

        # Expansion boost (bm25.rs:44-55) -> premultiplied per-job scale
        # (the vectorized before_each, models/base.py DeviceScorer).
        exact = self.terms[tid] == flat_terms[jidx]
        boost = np.where(
            exact, 1.0, np.log1p(1.0 / (1.0 + self.term_lens[tid] - flat_blen[jidx]))
        )
        scale = scorer.device_term_scale(jdf, self.n_docs, boost)

        # Per-shard job words (same job order on every shard, so one static
        # class layout serves the whole mesh).  Jobs whose per-shard posting
        # list exceeds the packed-length capacity are SPLIT into parts
        # (mirroring the single-chip planner, index/device.py); the split
        # count is the max over shards so the job table stays rectangular —
        # shorter shards get zero-length tail parts (zero chunks, harmless).
        meta1 = (flat_qterm[jidx] << _LEN_BITS).astype(np.int64)
        starts_all = self.offsets_sh[:, tid]  # [n, J]
        lens_all = (self.offsets_sh[:, tid + 1] - starts_all).astype(np.int64)
        jrange = np.zeros(len(jidx), dtype=bool)
        if len(r_i):
            # Per-shard CSR follows the global term order, so a term range
            # [lo, hi) is contiguous on every shard.
            starts_all = np.concatenate(
                [starts_all, self.offsets_sh[:, lo[r_i]]], axis=1
            )
            lens_all = np.concatenate(
                [
                    lens_all,
                    (self.offsets_sh[:, hi[r_i]] - self.offsets_sh[:, lo[r_i]]).astype(
                        np.int64
                    ),
                ],
                axis=1,
            )
            jquery = np.concatenate([jquery, flat_query[r_i]])
            meta1 = np.concatenate(
                [meta1, (flat_qterm[r_i] << _LEN_BITS).astype(np.int64)]
            )
            scale = np.concatenate(
                [scale, flat_blen[r_i].astype(np.int32).view(np.float32)]
            )
            jrange = np.concatenate([jrange, np.ones(len(r_i), bool)])
        nsplit = np.maximum(
            1, (lens_all.max(axis=0) + _MAX_JOB_LEN - 1) // _MAX_JOB_LEN
        )
        if (nsplit > 1).any():
            sj = np.repeat(np.arange(lens_all.shape[1], dtype=np.int64), nsplit)
            si = _segment_arange(nsplit)
            starts_all = starts_all[:, sj] + si[None, :] * _MAX_JOB_LEN
            lens_all = np.clip(
                lens_all[:, sj] - si[None, :] * _MAX_JOB_LEN, 0, _MAX_JOB_LEN
            )
            jquery = jquery[sj]
            meta1 = meta1[sj]
            scale = scale[sj]
            jrange = jrange[sj]
        NJOBS = lens_all.shape[1]
        words = np.empty((n, NJOBS, 3), dtype=np.int32)
        words[:, :, 0] = starts_all
        words[:, :, 1] = lens_all | meta1[None, :] | (jrange.astype(np.int64) << 30)
        words[:, :, 2] = scale.view(np.int32)[None, :]
        has_range = (
            np.bincount(jquery, weights=jrange.astype(np.float64), minlength=B) > 0
        )
        if len(r_i):
            # The window packer requires each query's jobs contiguous
            # (appended range jobs broke the grouping).
            order = np.argsort(jquery, kind="stable")
            jquery = jquery[order]
            words = words[:, order]
            lens_all = lens_all[:, order]
        max_chunks = np.zeros(B, dtype=np.int64)
        # Stride-C contiguous chunks (must match the on-device expansion);
        # starts live in words[..., 0] (already range-reordered with lens).
        starts_mod = words[:, :, 0].astype(np.int64) % 128
        chunks_all = np.where(
            lens_all > 0, (starts_mod + lens_all + C - 1) // C, 0
        )  # [n, NJOBS]
        for s in range(n):
            nch = np.bincount(
                jquery, weights=chunks_all[s].astype(np.float64), minlength=B
            )
            np.maximum(max_chunks, nch.astype(np.int64), out=max_chunks)
        # Lane-budget guard (mirrors the single-chip planner): per-shard
        # chunk totals beyond one dispatch's budget degrade to the
        # vectorized host path.
        from ..index.device import DeviceIndex

        over_lanes = np.flatnonzero(
            max_chunks > DeviceIndex.LANES_PER_DISPATCH // C
        )
        if len(over_lanes):
            fallback.extend(int(q) for q in over_lanes)
            keep_j = ~np.isin(jquery, over_lanes)
            jquery = jquery[keep_j]
            words = words[:, keep_j]
            max_chunks[over_lanes] = 0
            has_range[over_lanes] = False
            if len(jquery) == 0:
                return None, fallback
        njobs = np.bincount(jquery, minlength=B)
        return (jquery, words, max_chunks, njobs, has_range), fallback

    # ------------------------------------------------------------------ #
    # zero-to-one planning (two-phase scorer; SURVEY §7 M4)                #
    # ------------------------------------------------------------------ #

    def plan_batch_z2o(self, queries: Sequence[str], tokenizer):
        """Plan a zero-to-one batch into per-shard 4-word job tables.

        Mirrors ``ops.z2o_device.plan_batch_z2o`` over the sharded index's
        single merged term view: expansions are one searchsorted range, df
        is two global live-cumsum lookups, and per-shard (start, len) come
        from ``offsets_sh``.  Only the FAST (no shared expansion nodes)
        program runs on the mesh — shared-node queries join ``fallback``
        and run the bit-exact vectorized host lockstep, like every other
        cap.  Returns ``(jquery, words int32[n, NJ, 4], qlen f32[B],
        max_chunks, njobs, fallback)`` or ``(None, ..., fallback)``.
        """
        cfg = self.config
        B = len(queries)
        n = self.n_shards
        C = self.CHUNK
        fallback: List[int] = []

        tok_lists = [list(tokenizer(q)) for q in queries]
        qlen = np.array([len(t) for t in tok_lists], dtype=np.float32)
        if self.local_slots >= (1 << 27):
            # The fast z2o sort key packs local_doc << 4 | qterm into int32
            # (fields ride as sort values, so any F works — ops/z2o_device
            # z2o_fast_step); only shards beyond the same 2^27 capacity as
            # the BM25 merge key route to the vectorized host lockstep.
            fallback.extend(range(B))
            return None, None, qlen, None, None, fallback, None
        filt = [[t for t in toks if t] for toks in tok_lists]
        max_terms = min(cfg.max_query_terms, 1 << self._qterm_bits)
        for qi, toks in enumerate(filt):
            if len(toks) > max_terms:
                fallback.append(qi)
                filt[qi] = []
        counts = np.array([len(t) for t in filt], dtype=np.int64)
        total_terms = int(counts.sum())
        if total_terms == 0 or len(self.terms) == 0:
            return None, None, qlen, None, None, fallback, None
        flat_query = np.repeat(np.arange(B, dtype=np.int64), counts)
        flat_qterm = _segment_arange(counts)
        from ..index.segment import probe_terms_fixed

        flat_terms, flat_blen = probe_terms_fixed(
            [t for toks in filt for t in toks]
        )
        lo = np.searchsorted(self.terms, flat_terms, side="left")
        hi = np.searchsorted(self.terms, np.char.add(flat_terms, _MAX_CHAR), side="left")
        nexp = hi - lo
        if nexp.max(initial=0) == 0:
            return None, None, qlen, None, None, fallback, None
        tid = np.repeat(lo, nexp) + _segment_arange(nexp)
        jidx = np.repeat(np.arange(total_terms, dtype=np.int64), nexp)
        jdf = self.g_live_cum[self.g_offsets[tid + 1]] - self.g_live_cum[self.g_offsets[tid]]
        keep = jdf > 0  # df == 0 expansions never scored (query.rs:48)
        tid, jidx = tid[keep], jidx[keep]
        if len(tid) == 0:
            return None, None, qlen, None, None, fallback, None
        jquery = flat_query[jidx]
        jqterm = flat_qterm[jidx]

        # Shared-node detection (node identity == merged tid per query):
        # those queries need the lockstep pool semantics.  They get their
        # OWN per-shard job tables (word 2 = dense per-query node id) and
        # run the exact lockstep program per shard (z2o_step is per-(doc,
        # field) local, so doc-sharding composes) —
        # host fallback only past the lockstep caps (F > 8, > 16 terms,
        # > 16384 local entry lanes).
        o3 = np.lexsort((jqterm, tid, jquery))
        samegrp = (jquery[o3][1:] == jquery[o3][:-1]) & (tid[o3][1:] == tid[o3][:-1])
        diffq = jqterm[o3][1:] != jqterm[o3][:-1]
        shared_q = np.unique(jquery[o3][1:][samegrp & diffq])
        lock_pack = None
        if len(shared_q):
            sharedm = np.isin(jquery, shared_q)
            lock_ok = self.num_fields <= 8 and self.num_fields >= 1
            qt_ok = np.ones(B, bool)
            over_terms = np.flatnonzero(counts > 16)
            if len(over_terms):
                qt_ok[over_terms] = False
            lkeep = sharedm & lock_ok & qt_ok[jquery]
            lhost = sharedm & ~(lock_ok & qt_ok[jquery])
            if lhost.any():
                fallback.extend(int(q) for q in np.unique(jquery[lhost]))
            if lkeep.any():
                lock_pack = self._build_z2o_lockstep_pack(
                    tid[lkeep], jidx[lkeep], jquery[lkeep], jqterm[lkeep],
                    flat_blen, B, fallback,
                )
            keep2 = ~sharedm
            tid, jidx, jquery, jqterm = (
                tid[keep2], jidx[keep2], jquery[keep2], jqterm[keep2]
            )
            if len(tid) == 0:
                return None, None, qlen, None, None, fallback, lock_pack

        # Entry score (zero_to_one.rs:57-58, byte lengths).
        tlen = self.term_lens[tid].astype(np.float64)
        score = (1.0 - np.abs(tlen - flat_blen[jidx]) / tlen).astype(np.float32)
        meta1 = (jqterm << _LEN_BITS).astype(np.int64)

        starts_all = self.offsets_sh[:, tid]
        lens_all = (self.offsets_sh[:, tid + 1] - starts_all).astype(np.int64)
        nsplit = np.maximum(
            1, (lens_all.max(axis=0) + _MAX_JOB_LEN - 1) // _MAX_JOB_LEN
        )
        if (nsplit > 1).any():
            sj = np.repeat(np.arange(len(tid), dtype=np.int64), nsplit)
            si = _segment_arange(nsplit)
            starts_all = starts_all[:, sj] + si[None, :] * _MAX_JOB_LEN
            lens_all = np.clip(
                lens_all[:, sj] - si[None, :] * _MAX_JOB_LEN, 0, _MAX_JOB_LEN
            )
            jquery, meta1, score = jquery[sj], meta1[sj], score[sj]
        NJOBS = lens_all.shape[1]
        words = np.zeros((n, NJOBS, 4), dtype=np.int32)
        words[:, :, 0] = starts_all
        words[:, :, 1] = lens_all | meta1[None, :]
        words[:, :, 3] = score.view(np.int32)[None, :]  # word 2 unused

        # Stride-C contiguous chunks (must match the on-device expansion).
        starts_mod = words[:, :, 0].astype(np.int64) % 128
        chunks_all = np.where(
            lens_all > 0, (starts_mod + lens_all + C - 1) // C, 0
        )
        max_chunks = np.zeros(B, dtype=np.int64)
        for s in range(n):
            nch = np.bincount(
                jquery, weights=chunks_all[s].astype(np.float64), minlength=B
            )
            np.maximum(max_chunks, nch.astype(np.int64), out=max_chunks)
        from ..index.device import DeviceIndex

        # Fast-program lanes carry no field dimension (fields are sort
        # values), so the budget is in posting chunks alone.
        over = np.flatnonzero(
            max_chunks > DeviceIndex.LANES_PER_DISPATCH // C
        )
        if len(over):
            fallback.extend(int(q) for q in over)
            keep_j = ~np.isin(jquery, over)
            jquery = jquery[keep_j]
            words = words[:, keep_j]
            max_chunks[over] = 0
            if len(jquery) == 0:
                return None, None, qlen, None, None, fallback, None
        njobs = np.bincount(jquery, minlength=B)
        return jquery, words, qlen, max_chunks, njobs, fallback, lock_pack

    def _build_z2o_lockstep_pack(
        self, tid, jidx, jquery, jqterm, flat_blen, B, fallback
    ):
        """Per-shard lockstep job tables for shared-node queries.

        Word layout matches ``ops.z2o_device.z2o_step``: (start, len |
        qterm << 26, node_id, score_f32_bits); node ids are dense per query
        over distinct merged tids (the arena-identity rule,
        zero_to_one.rs:75).  The pool semantics are per-(doc, field) and a
        doc lives on exactly one shard, so running the lockstep program per
        shard over its local postings composes exactly.  Queries past the
        lockstep lane cap (16384 LOCAL entry lanes, as on one card,
        ops/z2o_device.py) fall back to host and are appended to
        ``fallback``.  Returns ``(jquery, words[n, NJOBS, 4], max_chunks,
        njobs)`` or None.
        """
        n = self.n_shards
        C = self.CHUNK
        F = max(self.num_fields, 1)
        o = np.lexsort((tid, jquery))
        tid_o, jq_o = tid[o], jquery[o]
        newn = np.ones(len(o), bool)
        newn[1:] = (jq_o[1:] != jq_o[:-1]) | (tid_o[1:] != tid_o[:-1])
        grp = np.cumsum(newn) - 1
        qnew = np.ones(len(o), bool)
        qnew[1:] = jq_o[1:] != jq_o[:-1]
        qfirst = np.maximum.accumulate(np.where(qnew, grp, -1))
        node = np.empty(len(o), np.int64)
        node[o] = grp - qfirst

        tlen = self.term_lens[tid].astype(np.float64)
        score = (1.0 - np.abs(tlen - flat_blen[jidx]) / tlen).astype(np.float32)
        starts_all = self.offsets_sh[:, tid]
        lens_all = (self.offsets_sh[:, tid + 1] - starts_all).astype(np.int64)
        words = np.zeros((n, len(tid), 4), dtype=np.int32)
        words[:, :, 0] = starts_all
        words[:, :, 1] = lens_all | (jqterm << _LEN_BITS)[None, :]
        words[:, :, 2] = node[None, :]
        words[:, :, 3] = score.view(np.int32)[None, :]

        # Stride-C contiguous chunks (must match the on-device expansion).
        starts_mod = words[:, :, 0].astype(np.int64) % 128
        chunks_all = np.where(
            lens_all > 0, (starts_mod + lens_all + C - 1) // C, 0
        )
        max_chunks = np.zeros(B, dtype=np.int64)
        for s in range(n):
            nch = np.bincount(
                jquery, weights=chunks_all[s].astype(np.float64), minlength=B
            )
            np.maximum(max_chunks, nch.astype(np.int64), out=max_chunks)
        nc_bucket = _bucket_vec(max_chunks, self.NC_BUCKETS, 4)
        over = np.flatnonzero((max_chunks > 0) & (nc_bucket * C * F > 16384))
        if len(over):
            fallback.extend(int(q) for q in over)
            keep = ~np.isin(jquery, over)
            jquery, words = jquery[keep], words[:, keep]
            if len(jquery) == 0:
                return None
        njobs = np.bincount(jquery, minlength=B)
        return jquery, words, max_chunks, njobs

    def _get_z2o_window_step(
        self, class_specs, k: int, lockstep: bool = False, fmt: str = "f32"
    ):
        key = ("z2o_lock" if lockstep else "z2o", class_specs, k, fmt)
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn

        from ..ops.z2o_device import z2o_fast_step, z2o_step

        mesh = self.mesh
        n = self.n_shards
        C = self.CHUNK
        F = self.num_fields

        def per_cell(rec_blk, words_blk, qlen_blk):
            rec_l = rec_blk[0]
            w = words_blk[0, 0]
            ql = qlen_blk[0, 0]
            outs = []
            off = 0
            qoff = 0
            for b_pad, b_out, nj, nc in class_specs:
                nwords = b_pad * nj * 4
                jobs_l = w[off : off + nwords].reshape(b_pad, nj * 4)
                off += nwords
                ql_c = ql[qoff : qoff + b_pad]
                qoff += b_pad
                kk = min(k, nc * C * max(F, 1))
                if lockstep:
                    # Exact pool-consumption program per shard (z2o_step is
                    # per-(doc, field) local; doc-sharding composes).
                    s, d_local = z2o_step(
                        chunk=C,
                        k=kk,
                        num_fields=F,
                        num_chunks=nc,
                        rec=rec_l,
                        jobs_flat=jobs_l,
                        qlen=ql_c,
                    )
                else:
                    s, d_local = z2o_fast_step(
                        chunk=C,
                        k=kk,
                        num_fields=F,
                        num_chunks=nc,
                        rec=rec_l,
                        jobs_flat=jobs_l,
                        qlen=ql_c,
                    )
                # Drop pow-2 pad rows before the collective and the fetch.
                s = s[:b_out]
                d_local = d_local[:b_out]
                if kk < k:
                    s = jnp.pad(s, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
                    d_local = jnp.pad(d_local, ((0, 0), (0, k - kk)), constant_values=-1)
                outs.append((s, d_local))
            scores = jnp.concatenate([o[0] for o in outs], axis=0)
            docs_local = jnp.concatenate([o[1] for o in outs], axis=0)
            shard_id = jax.lax.axis_index("docs")
            docs_global = jnp.where(docs_local >= 0, docs_local * n + shard_id, -1)
            s_all = jax.lax.all_gather(scores, "docs")
            d_all = jax.lax.all_gather(docs_global, "docs")
            SB = scores.shape[0]
            s_cat = jnp.moveaxis(s_all, 0, 1).reshape(SB, n * k)
            d_cat = jnp.moveaxis(d_all, 0, 1).reshape(SB, n * k)
            # 2-key sort (score desc, global slot asc): deterministic tie
            # order matching the single-chip engine and the host oracle
            # (lax.top_k alone breaks ties by shard-concat position).
            neg_s, d = jax.lax.sort((-s_cat, d_cat), dimension=1, num_keys=2)
            v = -neg_s[:, :k]
            d = d[:, :k]
            d = jnp.where(jnp.isfinite(v), d, -1)
            packed = pack_result_rows(v, d, fmt)
            return packed[None, None]

        fn = jax.jit(
            jax.shard_map(
                per_cell,
                mesh=mesh,
                in_specs=(
                    P("docs", None, None),
                    P("docs", "data", None),
                    P("docs", "data", None),
                ),
                # slots20 packs each row to a flat byte vector (rank-4
                # window output); the other formats keep [.., {2,3}, k].
                out_specs=P("docs", "data", *([None] * (2 if fmt == "slots20" else 3))),
            )
        )
        self._step_cache[key] = fn
        return fn

    def query_batch_z2o(
        self,
        queries: Sequence[str],
        scorer=None,
        tokenizer=whitespace_tokenizer,
        top_k: Optional[int] = None,
    ) -> "ShardedPendingBatch":
        """Async zero-to-one batch over the mesh.  Shared-node queries run
        the exact lockstep program per shard as a second dispatch; only
        cap-exceeding queries run the vectorized host lockstep.  Drain via
        ``.get()`` / ``.get_arrays()``."""
        from ..models import zero_to_one as _z2o
        from ..utils.metrics import metrics

        k = top_k or self.config.default_top_k
        B = len(queries)
        metrics.inc("sharded_queries_submitted", B)
        with metrics.timer("sharded/plan"):
            (
                jquery, words, qlen, max_chunks, njobs, fallback, lock_pack,
            ) = self.plan_batch_z2o(queries, tokenizer)
        host_rows = None
        if fallback:
            metrics.inc("device_fallback_queries", len(fallback))
            from ..index.device import _host_fallback_policy

            _host_fallback_policy(
                self.config, len(fallback), "sharded z2o plan caps exceeded"
            )
            plain = scorer is None or type(scorer) is _z2o.ZeroToOne
            host_rows = {
                qi: (
                    _z2o.ZeroToOne.vectorized_query(
                        self._index, queries[qi], tokenizer, top_k=k
                    )
                    if plain
                    else self._index.query(
                        queries[qi], scorer, tokenizer,
                        [1.0] * self.num_fields, top_k=k,
                    )
                )
                for qi in fallback
            }
        if jquery is None and lock_pack is None:
            return ShardedPendingBatch(self, B, None, None, host_rows, k=k)
        n = self.n_shards
        d_ax = int(self.mesh.shape["data"])

        def pack_classes(jquery_p, words_p, max_chunks_p, njobs_p, qlen_p):
            nc_bucket = _bucket_vec(max_chunks_p, self.nc_buckets, self.nc_min)
            class_specs = []
            layout = []
            flat_parts = [[] for _ in range(n)]
            qlen_parts = []
            row_base = 0
            for nc in np.unique(nc_bucket):
                nc = int(nc)
                members = np.flatnonzero((nc_bucket == nc) & (njobs_p > 0))
                if len(members) == 0:
                    continue
                nj = _bucket(int(njobs_p[members].max()), self.NJ_BUCKETS, 4)
                b_pad = max(8, 1 << (-(-len(members) // d_ax) - 1).bit_length())
                rank = np.arange(len(members))
                drow = rank // b_pad
                dslot = rank % b_pad
                # Kept output rows per data cell (pad-row trim, see the
                # BM25 window packer above).
                b_out = min(b_pad, -(-min(len(members), b_pad) // 256) * 256)
                jobs_cls = np.zeros((n, d_ax, b_pad, nj, 4), dtype=np.int32)
                sel = np.isin(jquery_p, members)
                jq = jquery_p[sel]
                pos = _segment_arange(np.bincount(jq, minlength=B)[members])
                r = np.searchsorted(members, jq)
                jobs_cls[:, drow[r], dslot[r], pos] = words_p[:, sel]
                qlen_cls = np.ones((d_ax, b_pad), np.float32)
                qlen_cls[drow, dslot] = qlen_p[members]
                for s in range(n):
                    flat_parts[s].append(jobs_cls[s].reshape(d_ax, -1))
                qlen_parts.append(qlen_cls)
                class_specs.append((b_pad, b_out, nj, nc))
                layout.append((members, drow, dslot, row_base))
                row_base += b_out
            if not class_specs:
                return None
            buf = np.stack([np.concatenate(parts, axis=1) for parts in flat_parts])
            qcat = np.concatenate(qlen_parts, axis=1)  # [d_ax, total_rows]
            qbuf = np.broadcast_to(qcat[None], (n,) + qcat.shape).copy()
            return class_specs, layout, buf, qbuf

        dispatches = []  # (packed, layout) pairs
        sharding = NamedSharding(self.mesh, P("docs", "data", None))
        with metrics.timer("sharded/pack"):
            packs = []
            if jquery is not None:
                fast = pack_classes(jquery, words, max_chunks, njobs, qlen)
                if fast is not None:
                    packs.append((fast, False))
            if lock_pack is not None:
                ljq, lwords, lmax_chunks, lnjobs = lock_pack
                metrics.inc("z2o_sharded_lockstep_queries", int((lnjobs > 0).sum()))
                lock = pack_classes(ljq, lwords, lmax_chunks, lnjobs, qlen)
                if lock is not None:
                    packs.append((lock, True))
            if not packs:
                return ShardedPendingBatch(self, B, None, None, host_rows, k=k)

        fmt = resolve_result_format(
            self.config.effective_result_format(), self.num_slots
        )
        with metrics.timer("sharded/dispatch"):
            for (class_specs, layout, buf, qbuf), is_lock in packs:
                step = self._get_z2o_window_step(
                    tuple(class_specs), k, lockstep=is_lock, fmt=fmt
                )
                buf_dev = jax.device_put(buf, sharding)
                q_dev = jax.device_put(qbuf, sharding)
                dispatches.append((step(self.rec, buf_dev, q_dev), layout))
        if getattr(self.config, "prefetch_results", False):
            for d, _ in dispatches:
                d.copy_to_host_async()
        return ShardedPendingBatch(
            self,
            B,
            [d[0] for d in dispatches],
            [d[1] for d in dispatches],
            host_rows,
            k=k,
            fmt=fmt,
        )

    # ------------------------------------------------------------------ #
    # execution                                                           #
    # ------------------------------------------------------------------ #

    def _get_window_step(self, scorer, class_specs, k: int, fmt: str = "f32"):
        key = (
            getattr(scorer, "device_cache_key", lambda: ("id", id(scorer)))(),
            class_specs,
            k,
            fmt,
        )
        fn = self._step_cache.get(key)
        if fn is not None:
            return fn

        from ..index.device import _query_step_impl

        mesh = self.mesh
        n = self.n_shards
        C = self.CHUNK
        qb = self._qterm_bits

        def per_cell(rec_blk, words_blk, field_avg, fields_boost, aux_blk):
            rec_l = rec_blk[0]  # [R, Pmax + C]
            w = words_blk[0, 0]  # [total_words] int32
            aux_l = aux_blk[0]
            outs = []
            off = 0
            for b_pad, b_out, nj, nc, rng in class_specs:
                nwords = b_pad * nj * 3
                jobs_l = w[off : off + nwords].reshape(b_pad, nj * 3)
                off += nwords
                kk = min(k, nc * C)
                s, d_local = _query_step_impl(
                    scorer,
                    chunk=C,
                    k=kk,
                    qterm_bits=qb,
                    num_fields=self.num_fields,
                    num_chunks=nc,
                    rec=rec_l,
                    field_avg=field_avg,
                    fields_boost=fields_boost,
                    jobs_flat=jobs_l,
                    aux=aux_l,
                    use_ranges=rng,
                )
                # b_out <= b_pad: pow-2 pad rows beyond the real query
                # count are dropped BEFORE the collective and the packed
                # fetch (the O(k) all-gather and the drain pay per row).
                s = s[:b_out]
                d_local = d_local[:b_out]
                if kk < k:
                    s = jnp.pad(s, ((0, 0), (0, k - kk)), constant_values=-jnp.inf)
                    d_local = jnp.pad(d_local, ((0, 0), (0, k - kk)), constant_values=-1)
                outs.append((s, d_local))
            scores = jnp.concatenate([o[0] for o in outs], axis=0)  # [SB, k]
            docs_local = jnp.concatenate([o[1] for o in outs], axis=0)
            shard_id = jax.lax.axis_index("docs")
            docs_global = jnp.where(docs_local >= 0, docs_local * n + shard_id, -1)
            # Merge per-shard top-k: all-gather O(k) values, reduce.
            s_all = jax.lax.all_gather(scores, "docs")  # [n, SB, k]
            d_all = jax.lax.all_gather(docs_global, "docs")
            SB = scores.shape[0]
            s_cat = jnp.moveaxis(s_all, 0, 1).reshape(SB, n * k)
            d_cat = jnp.moveaxis(d_all, 0, 1).reshape(SB, n * k)
            # 2-key sort (score desc, global slot asc): deterministic tie
            # order matching the single-chip engine and the host oracle
            # (lax.top_k alone breaks ties by shard-concat position).
            neg_s, d = jax.lax.sort((-s_cat, d_cat), dimension=1, num_keys=2)
            v = -neg_s[:, :k]
            d = d[:, :k]
            d = jnp.where(jnp.isfinite(v), d, -1)
            # Rankings are fixed in f32 above; the format only changes what
            # the D2H drain moves (shared with the single-chip engine).
            packed = pack_result_rows(v, d, fmt)
            return packed[None, None]  # [1, 1, SB, ...]

        fn = jax.jit(
            jax.shard_map(
                per_cell,
                mesh=mesh,
                in_specs=(
                    P("docs", None, None),
                    P("docs", "data", None),
                    P(),
                    P(),
                    P("docs", None, None),
                ),
                # slots20 packs each row to a flat byte vector (rank-4
                # window output); the other formats keep [.., {2,3}, k].
                out_specs=P("docs", "data", *([None] * (2 if fmt == "slots20" else 3))),
            )
        )
        self._step_cache[key] = fn
        return fn

    def query_batch(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> List[List[QueryResult]]:
        """Blocking convenience over :meth:`query_batch_async`."""
        return self.query_batch_async(
            queries, scorer, tokenizer, fields_boost, top_k
        ).get()

    def query_batch_async(
        self,
        queries: Sequence[str],
        scorer,
        tokenizer=whitespace_tokenizer,
        fields_boost: Optional[Sequence[float]] = None,
        top_k: Optional[int] = None,
    ) -> "ShardedPendingBatch":
        from ..utils.metrics import metrics

        if fields_boost is None:
            fields_boost = [1.0] * self.num_fields
        k = top_k or self.config.default_top_k
        B = len(queries)
        metrics.inc("sharded_queries_submitted", B)
        with metrics.timer("sharded/plan"):
            planned, fallback = self.plan_batch(
                queries, tokenizer, scorer, with_rows=True
            )
        pool_rows = plan_qp = plan_qids = None
        if planned is not None:
            planned, (pool_rows, plan_qp, plan_qids) = planned[:5], planned[5]
        host_rows = None
        if fallback:
            metrics.inc("device_fallback_queries", len(fallback))
            from ..index.device import _host_fallback_policy

            _host_fallback_policy(
                self.config, len(fallback), "sharded plan caps exceeded"
            )
            vq = getattr(scorer, "vectorized_query", None)
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
        if planned is None:
            return ShardedPendingBatch(self, B, None, None, host_rows, k=k)
        # Sharded block-max pruning (index/prune.py prune_plan_sharded):
        # trim-only — per-shard jobs lose provably-hopeless leading /
        # trailing chunks, job rows stay shard-aligned.  Exact (bit-equal
        # results, tests/test_sharding.py).  Decisions are memoized per
        # (pooled query, k, boosts) like the single-chip engine's.
        if (
            getattr(self.config, "prune_blocks", True)
            and plan_qp is not None
            and "prune_sh" in plan_qp
        ):
            from ..index.prune import prune_plan_sharded_cached

            with metrics.timer("sharded/prune"):
                planned = prune_plan_sharded_cached(
                    self, planned, pool_rows, plan_qp, plan_qids, k,
                    fields_boost,
                )
        fmt = resolve_result_format(
            self.config.effective_result_format(), self.num_slots
        )

        with metrics.timer("sharded/pack"):
            class_specs, layout, buf = self._pack_window(planned, B)
        if not class_specs:
            return ShardedPendingBatch(self, B, None, None, host_rows, k=k)

        any_ranges = any(rng for *_s, rng in class_specs)
        aux = self._aux_rec(scorer) if any_ranges else self._aux_dummy()
        step = self._get_window_step(scorer, tuple(class_specs), k, fmt)
        with metrics.timer("sharded/dispatch"):
            buf_dev = jax.device_put(buf, NamedSharding(self.mesh, P("docs", "data", None)))
            packed = step(
                self.rec,
                buf_dev,
                self.field_avg,
                jnp.asarray(np.asarray(fields_boost, dtype=np.float32)),
                aux,
            )
        if getattr(self.config, "prefetch_results", False):
            # Stream the replicated packed result to host behind later
            # device work (config.prefetch_results).
            packed.copy_to_host_async()
        return ShardedPendingBatch(self, B, packed, layout, host_rows, k=k, fmt=fmt)

    def _pack_window(self, planned, B):
        """Pack a planned window into (class_specs, layout, buf).

        Shape classes (same bucketing as the single-chip engine), packed
        into one flat per-(shard, data-cell) ``buf`` [n, d_ax, words].
        Range-carrying queries form separate classes (aux gather +
        full-sort merge), padded to at most 2 rows per data cell, like
        the single-chip packer's range classes.

        Vectorized like the single-card packer: one
        stable class argsort of the queries, per-job destinations by
        direct lookup (jquery is repeat(arange(B), njobs), so query q's
        job rows start at the exclusive njobs cumsum), and ONE scatter of
        all jobs into the flat buffer, instead of a per-class np.isin over
        every job row and dense [n, d_ax, b_pad, nj, 3] zero-fills.
        Returns ([], [], None) for an all-empty window.
        """
        jquery, words, max_chunks, njobs, has_range = planned
        n = self.n_shards
        d_ax = int(self.mesh.shape["data"])
        nc_bucket = _bucket_vec(max_chunks, self.nc_buckets, self.nc_min)
        alive = njobs > 0
        # Class id: (range flag, nc bucket) — range classes sort last,
        # matching the previous packer's class order so frozen window
        # programs keep their identity.
        cls_q = np.where(
            alive, nc_bucket + (has_range.astype(np.int64) << 32), -1
        )
        order = np.argsort(cls_q, kind="stable")
        scls = cls_q[order]
        first = int(np.searchsorted(scls, 0))
        qorder, qcls = order[first:], scls[first:]
        if len(qorder) == 0:
            return [], [], None
        jpos = np.zeros(B, dtype=np.int64)
        np.subtract(np.cumsum(njobs), njobs, out=jpos)
        cbounds = np.flatnonzero(np.r_[True, qcls[1:] != qcls[:-1], True])
        class_specs = []
        layout = []  # (query_indices, data_rows, data_slots, row_offset)
        spans = []  # (members, drow, dslot, nj, col_off)
        row_base = col_off = 0
        for ci in range(len(cbounds) - 1):
            cls = int(qcls[cbounds[ci]])
            nc, rng_mode = cls & 0xFFFFFFFF, bool(cls >> 32)
            all_members = qorder[cbounds[ci] : cbounds[ci + 1]]
            nj = _bucket(int(njobs[all_members].max()), self.NJ_BUCKETS, 4)
            step_sz = (2 * d_ax) if rng_mode else len(all_members)
            for s0 in range(0, len(all_members), step_sz):
                members = all_members[s0 : s0 + step_sz]
                b_pad = max(
                    1 if rng_mode else 8,
                    1 << (-(-len(members) // d_ax) - 1).bit_length(),
                )
                rank = np.arange(len(members))
                drow = rank // b_pad
                dslot = rank % b_pad
                # Output rows kept per data cell: the max occupancy of
                # any cell (cell 0 fills first) rounded up to a coarse
                # 256 granularity — drops most pow-2 pad rows from the
                # collective and the D2H fetch while keeping window
                # compositions (= compiles) few.
                b_out = min(b_pad, -(-min(len(members), b_pad) // 256) * 256)
                class_specs.append((b_pad, b_out, nj, nc, rng_mode))
                layout.append((members, drow, dslot, row_base))
                spans.append((members, drow, dslot, nj, col_off))
                row_base += b_out
                col_off += b_pad * nj * 3
        # One scatter: per-job (data row, flat column) destinations.
        src_p, dr_p, dc_p = [], [], []
        for members, drow, dslot, nj, coff in spans:
            qnj = njobs[members]
            r = np.repeat(np.arange(len(members), dtype=np.int64), qnj)
            pos = _segment_arange(qnj)
            src_p.append(np.repeat(jpos[members], qnj) + pos)
            dr_p.append(drow[r])
            dc_p.append(coff + (dslot[r] * nj + pos) * 3)
        src = np.concatenate(src_p)
        dr = np.concatenate(dr_p)
        dc = np.concatenate(dc_p)
        buf = np.zeros((n, d_ax, col_off), dtype=np.int32)
        for i in range(3):
            buf[:, dr, dc + i] = words[:, src, i]
        return class_specs, layout, buf

    def _aux_dummy(self):
        d = self._aux_cache.get("dummy")
        if d is None:
            d = jax.device_put(
                np.zeros((self.n_shards, 4, 8), np.int32),
                NamedSharding(self.mesh, P("docs", None, None)),
            )
            self._aux_cache["dummy"] = d
        return d


class ShardedPendingBatch:
    """Handle for an in-flight sharded query window."""

    def __init__(
        self, sdix, n, packed, layout, host_rows=None, k=None, fmt="f32"
    ) -> None:
        self._sdix = sdix
        self._n = n
        # One dispatch (BM25 window) or a list of them (z2o fast +
        # lockstep); each packed is [n_shards, d_ax, SB, ...] (replicated
        # over docs; trailing dims per result format) with its own layout.
        self._packed = packed
        self._layout = layout
        self._host_rows = host_rows
        self._fmt = fmt
        # The submitted top_k: sizes the all-host-fallback result arrays
        # (get_arrays must agree with get() when top_k != default_top_k).
        self._k = k if k is not None else sdix.config.default_top_k

    def get(self) -> List[List[QueryResult]]:
        """QueryResult rows, assembled through the columnar drain (nested
        per-member Python loops cost more than the device work at large
        windows)."""
        if self._fmt.startswith("slots") and self._packed is not None:
            raise ValueError(
                "result_format='slots'/'slots20' windows carry no scores; use "
                "get_arrays() (ranked slots/keys) or a score-carrying "
                "result_format for QueryResult rows"
            )
        scores, slots, keys = self.get_arrays()
        results: List[List[QueryResult]] = [[] for _ in range(self._n)]
        valid = (
            np.isfinite(scores) if scores is not None else slots >= 0
        )
        obj_keys = keys.dtype == object if keys is not None else False
        for qi in range(self._n):
            if self._host_rows and qi in self._host_rows:
                results[qi] = self._host_rows[qi]
                continue
            m = valid[qi]
            if not m.any():
                continue
            results[qi] = [
                QueryResult(key=kk if obj_keys else int(kk), score=float(s))
                for s, kk in zip(scores[qi][m], keys[qi][m])
            ]
        return results

    def get_arrays(self, want_keys: bool = True):
        """Raw columnar results — the serving surface (mirrors
        ``PendingBatch.get_arrays``): ``(scores f32[n, k] | None, slots
        int32[n, k], keys[n, k])`` in query order.  VALIDITY MASK: ``slots
        >= 0`` (``slots`` is the GLOBAL doc slot); invalid entries carry
        score ``-inf`` when scores are present.  Under the slots formats
        the window carries no scores and ``scores`` is ``None`` (rankings
        are still exact: columns are in descending-score order).
        Per-result Python object construction costs more than the device
        work at large windows; multi-chip serving must drain through this.
        """
        from ..utils.metrics import metrics

        sdix = self._sdix
        slots_only = self._fmt.startswith("slots")
        with metrics.timer("sharded/drain"):
            if self._packed is None:
                k = self._k
                scores = np.full((self._n, k), -np.inf, np.float32)
                slots = np.full((self._n, k), -1, np.int32)
            else:
                many = isinstance(self._packed, list)
                packs = self._packed if many else [self._packed]
                layouts = self._layout if many else [self._layout]
                k = self._k
                scores = (
                    None if slots_only else np.full((self._n, k), -np.inf, np.float32)
                )
                slots = np.full((self._n, k), -1, np.int32)
                for packed_dev, layout in zip(packs, layouts):
                    with metrics.timer("sharded/fetch"):
                        host = np.asarray(packed_dev)[0]  # [d_ax, SB, ...]
                    d_ax, SB = host.shape[0], host.shape[1]
                    p_scores, p_slots = unpack_result_rows(
                        host.reshape((d_ax * SB,) + host.shape[2:]), self._fmt, k
                    )
                    p_slots = p_slots.reshape(d_ax, SB, k)
                    if p_scores is not None:
                        p_scores = p_scores.reshape(d_ax, SB, k)
                    for members, drow, dslot, row_base in layout:
                        if scores is not None:
                            scores[members] = p_scores[drow, row_base + dslot]
                        slots[members] = p_slots[drow, row_base + dslot]
                if scores is not None:
                    slots = np.where(np.isfinite(scores), slots, -1)
            keys = None
            if want_keys:
                if not sdix.slot_to_key:
                    # Empty index: every slot is -1; an eager gather on a
                    # zero-length key array would IndexError.
                    keys = np.full(slots.shape, None, dtype=object)
                elif all(type(x) is int for x in sdix.slot_to_key):
                    karr = np.asarray(sdix.slot_to_key, dtype=np.int64)
                    keys = karr[np.clip(slots, 0, None)]
                else:
                    karr = np.empty(len(sdix.slot_to_key), dtype=object)
                    karr[:] = sdix.slot_to_key
                    valid = slots >= 0
                    keys = np.where(valid, karr[np.where(valid, slots, 0)], None)
            if self._host_rows:
                k2s = sdix._index._key_to_slot
                for qi, row in self._host_rows.items():
                    m = min(len(row), slots.shape[1])
                    if scores is not None:
                        scores[qi, :m] = [r.score for r in row[:m]]
                    slots[qi, :] = -1
                    # Host-fallback rows keep the ``slots >= 0`` validity
                    # contract (the only mask under the slots formats).
                    slots[qi, :m] = [k2s.get(r.key, -1) for r in row[:m]]
                    if keys is not None:
                        if keys.dtype == object:
                            keys[qi, :] = None
                        keys[qi, :m] = [r.key for r in row[:m]]
        return scores, slots, keys
