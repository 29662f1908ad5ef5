#!/usr/bin/env python
"""End-to-end smoke run of the device serving path on a GPU.

    python chip_smoke.py            # one card: device, bm25, prefix, z2o, mutate
    python chip_smoke.py --mesh 4   # the doc-sharded path over 4 cards only

Phases, each checked against the exact f64 host oracle (``Index.query``):

* device  — JAX must report a GPU; prints its kind and count, the card's
            name and power limit (nvidia-smi), and whether the native host
            runtime loaded.
* bm25    — the bench corpus (1M docs x 8 tokens, Zipf(1.07) over 50k
            terms, seed 0), 16384-query windows of 3-term queries at
            top-10; recall@10 must be 1.0 and the worst relative score
            error at most 2e-5 on 256 queries.
* prefix  — single- and two-character prefix queries (term-range jobs) and
            a second hit of the heavy-query cache, ranked like the oracle.
* z2o     — the zero-to-one corpus (50k docs, 2 fields), 2-term windows
            plus a duplicate-term query (the exact lockstep program).
* mutate  — remove a top hit, re-query, vacuum, re-query.

``--mesh N`` attaches a ("data", "docs") = (1, N) mesh and runs only the
bm25 and z2o phases through the sharded engine.  Every phase is a function
of its sizes; none catches its own failure.  Any failed check raises, so
the process exits non-zero and prints no result.  The last stdout line is
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

REL_TOL = 2e-5  # device f32 vs the f64 oracle (README parity contract)


def say(msg: str) -> None:
    print(msg, flush=True)


def _rel_err(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


# --------------------------------------------------------------------------- #
# phases                                                                      #
# --------------------------------------------------------------------------- #


def device_phase(n_devices: int = 1) -> dict:
    """Fail unless JAX sees at least ``n_devices`` GPUs; describe them."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU visible to JAX (platform {devs[0].platform!r}); this "
            "smoke run measures the card and has no CPU mode"
        )
    if len(devs) < n_devices:
        raise RuntimeError(f"{n_devices} GPUs wanted, JAX sees {len(devs)}")
    say(f"device: platform={devs[0].platform} kind={devs[0].device_kind} count={len(devs)}")
    from bench import card_name_and_power_limit

    for line in card_name_and_power_limit():
        say(f"card: {line}")
    from probly_search_tpu.native import native_available

    say(f"native host runtime loaded: {native_available()}")
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def _check_bm25(ix, queries, scores, slots, keys, top_k):
    """(recall@k, worst relative score error) of device rows vs the oracle."""
    from probly_search_tpu import bm25, whitespace_tokenizer

    hits = total = 0
    worst = 0.0
    for qi, q in enumerate(queries):
        want = ix.query(
            q, bm25.new(), whitespace_tokenizer, [1.0] * ix.num_fields, top_k=top_k
        )
        valid = slots[qi] >= 0
        got_keys = [int(k) for k in keys[qi][valid]]
        got_scores = scores[qi][valid]
        hits += len({r.key for r in want} & set(got_keys))
        total += len(want)
        if len(got_keys) != len(want):
            raise AssertionError(f"{q!r}: {len(got_keys)} rows, oracle {len(want)}")
        for s, r in zip(got_scores, want):
            worst = max(worst, _rel_err(float(s), r.score))
    return hits / max(total, 1), worst


def bm25_phase(
    n_docs: int,
    vocab_size: int = 50_000,
    window: int = 16384,
    n_windows: int = 3,
    n_check: int = 256,
    top_k: int = 10,
    mesh=None,
):
    """Serve BM25 windows over the bench corpus; returns the index."""
    from bench import make_corpus, make_queries
    from probly_search_tpu import Index, IndexConfig, bm25
    from probly_search_tpu.utils.metrics import metrics

    t0 = time.perf_counter()
    vocab, cdf, texts = make_corpus(n_docs, vocab_size, 8, seed=0)
    ix = Index(1, config=IndexConfig(result_format="f32", host_fallback="error"))
    ix.add_documents_columnar(list(range(n_docs)), [texts])
    t1 = time.perf_counter()
    if mesh is not None:
        ix.attach_mesh(mesh)
        ix.sharded_index()
    else:
        ix.device_index()
    t2 = time.perf_counter()
    say(f"bm25: {n_docs} docs built in {t1 - t0:.2f}s, device snapshot {t2 - t1:.2f}s")

    queries = make_queries(vocab, cdf, window * n_windows, 3)
    windows = [queries[i : i + window] for i in range(0, len(queries), window)]
    scorer = bm25.new()
    metrics.reset()
    t3 = time.perf_counter()
    for w in windows:  # first pass: compiles every window program
        ix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    t4 = time.perf_counter()
    for w in windows:
        ix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    t5 = time.perf_counter()
    fallback = int(metrics.snapshot()["counters"].get("device_fallback_queries", 0))
    if fallback:
        raise AssertionError(f"bm25: {fallback} queries degraded to the host")
    say(
        f"bm25: compile+first pass {t4 - t3:.2f}s (set-up); steady "
        f"{len(windows) / (t5 - t4):.3f} windows/s of {window} queries "
        f"(information only); host-fallback queries {fallback}"
    )

    sample = queries[:n_check]
    scores, slots, keys = ix.query_batch_async(sample, scorer, top_k=top_k).get_arrays()
    recall, worst = _check_bm25(ix, sample, scores, slots, keys, top_k)
    say(f"bm25: recall@{top_k} {recall} worst rel err {worst:.3e} on {len(sample)} queries")
    if recall != 1.0 or worst > REL_TOL:
        raise AssertionError(f"bm25 parity failed: recall {recall}, worst {worst}")
    say(f"bm25: peak_bytes_in_use {_peak_bytes()}")
    return ix


def prefix_phase(ix, prefixes, heavy: str, top_k: int = 10) -> None:
    """Prefix queries (term-range jobs) and the heavy-query cache's second
    hit, ranked like the oracle."""
    from probly_search_tpu import bm25, whitespace_tokenizer
    from probly_search_tpu.utils.metrics import metrics

    scorer = bm25.new()
    metrics.reset()
    qs = list(prefixes) + [heavy]
    plan, fb = ix.device_index().plan_batch(qs, whitespace_tokenizer, scorer)
    if fb or plan is None or not plan.has_range.all():
        raise AssertionError(f"prefix: not all term-range jobs ({fb}, {plan})")
    t0 = time.perf_counter()
    first = ix.query_batch_async(qs, scorer, top_k=top_k).get_arrays()
    t1 = time.perf_counter()
    second = ix.query_batch_async([heavy], scorer, top_k=top_k).get_arrays()
    counters = metrics.snapshot()["counters"]
    if counters.get("heavy_cache_hits", 0) < 1:
        raise AssertionError(f"prefix: heavy cache never hit ({counters})")
    for a, b in zip(second, (x[-1:] for x in first)):
        np.testing.assert_array_equal(a, b)
    recall, worst = _check_bm25(ix, qs, *first, top_k)
    say(
        f"prefix: {qs} served in {t1 - t0:.2f}s; heavy-cache hits "
        f"{int(counters['heavy_cache_hits'])}; recall@{top_k} {recall} "
        f"worst rel err {worst:.3e}"
    )
    if recall != 1.0 or worst > REL_TOL:
        raise AssertionError(f"prefix parity failed: recall {recall}, worst {worst}")


def _check_z2o(ix, queries, scores, slots, keys, top_k):
    """Worst relative error of z2o rows vs the oracle.  Score lists must
    match rank by rank and every key must carry its oracle score (z2o
    tie order among equal scores is documented as free)."""
    from probly_search_tpu import whitespace_tokenizer, zero_to_one

    worst = 0.0
    for qi, q in enumerate(queries):
        full = ix.query(q, zero_to_one.new(), whitespace_tokenizer, [1.0] * ix.num_fields)
        by_key = {r.key: r.score for r in full}
        want = [r.score for r in full[:top_k]]
        valid = slots[qi] >= 0
        got = scores[qi][valid]
        if len(got) != len(want):
            raise AssertionError(f"{q!r}: {len(got)} rows, oracle {len(want)}")
        for s, w in zip(got, want):
            worst = max(worst, _rel_err(float(s), w))
        for s, k in zip(got, keys[qi][valid]):
            worst = max(worst, _rel_err(float(s), by_key[int(k)]))
    return worst


def z2o_phase(
    n_docs: int,
    window: int = 16384,
    n_windows: int = 2,
    n_check: int = 256,
    top_k: int = 10,
    mesh=None,
):
    """Serve zero-to-one windows over the 2-field corpus; returns the index
    and a sample query."""
    from bench import make_z2o_corpus
    from probly_search_tpu import Index, IndexConfig, zero_to_one
    from probly_search_tpu.utils.metrics import metrics

    titles, bodies, queries = make_z2o_corpus(n_docs, window * n_windows)
    ix = Index(2, config=IndexConfig(result_format="f32", host_fallback="error"))
    ix.add_documents_columnar(list(range(n_docs)), [titles, bodies])
    if mesh is not None:
        ix.attach_mesh(mesh)
    # A duplicate-term query shares its expansion nodes: the exact
    # lockstep program serves it.
    dup = f"{queries[0].split()[0]} {queries[0].split()[0]}"
    windows = [queries[i : i + window] for i in range(0, len(queries), window)]
    scorer = zero_to_one.new()
    metrics.reset()
    t0 = time.perf_counter()
    for w in windows:
        ix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    t1 = time.perf_counter()
    for w in windows:
        ix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    t2 = time.perf_counter()
    sample = queries[: n_check - 1] + [dup]
    scores, slots, keys = ix.query_batch_async(sample, scorer, top_k=top_k).get_arrays()
    counters = metrics.snapshot()["counters"]
    fallback = int(counters.get("device_fallback_queries", 0))
    if fallback:
        raise AssertionError(f"z2o: {fallback} queries degraded to the host")
    worst = _check_z2o(ix, sample, scores, slots, keys, top_k)
    say(
        f"z2o: {n_docs} docs x 2 fields; compile+first pass {t1 - t0:.2f}s "
        f"(set-up); steady {len(windows) / (t2 - t1):.3f} windows/s of "
        f"{window} queries (information only); worst rel err {worst:.3e} on "
        f"{len(sample)} queries incl. {dup!r}; host-fallback queries {fallback}"
    )
    if worst > REL_TOL:
        raise AssertionError(f"z2o parity failed: worst {worst}")
    say(f"z2o: peak_bytes_in_use {_peak_bytes()}")
    return ix, queries[0]


def mutate_phase(ix, query: str, top_k: int = 10) -> None:
    """Remove the top hit of ``query``; it never returns, before or after
    vacuum, and the rows stay equal to the oracle."""
    from probly_search_tpu import bm25

    scorer = bm25.new()
    _s, slots, keys = ix.query_batch_async([query], scorer, top_k=top_k).get_arrays()
    if slots[0][0] < 0:
        raise AssertionError(f"mutate: {query!r} has no hit to remove")
    removed = int(keys[0][0])
    ix.remove_document(removed)
    for stage in ("removed", "vacuumed"):
        if stage == "vacuumed":
            ix.vacuum()
        rows = ix.query_batch_async([query], scorer, top_k=top_k).get_arrays()
        if removed in {int(k) for k, s in zip(rows[2][0], rows[1][0]) if s >= 0}:
            raise AssertionError(f"mutate: removed key {removed} returned ({stage})")
        blocking = ix.query_batch([query], scorer, top_k=top_k)[0]
        if removed in {r.key for r in blocking}:
            raise AssertionError(f"mutate: removed key {removed} returned ({stage})")
        recall, worst = _check_bm25(ix, [query], *rows, top_k)
        if recall != 1.0 or worst > REL_TOL:
            raise AssertionError(f"mutate parity failed ({stage}): {recall}, {worst}")
    say(f"mutate: removed key {removed} stays gone through re-query and vacuum")


# --------------------------------------------------------------------------- #
# driver                                                                      #
# --------------------------------------------------------------------------- #


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--mesh", type=int, default=0,
        help="run only the doc-sharded bm25 and z2o phases over this many cards",
    )
    args = ap.parse_args(argv)

    import jax

    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    say(f"compile cache: {enable_compile_cache()}")
    t0 = time.perf_counter()
    dev = device_phase(max(args.mesh, 1))
    mesh = None
    if args.mesh:
        from probly_search_tpu.parallel import make_mesh

        mesh = make_mesh(data=1, docs=args.mesh, devices=jax.devices()[: args.mesh])
        say(f"mesh: {dict(mesh.shape)}")
    ix = bm25_phase(1_000_000, mesh=mesh)
    if mesh is None:
        prefix_phase(ix, ["t4", "t49", "t3 t4"], heavy="t")
    del ix
    zix, zq = z2o_phase(50_000, mesh=mesh)
    if mesh is None:
        mutate_phase(zix, zq)
    say(f"all phases passed in {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
