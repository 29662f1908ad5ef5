#!/usr/bin/env python
"""Headline benchmark: BM25 top-10 query throughput at 1M documents, 1 card.

Workload (BASELINE.md):
  * corpus: 1,000,000 single-field docs, 8 tokens each, 50k-term vocabulary
    with Zipf(1.07) frequencies — realistic power-law posting skew.
  * queries: 3 terms each, Zipf-sampled with the top 100 ranks excluded
    (standard stopword removal; without it any engine that scores every
    posting is measuring stopword bandwidth, not search).
  * serving shape: 16384-query windows submitted through the async API
    with a depth-3 pipeline (host planning and result fetches overlap
    device work), top-10, BM25.

The reference (quantleaf/probly-search) publishes no numbers and has no
query benchmark at all (BASELINE.md); vs_baseline = QPS / 100_000.

Prints exactly one JSON line on stdout (QPS headline, p50/p99 window
latency, recall, and the device it ran on); diagnostics go to stderr.
Fails on a CPU-only JAX: the numbers are device metrics.
"""

import json
import sys
import time

import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_corpus(n_docs, vocab_size, doc_len, seed=0):
    rng = np.random.default_rng(seed)
    vocab = np.array(["t%05d" % i for i in range(vocab_size)])
    weights = 1.0 / np.arange(1, vocab_size + 1) ** 1.07
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]
    ids = np.searchsorted(cdf, rng.random((n_docs, doc_len)))
    texts = [" ".join(row) for row in vocab[ids]]
    return vocab, cdf, texts


def make_queries(vocab, cdf, n_queries, terms_per_query, stop_ranks=100, seed=1):
    rng = np.random.default_rng(seed)
    lo = cdf[stop_ranks - 1]
    ids = np.searchsorted(cdf, lo + rng.random((n_queries, terms_per_query)) * (1.0 - lo))
    ids = np.minimum(ids, len(vocab) - 1)
    return [" ".join(row) for row in vocab[ids]]


def make_z2o_corpus(n_docs, n_queries, vocab_size=4000, seed=7):
    """The zero-to-one workload (benchmarks/zero_to_one_50k.py): 2-field
    docs (3-token titles, 8-token bodies), Zipf(1.05) over ``vocab_size``
    terms, and 2-term title-like queries with the top 50 ranks excluded.
    Returns (titles, bodies, queries)."""
    rng = np.random.default_rng(seed)
    vocab = np.array(["w%04d" % i for i in range(vocab_size)])
    cdf = np.cumsum(1.0 / np.arange(1, vocab_size + 1) ** 1.05)
    cdf /= cdf[-1]

    def texts(n, length):
        ids = np.searchsorted(cdf, rng.random((n, length)))
        return [" ".join(row) for row in vocab[np.minimum(ids, vocab_size - 1)]]

    titles = texts(n_docs, 3)
    bodies = texts(n_docs, 8)
    lo = cdf[49]
    qids = np.searchsorted(cdf, lo + rng.random((n_queries, 2)) * (1.0 - lo))
    queries = [" ".join(row) for row in vocab[np.minimum(qids, vocab_size - 1)]]
    return titles, bodies, queries


def card_name_and_power_limit():
    """``name, power.limit`` per card from nvidia-smi (a child process that
    stays off JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return [line.strip() for line in out.stdout.strip().splitlines()]


def main():
    n_docs = int(1e6)
    window = 16384
    n_windows = 2
    n_passes = 24  # windows per timed section: 48
    top_k = 10
    pipeline_depth = 4  # 2 pairs in flight (paired late drains; see below)

    import jax

    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev0 = jax.devices()[0]
    if dev0.platform == "cpu":
        raise SystemExit("bench.py measures an accelerator; JAX sees only the CPU")
    device = {
        "platform": dev0.platform,
        "kind": dev0.device_kind,
        "count": len(jax.devices()),
        "cards": card_name_and_power_limit(),
    }
    log(f"device: {device}")
    t0 = time.time()
    from probly_search_tpu import Index, bm25, whitespace_tokenizer
    from probly_search_tpu.utils.metrics import metrics

    vocab, cdf, texts = make_corpus(n_docs, 50_000, 8)
    t1 = time.time()
    log(f"corpus gen: {t1 - t0:.1f}s")

    from probly_search_tpu import IndexConfig

    # Serving mode: slots20 nibble-packed result format — 25 B fetched per
    # query (the entropy floor for top-10 of 1M docs) vs 30 (slots) / 60
    # (compact) / 80 (f32).  Parity policy: rankings are computed on device
    # in f32 identically in every mode; slots modes drop only the score
    # REPORT (the recall check below uses ranked keys).  The parity suites
    # and the default API keep f32.
    ix = Index(1, config=IndexConfig(result_format="slots20"))
    ix.add_documents_columnar(list(range(n_docs)), [texts])
    t2 = time.time()
    log(f"bulk index build: {t2 - t1:.1f}s ({n_docs / (t2 - t1):.0f} docs/s)")

    queries = make_queries(vocab, cdf, window * n_windows, 3)
    windows = [queries[i : i + window] for i in range(0, len(queries), window)]
    scorer = bm25.new()
    dix = ix.device_index()
    t3 = time.time()
    log(f"device snapshot: {t3 - t2:.1f}s")

    # Zero-traffic cold start: the checked-in template manifest
    # (tools/freeze_bench_templates.py regenerates it; corpus-deterministic,
    # so live traffic hits the frozen layout and never re-freezes) +
    # prewarm compiles the stream's ONE window program before the first
    # query — a persistent-cache load once any earlier process from this
    # checkout compiled it.  README "Production cold start" documents the
    # same recipe for real deployments.
    import os

    manifest = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmarks", "bench_templates.json")
    if os.path.exists(manifest):
        n_tpl = dix.load_templates(manifest)
        n_warm = dix.prewarm(scorer)
        t_pw = time.time()
        log(f"prewarm: {n_tpl} template(s), {n_warm} program(s) in {t_pw - t3:.1f}s")

    # Warmup pass: two settle passes through the full pipeline (plan-pool
    # build for the query stream's terms, queue/cache settling).  With the
    # manifest prewarm above, no window-program compile happens here.
    for w in windows:
        dix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    for w in windows:
        dix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    t4 = time.time()
    warmup_s = t4 - t3
    log(f"warmup (incl. prewarm): {warmup_s:.1f}s")

    # Timed: async submission with a depth-4 pipeline and a background
    # drain thread that reads windows in PAIRS, one window late.  Submit
    # issues copy_to_host_async on the packed result (prefetch_results),
    # so the D2H streams behind later windows' device compute; draining a
    # pair after two more submissions lets the async copies land first.
    # Seven timed sections are sampled and the MEDIAN section is reported
    # (all seven go into the JSON).
    from concurrent.futures import ThreadPoolExecutor

    metrics.reset()
    lat_ms = []
    results_box = []

    def drain_pair(pair):
        for t_submit, h in pair:
            out = h.get_arrays()
            lat_ms.append(1e3 * (time.perf_counter() - t_submit))
            results_box.append(out)

    def timed_section():
        t5 = time.perf_counter()
        n_total = 0
        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = []
            pending = []
            for p in range(n_passes):
                for w in windows:
                    h = dix.query_batch_async(w, scorer, top_k=top_k)
                    pending.append((time.perf_counter(), h))
                    n_total += len(w)
                    if len(pending) == 2:
                        futs.append(pool.submit(drain_pair, pending))
                        pending = []
                    while len(futs) >= pipeline_depth // 2:
                        futs.pop(0).result()
            if pending:
                futs.append(pool.submit(drain_pair, pending))
            for f in futs:
                f.result()
        return n_total / (time.perf_counter() - t5)

    n_sections = 7
    sections = []
    for s in range(n_sections):
        sections.append(timed_section())
        log(f"timed section {s}: {sections[-1]:.0f} QPS")
    qps = sorted(sections)[n_sections // 2]
    scores_out, slots_out, keys_out = results_box[-1]
    assert slots_out.shape == (window, top_k) and keys_out.shape == (window, top_k)
    assert scores_out is None  # slots-only serving mode carries no scores
    assert (slots_out[0] >= 0).any()
    lat_ms = sorted(lat_ms)
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))]
    log(
        f"timed: median {qps:.0f} QPS over {n_sections} sections; "
        f"window latency p50 {p50:.0f}ms p99 {p99:.0f}ms ({len(lat_ms)} windows)"
    )
    snap = metrics.snapshot()
    for name, h in sorted(snap["histograms"].items()):
        log(
            f"  phase {name:22s} n={h['count']:3d} mean={h['mean_us'] / 1e3:8.2f}ms "
            f"total={h['count'] * h['mean_us'] / 1e3:8.1f}ms"
        )

    def phase_ms(name):
        h = snap["histograms"].get(name)
        return round(h["mean_us"] / 1e3, 2) if h else None

    # Companions to the QPS sample: per-window phase means, drained bytes,
    # and a synchronous window time (plan+pack+device+fetch with no
    # pipeline).
    sync_ms = []
    for _ in range(3):
        t_s = time.perf_counter()
        dix.query_batch_async(windows[0], scorer, top_k=top_k).get_arrays()
        sync_ms.append(1e3 * (time.perf_counter() - t_s))
    sync_window_ms = sorted(sync_ms)[1]
    log(f"sync window (no pipeline): {sync_window_ms:.0f}ms {sync_ms}")

    # Device pace: queue N windows, one sync — executions run in
    # submission order on the device, so the marginal window cost is the
    # device-stream cost per window.
    def queue_n(n):
        t_s = time.perf_counter()
        hs = [
            dix.query_batch_async(windows[i % len(windows)], scorer, top_k=top_k)
            for i in range(n)
        ]
        hs[-1]._packed.block_until_ready()
        return 1e3 * (time.perf_counter() - t_s)

    t1w = min(queue_n(1) for _ in range(2))
    t8w = min(queue_n(8) for _ in range(2))
    device_ms_per_window = (t8w - t1w) / 7.0
    log(f"device pace: {device_ms_per_window:.1f} ms/window (T1 {t1w:.0f}, T8 {t8w:.0f})")

    # Model ceiling: the pipeline's steady-state pace is the marginal
    # per-window device-stream cost.  prefetch_results (the package
    # default) enqueues each window's D2H copy at submit time, so the
    # queue-8 measurement above already carries one drain per window.
    # Host planning and the drain's blocking reads are hidden by the
    # pipeline, so headline QPS is this ceiling minus serving-loop slack.
    drained_bytes_per_query = 2 * top_k + (top_k + 1) // 2  # slots20
    qps_model_ceiling = window / (device_ms_per_window / 1e3)
    spread = (max(sections) - min(sections)) / qps
    log(
        f"model ceiling: {qps_model_ceiling:.0f} QPS "
        f"(device-stream pace {device_ms_per_window:.1f} ms/window incl. "
        f"on-stream drain); section spread {spread:.2f}"
    )

    # Recall vs the exact f64 oracle on a 256-query sample (ranked keys
    # from the slots-only drain — the same surface the timed loop serves).
    sample = queries[:256]
    _s, s_slots, s_keys = dix.query_batch_async(
        sample, scorer, top_k=top_k
    ).get_arrays()
    hits = total = 0
    for qi, q in enumerate(sample):
        oracle = ix.query(q, bm25.new(), whitespace_tokenizer, [1.0])[:top_k]
        o_keys = {r.key for r in oracle}
        d_keys = {int(k) for k, sl in zip(s_keys[qi], s_slots[qi]) if sl >= 0}
        hits += len(o_keys & d_keys)
        total += len(o_keys)
    recall = hits / max(total, 1)
    log(f"recall@{top_k} vs oracle on {len(sample)} queries: {recall:.4f}")

    # Sharded path on the same device: a 1-device mesh runs the
    # shard_map window program.  A failure here fails the run.
    from probly_search_tpu.parallel import ShardedDeviceIndex, make_mesh

    ix2 = Index(1, config=IndexConfig(result_format="slots"))
    ix2.add_documents_columnar(list(range(50_000)), [texts[:50_000]])
    sdix = ShardedDeviceIndex(ix2, make_mesh(data=1, docs=1, devices=jax.devices()[:1]))
    _ss, sh_slots, sh_keys = sdix.query_batch_async(
        queries[:512], scorer, top_k=top_k
    ).get_arrays()
    sh_hits = sh_total = 0
    for qi in range(32):
        oracle = ix2.query(queries[qi], bm25.new(), whitespace_tokenizer, [1.0])[:top_k]
        o_keys = {r.key for r in oracle}
        d_keys = {int(k) for k, sl in zip(sh_keys[qi], sh_slots[qi]) if sl >= 0}
        sh_hits += len(o_keys & d_keys)
        sh_total += len(o_keys)
    sharded_recall = round(sh_hits / max(sh_total, 1), 4)
    log(f"sharded 1-device mesh: recall={sharded_recall}")
    if sharded_recall != 1.0:
        raise SystemExit(f"sharded path recall {sharded_recall} != 1.0")

    print(
        json.dumps(
            {
                "metric": "bm25_query_qps_1M_docs",
                "value": round(qps, 1),
                "unit": "queries/s",
                "vs_baseline": round(qps / 100_000.0, 4),
                "p50_window_ms": round(p50, 1),
                "p99_window_ms": round(p99, 1),
                "recall_at_10": round(recall, 4),
                "window_size": window,
                "result_format": "slots20",
                "qps_sections": [round(s, 1) for s in sections],
                "qps_model_ceiling": round(qps_model_ceiling, 1),
                "qps_sections_spread": round(spread, 3),
                "drained_bytes_per_query": drained_bytes_per_query,
                "plan_ms_mean": phase_ms("query/plan"),
                "prune_ms_mean": phase_ms("query/prune"),
                "pack_ms_mean": phase_ms("query/pack"),
                "drain_ms_mean": phase_ms("query/drain"),
                "fetch_ms_mean": phase_ms("query/fetch"),
                "sync_window_ms": round(sync_window_ms, 1),
                "device_ms_per_window": round(device_ms_per_window, 1),
                "warmup_s": round(warmup_s, 1),
                "sharded_recall": sharded_recall,
                "device": device,
            }
        )
    )


if __name__ == "__main__":
    main()
