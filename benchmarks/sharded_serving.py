#!/usr/bin/env python
"""Steady-state SHARDED serving benchmark on the virtual 8-device CPU mesh.

The sharded engine carries the full single-card serving kit: pooled
per-query plan cache, packed result formats (f32/compact/slots/slots20 via
the shared pack_result_rows), b_out pad-row trimming, prefetch_results +
paired late drains.  This harness records the
steady-state QPS and the plan/pack/dispatch/drain phase split per window —
the same decomposition bench.py records for the single-chip engine.

NOT a device number: the virtual mesh executes on the host CPU, so
absolute QPS tracks host speed; the value of the record is (a) regression
tracking for the collective plan + serving machinery and (b) the phase
split, which shows where a real multi-chip deployment would bind (plan and
pack run on the host either way).
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


sys.path.insert(0, __file__.rsplit("/", 2)[0])
from bench import make_corpus, make_queries, log  # noqa: E402


def main():
    from concurrent.futures import ThreadPoolExecutor

    from probly_search_tpu import Index, IndexConfig, bm25
    from probly_search_tpu.parallel import ShardedDeviceIndex, make_mesh
    from probly_search_tpu.utils.metrics import metrics

    n_docs = 100_000
    window = 2048
    n_windows = 2
    n_passes = 4
    top_k = 10
    fmt = os.environ.get("SHARDED_FMT", "slots")

    vocab, cdf, texts = make_corpus(n_docs, 20_000, 8)
    ix = Index(1, config=IndexConfig(result_format=fmt))
    t0 = time.time()
    ix.add_documents_columnar(list(range(n_docs)), [texts])
    log(f"index build: {time.time() - t0:.1f}s")

    queries = make_queries(vocab, cdf, window * n_windows, 3)
    windows = [queries[i : i + window] for i in range(0, len(queries), window)]
    scorer = bm25.new()

    mesh = make_mesh(data=1, docs=8)
    t1 = time.time()
    sdix = ShardedDeviceIndex(ix, mesh)
    log(f"sharded snapshot (8 shards): {time.time() - t1:.1f}s")

    # Warmup: compiles + fills the per-query plan pool.
    t2 = time.time()
    for w in windows:
        sdix.query_batch_async(w, scorer, top_k=top_k).get_arrays()
    log(f"warmup (compiles + plan pool): {time.time() - t2:.1f}s")

    # Timed: paired late drains in a background worker, depth-4 pipeline —
    # the same serving loop bench.py times on the single chip.
    metrics.reset()
    lat_ms = []
    box = []

    def drain_pair(pair):
        for t_submit, h in pair:
            box.append(h.get_arrays())
            lat_ms.append(1e3 * (time.perf_counter() - t_submit))

    def timed_section():
        t5 = time.perf_counter()
        n_total = 0
        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = []
            pending = []
            for _ in range(n_passes):
                for w in windows:
                    h = sdix.query_batch_async(w, scorer, top_k=top_k)
                    pending.append((time.perf_counter(), h))
                    n_total += len(w)
                    if len(pending) == 2:
                        futs.append(pool.submit(drain_pair, pending))
                        pending = []
                    while len(futs) >= 2:
                        futs.pop(0).result()
            if pending:
                futs.append(pool.submit(drain_pair, pending))
            for f in futs:
                f.result()
        return n_total / (time.perf_counter() - t5)

    sections = [timed_section() for _ in range(3)]
    qps = sorted(sections)[1]
    for i, s in enumerate(sections):
        log(f"timed section {i}: {s:.0f} QPS")
    snap = metrics.snapshot()
    for name, h in sorted(snap["histograms"].items()):
        log(
            f"  phase {name:22s} n={h['count']:4d} mean={h['mean_us'] / 1e3:8.2f}ms"
        )

    def phase_ms(name):
        h = snap["histograms"].get(name)
        return round(h["mean_us"] / 1e3, 2) if h else None

    # Parity spot-check vs the f64 oracle through the slots-format drain.
    from probly_search_tpu import whitespace_tokenizer

    _s, s_slots, s_keys = sdix.query_batch_async(
        queries[:64], scorer, top_k=top_k
    ).get_arrays()
    hits = total = 0
    for qi, q in enumerate(queries[:64]):
        o_keys = {r.key for r in ix.query(q, bm25.new(), whitespace_tokenizer, [1.0])[:top_k]}
        d_keys = {int(k) for k, sl in zip(s_keys[qi], s_slots[qi]) if sl >= 0}
        hits += len(o_keys & d_keys)
        total += len(o_keys)
    recall = hits / max(total, 1)
    log(f"recall@{top_k} vs oracle on 64 queries: {recall:.4f}")

    lat_ms.sort()
    print(
        json.dumps(
            {
                "metric": "sharded_bm25_qps_virtual8",
                "value": round(qps, 1),
                "unit": "queries/s (host-CPU virtual mesh; functional number)",
                "qps_sections": [round(s, 1) for s in sections],
                "result_format": fmt,
                "window_size": window,
                "recall_at_10": round(recall, 4),
                "p50_window_ms": round(lat_ms[len(lat_ms) // 2], 1),
                "plan_ms_mean": phase_ms("sharded/plan"),
                "pack_ms_mean": phase_ms("sharded/pack"),
                "dispatch_ms_mean": phase_ms("sharded/dispatch"),
                "drain_ms_mean": phase_ms("sharded/drain"),
                "fetch_ms_mean": phase_ms("sharded/fetch"),
            }
        )
    )


if __name__ == "__main__":
    main()
