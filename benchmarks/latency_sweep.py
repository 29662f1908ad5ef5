#!/usr/bin/env python
"""Latency-mode sweep: QPS vs p50/p99 window latency
across window size x pipeline depth on the 1M-doc BM25 bench workload.

Depth 1 = synchronous serving (submit, then immediately drain: the window
latency IS the query latency bound).  Depth d >= 2 keeps d windows in
flight (paired late drains when d >= 4, matching bench.py's loop) —
higher QPS, each window waits behind d-1 others.  Configs are interleaved
round-robin within one process and medians over 3 passes are reported.

Usage: python benchmarks/latency_sweep.py [--per-class]
"""

import json
import sys
import time


sys.path.insert(0, __file__.rsplit("/", 2)[0])
from bench import log, make_corpus, make_queries  # noqa: E402

WINDOWS = (2048, 4096, 8192, 16384)
DEPTHS = (1, 2, 4, 6)
N_QUERIES = 65536  # per (window, depth) section


def serve_section(dix, scorer, qs, window, depth, top_k=10):
    """Serve ``qs`` in ``window``-sized batches at pipeline depth ``depth``.
    Returns (qps, [window_latency_ms...])."""
    wins = [qs[i : i + window] for i in range(0, len(qs), window)]
    lat = []
    t0 = time.perf_counter()
    inflight = []  # (t_submit, handle)
    for w in wins:
        h = dix.query_batch_async(w, scorer, top_k=top_k)
        inflight.append((time.perf_counter(), h))
        while len(inflight) >= depth:
            ts, hh = inflight.pop(0)
            hh.get_arrays()
            lat.append(1e3 * (time.perf_counter() - ts))
    for ts, hh in inflight:
        hh.get_arrays()
        lat.append(1e3 * (time.perf_counter() - ts))
    qps = len(qs) / (time.perf_counter() - t0)
    return qps, lat


def main():
    import jax

    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"devices: {jax.devices()}")

    from probly_search_tpu import Index, IndexConfig, bm25

    per_class = "--per-class" in sys.argv
    # template_compositions defaults ON package-wide;
    # --composed opts back into per-composition window programs.
    template = "--composed" not in sys.argv
    t0 = time.time()
    vocab, cdf, texts = make_corpus(int(1e6), 50_000, 8)
    ix = Index(
        1,
        config=IndexConfig(
            result_format="slots20",
            per_class_dispatch=per_class,
            template_compositions=template,
        ),
    )
    ix.add_documents_columnar(list(range(int(1e6))), [texts])
    queries = make_queries(vocab, cdf, N_QUERIES, 3)
    scorer = bm25.new()
    dix = ix.device_index()
    log(f"index+snapshot {time.time() - t0:.0f}s (per_class={per_class})")

    # Warm every window size (compiles all compositions this sweep hits).
    for w in WINDOWS:
        t1 = time.time()
        for i in range(0, N_QUERIES, w):
            dix.query_batch_async(queries[i : i + w], scorer, top_k=10).get_arrays()
        log(f"warm window={w}: {time.time() - t1:.1f}s")

    stats = {(w, d): {"qps": [], "lat": []} for w in WINDOWS for d in DEPTHS}
    for rep in range(3):
        for w in WINDOWS:
            for d in DEPTHS:
                qps, lat = serve_section(dix, scorer, queries, w, d)
                stats[(w, d)]["qps"].append(qps)
                stats[(w, d)]["lat"].extend(lat)
                log(f"rep{rep} window={w} depth={d}: {qps:.0f} QPS")

    rows = []
    for (w, d), s in stats.items():
        lat = sorted(s["lat"])
        rows.append(
            {
                "window": w,
                "depth": d,
                "qps_median": round(sorted(s["qps"])[1]),
                "p50_ms": round(lat[len(lat) // 2], 1),
                "p99_ms": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 1),
            }
        )
    rows.sort(key=lambda r: (r["window"], r["depth"]))
    for r in rows:
        log(
            f"window {r['window']:6d} depth {r['depth']}: {r['qps_median']:7d} QPS  "
            f"p50 {r['p50_ms']:7.1f} ms  p99 {r['p99_ms']:7.1f} ms"
        )
    print(
        json.dumps(
            {
                "metric": "latency_sweep_1M",
                "per_class": per_class,
                "template": template,
                "rows": rows,
            }
        )
    )


if __name__ == "__main__":
    main()
