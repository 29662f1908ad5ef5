#!/usr/bin/env python
"""zero-to-one benchmark at the BASELINE.md config: 50k docs, 2 fields,
top-10 — the reference's WASM demo scale (recipe-title search,
`/root/reference/README.md:10-13`).

Measures device-path QPS and verifies parity against the exact f64 host
oracle on a query sample.  Prints one JSON line (diagnostics on stderr).
"""

import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax

    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"devices: {jax.devices()}")
    from bench import make_z2o_corpus
    from probly_search_tpu import Index, zero_to_one, whitespace_tokenizer

    # Title-like queries: top-50 stopword ranks excluded (a label-matching
    # scorer is not served stopword queries; with them, every doc matches
    # and the engine correctly degrades to the host lockstep path).
    n_docs = 50_000
    n_queries = 16384
    t0 = time.time()
    titles, bodies, queries = make_z2o_corpus(n_docs, n_queries)
    ix = Index(2)
    ix.add_documents_columnar(list(range(n_docs)), [titles, bodies])
    log(f"index build: {time.time() - t0:.1f}s")

    scorer = zero_to_one.new()
    # Warmup (compiles every shape class this workload hits): small slices
    # first, then once at the full timed batch shape (dispatch shapes
    # depend on batch size).
    from probly_search_tpu.ops.z2o_device import z2o_query_batch_async

    dix = ix.device_index()
    t0 = time.time()
    for s in range(0, n_queries, 2048):
        z2o_query_batch_async(
            dix, queries[s : s + 2048], whitespace_tokenizer, 10, fmt="slots"
        ).get_arrays()
        log(f"warm {s + 2048}/{n_queries} ({time.time() - t0:.0f}s)")
    z2o_query_batch_async(
        dix, queries, whitespace_tokenizer, 10, fmt="slots"
    ).get_arrays()
    log(f"warm full batch ({time.time() - t0:.0f}s)")

    # Timed: pipelined async windows drained through the columnar serving
    # surface (z2o shares the BM25 engine's PendingBatch), median of 3
    # sections.  Serving mode: slots-only drain (30 B/query vs 80 f32);
    # rankings are computed on device in f32 identically in every format.
    from concurrent.futures import ThreadPoolExecutor

    n_passes = 6
    depth_pairs = 2  # paired late drains (prefetch_results + 2 pairs in flight)

    def drain_pair(pair):
        for h in pair:
            h.get_arrays()

    def timed_section():
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=1) as pool:
            futs = []
            pending = []
            for _ in range(n_passes):
                h = z2o_query_batch_async(
                    dix, queries, whitespace_tokenizer, 10, fmt="slots"
                )
                pending.append(h)
                if len(pending) == 2:
                    futs.append(pool.submit(drain_pair, pending))
                    pending = []
                while len(futs) >= depth_pairs:
                    futs.pop(0).result()
            if pending:
                futs.append(pool.submit(drain_pair, pending))
            for f in futs:
                f.result()
        return n_passes * n_queries / (time.perf_counter() - t1)

    sections = [timed_section() for _ in range(3)]
    qps = sorted(sections)[1]
    log(f"timed sections: {[f'{s:.0f}' for s in sections]} -> median {qps:.0f} QPS")

    # Parity vs the exact host oracle on a sample.
    sample = queries[:24]
    rows = ix.query_batch(sample, scorer, top_k=10, backend="device")
    worst = 0.0
    for q, row in zip(sample, rows):
        oracle = ix.query(q, zero_to_one.new(), whitespace_tokenizer, [1.0, 1.0], top_k=10)
        assert len(row) == len(oracle), q
        a = sorted(r.score for r in row)
        b = sorted(r.score for r in oracle)
        worst = max(
            worst,
            max(
                (abs(x - y) / max(1e-9, abs(y)) for x, y in zip(a, b)),
                default=0.0,
            ),
        )
    log(f"parity vs f64 oracle on {len(sample)} queries: worst rel err {worst:.2e}")
    assert worst < 1e-4

    print(
        json.dumps(
            {
                "metric": "zero_to_one_qps_50k_docs_2f",
                "value": round(qps, 1),
                "unit": "queries/s",
                "vs_baseline": None,
                "window_size": n_queries,
                "result_format": "slots",
                "drained_bytes_per_query": 30,
                "qps_sections": [round(s, 1) for s in sections],
            }
        )
    )


if __name__ == "__main__":
    main()
