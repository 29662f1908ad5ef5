#!/usr/bin/env python
"""zero-to-one ADVERSARIAL worst case: shared-node queries past the
lockstep lane cap.

Shared expansion nodes need the exact lockstep program, which is capped at
16384 entry lanes (ops/z2o_device.py ``max_fl``); bigger shared-node
queries are served by the vectorized HOST
lockstep (`ZeroToOne.vectorized_query`) — exact, but at host speed.  This
probe puts a number on that degradation: a window of duplicate-term
hot-prefix queries (`"w0 w0"`-style — every query shares a fat expansion
node and exceeds the cap) served end to end, vs the engine's fast-path
headline on the same corpus (benchmarks/zero_to_one_50k.py).

Exactness is still asserted (host lockstep is bit-identical to the f64
oracle).  Prints one JSON line.

Run:  python benchmarks/z2o_adversarial.py        (host-bound; the device
is only touched by the non-adversarial comparison window)
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax

    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"devices: {jax.devices()}")
    from probly_search_tpu import Index, whitespace_tokenizer, zero_to_one
    from probly_search_tpu.ops.z2o_device import z2o_query_batch_async
    from probly_search_tpu.utils.metrics import metrics

    n_docs = 50_000
    rng = np.random.default_rng(7)
    vocab = np.array(["w%04d" % i for i in range(4000)])
    weights = 1.0 / np.arange(1, len(vocab) + 1) ** 1.05
    cdf = np.cumsum(weights)
    cdf /= cdf[-1]

    def texts(n, length):
        ids = np.searchsorted(cdf, rng.random((n, length)))
        return [" ".join(row) for row in vocab[np.minimum(ids, len(vocab) - 1)]]

    t0 = time.time()
    titles = texts(n_docs, 3)
    bodies = texts(n_docs, 8)
    ix = Index(2)
    ix.add_documents_columnar(list(range(n_docs)), [titles, bodies])
    dix = ix.device_index()
    log(f"index build: {time.time() - t0:.1f}s")

    # Adversarial window: duplicate-term hot-prefix queries.  "wNN wNN"
    # expands each term over the whole wNN* family (~40 terms x 2 fields
    # over thousands of postings — far past the 16384-lane lockstep cap),
    # and the duplicate makes the expansion nodes SHARED, so the fast
    # loop-free program is semantically out too.
    n_adv = 512
    prefixes = [f"w{i:02d}" for i in rng.integers(0, 40, n_adv)]
    adversarial = [f"{p} {p}" for p in prefixes]

    # Sanity: these must actually route to the host lockstep.
    metrics.reset()
    h = z2o_query_batch_async(dix, adversarial[:8], whitespace_tokenizer, 10, fmt="slots")
    h.get_arrays()
    n_host = metrics.snapshot()["counters"].get("z2o_host_vectorized_queries", 0)
    assert n_host == 8, f"expected full host routing, got {n_host}/8"

    # Exactness spot check vs the f64 oracle.
    rows = z2o_query_batch_async(dix, adversarial[:4], whitespace_tokenizer, 10).get()
    for q, row in zip(adversarial[:4], rows):
        oracle = ix.query(q, zero_to_one.new(), whitespace_tokenizer, [1.0, 1.0])[:10]
        assert [r.key for r in row] == [r.key for r in oracle], q
        np.testing.assert_allclose(
            [r.score for r in row], [r.score for r in oracle], rtol=1e-12
        )
    log("host-lockstep routing + oracle exactness ok")

    # Timed adversarial window (3 reps, median).
    reps_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        z2o_query_batch_async(
            dix, adversarial, whitespace_tokenizer, 10, fmt="slots"
        ).get_arrays()
        reps_ms.append(1e3 * (time.perf_counter() - t1))
    adv_ms = sorted(reps_ms)[1]
    adv_qps = n_adv / (adv_ms / 1e3)
    log(f"adversarial: {adv_qps:.0f} QPS ({adv_ms:.0f} ms / {n_adv} queries; reps {reps_ms})")

    # Same-size NORMAL window for the degradation ratio (fast device path).
    lo = cdf[49]
    qids = np.searchsorted(cdf, lo + rng.random((n_adv, 2)) * (1.0 - lo))
    normal = [" ".join(row) for row in vocab[np.minimum(qids, len(vocab) - 1)]]
    z2o_query_batch_async(dix, normal, whitespace_tokenizer, 10, fmt="slots").get_arrays()
    reps_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        z2o_query_batch_async(
            dix, normal, whitespace_tokenizer, 10, fmt="slots"
        ).get_arrays()
        reps_ms.append(1e3 * (time.perf_counter() - t1))
    norm_ms = sorted(reps_ms)[1]
    norm_qps = n_adv / (norm_ms / 1e3)
    log(f"normal same-size window: {norm_qps:.0f} QPS ({norm_ms:.0f} ms)")

    print(
        json.dumps(
            {
                "metric": "z2o_adversarial_shared_node_qps",
                "adversarial_qps": round(adv_qps, 1),
                "adversarial_ms_per_query": round(adv_ms / n_adv, 3),
                "normal_window_qps": round(norm_qps, 1),
                "degradation_x": round(norm_qps / max(adv_qps, 1e-9), 1),
                "window": n_adv,
            }
        )
    )


if __name__ == "__main__":
    main()
