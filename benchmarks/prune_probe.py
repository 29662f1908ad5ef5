#!/usr/bin/env python
"""Block-max pruning A/B on the device (index/prune.py).

Measures, in ONE process with interleaved reps, the pruned vs unpruned
serving rate of the 1M-doc corpus under three query mixes:

  * ``single``   — 1-term Zipf queries (stopwords excluded): the classic
    block-max win case (one term, tau comes straight off the term's own
    top-k ladder).
  * ``skewed``   — 2-term queries pairing one mid-rank term with one rare
    term: idf skew gives the rare term a small UB, so the common term's
    tail chunks fall below tau.
  * ``headline`` — the bench's 3-term uniform-Zipf mix: same-magnitude
    idfs make the disjunctive slack sum UB(t') swamp tau, so ~nothing
    prunes (the known WAND-family weak spot, recorded honestly).

For each mix: queued-window device pace (executions run in submission
order on the device) and the fraction of chunks pruned, plus a
bit-equality check of the pruned vs unpruned slots on the first window.

Run:  python benchmarks/prune_probe.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    import jax

    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    log(f"devices: {jax.devices()}")
    import bench

    from probly_search_tpu import Index, IndexConfig, bm25
    from probly_search_tpu.utils.metrics import metrics

    window = 16384
    top_k = 10
    reps = 5
    queue_n = 4

    t0 = time.time()
    vocab, cdf, texts = bench.make_corpus(int(1e6), 50_000, 8)
    ix = Index(1, config=IndexConfig(result_format="slots20"))
    ix.add_documents_columnar(list(range(int(1e6))), [texts])
    scorer = bm25.new()
    dix = ix.device_index()
    log(f"setup {time.time() - t0:.1f}s")

    rng = np.random.default_rng(7)

    def zipf_ids(n, lo_rank=100, hi=None):
        lo = cdf[lo_rank - 1]
        hiv = cdf[hi - 1] if hi else 1.0
        ids = np.searchsorted(cdf, lo + rng.random(n) * (hiv - lo))
        return np.minimum(ids, len(vocab) - 1)

    mixes = {
        "single": [vocab[i] for i in zipf_ids(window)],
        "skewed": [
            f"{vocab[c]} {vocab[r]}"
            for c, r in zip(
                zipf_ids(window, 100, 2000),
                rng.integers(20_000, 50_000, window),
            )
        ],
        "headline": bench.make_queries(vocab, cdf, window, 3, seed=9),
    }

    def pruned_chunks():
        return int(
            metrics.snapshot()["counters"].get("prune/pruned_chunks", 0)
        )

    def serve(q, on):
        ix.config.prune_blocks = on
        return dix.query_batch_async(q, scorer, top_k=top_k)

    def pace(q, on, n):
        """Queued-window wall time (ms/window marginal over the queue)."""
        t1 = time.perf_counter()
        hs = [serve(q, on) for _ in range(n)]
        np.asarray(hs[-1]._packed)
        return 1e3 * (time.perf_counter() - t1) / n

    out = {}
    from probly_search_tpu import whitespace_tokenizer

    for name, q in mixes.items():
        plan0, _fb = dix.plan_batch(q, whitespace_tokenizer, scorer)
        total_chunks = int(plan0.nchunks.sum())
        # Warm both variants (compiles + plan pool) before timing.
        c0 = pruned_chunks()
        sa = serve(q, True).get_arrays()
        frac_pruned_chunks = pruned_chunks() - c0
        sb = serve(q, False).get_arrays()
        # Bit-equality of the ranked slots/keys (slots20 carries no scores).
        for x, y in zip(sa[1:], sb[1:]):
            np.testing.assert_array_equal(x, y, err_msg=name)
        # Interleaved pace reps.
        on_ms, off_ms = [], []
        for r in range(reps):
            on_ms.append(pace(q, True, queue_n))
            off_ms.append(pace(q, False, queue_n))
        on_med = sorted(on_ms)[reps // 2]
        off_med = sorted(off_ms)[reps // 2]
        out[name] = (on_med, off_med, frac_pruned_chunks, total_chunks)
        log(
            f"{name:9s} pace pruned {on_med:6.1f} ms/w (reps {[f'{v:.0f}' for v in on_ms]}) "
            f"unpruned {off_med:6.1f} ms/w ({[f'{v:.0f}' for v in off_ms]}) "
            f"chunks pruned/window: {frac_pruned_chunks}/{total_chunks}"
        )
    ix.config.prune_blocks = True

    import json

    print(
        json.dumps(
            {
                name: {
                    "pruned_ms_per_window": round(on, 1),
                    "unpruned_ms_per_window": round(off, 1),
                    "chunks_pruned_per_window": int(n),
                    "total_chunks_per_window": int(tot),
                }
                for name, (on, off, n, tot) in out.items()
            }
        )
    )


if __name__ == "__main__":
    main()
