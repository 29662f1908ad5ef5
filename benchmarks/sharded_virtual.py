#!/usr/bin/env python
"""Sharded engine throughput harness on the virtual 8-device CPU mesh.

NOT a device number: the virtual mesh runs on host CPU, so this measures
the sharded program's functional scaling shape (classes, packing, O(k)
collective) and gives a tracked number for regressions.  The four-card
path runs on the GPUs with ``python chip_smoke.py --mesh 4``.
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

import numpy as np  # noqa: E402

sys.path.insert(0, __file__.rsplit("/", 2)[0])
from bench import make_corpus, make_queries, log  # noqa: E402


def main():
    from probly_search_tpu import Index, bm25
    from probly_search_tpu.parallel import ShardedDeviceIndex, make_mesh

    n_docs = 100_000
    vocab, cdf, texts = make_corpus(n_docs, 20_000, 8)
    ix = Index(1)
    ix.add_documents_columnar(list(range(n_docs)), [texts])
    queries = make_queries(vocab, cdf, 2048, 3)
    scorer = bm25.new()

    mesh = make_mesh(data=1, docs=8)
    t0 = time.time()
    sdix = ShardedDeviceIndex(ix, mesh)
    log(f"sharded snapshot (8 shards): {time.time() - t0:.1f}s")

    sdix.query_batch(queries, scorer, top_k=10)  # warmup/compile
    t1 = time.time()
    n_passes = 3
    for _ in range(n_passes):
        rows = sdix.query_batch(queries, scorer, top_k=10)
    elapsed = time.time() - t1
    qps = n_passes * len(queries) / elapsed
    assert len(rows) == len(queries)
    log(f"virtual-mesh sharded: {n_passes * len(queries)} queries in {elapsed:.2f}s")

    # Spot parity vs oracle.
    sample_idx = np.linspace(0, len(queries) - 1, 16).astype(int)
    from probly_search_tpu import whitespace_tokenizer

    for i in sample_idx:
        oracle = ix.query(queries[i], bm25.new(), whitespace_tokenizer, [1.0], top_k=10)
        got = rows[i]
        assert len(got) == len(oracle), queries[i]
        np.testing.assert_allclose(
            sorted(r.score for r in got),
            sorted(r.score for r in oracle),
            rtol=2e-5,
            atol=1e-6,
        )
    log("parity vs oracle on 16 sampled queries OK")

    print(
        json.dumps(
            {
                "metric": "sharded_virtual8_qps_100k_docs",
                "value": round(qps, 1),
                "unit": "queries/s",
                "vs_baseline": None,
            }
        )
    )


if __name__ == "__main__":
    main()
