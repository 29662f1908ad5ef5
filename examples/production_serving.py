#!/usr/bin/env python
"""Production serving walkthrough — the high-throughput recipe.

Shows the pieces a real deployment combines (bench.py is the full-scale
version):

1. columnar bulk ingestion,
2. the async window API with the columnar drain (``get_arrays`` — never
   build per-result Python objects on the hot path),
3. paired one-late drains riding the prefetched results,
4. template persistence for a zero-compile restart
   (``save_templates`` / ``load_templates`` / ``prewarm``),
5. the ``host_fallback`` policy guard for adversarial queries,
6. exact block-max pruning (on by default; decisions are memoized, so
   it costs ~nothing on mixes it cannot help).

Runs on CPU in under a minute (tiny corpus / windows); on a GPU only the
scale changes.
"""

import os
import sys
import tempfile

sys.path.insert(0, "..")
sys.path.insert(0, ".")

if os.environ.get("PSEARCH_CPU"):  # run on the CPU (e.g. while the GPU is busy)
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

from probly_search_tpu import (
    HostFallbackError,
    Index,
    IndexConfig,
    bm25,
)

# 1. Ingest: columnar bulk build (native C++ tokenize/intern one-pass).
rng = np.random.default_rng(0)
vocab = np.array([f"w{i:03d}" for i in range(300)])
texts = [" ".join(vocab[rng.integers(0, 300, 6)]) for _ in range(20_000)]
ix = Index(
    1,
    config=IndexConfig(
        result_format="slots",  # slots-only drain: 30 B/query, no scores
        host_fallback="warn",  # surface (don't absorb) host-degraded queries
    ),
)
ix.add_documents_columnar(list(range(len(texts))), [texts])
dix = ix.device_index()
scorer = bm25.new()

# 2.-3. Serve async windows; drain pairs ONE WINDOW LATE so the
# prefetched result (copy_to_host_async at submit) has landed and the
# read never pays the device->host round trip.
queries = [" ".join(vocab[rng.integers(0, 300, 2)]) for _ in range(256)]
windows = [queries[i : i + 64] for i in range(0, 256, 64)]
pending = []
served = 0
for w in windows:
    pending.append(dix.query_batch_async(w, scorer, top_k=5))
    if len(pending) == 2:
        _scores, slots, keys = pending.pop(0).get_arrays()
        served += (slots[:, 0] >= 0).sum()
for h in pending:
    _scores, slots, keys = h.get_arrays()
    served += (slots[:, 0] >= 0).sum()
print(f"served {len(queries)} queries; {served} with >=1 hit")

# 4. Persist the stream's frozen window templates; a fresh process
# load_templates + prewarm compiles (or cache-loads) the exact window
# programs before the first query arrives.
with tempfile.TemporaryDirectory() as td:
    man = os.path.join(td, "templates.json")
    n_saved = dix.save_templates(man)
    dix2 = ix.device_index()
    n_loaded = dix2.load_templates(man)
    n_warm = dix2.prewarm(scorer)
    print(f"templates: saved {n_saved}, loaded {n_loaded}, prewarmed {n_warm}")

# 5. Reject (rather than absorb) queries that would degrade to the
# host path under policy "error".
ix.config.host_fallback = "error"
monster = " ".join(["w000"] * 200)  # blows the per-query term cap
try:
    dix.query_batch_async([monster], scorer, top_k=5).get_arrays()
    print("unexpected: monster query served")
except HostFallbackError as e:
    print(f"host-fallback rejected as configured: {e}")
ix.config.host_fallback = "warn"

# 6. Pruning parity spot-check: same window, prune on/off, same rows.
ix.config.prune_blocks = True
a = dix.query_batch_async(queries[:64], scorer, top_k=5).get_arrays()
ix.config.prune_blocks = False
b = dix.query_batch_async(queries[:64], scorer, top_k=5).get_arrays()
ix.config.prune_blocks = True
assert np.array_equal(a[1], b[1]), "pruned slots must be bit-equal"
print("prune on/off bit-equal on the served window")
