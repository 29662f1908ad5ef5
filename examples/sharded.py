#!/usr/bin/env python
"""Multi-chip serving — doc-sharded index over a ("data", "docs") mesh.

Runs anywhere: set PSEARCH_CPU=1 to simulate 8 devices on the host CPU
(the same SPMD program a mesh of GPUs executes).  The sharded engine's only
query-time collective is the O(k) top-k all-gather; document frequencies
are global but static per snapshot, so idf is precomputed on host.
"""

import os
import sys

sys.path.insert(0, "..")
sys.path.insert(0, ".")

if os.environ.get("PSEARCH_CPU"):
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
else:
    import jax

from probly_search_tpu import Index, bm25, whitespace_tokenizer
from probly_search_tpu.parallel import ShardedDeviceIndex, make_mesh

# Build an index (any size; here 10k synthetic two-token docs).
ix = Index(1)
keys = list(range(10_000))
texts = [f"term{i % 97} common{i % 11}" for i in keys]
ix.add_documents_columnar(keys, [texts])

# Shard it over every available device: postings of doc slot g live on
# shard g % n; a second mesh axis ("data") splits query batches.
n = len(jax.devices())
mesh = make_mesh(data=2 if n % 2 == 0 and n > 2 else 1, docs=None)
sdix = ShardedDeviceIndex(ix, mesh)
print(f"mesh: {dict(mesh.shape)}, shards hold ~{10_000 // sdix.n_shards} docs each")

queries = ["term13 common3", "common7", "ter"]
rows = sdix.query_batch(queries, bm25.new(), top_k=5)
for q, row in zip(queries, rows):
    print(f"{q!r}: {[(r.key, round(r.score, 4)) for r in row[:3]]}")

# The async API pipelines windows: submit the next while draining the last.
pending = sdix.query_batch_async(queries, bm25.new(), top_k=5)
rows2 = pending.get()
assert [r.key for r in rows2[0]] == [r.key for r in rows[0]]

# Results match the exact f64 host oracle (compare scores: equal-scored
# docs may tie-break differently across shards).
oracle = ix.query(queries[0], bm25.new(), whitespace_tokenizer, [1.0], top_k=5)
got = sorted(round(r.score, 5) for r in rows[0])
want = sorted(round(r.score, 5) for r in oracle)
assert got == want, (got, want)
print("sharded results match the host oracle")
