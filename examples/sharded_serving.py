#!/usr/bin/env python
"""Multi-chip serving walkthrough.

Runs on any JAX platform: on CPU set a virtual device count first, e.g.

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/sharded_serving.py

Shows the full multi-chip serving surface:

* ``make_mesh`` + ``Index.attach_mesh`` — one switch turns a single-chip
  index into a doc-sharded SPMD engine (postings partitioned by document
  over the "docs" axis; the only query-time collective is the O(k) top-k
  all-gather).
* ``query_batch`` routes BOTH shipped scorers through the mesh.
* The columnar drain (``get_arrays``) — the serving-path API: per-result
  Python objects cost more than the device work at real window sizes.
* Mutation-safe snapshot caching: add/remove invalidates the sharded
  snapshot exactly like the single-chip one.
"""

import os
import sys

if not os.environ.get("PSEARCH_EXAMPLE_REAL"):
    # Self-provision a virtual 8-device CPU platform (set
    # PSEARCH_EXAMPLE_REAL=1 to use the ambient real devices instead).
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from probly_search_tpu import Index, bm25, make_mesh, whitespace_tokenizer, zero_to_one

# --- build a corpus --------------------------------------------------------
rng = np.random.default_rng(0)
vocab = np.array([f"w{i:03d}" for i in range(300)])
texts = [" ".join(rng.choice(vocab, size=6)) for _ in range(5000)]
ix = Index(1)
ix.add_documents_columnar(list(range(5000)), [texts])

# --- attach a mesh: everything below runs doc-sharded ----------------------
mesh = make_mesh(data=2, docs=4)  # 8 devices: 2-way data, 4-way doc shards
ix.attach_mesh(mesh)
print(f"mesh: {dict(mesh.shape)}")

queries = ["w001 w002", "w1", "w250", ""]
rows = ix.query_batch(queries, bm25.new(), top_k=5)
print("bm25 top hit per query:", [(r[0].key, round(r[0].score, 4)) if r else None for r in rows])

zrows = ix.query_batch(queries[:2], zero_to_one.new(), top_k=5)
print("zero-to-one top hit:", [(r[0].key, round(r[0].score, 4)) if r else None for r in zrows])

# --- the columnar serving surface ------------------------------------------
sdix = ix.sharded_index()
handle = sdix.query_batch_async(queries, bm25.new(), top_k=5)
scores, slots, keys = handle.get_arrays()  # f32[n,k], int32[n,k], keys[n,k]
valid = np.isfinite(scores)
print("columnar: hits per query =", valid.sum(axis=1).tolist())

# --- mutation invalidates the cached sharded snapshot ----------------------
top_key = rows[0][0].key
ix.remove_document(top_key)
rows2 = ix.query_batch([queries[0]], bm25.new(), top_k=5)
assert all(r.key != top_key for r in rows2[0])
print(f"removed doc {top_key}; it no longer appears — snapshot refreshed")
