#!/usr/bin/env python
"""Basic usage — the analogue of the reference's README example
(`/root/reference/README.md`): two-field docs, BM25 search, removal,
vacuum, re-query."""

import os
import sys

sys.path.insert(0, "..")
sys.path.insert(0, ".")

if os.environ.get("PSEARCH_CPU"):  # run on the CPU (e.g. while the GPU is busy)
    import jax

    jax.config.update("jax_platforms", "cpu")

from probly_search_tpu import Index, bm25, zero_to_one, whitespace_tokenizer

docs = [
    {"id": 0, "title": "abc", "description": "dfg"},
    {"id": 1, "title": "dfgh", "description": "abcd"},
]

index = Index(2)
for doc in docs:
    index.add_document(
        [lambda d: [d["title"]], lambda d: [d["description"]]],
        whitespace_tokenizer,
        doc["id"],
        doc,
    )

print("BM25 'abc':")
for r in index.query("abc", bm25.new(), whitespace_tokenizer, [1.0, 1.0]):
    print(f"  doc {r.key}: {r.score:.10f}")

print("zero-to-one 'abc':")
for r in index.query("abc", zero_to_one.new(), whitespace_tokenizer, [1.0, 1.0]):
    print(f"  doc {r.key}: {r.score:.10f}")

index.remove_document(0)
index.vacuum()
print("after remove + vacuum, BM25 'abc':")
for r in index.query("abc", bm25.new(), whitespace_tokenizer, [1.0, 1.0]):
    print(f"  doc {r.key}: {r.score:.10f}")

# Batched device path (top-k):
rows = index.query_batch(["abc", "dfg"], bm25.new(), top_k=5)
print("batched:", [[(r.key, round(r.score, 6)) for r in row] for row in rows])
