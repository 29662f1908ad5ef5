"""Device-side operators (plain JAX/XLA).

These replace the reference's pointer-chasing query machinery:

* merge.py — sort-based segmented max/sum merge + top-k (replaces the
  HashMap `max_score_merger` accumulation, `query.rs:150-164`, and the final
  sort, `query.rs:103`).
* z2o_device.py — the zero-to-one scorer's device programs (a sort +
  segmented-scan fast program and the exact lockstep program).

Posting-range expansion ((start, len) jobs -> chunked gather lanes,
replacing the per-posting linked-list walk `query.rs:61-89`) lives inline in
the query step (`index/device.py:_query_step_impl`); the batched index
build (the vectorized analogue of per-document trie insertion,
`index.rs:119-157`) is the host pipeline `index/bulk.py` + the native
tokenizer, since the host CSR must exist anyway for the exact f64 path and
snapshots.
"""

from .merge import merge_scores_topk, segmented_scan

__all__ = ["merge_scores_topk", "segmented_scan"]
