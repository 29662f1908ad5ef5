"""probly-search-tpu — a full-text search engine for accelerators (JAX/XLA).

A ground-up rebuild of the capabilities of `quantleaf/probly-search` (Rust)
designed for batched execution on an accelerator:

* The reference's per-char trie inverted index (``src/index.rs:363-452``)
  is replaced by a **sorted term dictionary + CSR posting lists** stored as
  structure-of-arrays; prefix expansion (``src/query.rs:109-147``) becomes two
  binary searches yielding a contiguous term range.
* The reference's per-posting scoring loop (``src/query.rs:61-89``) becomes a
  batched device program: segment-arange range expansion -> posting gather ->
  fused scoring -> sort-based segmented max/sum merge (the
  ``max_score_merger`` rule, ``src/query.rs:150-164``) -> ``lax.top_k``.
* Mutation keeps the reference's fast-insert / latent-delete semantics
  (``src/index.rs:77-199``): adds land in delta segments, ``remove_document``
  only flips a liveness bit and updates field stats, ``vacuum`` compacts.

Public API mirrors the reference surface (``src/lib.rs``):

* :class:`Index` — ``add_document`` / ``remove_document`` / ``vacuum`` /
  ``query`` (`src/index.rs:37-199`, `src/query.rs:21-27`).
* :class:`QueryResult` — ``(key, score)`` (`src/query.rs:10-15`).
* :mod:`probly_search_tpu.models` — the scorer plugin protocol
  (`src/score/calculator.rs:33-70`) plus BM25 and zero-to-one scorers.
* Tokenizers and field accessors are plain Python callables, mirroring the
  reference's fn-pointer extension points (`src/lib.rs:11-14`).
"""

from .index.core import Index, QueryResult, DocumentDetails, DocumentPointer, FieldDetails
from .config import IndexConfig, HostFallbackError
from .models.base import ScoreCalculator, TermData, FieldData
from .models import bm25, zero_to_one
from .utils.tokenizers import whitespace_tokenizer


def make_mesh(*args, **kwargs):
    """Build a ("data", "docs") device mesh for multi-chip serving — see
    :func:`probly_search_tpu.parallel.make_mesh` (lazy import: constructing
    a mesh touches the JAX backend; plain indexing should not)."""
    from .parallel import make_mesh as _mm

    return _mm(*args, **kwargs)


__version__ = "0.2.0"

__all__ = [
    "Index",
    "IndexConfig",
    "HostFallbackError",
    "QueryResult",
    "DocumentDetails",
    "DocumentPointer",
    "FieldDetails",
    "ScoreCalculator",
    "TermData",
    "FieldData",
    "bm25",
    "zero_to_one",
    "whitespace_tokenizer",
    "make_mesh",
]
