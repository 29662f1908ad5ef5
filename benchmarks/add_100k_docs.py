#!/usr/bin/env python
"""1:1 port of the reference's only benchmark: ``add_100k_docs``
(`/root/reference/benches/test_benchmark.rs:16-63`).

Workload reproduced exactly:
  * 99,999 random strings (the Rust loop ``for _ in 1..100000``),
  * each = two tokens of 5 chars (inclusive range 0..=4,
    test_benchmark.rs:28) drawn from the 24-char alphabet literal
    "abcdefghilkjapqrstuvwxyz" (test_benchmark.rs:21 — including its
    duplicated 'a' and missing 'm'),
  * ``Index::new_with_capacity(1, 100000, 100000)``,
  * one timed pass of per-document insertion (criterion re-adds into the
    same growing index across iterations; we report the first — cold —
    pass, plus steady-state re-add passes to mirror criterion's warm
    measurement).

Also reports the bulk columnar pipeline on the same corpus (the batched
build path, no per-doc analogue in the reference).
"""

import json
import random
import sys
import time

sys.path.insert(0, ".")

from probly_search_tpu import Index, whitespace_tokenizer

ALPHABET = "abcdefghilkjapqrstuvwxyz"  # test_benchmark.rs:21, verbatim


def generate_strings(rng):
    out = []
    for _ in range(1, 100000):  # 99,999 docs, matching the Rust range
        a = "".join(rng.choice(ALPHABET) for _ in range(5))
        b = "".join(rng.choice(ALPHABET) for _ in range(5))
        out.append(a + " " + b)
    return out


def title_extract(d):
    return [d]


def main():
    rng = random.Random(42)
    strings = generate_strings(rng)
    n = len(strings)

    index = Index.new_with_capacity(1, 100000, 100000)
    t0 = time.time()
    for i, s in enumerate(strings):
        index.add_document([title_extract], whitespace_tokenizer, i, s)
    # Materialize the write buffer inside the timed window: adds are
    # buffered and built in batches (index/core.py), and an honest
    # comparison against the reference's per-add trie insertion must
    # include that deferred work.
    index._flush_pending()
    cold = time.time() - t0
    print(f"add_100k_docs cold pass: {cold:.2f}s ({n / cold:.0f} docs/s)", file=sys.stderr)

    # Criterion reuses the same index across iterations (keys overwrite;
    # the reference leaves stale postings, we replace — both measure warm
    # insertion into a populated index).
    warm_times = []
    for _ in range(2):
        t0 = time.time()
        for i, s in enumerate(strings):
            index.add_document([title_extract], whitespace_tokenizer, i, s)
        index._flush_pending()
        warm_times.append(time.time() - t0)
    warm = min(warm_times)
    print(f"add_100k_docs warm pass: {warm:.2f}s ({n / warm:.0f} docs/s)", file=sys.stderr)

    ix2 = Index.new_with_capacity(1, 100000, 100000)
    t0 = time.time()
    ix2.add_documents_columnar(list(range(n)), [strings])
    bulk = time.time() - t0
    print(f"bulk columnar pipeline: {bulk:.2f}s ({n / bulk:.0f} docs/s)", file=sys.stderr)

    print(
        json.dumps(
            {
                "metric": "add_100k_docs",
                "value": round(n / cold, 1),
                "unit": "docs/s",
                "bulk_docs_per_s": round(n / bulk, 1),
            }
        )
    )


if __name__ == "__main__":
    main()
