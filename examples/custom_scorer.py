#!/usr/bin/env python
"""Custom scorer — user-pluggable scoring is a headline reference feature
(`/root/reference/README.md:19`, the `ScoreCalculator` trait).  This scorer
implements simple TF-IDF-free "field-weighted term count" with all three
protocol phases, plus the optional device protocol so it runs vectorized on
the device."""

import os
import sys

sys.path.insert(0, "..")
sys.path.insert(0, ".")

if os.environ.get("PSEARCH_CPU"):  # run on the CPU (e.g. while the GPU is busy)
    import jax

    jax.config.update("jax_platforms", "cpu")

from probly_search_tpu import Index, whitespace_tokenizer
from probly_search_tpu.models.base import BaseScoreCalculator


class WeightedCount(BaseScoreCalculator):
    """score(doc) = sum over query terms of max over expansions of
    sum_f tf_f * boost_f; finalize() normalizes by the max score."""

    device_needs_finalize = True  # finalize must run on host

    def score(self, before, pointer, details, node, field_data, term):
        return float(
            sum(
                tf * b
                for tf, b in zip(pointer.term_frequency, field_data.fields_boost)
            )
        )

    def finalize(self, results):
        if results:
            peak = max(r.score for r in results) or 1.0
            for r in results:
                r.score /= peak


class DeviceWeightedCount(BaseScoreCalculator):
    """The same scorer WITHOUT the normalization pass — finalize-free, so it
    also implements the device protocol and runs as one batched device program
    through ``Index.query_batch`` (models/base.py DeviceScorer):

    * ``device_term_scale`` — the vectorized ``before_each``: one host f32
      scale per (query term x expansion) job.  Here: no idf, no expansion
      boost, so the scale is 1.
    * ``device_score_lanes`` — the vectorized ``score`` over posting lanes.
    """

    device_needs_finalize = False
    device_excludes_nonpositive = True  # drop docs with zero/negative score

    def device_cache_key(self):
        return ("weighted_count",)

    def before_each(self, term, df, docs):
        return None

    def score(self, before, pointer, details, node, field_data, term):
        s = float(
            sum(
                tf * b
                for tf, b in zip(pointer.term_frequency, field_data.fields_boost)
            )
        )
        return s if s > 0 else None

    def device_term_scale(self, df, n_docs, expansion_boost):
        import numpy as np

        return np.ones(len(df), np.float32)

    def device_score_lanes(self, lanes):
        import jax.numpy as jnp

        per_field = lanes.tf * lanes.fields_boost[:, None]  # [B, NC, F, C]
        return jnp.sum(per_field, axis=-2) * lanes.scale  # scale is per-lane


index = Index(2)
corpus = [
    (0, "red apple", "fruit sweet red"),
    (1, "green pear", "fruit green"),
    (2, "red car", "vehicle fast red red"),
]
for key, title, body in corpus:
    index.add_document(
        [lambda d: [d[1]], lambda d: [d[2]]], whitespace_tokenizer, key, (key, title, body)
    )

print("host path (stateful finalize):")
for r in index.query("red fruit", WeightedCount(), whitespace_tokenizer, [2.0, 1.0]):
    print(f"  doc {r.key}: {r.score:.4f}")

print("device batch path (custom scorer on the device):")
rows = index.query_batch(
    ["red fruit", "green"], DeviceWeightedCount(), whitespace_tokenizer, [2.0, 1.0]
)
for q, row in zip(["red fruit", "green"], rows):
    print(f"  {q!r}: {[(r.key, round(r.score, 4)) for r in row]}")

# The device path matches the exact host path for this scorer.
host = index.query("red fruit", DeviceWeightedCount(), whitespace_tokenizer, [2.0, 1.0])
assert [(r.key, round(r.score, 5)) for r in rows[0]] == [
    (r.key, round(r.score, 5)) for r in host
]
print("device == host for the custom scorer")
