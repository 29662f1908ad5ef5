"""Greedy pow2 row-splitting of shape classes (IndexConfig.pow2_row_split).

Device compute is ~linear in rows x lanes; splitting a 2638-member class
into 2048+512+pad(128) instead of one pow2 pad to 4096 saves the pad
rows.  Results must be identical
either way — spans only re-tile the SAME job rows."""

import random

import numpy as np

from probly_search_tpu import Index, bm25
from probly_search_tpu.index.device import DeviceIndex


def test_pow2_spans_shapes():
    spans = DeviceIndex._pow2_spans(2638, 4096)
    assert spans == [(2048, 2048), (512, 512), (78, 128)]
    assert DeviceIndex._pow2_spans(4096, 4096) == [(4096, 4096)]
    assert DeviceIndex._pow2_spans(84, 4096) == [(84, 128)]
    assert DeviceIndex._pow2_spans(512, 4096) == [(512, 512)]
    assert DeviceIndex._pow2_spans(513, 4096) == [(512, 512), (1, 8)]
    # cap respected even when not a power of two; min_pad honored
    assert DeviceIndex._pow2_spans(5, 5, min_pad=1) == [(4, 4), (1, 1)]
    for n in (1, 7, 255, 256, 600, 2048, 2639, 9001):
        for cap in (2, 5, 256, 4096):
            spans = DeviceIndex._pow2_spans(n, cap)
            assert sum(t for t, _ in spans) == n
            for take, pad in spans:
                assert take <= pad and pad & (pad - 1) == 0
                assert take <= (1 << (max(cap, 1).bit_length() - 1))


def _corpus(n=800, seed=4):
    rng = random.Random(seed)
    vocab = ["w%02d" % i for i in range(40)]
    ix = Index(1)
    texts = [" ".join(rng.choice(vocab) for _ in range(4)) for _ in range(n)]
    ix.add_documents_columnar(list(range(n)), [texts])
    return ix, vocab, rng


def test_split_results_identical_bm25():
    ix, vocab, rng = _corpus()
    # 600 queries landing in few classes -> the modal class splits
    # (512 + pad) under the flag; results must not change.
    queries = [rng.choice(vocab) for _ in range(600)]
    dix = ix.device_index()
    dix.config.pow2_row_split = False
    base = dix.query_batch_async(queries, bm25.new(), top_k=5).get_arrays()
    dix.config.pow2_row_split = True
    split = dix.query_batch_async(queries, bm25.new(), top_k=5).get_arrays()
    np.testing.assert_array_equal(split[1], base[1])
    np.testing.assert_allclose(split[0], base[0], rtol=0, atol=0)


def test_split_results_identical_z2o():
    from probly_search_tpu.ops.z2o_device import z2o_query_batch_async
    from probly_search_tpu.utils.tokenizers import whitespace_tokenizer

    ix, vocab, rng = _corpus()
    queries = [rng.choice(vocab) for _ in range(600)]
    dix = ix.device_index()
    dix.config.pow2_row_split = False
    base = z2o_query_batch_async(dix, queries, whitespace_tokenizer, 5).get_arrays()
    dix.config.pow2_row_split = True
    split = z2o_query_batch_async(dix, queries, whitespace_tokenizer, 5).get_arrays()
    np.testing.assert_array_equal(split[1], base[1])
    np.testing.assert_allclose(split[0], base[0], rtol=0, atol=0)
