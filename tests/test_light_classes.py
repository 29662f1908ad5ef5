"""Light shape classes (IndexConfig.light_chunk_size).

Queries whose bucketed lane count strictly shrinks at a smaller chunk
width are classed at that width (device chunk decomposition is per class;
index/device.py _light_classes).  The r8 lane census measured 37.6% of
the headline window's chunk-grid lanes as in-chunk tail padding, mostly
in light classes.  Results must be IDENTICAL to the single-width engine
(same merge contract — chunks stay ascending doc-sorted runs at any pow2
width), across the composed, template, and per-class dispatch paths.
"""

import numpy as np

from probly_search_tpu import Index, bm25, whitespace_tokenizer
from probly_search_tpu.config import IndexConfig

tokenizer = whitespace_tokenizer


def _corpus(n=3000, seed=7):
    # Default chunk width (1024): term dfs of ~30-600 postings leave most
    # posting lists inside one mostly-empty 1024-chunk — light territory.
    import random

    rng = random.Random(seed)
    vocab = [f"t{i:03d}" for i in range(60)]
    col = []
    for i in range(n):
        col.append(" ".join(rng.choice(vocab) for _ in range(5)))
    return vocab, col


def _build(**cfg):
    vocab, col = _corpus()
    cfg.setdefault("light_chunk_size", 256)  # default is 0 (off)
    ix = Index(1, config=IndexConfig(**cfg))
    ix.add_documents_columnar(list(range(len(col))), [col])
    return vocab, ix


def _rows_equal(a, b, queries):
    assert len(a) == len(b)
    for q, ra, rb in zip(queries, a, b):
        assert [r.key for r in ra] == [r.key for r in rb], q
        np.testing.assert_array_equal(
            np.array([r.score for r in ra], np.float32),
            np.array([r.score for r in rb], np.float32),
            err_msg=q,
        )


class TestLightClasses:
    def test_packer_picks_light_width(self):
        vocab, ix = _build()
        dix = ix.device_index()
        queries = [f"{vocab[3]} {vocab[4]} {vocab[5]}", vocab[10]]
        plan, fb = dix.plan_batch(queries, tokenizer, bm25.new())
        assert plan is not None and not fb
        disp = dix.pack_dispatches(len(queries), plan)
        widths = {d[5] for d in disp}
        assert 256 in widths, (widths, [d[2:] for d in disp])

    def test_light_off_on_bit_equal_and_oracle(self):
        vocab, ix_on = _build()
        _, ix_off = _build(light_chunk_size=0)
        queries = [
            f"{vocab[0]} {vocab[1]} {vocab[2]}",
            vocab[7],
            f"{vocab[20]} {vocab[21]}",
            "zzz",
            "",
            f"{vocab[5]} {vocab[5]} {vocab[9]}",
        ]
        for k in (3, 10):
            a = ix_on.query_batch(
                queries, bm25.new(), tokenizer, top_k=k, backend="device"
            )
            b = ix_off.query_batch(
                queries, bm25.new(), tokenizer, top_k=k, backend="device"
            )
            _rows_equal(a, b, queries)
            for q, row in zip(queries, a):
                oracle = ix_on.query(q, bm25.new(), tokenizer, [1.0])[:k]
                assert [r.key for r in row] == [r.key for r in oracle], q

    def test_template_path_carries_width(self):
        vocab, ix = _build()  # template_compositions default ON
        queries = [f"{vocab[i % 30]} {vocab[(i * 7) % 30]}" for i in range(64)]
        a = ix.query_batch(queries, bm25.new(), tokenizer, top_k=5,
                           backend="device")
        b = ix.query_batch(queries, bm25.new(), tokenizer, top_k=5,
                           backend="device")  # second pass rides the template
        _rows_equal(a, b, queries)
        dix = ix.device_index()
        entries = next(iter(dix._comp_templates.values()))
        assert any(len(e) > 3 and e[3] == 256 for e in entries), entries

    def test_per_class_dispatch_path(self):
        vocab, ix = _build(per_class_dispatch=True)
        _, ix_off = _build(per_class_dispatch=True, light_chunk_size=0)
        queries = [f"{vocab[0]} {vocab[9]}", vocab[3], f"{vocab[4]} zz"]
        a = ix.query_batch(queries, bm25.new(), tokenizer, top_k=5,
                           backend="device")
        b = ix_off.query_batch(queries, bm25.new(), tokenizer, top_k=5,
                               backend="device")
        _rows_equal(a, b, queries)

    def test_prune_interplay(self):
        # Pruned (trimmed/split) jobs re-decompose at the light width; the
        # prune parity contract must survive the reclassing.
        vocab, col = _corpus()
        col = ["common common common common" if i < 8 else c + " common"
               for i, c in enumerate(col)]
        ix = Index(
            1, config=IndexConfig(prune_blocks=True, light_chunk_size=256)
        )
        ix.add_documents_columnar(list(range(len(col))), [col])
        queries = ["common", f"common {vocab[4]}", vocab[4]]
        a = ix.query_batch(queries, bm25.new(), tokenizer, top_k=3,
                           backend="device")
        ix.config.prune_blocks = False
        b = ix.query_batch(queries, bm25.new(), tokenizer, top_k=3,
                           backend="device")
        ix.config.prune_blocks = True
        _rows_equal(a, b, queries)

    def test_invalid_light_widths_disable(self):
        vocab, ix = _build(light_chunk_size=300)  # not pow2/128-divisible
        dix = ix.device_index()
        assert dix._light_width() == 0
        vocab, ix2 = _build(chunk_size=128)  # light >= global width
        assert ix2.device_index()._light_width() == 0
        row = ix.query_batch([vocab[0]], bm25.new(), tokenizer, top_k=3,
                             backend="device")[0]
        oracle = ix.query(vocab[0], bm25.new(), tokenizer, [1.0])[:3]
        assert [r.key for r in row] == [r.key for r in oracle]
