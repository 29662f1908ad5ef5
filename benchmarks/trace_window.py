#!/usr/bin/env python
"""Trace one steady BM25 serving window and reduce it to per-op device time.

    python benchmarks/trace_window.py --out chiprun_out/trace [--docs N]

Builds the bench corpus (bench.py: 1M docs, Zipf(1.07) over 50k terms),
serves 16384-query windows of the bench mix at top-10 in the bench's
slots20 format until the window program is compiled, times a few windows
with ``block_until_ready``, then records ONE window under ``jax.profiler``
and reduces the trace (``jax.profiler.ProfileData``) to the device time of
each named stage of the query program: ``gather``, ``score``,
``merge_sort``, ``merge_scan``, ``topk`` and ``pack`` (the
``jax.named_scope`` names in index/device.py and ops/merge.py).  The
gather's bytes come from the window's class shapes; its rate is compared
with the card's HBM peak.  Writes ``<out>/summary.json`` and prints it.

XLA:GPU folds runs of kernels into command buffers (CUDA graphs), whose
trace events carry no op name; this script turns them off
(``--xla_gpu_enable_command_buffer=``) so every kernel is attributed.  The
untraced pace it reports is therefore without command buffers too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":  # before JAX starts: attribute every kernel
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()

STAGES = ("gather", "score", "merge_sort", "merge_scan", "topk", "pack")
# HBM peak per device kind (NVIDIA H100 SXM data sheet).
HBM_PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


_HLO_OP_NAME = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name="([^"]*)"', re.M)


def hlo_scopes(hlo_text: str) -> dict:
    """Instruction name -> op_name metadata of an optimized HLO module; a
    trace event's ``hlo_op`` stat is such an instruction name."""
    return dict(_HLO_OP_NAME.findall(hlo_text))


def _stage_of(event, scopes) -> str:
    """The named scope an XLA op event belongs to: from the op_name of its
    HLO instruction (``scopes``) or its own op-name stat.  Library kernels
    that carry neither are named by their kernel: XLA's GPU top-k kernel
    (``stream_executor::...::Run<k, float, ...>``) and the sorts (XLA's
    ``sort_*`` kernels, CUB radix sorts)."""
    stats = dict(event.stats)
    scope = scopes.get(str(stats.get("hlo_op", ""))) or str(stats.get("name", ""))
    for stage in STAGES:
        if f"/{stage}/" in scope or scope.endswith(f"/{stage}"):
            return stage
    if "stream_executor::cuda::Run<" in event.name or "TopK" in event.name:
        return "topk"
    if event.name.startswith("sort") or "RadixSort" in event.name:
        return "merge_sort"
    return "other"


def _union_ns(intervals) -> int:
    total = 0
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(trace_dir: str, scopes=None) -> dict:
    """Per-stage device time, busy share and top ops of a profiler trace;
    ``scopes`` maps HLO instruction names to op names (:func:`hlo_scopes`)."""
    scopes = scopes or {}
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    out = {"planes": [p.name for p in pd.planes], "devices": {}}
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        lines = {ln.name: list(ln.events) for ln in plane.lines}
        ops = lines.get("XLA Ops")
        if ops is None:  # no op line by that name: take the busiest line
            cand = [v for k, v in lines.items() if "Module" not in k and "Step" not in k]
            ops = max(cand, key=len, default=[])
        if not ops:
            out["devices"][plane.name] = {"lines": sorted(lines), "n_op_events": 0}
            continue
        stage_ns = {s: 0 for s in STAGES + ("other",)}
        by_name = {}
        for ev in ops:
            stage_ns[_stage_of(ev, scopes)] += ev.duration_ns
            by_name[ev.name] = by_name.get(ev.name, 0) + ev.duration_ns
        t0 = min(ev.start_ns for ev in ops)
        t1 = max(ev.end_ns for ev in ops)
        busy = _union_ns([(ev.start_ns, ev.end_ns) for ev in ops])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:25]
        sample = {}
        for ev in ops:
            if ev.name in dict(top[:8]) and ev.name not in sample:
                sample[ev.name] = {k: str(v)[:300] for k, v in ev.stats}
        out["devices"][plane.name] = {
            "lines": sorted(lines),
            "n_op_events": len(ops),
            "stage_ms": {k: v / 1e6 for k, v in stage_ns.items()},
            "op_span_ms": (t1 - t0) / 1e6,
            "busy_ms": busy / 1e6,
            "busy_share_of_span": busy / max(t1 - t0, 1),
            "top_ops_ms": [(n, v / 1e6) for n, v in top],
            "top_op_stats": sample,
        }
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--window", type=int, default=16384)
    args = ap.parse_args(argv)

    import jax

    from bench import make_corpus, make_queries
    from probly_search_tpu import Index, IndexConfig, bm25
    from probly_search_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    vocab, cdf, texts = make_corpus(args.docs, 50_000, 8, seed=0)
    ix = Index(1, config=IndexConfig(result_format="slots20"))
    ix.add_documents_columnar(list(range(args.docs)), [texts])
    dix = ix.device_index()
    queries = make_queries(vocab, cdf, 2 * args.window, 3)
    windows = [queries[: args.window], queries[args.window :]]
    scorer = bm25.new()
    t0 = time.perf_counter()
    for _ in range(2):
        for w in windows:
            dix.query_batch_async(w, scorer, top_k=10).get_arrays()
    warm_s = time.perf_counter() - t0

    # Untraced device-stream pace: queue N windows, block on the last.
    def queue(n):
        t = time.perf_counter()
        hs = [dix.query_batch_async(windows[i % 2], scorer, top_k=10) for i in range(n)]
        hs[-1]._packed.block_until_ready()
        return time.perf_counter() - t

    t1 = min(queue(1) for _ in range(3))
    t8 = min(queue(8) for _ in range(3))

    os.makedirs(args.out, exist_ok=True)
    dix.query_batch_async(windows[0], scorer, top_k=10).get_arrays()
    with jax.profiler.trace(args.out):
        with jax.profiler.TraceAnnotation("window"):
            dix.query_batch_async(windows[0], scorer, top_k=10).get_arrays()
    # The optimized HLO of the traced window program (the same program
    # DeviceIndex.prewarm compiles for the frozen template): maps each
    # kernel's HLO instruction to its named scope.
    import jax.numpy as jnp

    from probly_search_tpu.index.device import _AUX_DUMMY, _get_window_step

    R = int(dix.rec.shape[0])
    specs = [e for v in dix._comp_templates.values() for e in v]
    (tkey,) = dix._comp_templates
    hlo = _get_window_step(scorer).lower(
        dix.rec,
        dix.field_avg,
        jnp.ones(1, jnp.float32),
        jnp.zeros(sum(cap * nj * 3 for _nc, nj, cap, _cw in specs), jnp.int32),
        jnp.asarray(_AUX_DUMMY),
        chunk=dix.CHUNK,
        k=tkey[1],
        qterm_bits=dix._qterm_bits,
        num_fields=dix.num_fields,
        class_specs=tuple((cap, cap, nj, nc, False, cw) for nc, nj, cap, cw in specs),
        fmt=tkey[2],
    ).compile().as_text()
    with open(os.path.join(args.out, "window_hlo.txt"), "w") as f:
        f.write(hlo)
    summary = reduce_trace(args.out, hlo_scopes(hlo))

    gather_bytes = sum(cap * nc * cw * R * 4 for nc, _nj, cap, cw in specs)
    peak = HBM_PEAK_BYTES_PER_S.get(dev.device_kind)
    for d in summary["devices"].values():
        if not d["n_op_events"]:
            continue
        g_s = d["stage_ms"]["gather"] / 1e3
        d["gather_bytes_read"] = gather_bytes
        d["gather_bytes_per_s"] = gather_bytes / g_s if g_s else None
        d["gather_share_of_hbm_peak"] = (
            gather_bytes / g_s / peak if (g_s and peak) else None
        )
    summary.update(
        device={"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
        docs=args.docs,
        window=args.window,
        class_entries=specs,
        rec_rows=R,
        warm_s=warm_s,
        queue1_ms=t1 * 1e3,
        queue8_ms=t8 * 1e3,
        device_pace_ms_per_window=(t8 - t1) / 7 * 1e3,
    )
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
