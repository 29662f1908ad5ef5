#!/usr/bin/env bash
# CI pipeline — the analogue of the reference's .github/workflows/ci.yml
# (check / test / lint / coverage, ci.yml:5-133), runnable locally.
set -euo pipefail
cd "$(dirname "$0")"

echo "== syntax / import check =="
python -m compileall -q probly_search_tpu tests bench.py chip_smoke.py __graft_entry__.py
python -c "import probly_search_tpu"

echo "== lint (stdlib clippy/rustfmt analogue, ci.yml:44-69) =="
python tools/lint.py

echo "== unit + integration tests + coverage floor (grcov analogue, ci.yml:71-117) =="
# ONE pytest process PER FILE: XLA:CPU segfaults in
# backend_compile_and_load once enough large programs (window
# compositions, the 8-device shard_map window) have compiled in one
# process — position-dependent (reproduced at three different tests
# purely by ordering; every file passes alone — a jax/XLA process-state
# bug, not ours).  covgate --cum unions coverage across the processes;
# the final --gate-only call applies the floor.
rm -f /tmp/covgate_cum.json
for f in tests/test_*.py; do
  echo "-- $f"
  python -m tools.covgate 0 --cum /tmp/covgate_cum.json "$f" -q
done
python -m tools.covgate 85 --gate-only /tmp/covgate_cum.json

echo "== entry-point checks (virtual 8-device CPU mesh) =="
JAX_PLATFORMS=cpu XLA_FLAGS="--xla_force_host_platform_device_count=8" python - <<'EOF2'
import jax
import __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn)(*args)
g.dryrun_multichip(8)
print("entry points OK")
EOF2

echo "== examples smoke (walkthroughs must not rot) =="
for ex in examples/*.py; do
  echo "-- $ex"
  PSEARCH_CPU=1 JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8" \
    python "$ex" > /dev/null
done

echo "== chip_smoke.py refuses to run without a GPU =="
if JAX_PLATFORMS=cpu python chip_smoke.py > /dev/null 2>&1; then
  echo "chip_smoke.py completed on the CPU" >&2
  exit 1
fi

# On the card: python chip_smoke.py (one GPU); python chip_smoke.py --mesh 4.

echo "CI OK"
