#!/usr/bin/env bash
# 2-process multi-host smoke test.
#
# Spawns two CPU processes, each with 4 virtual devices; jax.distributed
# joins them into one 8-device global mesh. Asserts sharded_detect and one
# distributed BA step match single-process compute. This is the scaled-down
# rehearsal of a multi-host run (same init, same mesh, same collectives —
# the network replaced by localhost gRPC).
#
# Both processes stay pinned to CPU devices (scripts/multihost_worker.py
# sets JAX_PLATFORMS=cpu), so they never share a GPU: a JAX process
# reserves most of a card's memory, and a second process on that card
# would fail. On GPUs, run one process per card.
#
# Usage: bash scripts/multihost_smoke.sh [port]
set -euo pipefail
cd "$(dirname "$0")/.."
PORT="${1:-$(( (RANDOM % 20000) + 20000 ))}"

LOG0=$(mktemp /tmp/mh_p0.XXXX.log)
LOG1=$(mktemp /tmp/mh_p1.XXXX.log)

timeout 300 python scripts/multihost_worker.py 0 2 "$PORT" >"$LOG0" 2>&1 &
P0=$!
timeout 300 python scripts/multihost_worker.py 1 2 "$PORT" >"$LOG1" 2>&1 &
P1=$!

FAIL=0
wait "$P0" || FAIL=1
wait "$P1" || FAIL=1

echo "--- process 0 ---"; cat "$LOG0"
echo "--- process 1 ---"; cat "$LOG1"

if [ "$FAIL" -ne 0 ] || ! grep -q "OK" "$LOG0" || ! grep -q "OK" "$LOG1"; then
  echo "MULTIHOST SMOKE: FAILED"
  exit 1
fi
echo "MULTIHOST SMOKE: PASSED (2 processes x 4 devices, 8-device global mesh)"
