#!/usr/bin/env bash
# The port's checks (src/repro_torch), the counterpart of scripts/check.sh
# and the single entry point of .github/workflows/ci_torch.yml:
#   bash scripts/check_torch.sh [--fast]
# --fast skips the port's pytest suite (smokes only).
#
# CHECK_DEVICE (default cuda; cpu where no card is present, as in CI) is
# passed as --device to every smoke.  CHECK_SKIP_SCALE=1 skips the
# road64k scale smokes.
#
# Every stage runs with its exit code captured explicitly; a failing
# stage marks the whole run failed but later stages still execute, and
# the script's own exit code aggregates them — `set -e` alone is not
# relied on for the smoke invocations (a non-final failing stage must
# not be maskable by a later passing one, and CI needs the non-zero
# code propagated).
set -uo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
DEVICE="${CHECK_DEVICE:-cuda}"

fail=0
failed_stages=()

run_stage() {
    local name="$1"
    shift
    echo "== ${name} =="
    local t0=${SECONDS}
    if "$@"; then
        echo "-- ${name}: OK ($((SECONDS - t0))s)"
    else
        local rc=$?
        echo "-- ${name}: FAILED (exit ${rc}, $((SECONDS - t0))s)"
        fail=1
        failed_stages+=("${name}")
    fi
}

echo "check_torch: device ${DEVICE}"

# Lint first (cheapest signal).  ruff is a CI dependency, not a
# container one — skip gracefully where it isn't installed.
if command -v ruff >/dev/null 2>&1; then
    run_stage "ruff lint" ruff check src/repro_torch tests/test_torch_*.py \
        chip_smoke.py
else
    echo "== ruff lint =="
    echo "-- ruff lint: SKIPPED (ruff not installed)"
fi

if [[ "${1:-}" != "--fast" ]]; then
    # the port's tier-1 tests; no -x: report ALL failures, not the
    # first; --durations surfaces the slowest tests so suite growth
    # stays accountable.  The parity tests import the JAX package too;
    # tests marked cuda run only where a card is present.
    run_stage "port tier-1 tests" python -m pytest -q --durations=10 \
        tests/test_torch_*.py
fi

run_stage "serve smoke (2k nodes, validated)" \
    python -m repro_torch.launch.serve --device "${DEVICE}" --nodes 2000 \
    --batches 2 --batch-size 256 --validate 64 --json ""

run_stage "live-traffic refresh smoke" \
    python -m repro_torch.launch.serve --device "${DEVICE}" --nodes 2000 \
    --batches 1 --batch-size 256 --validate 32 --update-batches 1 \
    --update-frac 0.02 --json ""

# The worker-parallel cover build must be array-equal to the serial
# build on every index table: --check-build-parity rebuilds serially
# in-run and fails the run on any table that differs.
run_stage "host-build parity smoke (road4000, 2 workers)" \
    python -m repro_torch.launch.serve --device "${DEVICE}" --nodes 4000 \
    --batches 1 --batch-size 256 --validate 16 --build-workers 2 \
    --check-build-parity --json ""

# --metrics-out/--trace-out exercise the observability exporters end to
# end on every check run; CI uploads the snapshot and the Chrome trace
# as workflow artifacts (ci_torch.yml)
run_stage "live serving smoke (open-loop + concurrent refresh)" \
    python -m repro_torch.launch.serve --device "${DEVICE}" --nodes 2000 \
    --live --rate 400 --live-seconds 2 --mix zipf \
    --live-update-batches 1 --validate 24 --json "" \
    --metrics-out obs_metrics.json --trace-out obs_trace.json

# Scale smokes: road64k must build the preset's 3-level overlay
# (--expect-hierarchy 3 fails the run on a shallower build) with a
# level-2 boundary of at most 0.5*S (--max-s2-ratio), and serve with
# sampled Dijkstra parity; then serve live while a 2% update batch
# re-closes through the pipeline, failing on a serving gap above 15 s
# (--max-serving-gap) or a label tier that served under 10% of the
# cache misses (--hot-tier, with 2,048 hub nodes from the Zipf pool's
# head).  CHECK_SKIP_SCALE=1 skips both (a road64k device build on a
# CPU takes minutes).
if [[ "${CHECK_SKIP_SCALE:-}" != "1" ]]; then
    run_stage "scale smoke (road64k, hierarchical overlay, validated)" \
        python -m repro_torch.launch.serve --device "${DEVICE}" \
        --graph road64k --batches 1 --batch-size 256 --validate 8 \
        --update-batches 0 --expect-hierarchy 3 --max-s2-ratio 0.5 \
        --json ""
    run_stage "scale live smoke (road64k, pipelined refresh, gap-gated)" \
        python -m repro_torch.launch.serve --device "${DEVICE}" \
        --graph road64k --live --rate 60 --live-seconds 8 --mix zipf \
        --live-batch 1024 --live-update-batches 1 --update-frac 0.02 \
        --live-update-every 2 --live-pipelined \
        --hub-budget 2048 --hot-tier 0.10 \
        --max-serving-gap 15 --validate 8 --json ""
else
    echo "== scale smoke (road64k) =="
    echo "-- scale smoke: SKIPPED (CHECK_SKIP_SCALE=1)"
fi

run_stage "quickstart" python -m repro_torch.examples.quickstart \
    --device "${DEVICE}"

if [[ ${fail} -ne 0 ]]; then
    echo "CHECKS FAILED: ${failed_stages[*]}"
    exit 1
fi
echo "ALL CHECKS PASSED"
