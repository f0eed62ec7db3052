#!/usr/bin/env bash
# Run the CPU suite as TWO pytest processes (VERDICT r4 weak #4: per-module
# jax.clear_caches() keeps one process under the XLA segfault cliff today,
# but suite growth erodes the headroom — a process boundary resets XLA's
# internal state completely).  The halves are split by file name so each
# stays well under the single-process footprint.
#
# Usage: bash tests/run_suite_split.sh [extra pytest args]
set -uo pipefail
cd "$(dirname "$0")/.."

FILES=(tests/test_*.py)
N=${#FILES[@]}
HALF=$((N / 2))
FIRST=("${FILES[@]:0:HALF}")
SECOND=("${FILES[@]:HALF}")

echo "== suite half 1/2: ${#FIRST[@]} files =="
python -m pytest "${FIRST[@]}" -q "$@"
rc1=$?
echo "== suite half 2/2: ${#SECOND[@]} files =="
python -m pytest "${SECOND[@]}" -q "$@"
rc2=$?
if [ $rc1 -ne 0 ] || [ $rc2 -ne 0 ]; then
    echo "SPLIT SUITE FAILED (half1=$rc1 half2=$rc2)"
    exit 1
fi
echo "SPLIT SUITE OK"
