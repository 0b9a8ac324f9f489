#!/usr/bin/env bash
# Canonical test lane: the suite split into a few pytest processes.
#
# Why not one process: the XLA CPU compiler in this image segfaults /
# aborts nondeterministically after many hundreds of in-process compiles
# (see CLAUDE.md "KNOWN FLAKE"; crash is inside backend_compile_and_load,
# every victim test passes standalone; standalone repro:
# tools/repro_compile_crash.py).  The compile-heavy files
# (test_pipeline_stats, test_sharding — the big sharded programs) get
# their own processes and the rest is grouped to keep per-process compile
# counts bounded; observed crashes cluster right AFTER test_pipeline_stats
# in single-process runs.
#
# Two mechanical fences:
#   - TC_COMPILE_BUDGET: tests/conftest.py counts real backend compiles
#     per process and ERRORS the crossing test, so group drift toward the
#     crash zone is loud, not silent.  Budget = 850 vs 2026-08-19 measured
#     group maxima {540, 164, 683, 33, 459}.
#   - group coverage check: every tests/test_*.py must appear in exactly
#     one group, so a new test file cannot be silently skipped.
#
# Usage:
#   tools/run_tests.sh             # fast lane (skips @slow, ~matches pytest -q)
#   tools/run_tests.sh --slow      # full lane
# Extra args are passed to every pytest invocation.

set -u
cd "$(dirname "$0")/.."

GROUPS_LIST=(
  "tests/test_ablation.py tests/test_analysis.py tests/test_chain_parity.py tests/test_cmip6_e2e.py tests/test_distributed.py tests/test_distributed_init.py tests/test_fast_golden.py tests/test_gcm_inputs.py tests/test_io_netcdf.py tests/test_notebook.py tests/test_ops_basic.py"
  "tests/test_pipeline_stats.py tests/test_quota_stress.py"
  "tests/test_preprocess.py tests/test_reader_fuzz.py tests/test_reference_differential.py tests/test_reference_differential_fast.py tests/test_reference_differential_seeding.py tests/test_seeding_parity.py"
  "tests/test_sharding.py"
  "tests/test_simulator.py tests/test_thermo.py tests/test_chip_smoke.py"
)

# --- group coverage fence: every tests/test_*.py in exactly one group ----
all_grouped=$(printf '%s\n' "${GROUPS_LIST[@]}" | tr ' ' '\n' | sort)
all_files=$(ls tests/test_*.py | sort)
if [ "$all_grouped" != "$all_files" ]; then
  echo "run_tests.sh: GROUPS_LIST is out of sync with tests/test_*.py" >&2
  echo "--- only in groups:" >&2
  comm -23 <(printf '%s\n' "$all_grouped") <(printf '%s\n' "$all_files") >&2
  echo "--- only on disk (NOT RUN):" >&2
  comm -13 <(printf '%s\n' "$all_grouped") <(printf '%s\n' "$all_files") >&2
  exit 2
fi
dups=$(printf '%s\n' "$all_grouped" | uniq -d)
if [ -n "$dups" ]; then
  echo "run_tests.sh: files listed in more than one group: $dups" >&2
  exit 2
fi

export TC_COMPILE_BUDGET="${TC_COMPILE_BUDGET:-850}"

fail=0
for g in "${GROUPS_LIST[@]}"; do
  echo "=== pytest $g $* ==="
  # shellcheck disable=SC2086
  python -m pytest $g -q "$@"
  rc=$?
  if [ $rc -ne 0 ]; then
    fail=$rc
    echo "=== group FAILED (rc=$rc): $g ===" >&2
  fi
done
exit $fail
