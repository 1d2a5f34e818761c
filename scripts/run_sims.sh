#!/usr/bin/env bash
# Campaign runner preserving the reference's run_sims.sh contract
# (reference run_sims.sh:7-25): first arg SEQL|PARA, remaining args are
# case names forwarded to the campaign registry; command lines are
# emitted by --emit and executed here.
#
# SEQL runs the lines one after another and stops at the first failure.
# PARA, with GPUs visible, runs one worker per card, pinned to it with
# CUDA_VISIBLE_DEVICES: a JAX process reserves most of its card's memory,
# so two on one card would fail. Each worker runs its share of the lines
# in sequence and carries on past a failed line. With no GPU, PARA runs
# every line as its own CPU process, as the reference does (host-bound
# cases such as LP then use every core). PARA waits for every process,
# names the lines that failed, and exits non-zero if any did.
#
# Usage: ./scripts/run_sims.sh SEQL REG_BAD --data_dir=/tmp/out
set -euo pipefail

mode="${1:?usage: run_sims.sh SEQL|PARA <case...> [extra args]}"
shift

cases=()
extra=()
for arg in "$@"; do
  case "$arg" in
    -*) extra+=("$arg") ;;
    *) cases+=("$arg") ;;
  esac
done

# Collect lines first (a `| while read` pipeline would background the
# jobs inside a subshell, leaving the outer `wait` nothing to wait on).
mapfile -t lines < <(python -m ldpc_decoders_tpu.campaign "${cases[@]}" --emit)

run_line() {
  local cmd="python -u -m ldpc_decoders_tpu.main $1 ${extra[*]-}"
  echo ">> ${2:+[card $2] }$cmd"
  eval "$cmd" || { echo "!! failed: $1" >&2; return 1; }
}

if [ "$mode" != "PARA" ]; then
  for line in "${lines[@]}"; do run_line "$line"; done
  echo "run_sims done"
  exit 0
fi

if [ -n "${CUDA_VISIBLE_DEVICES-}" ]; then
  IFS=, read -ra cards <<< "$CUDA_VISIBLE_DEVICES"
else
  mapfile -t cards < <(nvidia-smi --query-gpu=index --format=csv,noheader \
                       2>/dev/null || true)
fi
n=${#cards[@]}

pids=()
if [ "$n" -eq 0 ]; then
  for line in "${lines[@]}"; do
    run_line "$line" &
    pids+=($!)
  done
else
  for slot in $(seq 0 $((n - 1))); do
    (
      export CUDA_VISIBLE_DEVICES="${cards[$slot]}"
      failed=0
      for i in "${!lines[@]}"; do
        (( i % n == slot )) || continue
        run_line "${lines[$i]}" "${cards[$slot]}" || failed=1
      done
      exit "$failed"
    ) &
    pids+=($!)
  done
fi

status=0
for pid in "${pids[@]}"; do wait "$pid" || status=1; done
if [ "$status" -ne 0 ]; then
  echo "run_sims: some lines failed (see '!! failed' above)" >&2
  exit 1
fi
echo "run_sims done"
