#!/bin/bash
# chip_smoke.py of the parent (unpacked under build/parent with
# `git archive <parent> | tar -x -C build/parent`), then of TREE (the repo by
# default), one after the other on one card (ORDER="change parent" runs the
# tree first); logs LOGDIR/TAG_{parent,change}.log (LOGDIR: logs by default).
#
#     LOGDIR=... bash tools/torch_smoke_pair.sh [TREE] [TAG]
root="$(cd "$(dirname "$0")/.." && pwd)"
change="${1:-$root}"
tag="${2:-pair}"
logs="$(mkdir -p "${LOGDIR:-$root/logs}" && cd "${LOGDIR:-$root/logs}" && pwd)"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for which in ${ORDER:-parent change}; do
  dir="$root/build/parent"; [ "$which" = change ] && dir="$change"
  start=$(date +%s)
  (cd "$dir" && python3 chip_smoke.py > "$logs/${tag}_${which}.log" 2>&1)
  echo "$which rc=$? seconds=$(( $(date +%s) - start ))"
  grep -a "seconds by phase" "$logs/${tag}_${which}.log" | tail -1
  tail -n 1 "$logs/${tag}_${which}.log"
done
