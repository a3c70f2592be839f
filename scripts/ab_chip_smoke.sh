#!/usr/bin/env bash
# Compare two trees of the port on one card in one call: run
# chip_smoke.py's phases on PARENT (a checkout of another commit, e.g.
# unpacked with `git archive <commit> | tar -x -C build/ab_parent`) and
# on this tree, in the order parent, change, change, parent, sharing one
# kernel build directory (the sources must match). Each run's output goes
# to chiprun_out/ab_<n>_<tree>.log; read the phases' JSON lines there.
#
#   scripts/ab_chip_smoke.sh build/ab_parent 1,2,12
set -euo pipefail
cd "$(dirname "$0")/.."
parent=$1
phases=$2
export REPRO_TORCH_BUILD_DIR=$PWD/build/ab_libs
mkdir -p chiprun_out
i=0
for tree in parent change change parent; do
  i=$((i + 1))
  dir=.
  [[ $tree == parent ]] && dir=$parent
  log=$PWD/chiprun_out/ab_${i}_${tree}.log
  (cd "$dir" && python3 chip_smoke.py --phases "$phases") > "$log" 2>&1
  echo "$tree: $(tail -n 1 "$log")"
done
