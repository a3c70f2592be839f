#!/usr/bin/env bash
# Smoke check of the PyTorch/CUDA port (src/repro_torch). Run from
# anywhere.
#
#   scripts/check_torch.sh          # the port's tests on the CPU
#                                   # (tests/test_torch_*.py, held
#                                   # against the JAX reference), then,
#                                   # where nvidia-smi finds a card,
#                                   # python3 chip_smoke.py on it
#   scripts/check_torch.sh -k name  # pytest args pass through
#   scripts/check_torch.sh --chaos  # the robustness layer alone: the
#                                   # faults, chaos and launcher tests,
#                                   # then chip_smoke.py --phases 1,2,15
#
# Exits non-zero if the tests or chip_smoke.py fail.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=cpu

tests=(tests/test_torch_*.py)
smoke=()
if [[ "${1:-}" == "--chaos" ]]; then
  shift
  tests=(tests/test_torch_faults.py tests/test_torch_chaos.py
         tests/test_torch_chaos_families.py tests/test_torch_launch.py)
  smoke=(--phases 1,2,15)
fi

echo "== port tests on the CPU =="
python -m pytest -q "${tests[@]}" "$@"

if command -v nvidia-smi >/dev/null 2>&1 && nvidia-smi -L >/dev/null 2>&1; then
  echo "== chip_smoke.py on $(nvidia-smi --query-gpu=name --format=csv,noheader | head -n 1) =="
  python3 chip_smoke.py "${smoke[@]}"
else
  echo "== no card found by nvidia-smi: chip_smoke.py not run =="
fi
