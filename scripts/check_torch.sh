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
#
# Exits non-zero if the tests or chip_smoke.py fail.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=cpu

echo "== port tests on the CPU =="
python -m pytest -q tests/test_torch_*.py "$@"

if command -v nvidia-smi >/dev/null 2>&1 && nvidia-smi -L >/dev/null 2>&1; then
  echo "== chip_smoke.py on $(nvidia-smi --query-gpu=name --format=csv,noheader | head -n 1) =="
  python3 chip_smoke.py
else
  echo "== no card found by nvidia-smi: chip_smoke.py not run =="
fi
