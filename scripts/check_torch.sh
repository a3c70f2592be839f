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
#   scripts/check_torch.sh --docs   # every examples_torch/*.py with
#                                   # --device cpu and the fast arguments
#                                   # of scripts/check.sh --docs, then
#                                   # chip_smoke.py --phases 1,2,19
#
# Exits non-zero if the tests or chip_smoke.py fail.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export JAX_PLATFORMS=cpu

tests=(tests/test_torch_*.py)
smoke=()
if [[ "${1:-}" == "--docs" ]]; then
  shift
  echo "== the port's examples on the CPU =="
  for ex in examples_torch/*.py; do
    args=()
    case "$(basename "$ex")" in
      serve_llm.py) args=(--tokens 4) ;;
      prefix_serve.py) args=(--requests 8) ;;
      # a fresh checkpoint directory: a resumed 2-step run has no steps
      # left to smoke
      train_llm.py) args=(--steps 2 --tiny --ckpt-dir "$(mktemp -d)") ;;
    esac
    echo "-- $ex ${args[*]:-}"
    python "$ex" --device cpu ${args[@]+"${args[@]}"} >/dev/null
  done
  tests=()
  smoke=(--phases 1,2,19)
elif [[ "${1:-}" == "--chaos" ]]; then
  shift
  tests=(tests/test_torch_faults.py tests/test_torch_chaos.py
         tests/test_torch_chaos_families.py tests/test_torch_launch.py)
  smoke=(--phases 1,2,15)
fi

if [[ ${#tests[@]} -gt 0 ]]; then
  echo "== port tests on the CPU =="
  python -m pytest -q "${tests[@]}" "$@"
fi

if command -v nvidia-smi >/dev/null 2>&1 && nvidia-smi -L >/dev/null 2>&1; then
  echo "== chip_smoke.py on $(nvidia-smi --query-gpu=name --format=csv,noheader | head -n 1) =="
  python3 chip_smoke.py "${smoke[@]}"
else
  echo "== no card found by nvidia-smi: chip_smoke.py not run =="
fi
