#!/usr/bin/env bash
# Green-snapshot gate for the PyTorch port (crowdmod_tpu_torch): the port's
# doctor self-check, then the port's fast test tier.  The JAX gate's flags
# (tools/preflight.sh), plus --device (default cuda: the doctor asks for the
# card and fails without one) and --dry-run (print the commands only).
#
#   ./tools/preflight_torch.sh                  # doctor + the port's fast tier
#   ./tools/preflight_torch.sh --slow           # also the port's oracle tier
#   ./tools/preflight_torch.sh --nightly        # every tier of the port's tests
#   ./tools/preflight_torch.sh --device cpu     # no GPU
#   ./tools/preflight_torch.sh --dry-run        # print what would run
set -euo pipefail
cd "$(dirname "$0")/.."

DEVICE=cuda
TIER=""
DRY=""
while [[ $# -gt 0 ]]; do
  case "$1" in
    --slow|--nightly) TIER="$1" ;;
    --device) DEVICE="$2"; shift ;;
    --dry-run) DRY=1 ;;
    -h|--help) sed -n '2,13p' "$0"; exit 0 ;;
    *) echo "unknown argument: $1" >&2; exit 2 ;;
  esac
  shift
done

run() {
  echo "+ $*"
  [[ -n "$DRY" ]] || "$@"
}

echo "== crowdmod_tpu_torch doctor =="
run python -m crowdmod_tpu_torch.cli.doctor --skip-mesh --device "$DEVICE"

echo "== the port's fast test tier =="
run python -m pytest tests/test_torch_*.py -m "not slow" -q

if [[ "$TIER" == "--slow" ]]; then
  echo "== the port's oracle test tier =="
  run python -m pytest tests/test_torch_*.py -m "slow and not nightly" -q
elif [[ "$TIER" == "--nightly" ]]; then
  echo "== the port's oracle + nightly test tiers =="
  run python -m pytest tests/test_torch_*.py -m slow -q
fi
[[ -n "$DRY" ]] && echo "preflight: dry run, nothing ran" || echo "preflight: all green"
