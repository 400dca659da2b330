#!/usr/bin/env bash
# Sample every bundled dataset with one trained architecture, with the
# PyTorch port (crowdmod_tpu_torch).
#
# The JAX tool's loop (tools/sample_all_datasets.sh) over the same dataset
# configs, driving `python -m crowdmod_tpu_torch.cli.generate_samples` on
# DEVICE (default cuda: it fails without a GPU).  Each dataset needs a
# checkpoint saved under its config's SAVE_DIR first; a dataset whose
# sampling fails is skipped with a WARN line.
#
# Usage: tools/sample_all_datasets_torch.sh [--dry-run] [ARCH] [PLOT_TYPE] [DEVICE]
#        (--dry-run prints each command instead of running it)
set -euo pipefail
cd "$(dirname "$0")/.."

DRY=""
case "${1:-}" in
  -h|--help) sed -n '2,12p' "$0"; exit 0 ;;
  --dry-run) DRY=1; shift ;;
esac

ARCH="${1:-DDPM-UNet}"
PLOT_TYPE="${2:-Static}"
DEVICE="${3:-cuda}"

DATASETS=(ATC HERMES-BO HERMES-BN HERMES-CR-90 HERMES-CR-90-OBST HERMES-CR-120 HERMES-CR-120-OBST ETHUCY)

for ds in "${DATASETS[@]}"; do
    cfg="configs/${ds}.yml"
    if [[ ! -f "$cfg" ]]; then
        echo "skipping ${ds}: ${cfg} not found"
        continue
    fi
    list="configs/${ds}_datafiles.yml"
    list_args=()
    [[ -f "$list" ]] && list_args=(--configList-yml-file "$list")
    echo "=== sampling ${ds} with ${ARCH} ==="
    cmd=(python -m crowdmod_tpu_torch.cli.generate_samples
         --config-yml-file "$cfg" "${list_args[@]}"
         --arch "$ARCH" --plot-type "$PLOT_TYPE" --device "$DEVICE")
    if [[ -n "$DRY" ]]; then
        echo "+ ${cmd[*]}"
        continue
    fi
    "${cmd[@]}" || echo "WARN: ${ds} failed (missing checkpoint or data?)"
done
