#!/bin/bash
# Fine-tune and then run the BEIR evaluation of the PyTorch port for every
# config given on the command line, one after another. One process trains
# over the visible cards (`dp_size`, -1: all of them). `--device DEV`
# (e.g. `--device cpu`) goes to every run.
#
#   bash run_train_eval_torch.sh [--device DEV] <config1.yaml> [config2.yaml] ...
set -e

DEVICE=()
if [ "$1" = "--device" ]; then
    DEVICE=(--device "$2")
    shift 2
fi
if [ $# -eq 0 ]; then
    echo "Usage: $0 [--device DEV] <config1.yaml> [config2.yaml] ..."
    exit 1
fi

for CONFIG_PATH in "$@"; do
    if [ ! -f "$CONFIG_PATH" ]; then
        echo "warning: no such config '$CONFIG_PATH', skipping"
        continue
    fi
    echo "=== train+eval: $CONFIG_PATH ==="
    python -m opensearch_sparse_model_tuning_sample_torch.cli.train_ir "$CONFIG_PATH" "${DEVICE[@]}"
    python -m opensearch_sparse_model_tuning_sample_torch.cli.evaluate_beir "$CONFIG_PATH" "${DEVICE[@]}"
    echo "=== done: $CONFIG_PATH ==="
done
