#!/bin/bash
# Mine -> train -> evaluate demo loop of the PyTorch port (reference
# run_ft_demo.sh); defaults to the synthetic task so it runs with zero
# egress. Runs on the CUDA card; arguments after the config (for example
# `--device cpu`, `--output_dir DIR`) go to each of the three CLIs.
#
#   bash run_ft_demo_torch.sh [config.yaml] [--device cpu] [--flag value ...]
set -e

CONFIG=${1:-configs/smoke.yaml}
shift || true

python -m opensearch_sparse_model_tuning_sample_torch.cli.mine "$CONFIG" "$@"
python -m opensearch_sparse_model_tuning_sample_torch.cli.train_ir "$CONFIG" "$@"
python -m opensearch_sparse_model_tuning_sample_torch.cli.evaluate_beir "$CONFIG" "$@"
