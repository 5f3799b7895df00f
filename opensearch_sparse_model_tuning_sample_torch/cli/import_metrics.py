"""Backfill earlier eval results into the metrics ledger:

    python -m opensearch_sparse_model_tuning_sample_torch.cli.import_metrics \
        <output dirs or files> [--index NAME]

Reference: scripts/import_metrics.py. Re-emits the `avg_res*.json` files
found under output dirs through `eval/metrics_sink.py`, inferring the
metrics index and doc id from the path layout (beir_eval* or
nano_beir_eval*, step suffixes). Host only: no model, no card.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re

from ..eval.metrics_sink import emit_metrics

logger = logging.getLogger(__name__)


def infer_index_and_id(path: str):
    """output/<run>/beir_eval<suffix>/avg_res[_stepN].json -> (index, doc_id)."""
    d = os.path.dirname(path)
    base = os.path.basename(d)
    run = os.path.dirname(d)
    m = re.match(r"(nano_beir_eval|beir_eval)(.*)", base)
    if not m:
        return None, None
    index, suffix = m.group(1), m.group(2)
    fm = re.match(r"avg_res(_step\d+)?\.json", os.path.basename(path))
    step = fm.group(1) if fm and fm.group(1) else ""
    return index, run + suffix + step


def import_file(path: str, index_name=None, doc_id=None) -> bool:
    inferred_index, inferred_id = infer_index_and_id(path)
    index_name = index_name or inferred_index
    doc_id = doc_id or inferred_id
    if not index_name or not doc_id:
        logger.warning("cannot infer index/doc-id for %s; skipping", path)
        return False
    with open(path) as f:
        metrics = json.load(f)
    metrics.setdefault("timestamp", os.path.getmtime(path))
    emit_metrics(metrics, index_name, doc_id)
    logger.info("imported %s -> %s/%s", path, index_name, doc_id)
    return True


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("roots", nargs="+", help="output dirs (or files) to scan")
    p.add_argument("--index", default=None, help="override metrics index")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = 0
    for root in args.roots:
        if os.path.isfile(root):
            n += import_file(root, index_name=args.index)
            continue
        for path in glob.glob(os.path.join(root, "**", "avg_res*.json"), recursive=True):
            n += import_file(path, index_name=args.index)
    logger.info("imported %d result files", n)
    return n


if __name__ == "__main__":
    main()
