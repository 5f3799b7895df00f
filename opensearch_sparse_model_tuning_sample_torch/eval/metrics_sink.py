"""Metrics sink: local JSONL ledger with optional remote push.

The reference indexes eval results into an OpenSearch metrics cluster
(reference utils.py:149-163; indices beir_eval,
beir_eval_records, nano_beir_eval(_records)). Zero-egress default here is an
append-only JSONL ledger per index under $METRICS_DIR (default
output/metrics); when OS_URL is set the same documents are also POSTed to
that cluster with the same index/doc-id scheme, so dashboards keep working.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict

logger = logging.getLogger(__name__)


def metrics_dir() -> str:
    d = os.environ.get("METRICS_DIR", os.path.join("output", "metrics"))
    os.makedirs(d, exist_ok=True)
    return d


def emit_metrics(metrics: Dict, index_name: str, doc_id: str):
    doc = dict(metrics)
    doc.setdefault("id", doc_id)
    doc.setdefault("timestamp", time.time())

    path = os.path.join(metrics_dir(), f"{index_name}.jsonl")
    with open(path, "a") as f:
        f.write(json.dumps({"_index": index_name, "_id": doc_id, **doc}) + "\n")

    os_url = os.environ.get("OS_URL")
    if os_url:
        try:
            import base64
            import urllib.request

            req = urllib.request.Request(
                f"{os_url.rstrip('/')}/{index_name}/_doc/{urllib.parse.quote(doc_id, safe='')}",
                data=json.dumps(doc).encode(),
                headers={"Content-Type": "application/json"},
                method="PUT",
            )
            user, pw = os.environ.get("OS_USERNAME"), os.environ.get("OS_PASSWORD")
            if user and pw:
                token = base64.b64encode(f"{user}:{pw}".encode()).decode()
                req.add_header("Authorization", f"Basic {token}")
            urllib.request.urlopen(req, timeout=10)
        except Exception as e:  # metrics push must never fail the run
            logger.warning("remote metrics push failed: %s", e)


def read_metrics(index_name: str):
    path = os.path.join(metrics_dir(), f"{index_name}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


