"""Corpus datasets for ingest and search: host-side indexable sequences.

The PyTorch port's copy of the two views the eval path uses from the JAX
package's `data/datasets.py` (reference dataset.py:43-64). The training
datasets come with the training slice.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


class BEIRCorpusDataset:
    """BEIR corpus dict -> (doc_id, "title text") in sorted-id order; empty
    documents are dropped (reference dataset.py:43-64)."""

    def __init__(self, corpus: Dict[str, Dict[str, str]]):
        self.items: List[Tuple[str, str]] = []
        for key in sorted(corpus.keys()):
            doc = corpus[key]
            text = (doc.get("title", "") + " " + doc.get("text", "")).strip()
            if text:
                self.items.append((key, text))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]


class KeyValueDataset:
    """Plain dict -> (key, value) in sorted-key order (dataset.py:43-58)."""

    def __init__(self, data: Dict):
        self.keys = sorted(data.keys())
        self.data = data

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, idx: int):
        k = self.keys[idx]
        return k, self.data[k]
