"""Precomputed-embedding store with prefetch overlap.

The PyTorch port's own copy of the JAX package's framework-free
`train/embedding_store.py`, which replaces the reference's DynamoDB-backed
EmbeddingService (async_embedding_server.py:14-131, dynamo_utils.py:6-179)
with a local memory-mapped store:

  * storage: one dir per (table, model_id) holding an append-only fp16
    `vectors.bin` (memory-mapped for reads) and an `ids.txt` row->id log:
    zero-copy reads, O(batch) appends, no network;
  * the register-at-collate / fetch-at-step overlap protocol of the
    reference (a ThreadPoolExecutor and a per-key Event, errors stored in
    the result map so no waiter deadlocks). The owner calls `shutdown` when
    the run ends, also when it raises.
"""

from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np


class LocalVectorStore:
    """Disk-backed {(table, model_id): id -> fp16 vector} store."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._cache: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def _dir(self, table: str, model_id: int) -> str:
        return os.path.join(self.root, f"{table}_{model_id}")

    def store(self, table: str, model_id: int, ids: Sequence[int], vectors: np.ndarray):
        """Append a batch to a table (build-time API, analogous to
        batch_store_vectors_binary). O(batch): raw fp16 rows append to
        vectors.bin and ids append to ids.txt — nothing is rewritten, so
        building an MS MARCO-scale store (8.8M x 768) stays linear."""
        if len(ids) != vectors.shape[0]:
            raise ValueError(f"{len(ids)} ids for {vectors.shape[0]} vectors")
        d = self._dir(table, model_id)
        os.makedirs(d, exist_ok=True)
        vec_path = os.path.join(d, "vectors.bin")
        meta_path = os.path.join(d, "meta.json")
        vectors = np.ascontiguousarray(vectors, dtype=np.float16)
        with self._lock:
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = json.load(f)
                if meta["dim"] != vectors.shape[1]:
                    raise ValueError(f"dim mismatch on append: {vectors.shape[1]} "
                                     f"into a table of dim {meta['dim']}")
            else:
                meta = {"dim": int(vectors.shape[1])}
            with open(vec_path, "ab") as f:
                f.write(vectors.tobytes())
            with open(os.path.join(d, "ids.txt"), "a") as f:
                f.writelines(f"{int(_id)}\n" for _id in ids)
            with open(meta_path, "w") as f:
                json.dump(meta, f)
            self._cache.pop(f"{table}_{model_id}", None)

    def _load(self, table: str, model_id: int):
        key = f"{table}_{model_id}"
        with self._lock:
            if key not in self._cache:
                d = self._dir(table, model_id)
                with open(os.path.join(d, "meta.json")) as f:
                    dim = json.load(f)["dim"]
                vec = np.memmap(
                    os.path.join(d, "vectors.bin"), dtype=np.float16, mode="r"
                ).reshape(-1, dim)
                with open(os.path.join(d, "ids.txt")) as f:
                    # later appends win for duplicate ids (overwrite semantics)
                    id_map = {line.strip(): row for row, line in enumerate(f)}
                self._cache[key] = (vec, id_map)
            return self._cache[key]

    def get(self, table: str, model_id: int, ids: Sequence[int]) -> np.ndarray:
        vec, id_map = self._load(table, model_id)
        rows = [id_map[str(int(i))] for i in ids]
        return np.asarray(vec[rows])


class EmbeddingStore:
    """Prefetching front-end (reference EmbeddingService API).

    register_task() fires a background read at collate time;
    fetch_embedding() blocks on the per-key Event only if the read has not
    landed yet — overlapping store I/O with the device step.
    """

    def __init__(self, backend: LocalVectorStore, max_workers: int = 10):
        self.backend = backend
        self.registered_tasks: Dict[str, int] = {}
        self.fetched: Dict[str, object] = {}
        self.events: Dict[str, threading.Event] = {}
        self.lock = threading.Lock()
        self.pool = ThreadPoolExecutor(max_workers=max_workers)

    @staticmethod
    def _key(table, model_id, ids):
        return f"{table}_{model_id}_{','.join(map(str, ids))}"

    def _fetch_bg(self, table: str, model_id: int, ids: List[int]):
        key = self._key(table, model_id, ids)
        try:
            result = self.backend.get(table, model_id, ids)
        except Exception as e:  # store the error to avoid deadlocking waiters
            result = {"error": str(e)}
        with self.lock:
            self.fetched[key] = result
            if key in self.events:
                self.events[key].set()

    def register_task(self, table_name: str, model_id: int, ids: List[int]):
        key = self._key(table_name, model_id, ids)
        with self.lock:
            self.registered_tasks[key] = self.registered_tasks.get(key, 0) + 1
            needs_submit = key not in self.events
            if needs_submit:
                self.events[key] = threading.Event()
        if needs_submit:
            self.pool.submit(self._fetch_bg, table_name, model_id, list(ids))
        return {"status": "success", "task_id": key}

    def fetch_embedding(self, table_name: str, model_id: int, ids: List[int]) -> np.ndarray:
        key = self._key(table_name, model_id, ids)
        with self.lock:
            if key not in self.registered_tasks:
                raise ValueError("Task not registered")
            event = None if key in self.fetched else self.events[key]
        if event is not None:
            event.wait()
        with self.lock:
            result = self.fetched.get(key)
            self.registered_tasks[key] -= 1
            if self.registered_tasks[key] <= 0:
                self.registered_tasks.pop(key, None)
                self.fetched.pop(key, None)
                self.events.pop(key, None)
        if isinstance(result, dict) and "error" in result:
            raise RuntimeError(f"Task failed: {result['error']}")
        return result

    def health_check(self):
        return {"status": "healthy"}

    def shutdown(self):
        self.pool.shutdown(wait=True)
