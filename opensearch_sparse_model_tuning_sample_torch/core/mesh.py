"""The device mesh inside one process: the port of the JAX package's
`core/mesh.py`.

JAX's mesh is a `jax.sharding.Mesh` with one `data` axis; the index shards
its corpus (or its query batches) over it, and XLA places the shards. Here a
mesh is an ordered tuple of torch devices, and placement is explicit:
`shard_rows` gives device s its contiguous block of rows and `replicate` a
copy on every device, as plain per-device lists (the counterparts of a
`NamedSharding` with P("data") and with P()); `shard_batch` does what
`shard_rows` does for every entry of a batch dict. The sharded index
(`index/engine.py`) runs each device's part of a search on that device and
merges on the first (`parallel/collectives.py::merged_topk`). The trainer
(`train/trainer.py`) runs one step over the mesh as JAX's jitted step runs
over its `data` axis: each position encodes its rows with a replica of the
model, and the loss is taken once on the gathered global batch. Under a
launch of more than one process each rank's mesh is its own card, and the
port of `maybe_init_distributed` stays in `core/distributed.py`.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .device import DeviceLike, resolve_device

logger = logging.getLogger(__name__)

DATA_AXIS = "data"


class Mesh:
    """A 1-D mesh over the `data` axis: an ordered tuple of devices. A
    device may appear more than once (several stripes on one card, or the
    tests' eight stripes on the CPU)."""

    def __init__(self, devices: Sequence[DeviceLike]):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def repeats(self) -> bool:
        """Whether some device holds more than one position of the mesh."""
        return len(set(self.devices)) < self.size

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(dp_size: int = -1, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of the first `dp_size` of `devices` (-1: all of them).

    Without `devices` it takes every visible CUDA card, and raises when there
    is none: the port never falls back to the CPU on its own (pass
    `devices=["cpu"]` for that). A device may repeat only when the caller
    lists it so: the visible cards are all distinct."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: a mesh is made of the visible cards unless the "
                "caller names its devices (devices=['cpu'] for the CPU)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(d) for d in devices]
    if dp_size == -1:
        dp_size = len(devices)
    if dp_size < 1 or dp_size > len(devices):
        raise ValueError(f"dp_size {dp_size} > available devices {len(devices)}")
    mesh = Mesh(devices[:dp_size])
    if mesh.repeats:
        logger.info("mesh of %d positions over %d device(s): %s (devices repeat: their "
                    "stripes share a device)", mesh.size, len(set(mesh.devices)), mesh)
    else:
        logger.info("mesh of %d device(s): %s", mesh.size, mesh)
    return mesh


def process_mesh(device: torch.device, dp_size: int = -1, world_size: int = 1) -> Mesh:
    """The mesh of a CLI process (`cli.evaluate_beir`, `cli.mine`). Under a
    launch of more than one rank, each rank's mesh is its own device. In one
    process it is `make_mesh(dp_size)` over the visible cards, ordered from
    `device` on (so the model's card is the mesh's first); with a CPU
    `device` it is a one-CPU mesh."""
    device = resolve_device(device)  # raises for a card that is not there
    if world_size > 1:
        return make_mesh(devices=[device])
    if device.type != "cuda":
        return make_mesh(dp_size, devices=[device])
    n = torch.cuda.device_count()
    return make_mesh(dp_size, devices=[torch.device("cuda", (device.index + j) % n)
                                       for j in range(n)])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def _is_texts(x) -> bool:
    return isinstance(x, tuple)


def split_rows(x, n: int, what: str = "rows") -> list:
    """x's rows in n contiguous blocks, in order. Dicts and lists split leaf
    by leaf (a batch's teacher features), a tuple (a host teacher's texts)
    by the same rows as an array. Every leaf's row count must divide by n:
    nothing is padded."""
    leaves, spec = pytree.tree_flatten_with_path(x, is_leaf=_is_texts)
    blocks = []
    for path, leaf in leaves:
        if len(leaf) % n:
            raise ValueError(f"{len(leaf)} rows of {what}{pytree.keystr(path)} "
                             f"do not split into {n} blocks")
        m = len(leaf) // n
        blocks.append([leaf[i * m:(i + 1) * m] for i in range(n)])
    return [pytree.tree_unflatten([b[i] for b in blocks], spec) for i in range(n)]


def batch_to(x, device: torch.device):
    """A batch on `device`: arrays and tensors moved (without waiting for a
    copy to a card), dicts and lists leaf by leaf, tuples (raw texts) left
    on the host."""
    device = torch.device(device)
    return pytree.tree_map(
        lambda v: v if _is_texts(v) else _as_tensor(v).to(device,
                                                          non_blocking=device.type == "cuda"),
        x, is_leaf=_is_texts)


def shard_batch(mesh: Mesh, batch) -> list:
    """Position s's contiguous block of every entry's rows, on device s
    (JAX's P("data") over a batch pytree). Doc rows are query-major, so
    with n queries a position it takes queries [s n, (s+1) n) and their
    docs [s n G, (s+1) n G)."""
    return [batch_to(part, d)
            for part, d in zip(split_rows(batch, mesh.size, "the batch"), mesh.devices)]


def shard_rows(mesh: Mesh, x) -> List[torch.Tensor]:
    """Device s's contiguous block of x's rows, on device s (x's leading dim
    must divide by the mesh size, as a P("data") sharding needs)."""
    return shard_batch(mesh, _as_tensor(x))


def replicate(mesh: Mesh, x) -> List[torch.Tensor]:
    """A copy of x on every device of the mesh (positions that share a
    device share one copy)."""
    x = _as_tensor(x)
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = x.to(d)
    return [copies[d] for d in mesh.devices]
