"""Multi-process launch: the process-group half of the JAX package's
`core/mesh.py` (its `maybe_init_distributed`).

One process per card is PyTorch's idiom for a launch of several processes
(reference: `torchrun --nproc_per_node=N train_ir.py`, README.md:64-68);
one process trains over the `data` mesh of its visible cards instead
(`core/mesh.py`), as the JAX package does. Two launches are understood:

  * torchrun's: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT;
  * the JAX package's (`tools/launch_dist.py`): OSSMT_COORDINATOR=host:port,
    OSSMT_NUM_PROCESSES, OSSMT_PROCESS_ID.

The backend follows the run's device: NCCL on a CUDA card, gloo on the CPU.
There is no fallback from one to the other. The group is made with an
explicit timeout, so a rank that never arrives fails the run instead of
hanging it. Without a rendezvous address no group is made; `rank()` and
`world_size()` then read RANK/WORLD_SIZE (the filesystem-barrier ingest and
mining need no collective).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# seconds a collective (and the rendezvous) may wait for a peer
DEFAULT_TIMEOUT_S = 600.0


class Launch(NamedTuple):
    rank: int
    world_size: int
    local_rank: int
    init_method: Optional[str]  # tcp://host:port, or None (no rendezvous)


def launch_env(env=None) -> Launch:
    """The launch this process belongs to, from torchrun's variables or the
    JAX package's OSSMT_* ones; (0, 1, 0, None) when there is none."""
    env = os.environ if env is None else env
    coord = env.get("OSSMT_COORDINATOR")
    if coord:
        rank = int(env["OSSMT_PROCESS_ID"])
        return Launch(rank, int(env["OSSMT_NUM_PROCESSES"]),
                      int(env.get("LOCAL_RANK", rank)), f"tcp://{coord}")
    rank = int(env.get("RANK", "0"))
    world = int(env.get("WORLD_SIZE", "1"))
    local = int(env.get("LOCAL_RANK", "0"))
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    return Launch(rank, world, local, f"tcp://{addr}:{port}" if addr and port else None)


def process_device(device: Optional[str] = None, env=None) -> str:
    """The device string of this process: "cuda" (or None) becomes
    cuda:LOCAL_RANK; a named device ("cuda:0", "cpu") stays as it is."""
    if device is None or device == "cuda":
        return f"cuda:{launch_env(env).local_rank}"
    return device


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_dp_size(dp_size: int, world: int) -> None:
    """The JAX package's mesh size against the process count of a launch of
    more than one process: -1 (every process) or exactly the world size.
    (In one process the mesh is `make_mesh(dp_size)`: core/mesh.py.)"""
    if dp_size not in (-1, world):
        raise ValueError(
            f"dp_size={dp_size} but {world} process(es) were launched: under a launch the "
            "port runs one process per card, so the data-parallel size is the launch's world "
            "size (set dp_size to -1 or to WORLD_SIZE, or launch dp_size processes)")


def maybe_init_distributed(device=None, timeout_s: float = DEFAULT_TIMEOUT_S,
                           env=None) -> bool:
    """Join the launch's process group when the environment names a
    rendezvous (torchrun or OSSMT_COORDINATOR); True when a group is up.
    Idempotent. The backend follows `device` (see `backend_for`); at world
    size 1 the group is still made, so the collectives' path runs."""
    if dist.is_initialized():
        return True
    launch = launch_env(env)
    if launch.init_method is None:
        return False
    backend = backend_for(device if device is not None else "cuda")
    kwargs = {}
    if backend == "nccl":
        dev = torch.device(device)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=launch.init_method, rank=launch.rank,
                            world_size=launch.world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    logger.info("process group: %s, rank %d of %d, %s", backend, launch.rank,
                launch.world_size, device)
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else launch_env().rank


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else launch_env().world_size


def is_main() -> bool:
    return rank() == 0


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def barrier() -> None:
    """A barrier over the group; nothing without one."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
