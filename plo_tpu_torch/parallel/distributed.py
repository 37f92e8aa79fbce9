"""The multi-process runtime (the port of plo_tpu/parallel/distributed.py),
on torch.distributed.

One Python process per host (or per card), each driving its local shards,
all of them running every global step; the traffic between processes is
the collectives of sharding.py over the default process group: NCCL
between cards, gloo between CPU processes.

  * `initialize()` joins the process to the group through a TCP rendezvous
    at `coordinator_address` ("host:port"; process 0 listens there) and
    records its local shards and their device;
  * `global_mesh()` is the mesh of this process's shards joined to the
    group, so its collectives span every process's shards;
  * `barrier()` waits for every process (around checkpoints and at exit);
  * `shutdown()` leaves the group.

`python -m plo_tpu_torch.parallel.worker` runs one such process of the
sharded map odometry (tests/test_torch_distributed.py launches two).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from plo_tpu_torch import resolve_device
from plo_tpu_torch.parallel.sharding import Mesh, get_mesh


@dataclasses.dataclass
class _Runtime:
    local_shards: int = 1
    device: Optional[torch.device] = None


_runtime = _Runtime()   # what initialize() recorded for global_mesh()


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_shards: int = 1, device=None) -> Tuple[int, int]:
    """Join the process group; returns (process count, this process's rank).
    Every process passes the same coordinator and count and its own id.
    With no `device`, process p drives card p mod the visible count (and
    raises without a card); the backend is NCCL for a card and gloo for the
    CPU. `local_shards` is how many shards this process drives."""
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", process_id % torch.cuda.device_count())
    device = torch.device(device)
    kw = {}
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)
    _runtime.local_shards, _runtime.device = local_shards, device
    return dist.get_world_size(), dist.get_rank()


def global_mesh(axis_name: str = "points") -> Mesh:
    """The mesh of this process's shards joined to every other process's."""
    if not dist.is_initialized():
        raise RuntimeError("global_mesh() needs initialize() first")
    return get_mesh(_runtime.local_shards, device=_runtime.device, axis_name=axis_name,
                    group=dist.group.WORLD)


def barrier() -> None:
    """Wait until every process reaches this point (no-op for one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _runtime.local_shards, _runtime.device = 1, None
