"""Shards, processes and the sharded ICP step (the port of
plo_tpu/parallel/sharding.py).

plo_tpu puts the source cloud's point dimension over a device mesh and lets
GSPMD derive the sharded program. Here the decomposition is written out, on
two levels as in plo_tpu:
  * shards driven by one process: a `Mesh` holds this process's shards as an
    ordered tuple of torch devices, several of which may be one card (on a
    host with one card, `get_mesh(8)` puts 8 shards on cuda:0);
  * processes joined by torch.distributed (parallel/distributed.py): the
    mesh's process group; global shard g of a process of rank p holding L
    shards is p * L + its local position.
`all_gather` and `psum` are the only collectives. Each merges the local
shards in shard order first, then gathers over the group: NCCL for CUDA
tensors and gloo for CPU tensors. A tensor on a group of the other kind
raises (no staging through the host, no switch of backend). Both keep the
shard order, so a run gives the same numbers however its shards are laid
over processes.

The sharded ICP step holds the source sharded on points and the target
replicated: each iteration every shard matches its slice of the source
(plane-ICP: one `nearest` launch a shard), the correspondence rows are
gathered back in source order, and the ICP loop solves them replicated. The
solve sees the single-device rows, so the step is exact for every solver,
RANSAC's draws included, at one collective an iteration.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from plo_tpu_torch import resolve_device
from plo_tpu_torch.cloud import PointCloud

# Shards of a CPU mesh by default: the 8 virtual CPU devices that the JAX
# package's tests carve (tests/conftest.py).
CPU_SHARDS = 8


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's shards (torch devices, in shard order), the process
    group joining it to the others (None: one process) and the axis names."""

    devices: Tuple[torch.device, ...]
    group: Optional[dist.ProcessGroup] = None
    axis_names: Tuple[str, ...] = ("points",)

    @property
    def device(self) -> torch.device:
        """Where replicated values live: the first local shard's device."""
        return self.devices[0]

    @property
    def n_local(self) -> int:
        return len(self.devices)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Shards over every process."""
        return self.n_local * self.world

    @property
    def first_shard(self) -> int:
        """Global index of this process's first shard."""
        return 0 if self.group is None else dist.get_rank(self.group) * self.n_local

    @property
    def is_writer(self) -> bool:
        """Whether this process writes what every process holds (rank 0)."""
        return self.group is None or dist.get_rank(self.group) == 0


def _devices(n: Optional[int], device) -> Tuple[torch.device, ...]:
    if device is None:
        resolve_device(None)  # raises without a card
        count = torch.cuda.device_count()
        return tuple(torch.device("cuda", i % count) for i in range(n or count))
    dev = torch.device(device)
    return (dev,) * (n or (CPU_SHARDS if dev.type == "cpu" else 1))


def get_mesh(n_devices: Optional[int] = None, device=None, axis_name: str = "points",
             group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A 1-D mesh of `n_devices` local shards: with no `device`, one per
    visible card (shard i on cuda:(i % count); raises without a card);
    with a `device`, every shard there (the CPU's default: CPU_SHARDS).
    `group` joins it to other processes' meshes."""
    return Mesh(_devices(n_devices, device), group, (axis_name,))


def get_mesh_2d(n_hosts: int, chips_per_host: int, axes=("hosts", "chips"), device=None,
                group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """A hosts x chips mesh. In one process it holds all n_hosts *
    chips_per_host shards; with a `group` of n_hosts processes, each
    process is a host holding its chips_per_host shards. The point
    dimension goes over the flattened product, hosts-major, so merges run
    over the local chips first, then over the group."""
    if group is not None:
        if dist.get_world_size(group) != n_hosts:
            raise ValueError(f"a group of {dist.get_world_size(group)} processes for "
                             f"{n_hosts} hosts")
        return Mesh(_devices(chips_per_host, device), group, tuple(axes))
    return Mesh(_devices(n_hosts * chips_per_host, device), None, tuple(axes))


def _check_backend(mesh: Mesh, t: torch.Tensor) -> None:
    backend = dist.get_backend(mesh.group)
    want = "nccl" if t.is_cuda else "gloo"
    if backend != want:
        raise RuntimeError(f"a {t.device.type} tensor on a {backend} group: "
                           f"{'CUDA' if t.is_cuda else 'CPU'} tensors take {want}")


def _gather_group(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """local [n, ...] from every process, rank-major: [world * n, ...]."""
    if mesh.group is None:
        return local
    _check_backend(mesh, local)
    wire = local.to(torch.uint8) if local.dtype == torch.bool else local.contiguous()
    out = wire.new_empty((mesh.world * wire.shape[0],) + tuple(wire.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, wire, group=mesh.group)
    return out.to(torch.bool) if local.dtype == torch.bool else out


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The local shards' parts (one a shard, [n, ...] each, equal n on every
    process) concatenated over all shards in global shard order, on
    mesh.device."""
    return _gather_group(mesh, torch.cat([p.to(mesh.device) for p in parts]))


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of the local shards' parts over all shards, added one after
    another in global shard order (the same order, so the same numbers, on
    every process and every layout), on mesh.device."""
    every = _gather_group(mesh, torch.stack([p.to(mesh.device) for p in parts]))
    total = every[0]
    for p in every[1:]:
        total = total + p
    return total


def _padded(x: torch.Tensor, rows: int) -> torch.Tensor:
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))])


def shard_rows(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """This process's shards of x's rows, each on its device: x padded with
    zero rows to a multiple of mesh.size, global shard g taking the g-th
    block of ceil(rows / size) rows."""
    per = -(-x.shape[0] // mesh.size)
    x = _padded(x, per * mesh.size)
    return [x[g * per:(g + 1) * per].to(dev)
            for g, dev in enumerate(mesh.devices, start=mesh.first_shard)]


def shard_cloud(cloud: PointCloud, mesh: Mesh) -> List[PointCloud]:
    """Every per-point tensor sharded over the mesh's point axis (the
    padding rows are invalid): this process's shards, each on its device."""
    fields = {f.name: shard_rows(mesh, getattr(cloud, f.name))
              for f in dataclasses.fields(PointCloud)}
    return [PointCloud(**{k: v[j] for k, v in fields.items()}) for j in range(mesh.n_local)]


def replicate(x, mesh: Mesh) -> list:
    """A tensor or PointCloud on each local shard's device (the same object
    where the device is the one it is on)."""
    if isinstance(x, PointCloud):
        return [PointCloud(**{f.name: getattr(x, f.name).to(dev)
                              for f in dataclasses.fields(PointCloud)})
                for dev in mesh.devices]
    return [x.to(dev) for dev in mesh.devices]


def make_sharded_icp_step(cfg, mesh: Mesh):
    """The back-end ICP loop over a mesh: the source sharded on points, the
    target replicated, the pose replicated out. Returns run(flat, target,
    draws, init_pose=None) -> (rPose, iterations, correspondences,
    converged, DRPM probabilities), as models.odometry.icp_loop."""
    from plo_tpu_torch.models.odometry import icp_loop

    def run(flat: PointCloud, target: PointCloud, draws, init_pose=None):
        return icp_loop(cfg, flat, target, draws, init_pose, mesh.device, False, mesh=mesh)

    return run


def make_sharded_icp_step_2d(cfg, mesh: Mesh):
    """make_sharded_icp_step over a hosts x chips mesh: the source sharded
    over both axes (the flattened product), the target replicated."""
    if len(mesh.axis_names) != 2:
        raise ValueError(f"a 2-D mesh, not axes {mesh.axis_names}")
    return make_sharded_icp_step(cfg, mesh)
