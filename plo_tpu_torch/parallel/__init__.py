"""Scale-out (the port of plo_tpu/parallel): meshes of shards and processes
with their two collectives and the sharded ICP step (sharding.py), the
sharded voxel map and its distributed search (map_store.py), frame-to-map
odometry over it (odometry.py), windowed bundle adjustment on one device and
sharded (ba.py), and the torch.distributed runtime with its worker
(distributed.py, worker.py).

The names below resolve when first used: models/odometry.py imports this
package's ba and sharding modules, and odometry.py here builds on
models/odometry.py, so importing them all here would be circular."""
import importlib

_EXPORTS = {
    "get_mesh": "sharding", "get_mesh_2d": "sharding", "shard_cloud": "sharding",
    "replicate": "sharding", "make_sharded_icp_step": "sharding",
    "make_sharded_icp_step_2d": "sharding", "all_gather": "sharding", "psum": "sharding",
    "Mesh": "sharding", "ShardedMapStore": "map_store",
    "ShardedMapOdometry": "odometry", "make_distributed_refine": "ba",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
