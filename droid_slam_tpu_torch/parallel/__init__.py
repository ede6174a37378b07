"""Multi-device SLAM and training: the edge-parallel frontend
(``frontend.py``), the chunk-parallel global BA (``backend.py``) and the
data-parallel trainer's process groups (``mesh.py``)."""

from .mesh import (Mesh, all_reduce_mean, data_parallel_mesh,
                   init_data_parallel, replicate, shard_batch)

__all__ = ["Mesh", "all_reduce_mean", "data_parallel_mesh",
           "init_data_parallel", "replicate", "shard_batch"]
