"""Device meshes and data-parallel process groups.

Counterpart of ``droid_slam_tpu/parallel/mesh.py``. JAX runs every multi-
device path as one program over a ``jax.sharding.Mesh``. The port splits
them two ways:

* SLAM (the edge-parallel frontend, the chunk-parallel global BA) runs in
  one process that drives an ordered list of devices, a ``Mesh``: shard k
  computes on ``mesh.devices[k]``; a ``psum`` becomes a sum of the shards'
  partial tensors on the device that owns the replicated state, an
  ``all_gather`` a ``torch.cat`` in shard order (``gather``). One process
  makes every host decision (keyframes, proposals) once, so the shards
  cannot part. Work issued to different cards runs concurrently as long as
  no host synchronisation stands between the shards' launches.
* Training runs one process per rank (``init_data_parallel``): NCCL on the
  card, gloo on the CPU. Each rank takes a contiguous block of the global
  batch (``shard_batch``, JAX's ``P("dp")``); gradients and metrics are
  averaged over the ranks (``all_reduce_mean``, JAX's ``pmean``).
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for its peers before it raises
DEFAULT_TIMEOUT_S = 300.0


class Mesh:
    """An ordered list of devices; shard k computes on ``devices[k]``. A
    device may repeat (several shards on one card, or on the CPU)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def cuda_mesh(n: int, what: str) -> Mesh:
    """``cuda:0`` .. ``cuda:n-1``. Raises when the machine has fewer cards:
    a smaller mesh would run another program than the one asked for."""
    count = torch.cuda.device_count()
    if n < 1 or n > count:
        raise RuntimeError(f"{what} asks for {n} CUDA devices; this machine "
                           f"has {count}")
    return Mesh([torch.device("cuda", k) for k in range(n)])


def data_parallel_mesh(n_devices: int) -> Mesh:
    """The devices of ``n_devices`` training ranks: rank r on ``cuda:r``."""
    return cuda_mesh(n_devices, "data parallelism")


# ---------------------------------------------------------------------------
# edge-sharded tensors: contiguous blocks of the leading dimension
# ---------------------------------------------------------------------------

def block_sizes(n: int, shards: int) -> list:
    """Sizes of ``shards`` contiguous blocks of n rows, the first n % shards
    one row longer (uneven blocks: nothing is padded)."""
    return [len(b) for b in np.array_split(np.arange(n), shards)]


def split(mesh: Mesh, x, sizes=None):
    """x -> one contiguous block of rows per shard, block k on device k
    (a view where the device is x's own)."""
    sizes = block_sizes(len(x), mesh.size) if sizes is None else sizes
    out, off = [], 0
    for d, n in zip(mesh.devices, sizes):
        out.append(x.narrow(0, off, n).to(d))
        off += n
    return out


def gather(blocks, device):
    """The blocks on ``device``, concatenated in shard order (JAX's tiled
    ``all_gather``)."""
    if len(blocks) == 1:
        return blocks[0].to(device)
    return torch.cat([b.to(device) for b in blocks])


def reshard(mesh: Mesh, pieces):
    """Rows in edge order, held as ``pieces`` (tensors on any devices, in
    order) -> balanced contiguous blocks on the mesh. On one device the
    pieces are concatenated once and the blocks are views of the result;
    across devices each block is assembled on its own device from the
    pieces it overlaps (a view where it lies in one piece there), and no
    device assembles the whole."""
    if len({p.device for p in pieces} | set(mesh.devices)) == 1:
        return split(mesh, pieces[0] if len(pieces) == 1
                     else torch.cat(pieces))
    total = sum(len(p) for p in pieces)
    starts = np.cumsum([0] + [len(p) for p in pieces])
    out, lo = [], 0
    for d, n in zip(mesh.devices, block_sizes(total, mesh.size)):
        hi, parts = lo + n, []
        for p, s in zip(pieces, starts):
            a, b = max(lo, s), min(hi, s + len(p))
            if a < b:
                parts.append(p.narrow(0, a - s, b - a).to(d))
        if len(parts) == 1:
            out.append(parts[0])
        elif parts:
            out.append(torch.cat(parts))
        else:
            ref = pieces[0]
            out.append(ref.new_zeros((0,) + tuple(ref.shape[1:]), device=d))
        lo = hi
    return out


def sum_to(parts, device):
    """The sum of the shards' partial tensors on ``device``, in shard order
    (JAX's ``psum``)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def replicate_to(mesh: Mesh, tree: dict) -> list:
    """One copy of a dict of tensors per shard; shards on one device share
    it."""
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = {k: v.to(d) for k, v in tree.items()}
    return [copies[d] for d in mesh.devices]


# ---------------------------------------------------------------------------
# data parallelism: one process per rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in a data-parallel process group."""
    rank: int
    world: int
    device: torch.device
    backend: str


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_data_parallel(rank: int, world: int, backend: str, device,
                       timeout: float = DEFAULT_TIMEOUT_S,
                       init_method: str = None) -> DataParallel:
    """Join the default process group as ``rank`` of ``world`` on
    ``device`` ("nccl" on the card, "gloo" on the CPU, or gloo with CUDA
    tensors). ``init_method`` is ``tcp://localhost:<port>``, the same for
    every rank. Every collective raises after ``timeout`` s without its
    peers instead of waiting for ever."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout))
    return DataParallel(rank, world, device, backend)


def shutdown_data_parallel():
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(batch: dict, dp: DataParallel, replicated=("ii", "jj")):
    """This rank's contiguous block of a global batch: every entry but the
    ``replicated`` ones (the edge lists the batch shares) along its first
    dimension, which must divide by the world size."""
    out = {}
    for k, v in batch.items():
        if k in replicated:
            out[k] = v
            continue
        B = v.shape[0]
        if B % dp.world:
            raise ValueError(f"batch of {B} does not divide over "
                             f"{dp.world} ranks")
        b = B // dp.world
        out[k] = v[dp.rank * b:(dp.rank + 1) * b]
    return out


def replicate(tensors, dp: DataParallel):
    """Rank 0's values in every rank's tensors (in place; a broadcast)."""
    for t in tensors:
        dist.broadcast(t.data, src=0)


def all_reduce_mean(tensors, dp: DataParallel):
    """The mean over the ranks of each tensor (one all-reduce of their
    concatenation), as new tensors in the same order."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat = flat / dp.world
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out
