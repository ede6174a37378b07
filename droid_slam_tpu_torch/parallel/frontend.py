"""Edge-parallel frontend update over a device mesh.

Counterpart of ``droid_slam_tpu/parallel/frontend.py``. The update operator
(reprojection, the correlation lookup, the ConvGRU and its heads) is
independent from edge to edge, so the active edges are cut into contiguous
blocks, one per shard (``shard_edges``), and each shard runs one pass over
its own block on its own device:

* its per-edge state (GRU state, target, weight and the correlation-volume
  pyramid) lives on that device, which divides the pyramid's memory;
* the lookup kernel reads the shard's own pyramid rows through the local
  slot table 0..E_k-1 (JAX's ``_local_edge_tables``,
  droid_slam_tpu/state/graph.py:218-228), and the GRU's fused epilogues
  index the shard's own gates: nothing crosses shards inside the pass;
* GraphAgg's per-frame counts and sums are summed across shards on the
  owner device (the one that holds the replicated state: poses,
  disparities, the BA) before its heads run (JAX's ``psum``);
* target and weight are concatenated in edge order for the dense BA, which
  runs once on the owner (JAX's ``all_gather``).

The shards' launches are issued one after another from one thread with no
host synchronisation between them, so shards on different cards overlap.
``FactorGraph(mesh=...)`` (state/graph.py) runs this in ``update``; the
frontend builds the mesh from ``DroidConfig.edge_parallel``.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import nets
from ..ops import corr_cuda
from ..state.edge_update import edge_update
from . import mesh as pmesh


def edge_parallel_mesh(n_devices: int, devices=None) -> pmesh.Mesh:
    """The mesh of ``DroidConfig(edge_parallel=n_devices)``: ``devices``
    when given (they may repeat: several shards on one card, or the CPU),
    else ``cuda:0`` .. ``cuda:n-1``, which raises when the machine has
    fewer cards (JAX's ``devs[:n]`` would shrink the mesh instead)."""
    if devices is None:
        return pmesh.cuda_mesh(n_devices, f"edge_parallel={n_devices}")
    if len(devices) != n_devices:
        raise ValueError(f"edge_parallel={n_devices} with {len(devices)} "
                         f"devices")
    return pmesh.Mesh(devices)


def shard_edges(mesh: pmesh.Mesh, x, sizes=None):
    """A per-edge tensor (leading edge dimension) as contiguous blocks, one
    per shard on its device."""
    return pmesh.split(mesh, x, sizes)


@dataclasses.dataclass
class EdgeTables:
    """Each shard's edge tables on its device: source and target frames,
    the source frames' offsets in the update's window, and the context
    features' GRU contributions (``nets.gru_context_pre``; None: the update
    takes the full context path from the frames' ``inps``)."""
    ii: list
    jj: list
    agg_ii: list
    pre: list = None


def edge_parallel_update(mesh, params, poses, disps, intrinsics, inps,
                         pyramid, nets_e, target, tabs: EdgeTables, nw: int,
                         shard_params=None, fused_epilogue=False,
                         compute_upmask=False):
    """One update-operator pass with the edges sharded over ``mesh``.

    poses/disps/intrinsics/inps: the replicated state on its owner device
    (``params`` there too); pyramid [shard][level], nets_e, target: each
    shard's blocks (``shard_edges``); ``shard_params``: the parameters on
    each shard's device (``mesh.replicate_to``; made here when None).
    Returns the shards' new (nets, targets, weights) blocks and, on the
    owner, eta [nw,h,w] and the upsampling mask (None unless
    ``compute_upmask``): the serial pass's results in blocks."""
    owner = poses.device
    if shard_params is None:
        shard_params = pmesh.replicate_to(mesh, params)
    out = ([], [], [])
    counts, sums = [], []
    for k, d in enumerate(mesh.devices):
        E = len(tabs.ii[k])
        if E == 0:
            for o, x in zip(out, (nets_e[k], target[k], target[k])):
                o.append(x)
            continue
        slots = torch.arange(E, dtype=torch.int32, device=d)
        pre = None if tabs.pre is None else tabs.pre[k]
        net, tgt, wgt, _, _ = edge_update(
            shard_params[k], poses.to(d), disps.to(d), intrinsics.to(d),
            tabs.ii[k], tabs.jj[k], nets_e[k], target[k],
            lambda x: corr_cuda.lookup_pyramid_slots(pyramid[k], slots,
                                                     x.contiguous()),
            inp=inps.to(d)[tabs.ii[k]] if pre is None else None, pre=pre,
            fused_epilogue=fused_epilogue)
        c, s = nets.graph_agg_sums(shard_params[k], net, tabs.agg_ii[k],
                                   nw)
        for o, x in zip(out, (net, tgt, wgt)):
            o.append(x)
        counts.append(c)
        sums.append(s)
    eta, upmask = nets.graph_agg_heads(
        params, pmesh.sum_to(counts, owner), pmesh.sum_to(sums, owner),
        compute_upmask)
    return out + (eta, upmask)

