"""Chunk-parallel global BA (``FactorGraph.update_lowmem``) over a device
mesh.

Counterpart of ``droid_slam_tpu/parallel/backend.py``. A global-BA step is
a sweep of update-operator passes over chunks of 8 source frames, then one
dense BA. Within a sweep the chunks are independent: each owns its edges
and a window of 8 frames' damping that no other chunk writes. So the
chunks are split over the mesh (``shard_chunks``: contiguous runs, as many
as there are; a count that does not divide by the mesh size leaves the
runs uneven, where JAX pads with empty chunks), and each shard holds its
chunks' edge state (GRU state, target, weight) packed on its device. Per
step:

* each shard sweeps its chunks with on-the-fly (alt) correlation (the
  kernel of ``ops/alt_corr_cuda.py`` on the GPU) and the plain GRU, as the
  serial sweep does, from copies of the poses,
  disparities and feature pyramid on its device;
* the damping is the sum over shards of each shard's update, with the mask
  of the frames present in its chunks (JAX's ``present``), on the owner
  device (the video's): the windows are disjoint, so the sum is the update;
* the dense BA runs once on the owner from the shards' targets and weights
  concatenated in shard order (JAX's ``all_gather``), with a plan in that
  packed order.

``FactorGraph.update_lowmem`` takes this path when the graph has a mesh and
``upsample`` is off (droid_slam_tpu/state/graph.py:1297).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import alt_corr_cuda
from ..state.edge_update import edge_update
from . import mesh as pmesh


def shard_chunks(mesh: pmesh.Mesh, chunks):
    """Chunks [(g0, edge indices)] -> one contiguous run of them per
    shard."""
    bounds = np.cumsum([0] + pmesh.block_sizes(len(chunks), mesh.size))
    return [chunks[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


@dataclasses.dataclass
class ChunkSpan:
    """One chunk in its shard's packed rows [lo, hi): its window's first
    frame g0, and its source frames (and their offsets from g0) on the
    shard's device."""
    g0: int
    lo: int
    hi: int
    frames: torch.Tensor
    offsets: torch.Tensor


@dataclasses.dataclass
class ChunkShard:
    """A shard's chunks and their edges, packed on its device: source and
    target frames, feature-pyramid rows (source, target), and the edge
    state {"net", "target", "weight"}, which the steps update in place."""
    spans: list
    ii: torch.Tensor
    jj: torch.Tensor
    rows: tuple
    state: dict


def lowmem_step_mesh(mesh, shard_weights, video, fpyrs, inps, shards,
                     target_inac, weight_inac, plan, itrs):
    """One global-BA step with the chunks sharded over ``mesh``: each
    shard's sweep, the damping of every window present, and the dense BA
    on the video's device over ``target_inac`` / ``weight_inac`` and the
    shards' packed edges (``plan`` in that order). shard_weights, fpyrs,
    inps: the update operator's (params, merged) weights, the feature
    pyramid and the context features on each shard's device."""
    v, owner = video, video.device
    upds, masks = [], []
    for k, (d, sh) in enumerate(zip(mesh.devices, shards)):
        if not sh.spans:
            continue
        (p, merged), st = shard_weights[k], sh.state
        poses, disps = v.poses.to(d), v.disps.to(d)
        intr = v.intrinsics.to(d)
        upd = torch.zeros_like(v.damping, device=d)
        mask = torch.zeros(v.damping.shape[0], device=d)
        for c in sh.spans:
            sl = slice(c.lo, c.hi)
            ii, src, dst = sh.ii[sl], sh.rows[0][sl], sh.rows[1][sl]
            net, tgt, wgt, eta, _ = edge_update(
                p, poses, disps, intr, ii, sh.jj[sl], st["net"][sl],
                st["target"][sl],
                lambda x: alt_corr_cuda.alt_lookup(fpyrs[k], x, src, dst),
                inp=inps[k][ii], agg=ii - c.g0, num_frames=8, merged=merged)
            st["net"][sl] = net
            st["target"][sl], st["weight"][sl] = tgt, wgt
            upd[c.frames] = eta[c.offsets].float()
            mask[c.frames] = 1.0
        upds.append(upd)
        masks.append(mask)
    present = pmesh.sum_to(masks, owner) > 0
    v.damping.copy_(torch.where(present[:, None, None],
                                pmesh.sum_to(upds, owner), v.damping))
    tgt = pmesh.gather([sh.state["target"] for sh in shards], owner)
    wgt = pmesh.gather([sh.state["weight"] for sh in shards], owner)
    v.ba(torch.cat([target_inac, tgt]), torch.cat([weight_inac, wgt]), plan,
         iters=itrs, lm=1e-5, ep=1e-2)
