"""FactorGraph: the covisibility graph with dynamic shapes.

Counterpart of ``droid_slam_tpu/state/graph.py`` for the frontend, the
trajectory filler and the resident global BA. Edge bookkeeping (ii, jj, age,
inactive edges, NMS proposals) is host numpy; per-edge device state (GRU
hidden state, target, weight and, with volume correlation, the 4-level
correlation-volume pyramid) lives in tensors in edge order, concatenated on
add and compacted on remove. One update iteration: the edge pass
(``edge_update.py``) with the volume lookup (ops/corr_cuda.py) -> windowed
dense BA. ``update_lowmem`` is the global BA: the edge pass with on-the-fly
(alt) correlation (ops/alt_corr_cuda.py), swept over chunks of whole source
frames whose edges x pixels stay within ``SWEEP_EDGE_PIXELS``, planned and
uploaded once per call.

Stereo: a keyframe has two views, and an edge (i, i) joins frame i's left
view to its right. An edge correlates the left view of ii with view
``ii == jj`` of jj (droid_slam_tpu/state/graph.py:838,1275). With
``upsample`` the updates also write the full-resolution disparities of their
source frames (``video.disps_up``) from the last iteration's mask.

With a device ``mesh`` (``parallel/mesh.py``) the per-edge state lives in
contiguous blocks of edge order, block k on the mesh's device k, between
calls; adding and removing edges re-splits it into balanced blocks.
``update`` then runs the edge-parallel update (``parallel/frontend.py``)
and ``update_lowmem`` without ``upsample`` the chunk-parallel sweep
(``parallel/backend.py``); the replicated state (poses, disparities, the
BA) stays on the video's device. ``net``, ``target``, ``weight`` and
``pyramid`` read as edge-ordered tensors on the video's device either way.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..ba import inference as ba_inference
from ..geom import distance as gdist
from ..lie import se3
from ..models import nets
from ..ops import alt_corr_cuda
from ..ops import corr as corr_ops
from ..ops import corr_cuda
from ..parallel import mesh as pmesh
from ..utils import trace
from .edge_update import edge_update, new_edge_state

_BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# the frame path's slot pool (droid_slam_tpu/state/graph.py:57-72)
# ---------------------------------------------------------------------------

ACTIVE_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256)
WINDOW_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)
AE_BUCKET = 16  # sticky bucket of a frame's new edges
_ADD_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n, buckets):
    """The smallest bucket holding n; past the table, doubling."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# the global BA's sweep plan
# ---------------------------------------------------------------------------

# Cap on a sweep chunk's edges x feature pixels (h*w), which its working set
# grows with whatever the resolution. Of 2^19, 2^20 and 2^21 on an H100 at
# the tum preset (t=512, 240x320; 2^20 gives ~870 edges a chunk, 10 chunks
# a step), 2^19 ran 8.6% slower a step than 2^21, and 2^21 peaked above
# 16 GB where 2^20 peaked at 9.8 GB (PERF.md §6).
SWEEP_EDGE_PIXELS = 1 << 20


def sweep_bounds(ii, hw, cap):
    """The sweep's chunks over the edges' source frames ``ii`` (host):
    runs of consecutive whole source frames, each grown while its edges x
    ``hw`` stay at or below ``cap``; a frame whose edges alone pass the cap
    is a chunk of its own. Returns (order, bounds): the edges in order of
    source frame (stable), and each chunk's [lo, hi) in that order."""
    order = np.argsort(ii, kind="stable")
    _, counts = np.unique(ii, return_counts=True)
    bounds, lo, n = [], 0, 0
    for k in counts.tolist():
        if n and (n + k) * hw > cap:
            bounds.append((lo, lo + n))
            lo, n = lo + n, 0
        n += k
    if n:
        bounds.append((lo, lo + n))
    return order, bounds


def _sweep_weights(params):
    """The sweep's update weights, made once per ``update_lowmem`` call:
    (the ``update.`` parameters cast to bf16, ``nets.merge_update`` of
    them). Cast once, the convolutions cast nothing, and the bits are
    those of a cast per call."""
    params = {k: x.to(_BF16) for k, x in params.items()
              if k.startswith("update.")}
    return params, nets.merge_update(params)


class SweepChunk(NamedTuple):
    """One chunk of the sweep: its first source frame and its span of
    source frames (graph_agg's window), and device views of the plan's one
    upload: the edges' indices, source and target frames, source frames
    less g0, and feature-pyramid rows (source, target); its source frames
    and their offsets from g0."""
    g0: int
    span: int
    sel: torch.Tensor
    ii: torch.Tensor
    jj: torch.Tensor
    agg: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    frames: torch.Tensor
    offsets: torch.Tensor


def _edge_field(name):
    return property(lambda self: self._get(name),
                    lambda self, x: self._set(name, x))


class FactorGraph:
    net = _edge_field("net")
    target = _edge_field("target")
    weight = _edge_field("weight")

    def __init__(self, video, params, max_factors: int = -1,
                 corr_impl: str = "volume", fused_epilogue: bool = False,
                 upsample: bool = False, mesh=None):
        """corr_impl: "volume" (per-edge correlation pyramids, for
        ``update``) or "alt" (none: ``update_lowmem`` correlates on the
        fly). fused_epilogue: ``update`` runs the GRU's fused epilogues.
        upsample: the updates write ``video.disps_up``. mesh: a
        ``parallel.mesh.Mesh`` to shard the per-edge state and the updates
        over (None: one device, the video's)."""
        if corr_impl not in ("volume", "alt"):
            raise ValueError(f"corr_impl {corr_impl!r}")
        self.video = video
        self.params = params
        self.max_factors = max_factors
        self.fused_epilogue = fused_epilogue
        self.upsample = upsample
        self.mesh = mesh
        self.shard_params = (None if mesh is None
                             else pmesh.replicate_to(mesh, params))
        self.h, self.w = video.h, video.w
        dev, hw = video.device, video.h * video.w

        self.ii = np.zeros(0, np.int64)
        self.jj = np.zeros(0, np.int64)
        self.age = np.zeros(0, np.int64)
        # per-edge state: one tensor each in edge order, or with a mesh a
        # list of contiguous blocks, one per shard
        self._edges = {}
        self.net = torch.zeros((0, 128, self.h, self.w), dtype=_BF16,
                               device=dev)
        self.target = torch.zeros((0, 2, hw), device=dev)
        self.weight = torch.zeros((0, 2, hw), device=dev)
        self.levels = 0 if corr_impl == "alt" else corr_ops.NUM_LEVELS
        for l in range(self.levels):
            self._set(f"pyr{l}", torch.zeros(
                (0, hw, self.h >> l, self.w >> l), dtype=_BF16, device=dev))

        self.ii_inac = np.zeros(0, np.int64)
        self.jj_inac = np.zeros(0, np.int64)
        self.target_inac = torch.zeros((0, 2, hw), device=dev)
        self.weight_inac = torch.zeros((0, 2, hw), device=dev)
        # the global BA's sweep: chunks and steps run
        self.sweep_chunks = 0
        self.sweep_steps = 0

    def _dev(self, a):
        return torch.as_tensor(np.asarray(a, np.int64),
                               device=self.video.device)

    # ------------------------------------------------------------------
    # per-edge state, whole or in blocks
    # ------------------------------------------------------------------

    @property
    def pyramid(self):
        if not self.levels:
            return None
        return [self._get(f"pyr{l}") for l in range(self.levels)]

    def _names(self):
        return ["net", "target", "weight"] + [f"pyr{l}"
                                              for l in range(self.levels)]

    def _get(self, name):
        x = self._edges[name]
        return x if self.mesh is None else pmesh.gather(x, self.video.device)

    def _set(self, name, x):
        self._edges[name] = x if self.mesh is None else pmesh.split(self.mesh,
                                                                   x)

    def _blocks(self, name):
        """The shards' blocks of a per-edge field (with a mesh)."""
        return self._edges[name]

    def _append(self, name, x):
        """Rows x after the edges' own."""
        old = self._edges[name]
        self._edges[name] = (torch.cat([old, x]) if self.mesh is None
                             else pmesh.reshard(self.mesh, old + [x]))

    def _keep(self, name, kept, kept_t):
        """Only the rows ``kept`` (sorted edge indices, numpy; ``kept_t``
        the same on the video's device)."""
        old = self._edges[name]
        if self.mesh is None:
            self._edges[name] = old[kept_t]
            return
        pieces, off = [], 0
        for b in old:
            local = kept[(kept >= off) & (kept < off + len(b))] - off
            pieces.append(b[torch.as_tensor(local, device=b.device)])
            off += len(b)
        self._edges[name] = pmesh.reshard(self.mesh, pieces)

    # ------------------------------------------------------------------
    # add / remove
    # ------------------------------------------------------------------

    def _admit_edges(self, ii, jj, remove):
        """The edges of (ii, jj) that are new (in neither edge set, each
        once); with ``remove``, the oldest active edges evicted to the
        inactive store to keep ``max_factors``."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        seen = set(zip(self.ii.tolist(), self.jj.tolist()))
        seen |= set(zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = []
        for k, e in enumerate(zip(ii.tolist(), jj.tolist())):
            if e not in seen:
                seen.add(e)
                keep.append(k)
        ii, jj = ii[keep], jj[keep]
        # cap on active factors: evict the oldest
        if (len(ii) and self.max_factors > 0 and remove and len(self.ii)
                and len(self.ii) + len(ii) > self.max_factors):
            order = np.argsort(self.age, kind="stable")
            evict = order[max(self.max_factors - len(ii), 0):]
            mask = np.zeros(len(self.ii), bool)
            mask[evict] = True
            self.rm_factors(mask, store=True)
        return ii, jj

    def add_factors(self, ii, jj, remove: bool = False):
        ii, jj = self._admit_edges(ii, jj, remove)
        if len(ii) == 0:
            return

        v = self.video
        view2 = self._dev((ii == jj) & v.stereo) if self.levels else None
        net, target0, weight0, vols = new_edge_state(
            v, self._dev(ii), self._dev(jj), view2, bool(self.levels))
        for l, q in enumerate(vols):
            self._append(f"pyr{l}", q)
        self._append("net", net)
        self._append("target", target0)
        self._append("weight", weight0)
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])

    def rm_factors(self, mask, store: bool = False):
        """Remove the edges where ``mask``; with ``store`` their targets and
        weights stay in the BA as inactive edges."""
        mask = np.asarray(mask, bool)
        if not mask.any():
            return
        if store:
            gone = self._dev(np.flatnonzero(mask))
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
            self.target_inac = torch.cat([self.target_inac, self.target[gone]])
            self.weight_inac = torch.cat([self.weight_inac, self.weight[gone]])
        kept = np.flatnonzero(~mask)
        kept_t = self._dev(kept)
        for name in self._names():
            self._keep(name, kept, kept_t)
        self.ii, self.jj, self.age = (self.ii[~mask], self.jj[~mask],
                                      self.age[~mask])

    def clear_edges(self):
        self.rm_factors(np.ones(len(self.ii), bool), store=False)

    def rm_keyframe(self, ix: int):
        """Drop keyframe ix from the video and every edge touching it, and
        renumber the frames after it."""
        self.video.rm_keyframe(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)[~m]
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)[~m]
        if m.any():
            kept = self._dev(np.flatnonzero(~m))
            self.target_inac = self.target_inac[kept]
            self.weight_inac = self.weight_inac[kept]
        drop = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(drop, store=False)

    # ------------------------------------------------------------------
    # update operator + BA
    # ------------------------------------------------------------------

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               n_iters=1, motion_only=False, sens_frame=None):
        """n_iters x (update operator + ``itrs`` BA iterations) with free
        poses [t0, t1); ``motion_only`` keeps the disparities fixed (the
        trajectory filler). First, keyframe ``sens_frame`` (when given)
        takes its sensor disparity wherever that is set."""
        if not len(self.ii):
            return
        v = self.video
        if sens_frame is not None:
            sens = v.disps_sens[sens_frame]
            v.disps[sens_frame] = torch.where(sens > 0, sens,
                                              v.disps[sens_frame])
        ii, jj = self.ii, self.jj
        if t0 is None:
            t0 = max(1, int(ii.min()) + 1)
        if t1 is None:
            t1 = int(max(ii.max(), jj.max())) + 1
        g0 = int(min(ii.min(), jj.min(), t0 - 1))

        m = np.zeros(len(self.ii_inac), bool)
        if use_inactive:
            m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
        inac = self._dev(np.flatnonzero(m))
        tgt_inac, wgt_inac = self.target_inac[inac], self.weight_inac[inac]
        plan = ba_inference.build_plan(
            np.concatenate([self.ii_inac[m], ii]),
            np.concatenate([self.jj_inac[m], jj]), t0, t1, self.video.device)

        ii_t, jj_t = self._dev(ii), self._dev(jj)
        frames = np.unique(ii)
        if self.mesh is not None:
            tabs = self._shard_tables(ii_t, jj_t, g0)
        else:
            pyr, slots = self.pyramid, torch.arange(
                len(ii), dtype=torch.int32, device=v.device)
            pre = nets.gru_context_pre(self.params, v.inps[ii_t])
        for _ in range(n_iters):
            if self.mesh is not None:
                eta = self._mesh_update(tabs, t1 - g0)
            else:
                self.net, self.target, self.weight, eta, _ = edge_update(
                    self.params, v.poses, v.disps, v.intrinsics, ii_t, jj_t,
                    self.net, self.target,
                    lambda c: corr_cuda.lookup_pyramid_slots(
                        pyr, slots, c.contiguous()),
                    pre=pre, agg=ii_t - g0, num_frames=t1 - g0,
                    fused_epilogue=self.fused_epilogue)
            v.damping[self._dev(frames)] = eta[self._dev(frames - g0)].float()
            v.ba(torch.cat([tgt_inac, self.target]),
                 torch.cat([wgt_inac, self.weight]), plan, iters=itrs,
                 lm=1e-4, ep=0.1, motion_only=motion_only)
        self.age += n_iters
        if self.upsample:
            # the mask of the last iteration, from its GRU state
            # (droid_slam_tpu/state/graph.py:318-329,421-429)
            if self.mesh is None:
                _, upmask = nets.graph_agg(self.params, self.net, ii_t - g0,
                                           t1 - g0, compute_upmask=True)
            else:
                upmask = self._mesh_upmask(tabs, t1 - g0)
            self._write_disps_up(self._dev(frames),
                                 upmask[self._dev(frames - g0)])

    def _write_disps_up(self, f, upmask):
        """Full-resolution disparities of the frames ``f`` (on the device)
        from their masks."""
        v = self.video
        v.disps_up[f] = nets.upsample_disp(v.disps[f], upmask)

    def _shard_tables(self, ii_t, jj_t, g0):
        """Each shard's block of the edge tables on its device: source and
        target frames, their offsets from g0, and the context features'
        GRU contributions (``nets.gru_context_pre``), once per update."""
        from ..parallel import frontend as pfront
        sizes = [len(b) for b in self._blocks("target")]
        pre = []
        for d, p, ii_k in zip(self.mesh.devices, self.shard_params,
                              ii_t.split(sizes)):
            inp = self.video.inps[ii_k].to(d)
            pre.append(nets.gru_context_pre(p, inp))
        split = lambda x: pmesh.split(self.mesh, x, sizes)
        return pfront.EdgeTables(ii=split(ii_t), jj=split(jj_t),
                                 agg_ii=split(ii_t - g0), pre=pre)

    def _mesh_update(self, tabs, nw):
        """One update-operator pass with the edges sharded over the mesh
        (``parallel/frontend.py::edge_parallel_update``): writes the
        blocks, returns eta [nw,h,w] on the video's device."""
        from ..parallel import frontend as pfront
        v = self.video
        pyr = [self._blocks(f"pyr{l}") for l in range(self.levels)]
        nets_e, tgts, wgts, eta, _ = pfront.edge_parallel_update(
            self.mesh, self.params, v.poses, v.disps, v.intrinsics, v.inps,
            list(zip(*pyr)), self._blocks("net"), self._blocks("target"),
            tabs, nw, shard_params=self.shard_params,
            fused_epilogue=self.fused_epilogue)
        self._edges.update(net=nets_e, target=tgts, weight=wgts)
        return eta

    def _mesh_upmask(self, tabs, nw):
        """graph_agg's upsampling mask of the sharded GRU state."""
        parts = []
        for p, net, agg in zip(self.shard_params, self._blocks("net"),
                               tabs.agg_ii):
            parts.append(nets.graph_agg_sums(p, net, agg, nw))
        dev = self.video.device
        counts = pmesh.sum_to([c for c, _ in parts], dev)
        sums = pmesh.sum_to([s for _, s in parts], dev)
        return nets.graph_agg_heads(self.params, counts, sums,
                                    compute_upmask=True)[1]

    # ------------------------------------------------------------------
    # global BA (resident)
    # ------------------------------------------------------------------

    def update_lowmem(self, steps=8, itrs=2, use_inactive=False):
        """Global BA over all keyframes: ``steps`` x (a sweep of the update
        operator over chunks of source frames with on-the-fly correlation,
        then ``itrs`` dense BA iterations over every edge with free poses
        [1, t)); ``use_inactive`` adds every stored inactive edge to the BA,
        ahead of the active ones (the asynchronous backend's persistent
        graph). Counterpart of the resident path of
        ``droid_slam_tpu/state/graph.py::update_lowmem``; the chunking bounds
        the correlation's working set. The chunk's update operator takes the
        full 320-channel context path (no precompute, no fused epilogue).
        The feature pyramid flattens the views: row n*c + k is view k of
        frame n; with ``upsample`` each chunk writes ``disps_up`` of its
        source frames from the disparities the step began with.

        The serial sweep's chunks (``sweep_bounds`` under
        ``SWEEP_EDGE_PIXELS``), their tables and the update operator's
        merged weights are made once, before the steps: inside the steps
        nothing is copied to the device and nothing waits for it. Chunks
        are independent within a step (each reads poses and disparities
        that only the BA writes, and its own edges' state; graph_agg
        averages over whole source frames), so their size changes no
        result."""
        v = self.video
        t = v.counter
        c = v.fmaps.shape[1]
        fpyr = corr_ops.build_fmap_pyramid(v.fmaps[:t].reshape(
            t * c, *v.fmaps.shape[2:]))
        n_inac = len(self.ii_inac) if use_inactive else 0
        if self.mesh is not None and not self.upsample:
            # chunk-parallel sweep (droid_slam_tpu/state/graph.py:1292-1336)
            self._lowmem_steps_mesh(fpyr, c, n_inac, steps, itrs)
            v.dirty[:t] = True
            return
        plan = ba_inference.build_plan(
            np.concatenate([self.ii_inac[:n_inac], self.ii]),
            np.concatenate([self.jj_inac[:n_inac], self.jj]), 1, t, v.device)
        chunks = self._sweep_plan(c)
        weights = _sweep_weights(self.params)
        with self._whole():
            for _ in range(steps):
                for ch in chunks:
                    self._lowmem_chunk(fpyr, weights, ch)
                v.ba(torch.cat([self.target_inac[:n_inac], self.target]),
                     torch.cat([self.weight_inac[:n_inac], self.weight]),
                     plan, iters=itrs, lm=1e-5, ep=1e-2)
                self.age += 1
                self.sweep_steps += 1
        v.dirty[:t] = True

    def _sweep_plan(self, c):
        """The serial sweep's chunks (``SweepChunk``), their tables packed
        into one int64 tensor and uploaded in one copy. ``c``: views per
        frame."""
        order, bounds = sweep_bounds(self.ii, self.h * self.w,
                                     SWEEP_EDGE_PIXELS)
        ii, jj = self.ii[order], self.jj[order]
        g0 = np.zeros(len(ii), np.int64)
        for lo, hi in bounds:
            g0[lo:hi] = ii[lo]
        frames, first = np.unique(ii, return_index=True)
        cols = [order, ii, jj, ii - g0, ii * c, jj * c + (ii == jj)]
        packed = self._dev(np.concatenate(cols + [frames, frames - g0[first]]))
        E = len(ii)
        sel, ii_t, jj_t, agg, src, dst = packed[:6 * E].split(E)
        frames_t, offsets_t = packed[6 * E:].split(len(frames))
        f_lo = np.searchsorted(frames, ii[[lo for lo, _ in bounds]])
        f_hi = np.append(f_lo[1:], len(frames))
        return [SweepChunk(g0=int(ii[lo]), span=int(ii[hi - 1] - ii[lo]) + 1,
                           sel=sel[lo:hi], ii=ii_t[lo:hi], jj=jj_t[lo:hi],
                           agg=agg[lo:hi], src=src[lo:hi], dst=dst[lo:hi],
                           frames=frames_t[a:b], offsets=offsets_t[a:b])
                for (lo, hi), a, b in zip(bounds, f_lo.tolist(),
                                          f_hi.tolist())]

    @contextlib.contextmanager
    def _whole(self):
        """Inside, the per-edge state is one edge-ordered tensor per field
        on the video's device, written in place by the serial sweep; with a
        mesh it is split into blocks again after."""
        mesh = self.mesh
        if mesh is None:
            yield
            return
        self._edges = {k: self._get(k) for k in self._names()}
        self.mesh = None
        try:
            yield
        finally:
            self.mesh = mesh
            for k, x in list(self._edges.items()):
                self._set(k, x)

    def _lowmem_steps_mesh(self, fpyr, c, n_inac, steps, itrs):
        """Global-BA steps with chunks of 8 source frames split over the
        mesh (``parallel/backend.py``): each shard's chunks' edge state
        packed on its device for the run, the BA over the packed order,
        then the state written back in edge order. ``c``: views per
        frame."""
        from ..parallel import backend as pback
        v, mesh = self.video, self.mesh
        ii, jj = self.ii, self.jj
        rows = (self._dev(ii * c), self._dev(jj * c + (ii == jj)))
        starts = range(int(ii.min()), int(jj.max()) + 1, 8)
        chunks = [(s, np.flatnonzero((ii >= s) & (ii < s + 8)))
                  for s in starts]
        chunks = [(s, idx) for s, idx in chunks if len(idx)]
        groups = pback.shard_chunks(mesh, chunks)
        shards, order = [], []
        whole = {k: self._get(k) for k in ("net", "target", "weight")}
        for d, group in zip(mesh.devices, groups):
            sel = (np.concatenate([idx for _, idx in group]) if group
                   else np.zeros(0, np.int64))
            sel_t = self._dev(sel)
            spans, lo = [], 0
            for g0, idx in group:
                frames = np.unique(self.ii[idx])
                spans.append(pback.ChunkSpan(
                    g0=g0, lo=lo, hi=lo + len(idx),
                    frames=torch.as_tensor(frames, device=d),
                    offsets=torch.as_tensor(frames - g0, device=d)))
                lo += len(idx)
            shards.append(pback.ChunkShard(
                spans=spans,
                ii=self._dev(self.ii[sel]).to(d),
                jj=self._dev(self.jj[sel]).to(d),
                rows=(rows[0][sel_t].to(d), rows[1][sel_t].to(d)),
                state={k: x[sel_t].to(d) for k, x in whole.items()}))
            order.append(sel)
        order = np.concatenate(order)
        plan = ba_inference.build_plan(
            np.concatenate([self.ii_inac[:n_inac], self.ii[order]]),
            np.concatenate([self.jj_inac[:n_inac], self.jj[order]]), 1,
            v.counter, v.device)
        fpyrs = [[lvl.to(d) for lvl in fpyr] for d in mesh.devices]
        inps = [v.inps.to(d) for d in mesh.devices]
        weights = [_sweep_weights(p) for p in self.shard_params]
        for _ in range(steps):
            pback.lowmem_step_mesh(
                mesh, weights, v, fpyrs, inps, shards,
                self.target_inac[:n_inac], self.weight_inac[:n_inac], plan,
                itrs)
            self.age += 1
            self.sweep_chunks += len(chunks)
            self.sweep_steps += 1
        back = self._dev(order)
        for k, x in whole.items():
            x[back] = pmesh.gather([sh.state[k] for sh in shards], v.device)
            self._set(k, x)

    def _lowmem_chunk(self, fpyr, weights, ch):
        """One update-operator pass over the edges of the ``SweepChunk``
        ``ch``; writes their net, target and weight, and the damping (and
        with ``upsample`` the full-resolution disparities) of its source
        frames. ``weights``: the update operator's (params, merged). Reads
        only device tensors and host ints. The span ``droid:sweep_chunk``
        (args: the first frame, the edges, the source frames)."""
        with trace.span("sweep_chunk", {"first": ch.g0, "edges": len(ch.sel),
                                        "frames": len(ch.frames)}):
            v = self.video
            params, merged = weights
            net, tgt, wgt, eta, upmask = edge_update(
                params, v.poses, v.disps, v.intrinsics, ch.ii, ch.jj,
                self.net[ch.sel], self.target[ch.sel],
                lambda c: alt_corr_cuda.alt_lookup(fpyr, c, ch.src, ch.dst),
                inp=v.inps[ch.ii], agg=ch.agg, num_frames=ch.span,
                merged=merged, compute_upmask=self.upsample)
            self.net[ch.sel] = net
            self.target[ch.sel], self.weight[ch.sel] = tgt, wgt
            v.damping[ch.frames] = eta[ch.offsets].float()
            if self.upsample:
                self._write_disps_up(ch.frames, upmask[ch.offsets])
        self.sweep_chunks += 1

    # ------------------------------------------------------------------
    # edge proposers
    # ------------------------------------------------------------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        """Every pair of frames in [t0, t1) at most r apart; in stereo at
        least 2 apart (droid_slam_tpu/state/graph.py:1609-1615)."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        c = 1 if self.video.stereo else 0
        keep = (np.abs(ii - jj) > c) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False, dist=None):
        """Greedy NMS edge proposal by frame distance; in stereo each frame
        of [t0, t) also gets its (i, i) edge (droid_slam_tpu/native/
        plan_builder.cpp:182-193, in the same order). ``dist``: the pairs'
        distances, already probed by the frame program (used when it has
        one per pair). The span ``droid:proposal``."""
        with trace.span("proposal"):
            t = self.video.counter
            ix, jx = np.arange(t0, t), np.arange(t1, t)
            if len(ix) == 0 or len(jx) == 0:
                return
            ii, jj = np.meshgrid(ix, jx, indexing="ij")
            ii, jj = ii.reshape(-1), jj.reshape(-1)
            if dist is not None and len(dist) == len(ii):
                d = np.asarray(dist, np.float64)
            else:
                d = self.video.distance(ii, jj, beta=beta).cpu().numpy() \
                    .astype(np.float64)
            d[ii - rad < jj] = np.inf
            d[d > 100] = np.inf
            cols = t - t1

            def suppress(i, j):
                n = max(min(abs(i - j) - 2, nms), 0)
                for di in range(-nms, nms + 1):
                    for dj in range(-nms, nms + 1):
                        if abs(di) + abs(dj) <= n:
                            i1, j1 = i + di, j + dj
                            if t0 <= i1 < t and t1 <= j1 < t:
                                d[(i1 - t0) * cols + (j1 - t1)] = np.inf

            for i, j in zip(
                    np.concatenate([self.ii, self.ii_inac]).tolist(),
                    np.concatenate([self.jj, self.jj_inac]).tolist()):
                suppress(i, j)

            es = []
            for i in range(t0, t):
                if self.video.stereo:
                    # its distance is already inf: i-rad < i
                    es.append((i, i))
                for j in range(max(i - rad - 1, 0), i):
                    es += [(i, j), (j, i)]
                    if t1 <= j < t:
                        d[(i - t0) * cols + (j - t1)] = np.inf

            for k in np.argsort(d, kind="stable"):
                if d[k] > thresh:
                    continue
                if self.max_factors > 0 and len(es) > self.max_factors:
                    break
                i, j = int(ii[k]), int(jj[k])
                es += [(i, j), (j, i)]
                suppress(i, j)

            if es:
                es = np.asarray(es, np.int64)
                self.add_factors(es[:, 0], es[:, 1], remove)


# ---------------------------------------------------------------------------
# the frame path: slot pool, deferred tables, the two halves of the update
# (droid_slam_tpu/state/graph.py:179-442,639-699,793-945,1062-1188)
# ---------------------------------------------------------------------------

class SlotGraph(FactorGraph):
    """The frontend's graph on the frame path (``slam/fused_frame.py``).

    Per-edge state lives in fixed-capacity slot pools, each with one row
    more than its capacity: the sentinel that padded and gated-off writes
    go to. ``net_e`` [cap+1,128,h,w] bf16, ``target_e``/``weight_e``
    [cap+1,2,HW], ``pyr_e`` (4 levels [cap+1,HW,h_l,w_l] bf16), and the
    inactive store ``target_inac_p``/``weight_inac_p`` [icap+1,2,HW]. The
    host keeps edge order (``ii``, ``jj``, ``age``, ``slots``) and the free
    lists, as JAX's ``FactorGraph`` does. With ``defer`` set, moves to the
    inactive store and new edges are queued as tables (``drain_deferred``)
    for the frame program instead of run. The pools grow by reallocation
    (``generation`` counts them: a captured program holds their
    addresses); nothing else rebinds them.

    ``SlotGraph.from_graph`` takes over an edge-ordered ``FactorGraph``
    after the frontend's initialization: slot k holds edge k, as JAX's
    ``compact()`` leaves it."""

    net = property(lambda self: self.net_e[self._slots_t()])
    target = property(lambda self: self.target_e[self._slots_t()])
    weight = property(lambda self: self.weight_e[self._slots_t()])
    target_inac = property(
        lambda self: self.target_inac_p[self._dev(self.inac_slots)])
    weight_inac = property(
        lambda self: self.weight_inac_p[self._dev(self.inac_slots)])

    @property
    def pyramid(self):
        return None if self.pyr_e is None else [
            p[self._slots_t()] for p in self.pyr_e]

    @classmethod
    def from_graph(cls, g, inactive_capacity=2048, ba_inactive_bucket=192,
                   rmax=16, window_bucket=32):
        if g.mesh is not None:
            raise ValueError("the frame path runs on one device")
        self = cls.__new__(cls)
        self.video, self.params = g.video, g.params
        self.max_factors = g.max_factors
        self.fused_epilogue, self.upsample = g.fused_epilogue, g.upsample
        self.mesh, self.shard_params = None, None
        self.h, self.w, self.levels = g.h, g.w, g.levels
        self._edges = {}
        n = len(g.ii)
        self.ii, self.jj, self.age = g.ii.copy(), g.jj.copy(), g.age.copy()
        self.ii_inac, self.jj_inac = g.ii_inac.copy(), g.jj_inac.copy()
        self.capacity = _bucket(max(n, g.max_factors), ACTIVE_BUCKETS)
        self.slots = np.arange(n, dtype=np.int64)
        self.free = list(range(n, self.capacity))
        n_inac = len(g.ii_inac)
        icap = max(inactive_capacity, n_inac)
        self.inac_slots = np.arange(n_inac, dtype=np.int64)
        self.inac_free = list(range(n_inac, icap))
        self.ba_inactive_bucket, self.rmax = ba_inactive_bucket, rmax
        self.window_bucket = window_bucket
        self.defer, self.ae_bucket = False, AE_BUCKET
        self._pending_moves, self._pending_add = [], None
        self.generation = 0

        dev, hw = g.video.device, g.h * g.w
        cap = self.capacity
        pool = lambda rows, shape, dtype: torch.zeros(
            (rows + 1,) + shape, dtype=dtype, device=dev)
        self.net_e = pool(cap, (128, g.h, g.w), _BF16)
        self.target_e = pool(cap, (2, hw), torch.float32)
        self.weight_e = pool(cap, (2, hw), torch.float32)
        self.pyr_e = None if not g.levels else [
            pool(cap, (hw, g.h >> l, g.w >> l), _BF16)
            for l in range(g.levels)]
        self.net_e[:n] = g.net
        self.target_e[:n] = g.target
        self.weight_e[:n] = g.weight
        for l in range(g.levels):
            self.pyr_e[l][:n] = g.pyramid[l]
        self.target_inac_p = pool(icap, (2, hw), torch.float32)
        self.weight_inac_p = pool(icap, (2, hw), torch.float32)
        self.target_inac_p[:n_inac] = g.target_inac
        self.weight_inac_p[:n_inac] = g.weight_inac
        return self

    def _slots_t(self):
        return self._dev(self.slots)

    @property
    def inactive_capacity(self):
        return self.target_inac_p.shape[0] - 1

    def pool_tensors(self):
        """Every pool buffer (for address checks)."""
        return [self.net_e, self.target_e, self.weight_e,
                self.target_inac_p, self.weight_inac_p] + list(
                    self.pyr_e or [])

    # ------------------------------------------------------------------
    # add / remove
    # ------------------------------------------------------------------

    def add_factors(self, ii, jj, remove: bool = False):
        ii, jj = self._admit_edges(ii, jj, remove)
        if len(ii) == 0:
            return
        while len(self.free) < len(ii):
            self._grow()

        k = len(ii)
        kb = _bucket(k, _ADD_BUCKETS)
        if self.defer:
            while self.ae_bucket < kb:
                self.ae_bucket *= 2
            kb = self.ae_bucket
        ii_p = np.zeros(kb, np.int64)
        jj_p = np.zeros(kb, np.int64)
        ii_p[:k], jj_p[:k] = ii, jj
        slots = np.array([self.free.pop(0) for _ in range(k)], np.int64)
        slots_p = np.full(kb, self.capacity, np.int64)
        slots_p[:k] = slots
        c = (ii_p == jj_p).astype(np.int64)
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(k, np.int64)])
        self.slots = np.concatenate([self.slots, slots])
        if self.defer:
            assert self._pending_add is None, "one add per frame"
            self._pending_add = (ii_p, jj_p, c, slots_p)
            return
        add_edges(self, *(self._dev(a) for a in (ii_p, jj_p, c, slots_p)))

    def rm_factors(self, mask, store: bool = False):
        mask = np.asarray(mask, bool)
        if not mask.any():
            return
        slots = self.slots[mask]
        if store:
            while len(self.inac_free) < len(slots):
                self._grow_inactive()
            islots = np.array([self.inac_free.pop(0) for _ in slots],
                              np.int64)
            if self.defer:
                self._pending_moves.extend(zip(slots.tolist(),
                                               islots.tolist()))
            else:
                move_rows(self, self._dev(slots), self._dev(islots))
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
            self.inac_slots = np.concatenate([self.inac_slots, islots])
        self.ii, self.jj, self.age = (self.ii[~mask], self.jj[~mask],
                                      self.age[~mask])
        self.slots = self.slots[~mask]
        self.free.extend(slots.tolist())

    def rm_keyframe(self, ix: int):
        self.video.rm_keyframe(ix)
        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)
        if m.any():
            self.inac_free.extend(self.inac_slots[m].tolist())
            self.ii_inac, self.jj_inac = self.ii_inac[~m], self.jj_inac[~m]
            self.inac_slots = self.inac_slots[~m]
        drop = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(drop, store=False)

    def _grow(self):
        """Double the active capacity (new buffers: a new generation)."""
        old = self.capacity
        new = _bucket(old + 1, ACTIVE_BUCKETS + (512, 1024, 2048))
        grow = lambda x: torch.cat([x[:old], x.new_zeros(
            (new - old + 1,) + x.shape[1:])])
        self.net_e, self.target_e, self.weight_e = map(
            grow, (self.net_e, self.target_e, self.weight_e))
        if self.pyr_e is not None:
            self.pyr_e = [grow(p) for p in self.pyr_e]
        self.free.extend(range(old, new))
        self.capacity = new
        self.generation += 1

    def _grow_inactive(self):
        old = self.inactive_capacity
        grow = lambda x: torch.cat([x[:old], x.new_zeros(
            (old + 1,) + x.shape[1:])])
        self.target_inac_p = grow(self.target_inac_p)
        self.weight_inac_p = grow(self.weight_inac_p)
        self.inac_free.extend(range(old, 2 * old))
        self.generation += 1

    def update(self, *args, **kwargs):
        raise RuntimeError("a SlotGraph updates through the frame program "
                           "(slam/fused_frame.py)")

    # ------------------------------------------------------------------
    # the frame program's tables
    # ------------------------------------------------------------------

    def bump_age(self, n):
        """Account iterations that ran on the device."""
        self.age = self.age + n

    def update_tables(self, use_inactive=True, kf_pair=None,
                      next_state_t1=None, sens_frame=None, itrs=2):
        """Host half of an update: the int table vector of the frame
        program and its static sizes (droid_slam_tpu/state/graph.py:
        1074-1157). The active rows are in slot order; the BA's edges are
        the inactive ones padded to ``ba_inactive_bucket``, then every
        slot."""
        ii, jj = self.ii, self.jj
        EA = self.capacity
        t0 = max(1, int(ii.min()) + 1)
        t1 = int(max(ii.max(), jj.max())) + 1
        g0 = int(min(ii.min(), jj.min(), t0 - 1))
        ii_s = np.zeros(EA, np.int64)
        jj_s = np.zeros(EA, np.int64)
        valid_s = np.zeros(EA, np.int64)
        ii_s[self.slots], jj_s[self.slots], valid_s[self.slots] = ii, jj, 1
        self.window_bucket = max(self.window_bucket,
                                 _bucket(t1 - g0, WINDOW_BUCKETS))
        nw = self.window_bucket
        if use_inactive and len(self.ii_inac):
            m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
            ii_in, jj_in = self.ii_inac[m], self.jj_inac[m]
            in_slots = self.inac_slots[m]
        else:
            ii_in = jj_in = in_slots = np.zeros(0, np.int64)
        while len(ii_in) > self.ba_inactive_bucket:
            self.ba_inactive_bucket *= 2
        IB = self.ba_inactive_bucket
        in_slots_p = np.full(IB, self.inactive_capacity, np.int64)
        in_slots_p[:len(in_slots)] = in_slots
        pad = np.full(IB - len(ii_in), t0)
        ba_shape, plan = ba_inference.build_plan_padded(
            np.concatenate([ii_in, pad, np.where(valid_s > 0, ii_s, t0)]),
            np.concatenate([jj_in, pad, np.where(valid_s > 0, jj_s, t0)]),
            t0, t1, np.concatenate([np.ones(len(ii_in), bool),
                                    np.zeros(len(pad), bool), valid_s > 0]),
            edges=IB + EA, window=self.window_bucket, rmax=self.rmax)
        self.window_bucket = max(self.window_bucket, ba_shape.window)
        self.rmax = max(self.rmax, ba_shape.rmax)
        kf = (0, 0) if kf_pair is None else kf_pair
        packed = _pack(*plan, ii_s, jj_s, valid_s, in_slots_p, kf, [g0],
                       [0 if next_state_t1 is None else next_state_t1],
                       [-1 if sens_frame is None else sens_frame])
        return dict(packed=packed, ba_shape=ba_shape, nw=nw, EA=EA, g0=g0,
                    IB=IB)

    def up_dst_table(self, tb):
        """disps_up destination of window row k: frame g0+k when it has
        edges, else the sentinel (past the buffer)."""
        nw, g0 = tb["nw"], tb["g0"]
        dst = np.full(nw, self.video.buffer + 1, np.int64)
        f = np.unique(self.ii)
        f = f[(f - g0 >= 0) & (f - g0 < nw)]
        dst[f - g0] = f
        return dst

    def drain_deferred(self):
        """Padded (mv_src, mv_dst, ae_ii, ae_jj, ae_c, ae_slots) of the
        queued moves and adds; clears the queue."""
        cap, icap = self.capacity, self.inactive_capacity
        mv_src = np.full(cap, cap, np.int64)
        mv_dst = np.full(cap, icap, np.int64)
        for n, (s, d) in enumerate(self._pending_moves):
            mv_src[n], mv_dst[n] = s, d
        self._pending_moves = []
        if self._pending_add is None:
            kb = self.ae_bucket
            add = (np.zeros(kb, np.int64), np.zeros(kb, np.int64),
                   np.zeros(kb, np.int64), np.full(kb, cap, np.int64))
        else:
            add, self._pending_add = self._pending_add, None
        return (mv_src, mv_dst) + tuple(add)


def _pack(*arrays):
    """Host index arrays as one int32 vector."""
    return np.concatenate([np.asarray(a).reshape(-1).astype(np.int32)
                           for a in arrays])


class FrameTables:
    """The update tables of ``SlotGraph.update_tables``, unpacked on the
    device from the int vector at static offsets."""

    def __init__(self, take, ba_shape, ea, ib):
        self.plan, self.edge_valid = ba_inference.unpack_plan(take, ba_shape)
        self.ii, self.jj = take(ea).long(), take(ea).long()
        self.valid = take(ea) > 0
        self.in_slots = take(ib).long()
        self.kf_pair = take(2).long()
        self.g0, self.ns_t1, self.sens_frame = (take(1).long()[0]
                                                for _ in range(3))


def add_edges(g, ii, jj, c, slots):
    """New edges' first state (``new_edge_state``; ``c``: 1 for an (i, i)
    edge) into their slots (a slot past the capacity drops the write)."""
    v = g.video
    net, target0, weight0, vols = new_edge_state(
        v, ii, jj, c * int(v.stereo), g.pyr_e is not None)
    g.net_e.index_copy_(0, slots, net)
    g.target_e.index_copy_(0, slots, target0)
    g.weight_e.index_copy_(0, slots, weight0)
    for p, q in zip(g.pyr_e or (), vols):
        p.index_copy_(0, slots, q)


def move_rows(g, src, dst):
    """Active slots ``src`` into the inactive slots ``dst`` (a slot past
    the store drops the write)."""
    g.target_inac_p.index_copy_(0, dst, g.target_e[src])
    g.weight_inac_p.index_copy_(0, dst, g.weight_e[src])


def row(buf, index):
    """buf[index] for a device scalar ``index`` (clamped into the buffer):
    a gather, where Python indexing by a 0-d tensor would read it on the
    host."""
    return buf.index_select(
        0, index.clamp(0, buf.shape[0] - 1).reshape(1))[0]


def _row_put(buf, index, val, on):
    """buf[index] = val where ``on`` and ``index`` lies in the buffer
    (device scalars), in place."""
    ok = on & (index >= 0) & (index < buf.shape[0])
    r = index.clamp(0, buf.shape[0] - 1).reshape(1)
    buf.index_copy_(0, r, torch.where(ok, val, row(buf, index))[None])


def next_state_pose_disp(poses, disps, t1, motion_damping):
    """The motion model's pose and disparity for frame t1 (a device
    scalar), as ``slam/frontend.py::_init_next_state`` writes them."""
    p_prev = row(poses, t1 - 1)
    vel = se3.log(se3.mul(p_prev, se3.inv(row(poses, t1 - 2))))
    new_pose = se3.mul(se3.exp(motion_damping * vel), p_prev)
    dwin = torch.stack([row(disps, t1 - 3), row(disps, t1 - 2)])
    return new_pose, torch.quantile(dwin, 0.5)


class FrameIteration:
    """One update iteration (update operator + 2 BA iterations) over
    every slot, its writes in place and gated by a device flag
    (droid_slam_tpu/state/graph.py:229-332). Per program, the context
    features' GRU terms and the inactive edges are gathered once."""

    def __init__(self, g, tabs, nw, ba_shape):
        v = g.video
        self.g, self.tabs, self.nw = g, tabs, nw
        self.cap = cap = g.capacity
        dev = v.device
        self.slots = torch.arange(cap, dtype=torch.int32, device=dev)
        self.pre = nets.gru_context_pre(g.params, v.inps[tabs.ii])
        self.tgt_inac = g.target_inac_p[tabs.in_slots]
        self.wgt_inac = g.weight_inac_p[tabs.in_slots]
        self.agg_ii = torch.where(tabs.valid,
                                  (tabs.ii - tabs.g0).clamp(0, nw - 1), nw)
        counts = torch.zeros(nw + 1, device=dev).index_add_(
            0, self.agg_ii, torch.ones(cap, device=dev))
        self.present = counts[:nw] > 0
        self.win = tabs.g0 + torch.arange(nw, device=dev)
        self.vm = tabs.valid[:, None, None].float()

    def __call__(self, run):
        g, v, tabs, cap = self.g, self.g.video, self.tabs, self.cap
        tgt_e, wgt_e, net_e = (g.target_e[:cap], g.weight_e[:cap],
                               g.net_e[:cap])
        net, tgt, wgt, eta, _ = edge_update(
            g.params, v.poses, v.disps, v.intrinsics, tabs.ii, tabs.jj, net_e,
            tgt_e, lambda c: corr_cuda.lookup_pyramid_slots(
                g.pyr_e, self.slots, c.contiguous()),
            pre=self.pre, agg=self.agg_ii, num_frames=self.nw + 1,
            fused_epilogue=g.fused_epilogue)
        net_e.copy_(torch.where(run, net, net_e))
        tgt_e.copy_(torch.where(run, tgt * self.vm, tgt_e))
        wgt_e.copy_(torch.where(run, wgt * self.vm, wgt_e))
        win_c = self.win.clamp(max=v.buffer - 1)
        damp = torch.where(self.present[:, None, None] & run,
                           eta[:self.nw].float(), v.damping[win_c])
        v.damping.copy_(ba_inference.window_put(v.damping, self.win, damp))
        poses, disps = ba_inference.ba_iterations(
            v.poses, v.disps, v.disps_sens, v.damping, v.intrinsics[0],
            torch.cat([self.tgt_inac, tgt_e]),
            torch.cat([self.wgt_inac, wgt_e]), tabs.plan, tabs.edge_valid,
            lm=1e-4, ep=0.1, iters=2)
        v.poses.copy_(torch.where(run, poses, v.poses))
        v.disps.copy_(torch.where(run, disps, v.disps))

    def upmask(self):
        """The upsampling mask of the GRU state as it stands [nw,576,h,w]:
        the last iteration's (droid_slam_tpu/state/graph.py:318-329)."""
        g = self.g
        _, upmask = nets.graph_agg(g.params, g.net_e[:self.cap], self.agg_ii,
                                   self.nw + 1, compute_upmask=True)
        return upmask[:self.nw]


def update_part_a(g, tabs, nw, ba_shape, n_iters: int, n_iters_dev, gate,
                  kf_beta):
    """The iters1 half of an update (droid_slam_tpu/state/graph.py:
    343-391): the sensor disparity of ``sens_frame`` (RGB-D), ``n_iters``
    gated iterations (those at or past ``n_iters_dev`` write nothing), then
    the keyframe distance of ``kf_pair``. Returns kf_dist (device)."""
    v = g.video
    sf = torch.where(gate, tabs.sens_frame, -1)
    sens = row(v.disps_sens, sf)
    _row_put(v.disps, sf, torch.where(sens > 0, sens, row(v.disps, sf)),
             sf >= 0)
    it = FrameIteration(g, tabs, nw, ba_shape)
    for k in range(n_iters):
        it(k < n_iters_dev)
    kp = tabs.kf_pair
    return gdist.frame_distance(v.poses, v.disps, v.intrinsics[0], kp[:1],
                                kp[1:2], kf_beta)[0]


def update_part_b(g, tabs, nw, ba_shape, n_iters: int, n_iters_dev, keep,
                  do_next_state, motion_damping, up_dst=None):
    """The iters2 half (droid_slam_tpu/state/graph.py:392-442): ``n_iters``
    iterations gated by ``keep`` (the keyframe stays) and
    ``n_iters_dev``; the full-resolution disparities of the window rows
    whose ``up_dst`` is in the buffer (with ``upsample``); the motion
    model's pose and disparity of the next frame when ``do_next_state``
    and ``keep``."""
    v = g.video
    it = FrameIteration(g, tabs, nw, ba_shape)
    for k in range(n_iters):
        it(keep & (k < n_iters_dev))
    if g.upsample:
        win_c = it.win.clamp(max=v.buffer - 1)
        up = nets.upsample_disp(v.disps[win_c], it.upmask().float())
        on = (up_dst < v.buffer)[:, None, None]
        v.disps_up.copy_(ba_inference.window_put(
            v.disps_up, it.win, torch.where(on, up, v.disps_up[win_c])))
    pose, disp = next_state_pose_disp(v.poses, v.disps, tabs.ns_t1,
                                      motion_damping)
    on = (do_next_state > 0) & keep
    _row_put(v.poses, tabs.ns_t1, pose, on)
    _row_put(v.disps, tabs.ns_t1, disp.expand(v.disps.shape[1:]), on)
