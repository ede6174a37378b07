"""FactorGraph: the covisibility graph with dynamic shapes.

Counterpart of ``droid_slam_tpu/state/graph.py`` for the frontend, the
trajectory filler and the resident global BA. Edge bookkeeping (ii, jj, age,
inactive edges, NMS proposals) is host numpy; per-edge device state (GRU
hidden state, target, weight and, with volume correlation, the 4-level
correlation-volume pyramid) lives in tensors in edge order, concatenated on
add and compacted on remove. One update iteration: reproject -> corr-window
lookup (CUDA kernel on the GPU, ops/corr_cuda.py) -> update operator +
graph aggregation (optionally with the fused GRU epilogues) -> windowed
dense BA. ``update_lowmem`` is the global BA: on-the-fly (alt) correlation
from feature pyramids, swept over chunks of 8 source frames.

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

import numpy as np
import torch

from ..ba import inference as ba_inference
from ..geom import projective as pops
from ..models import nets
from ..ops import corr as corr_ops
from ..ops import corr_cuda
from ..parallel import mesh as pmesh

_BF16 = torch.bfloat16


def motion_features(poses, disps, intrinsics, ii_t, jj_t, target):
    """coords1 [E,h,w,2] of the edges (ii, jj) at the given poses and
    disparities, and the update operator's motion features [E,4,h,w]
    bf16: flow from the identity grid and residual to the target."""
    E, (h, w) = len(ii_t), disps.shape[-2:]
    coords1, _, _ = pops.projective_transform(poses, disps, intrinsics, ii_t,
                                              jj_t)
    coords0 = pops.coords_grid(h, w, device=coords1.device)
    resd = target.reshape(E, 2, h, w).permute(0, 2, 3, 1) - coords1
    motn = torch.cat([coords1 - coords0, resd], dim=-1).clamp(-64.0, 64.0)
    return coords1, motn.to(_BF16).permute(0, 3, 1, 2)


def corr_nchw(corr, h, w):
    """Lookup output [E,HW,196] f32 -> the corr encoder's [E,196,h,w]
    bf16."""
    return corr.to(_BF16).transpose(1, 2).reshape(corr.shape[0], -1, h, w)


def target_weight(coords1, delta, weight):
    """The update's new target and weight [E,2,HW] f32."""
    E, h, w = coords1.shape[:3]
    return ((coords1.permute(0, 3, 1, 2) + delta.float()).reshape(E, 2, h * w),
            weight.float().reshape(E, 2, h * w))


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

    def add_factors(self, ii, jj, remove: bool = False):
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
        if len(ii) == 0:
            return

        # cap on active factors: evict the oldest
        if (self.max_factors > 0 and len(self.ii) + len(ii) > self.max_factors
                and remove and len(self.ii)):
            order = np.argsort(self.age, kind="stable")
            evict = order[max(self.max_factors - len(ii), 0):]
            mask = np.zeros(len(self.ii), bool)
            mask[evict] = True
            self.rm_factors(mask, store=True)

        v = self.video
        ii_t, jj_t = self._dev(ii), self._dev(jj)
        coords, _, _ = pops.projective_transform(v.poses, v.disps,
                                                 v.intrinsics, ii_t, jj_t)
        k, hw = len(ii), self.h * self.w
        target0 = coords.reshape(k, hw, 2).transpose(1, 2)
        if self.levels:
            view2 = self._dev((ii == jj) & v.stereo)
            vols = corr_ops.build_pyramid(v.fmaps[ii_t, 0],
                                          v.fmaps[jj_t, view2])
            for l, q in enumerate(vols):
                self._append(f"pyr{l}", q.to(_BF16))

        self._append("net", v.nets[ii_t])
        self._append("target", target0)
        self._append("weight", torch.zeros_like(target0))
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(k, np.int64)])

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
            for _ in range(n_iters):
                self._mesh_iteration(tabs, g0, t1 - g0, self._dev(frames),
                                     tgt_inac, wgt_inac, plan, itrs,
                                     motion_only)
        else:
            slots = torch.arange(len(ii), dtype=torch.int32,
                                 device=self.video.device)
            pre = nets.gru_context_pre(self.params, self.video.inps[ii_t])
            for _ in range(n_iters):
                eta = self._step(ii_t, jj_t, slots, ii_t - g0, t1 - g0, pre)
                v.damping[self._dev(frames)] = \
                    eta[self._dev(frames - g0)].float()
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
            self._write_disps_up(frames, upmask[self._dev(frames - g0)])

    def _write_disps_up(self, frames, upmask):
        """Full-resolution disparities of ``frames`` from their masks."""
        v = self.video
        f = self._dev(frames)
        v.disps_up[f] = nets.upsample_disp(v.disps[f], upmask)

    def _step(self, ii_t, jj_t, slots, agg_ii, nw, pre):
        """One update-operator pass over the active edges; updates net,
        target and weight, returns the per-frame damping [nw,h,w]."""
        v = self.video
        coords1, motn = motion_features(v.poses, v.disps, v.intrinsics, ii_t,
                                        jj_t, self.target)
        E, h, w = len(slots), self.h, self.w
        corr = corr_cuda.lookup_pyramid_slots(
            self.pyramid, slots, coords1.reshape(E, h * w, 2).contiguous())
        self.net, delta, weight, eta, _ = nets.update_module(
            self.params, self.net, None, corr_nchw(corr, h, w), motn,
            ii=agg_ii, num_frames=nw, pre=pre,
            fused_epilogue=self.fused_epilogue)
        self.target, self.weight = target_weight(coords1, delta, weight)
        return eta

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

    def _mesh_iteration(self, tabs, g0, nw, frames, tgt_inac, wgt_inac,
                        plan, itrs, motion_only):
        """One iteration of ``update`` with the edges sharded over the
        mesh (``parallel/frontend.py::edge_parallel_iteration``)."""
        from ..parallel import frontend as pfront
        pyr = [self._blocks(f"pyr{l}") for l in range(self.levels)]
        nets_e, tgts, wgts = pfront.edge_parallel_iteration(
            self.mesh, self.params, self.video, list(zip(*pyr)),
            self._blocks("net"), self._blocks("target"), tabs, g0, nw,
            frames, tgt_inac, wgt_inac, plan, itrs=itrs,
            motion_only=motion_only, shard_params=self.shard_params,
            fused_epilogue=self.fused_epilogue)
        self._edges.update(net=nets_e, target=tgts, weight=wgts)

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
        operator over chunks of 8 source frames with on-the-fly correlation,
        then ``itrs`` dense BA iterations over every edge with free poses
        [1, t)); ``use_inactive`` adds every stored inactive edge to the BA,
        ahead of the active ones (the asynchronous backend's persistent
        graph). Counterpart of the resident path of
        ``droid_slam_tpu/state/graph.py::update_lowmem``; the chunking bounds
        the correlation's working set. The chunk's update operator takes the
        full 320-channel context path (no precompute, no fused epilogue).
        The feature pyramid flattens the views: row n*c + k is view k of
        frame n; with ``upsample`` each chunk writes ``disps_up`` of its
        source frames from the disparities the step began with."""
        v = self.video
        t = v.counter
        c = v.fmaps.shape[1]
        ii, jj = self.ii, self.jj
        fpyr = corr_ops.build_fmap_pyramid(v.fmaps[:t].reshape(
            t * c, *v.fmaps.shape[2:]))
        rows = (self._dev(ii * c), self._dev(jj * c + (ii == jj)))
        starts = range(int(ii.min()), int(jj.max()) + 1, 8)
        chunks = [(s, np.flatnonzero((ii >= s) & (ii < s + 8)))
                  for s in starts]
        chunks = [(s, idx) for s, idx in chunks if len(idx)]
        n_inac = len(self.ii_inac) if use_inactive else 0
        if self.mesh is not None and not self.upsample:
            # chunk-parallel sweep (droid_slam_tpu/state/graph.py:1292-1336)
            self._lowmem_steps_mesh(fpyr, rows, chunks, n_inac, steps, itrs)
            v.dirty[:t] = True
            return
        plan = ba_inference.build_plan(
            np.concatenate([self.ii_inac[:n_inac], ii]),
            np.concatenate([self.jj_inac[:n_inac], jj]), 1, t, v.device)
        with self._whole():
            for _ in range(steps):
                for s, idx in chunks:
                    self._lowmem_chunk(fpyr, rows, s, idx)
                v.ba(torch.cat([self.target_inac[:n_inac], self.target]),
                     torch.cat([self.weight_inac[:n_inac], self.weight]),
                     plan, iters=itrs, lm=1e-5, ep=1e-2)
                self.age += 1
        v.dirty[:t] = True

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

    def _lowmem_steps_mesh(self, fpyr, rows, chunks, n_inac, steps, itrs):
        """Global-BA steps with the chunks split over the mesh
        (``parallel/backend.py``): each shard's chunks' edge state packed
        on its device for the run, the BA over the packed order, then the
        state written back in edge order."""
        from ..parallel import backend as pback
        v, mesh = self.video, self.mesh
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
        for _ in range(steps):
            pback.lowmem_step_mesh(
                mesh, self.shard_params, v, fpyrs, inps, shards,
                self.target_inac[:n_inac], self.weight_inac[:n_inac], plan,
                itrs)
            self.age += 1
        back = self._dev(order)
        for k, x in whole.items():
            x[back] = pmesh.gather([sh.state[k] for sh in shards], v.device)
            self._set(k, x)

    def _lowmem_chunk(self, fpyr, rows, g0, idx):
        """One update-operator pass over the edges ``idx``, whose source
        frames lie in [g0, g0+8); writes their net, target and weight, and
        the damping (and with ``upsample`` the full-resolution disparities)
        of the source frames present. ``rows``: every edge's source and
        target rows of the feature pyramid."""
        v = self.video
        sel = self._dev(idx)
        ii, jj = self.ii[idx], self.jj[idx]
        ii_t, jj_t = self._dev(ii), self._dev(jj)
        coords1, motn = motion_features(v.poses, v.disps, v.intrinsics, ii_t,
                                        jj_t, self.target[sel])
        corr = corr_ops.alt_lookup(fpyr, coords1.reshape(len(idx), -1, 2),
                                   rows[0][sel], rows[1][sel])
        net, delta, weight, eta, upmask = nets.update_module(
            self.params, self.net[sel], v.inps[ii_t],
            corr_nchw(corr, self.h, self.w), motn, ii=ii_t - g0,
            num_frames=8, compute_upmask=self.upsample)
        self.net[sel] = net
        self.target[sel], self.weight[sel] = target_weight(coords1, delta,
                                                           weight)
        frames = np.unique(ii)
        v.damping[self._dev(frames)] = eta[self._dev(frames - g0)].float()
        if self.upsample:
            self._write_disps_up(frames, upmask[self._dev(frames - g0)])

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
                              thresh=16.0, remove=False):
        """Greedy NMS edge proposal by frame distance; in stereo each frame
        of [t0, t) also gets its (i, i) edge (droid_slam_tpu/native/
        plan_builder.cpp:182-193, in the same order)."""
        t = self.video.counter
        ix, jx = np.arange(t0, t), np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            return
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
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

        for i, j in zip(np.concatenate([self.ii, self.ii_inac]).tolist(),
                        np.concatenate([self.jj, self.jj_inac]).tolist()):
            suppress(i, j)

        es = []
        for i in range(t0, t):
            if self.video.stereo:
                es.append((i, i))   # its distance is already inf: i-rad < i
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
