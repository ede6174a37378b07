"""The tracker's steady-state frame as two programs, and their replay.

Counterpart of ``droid_slam_tpu/slam/fused_frame.py``. Each steady-state
frame runs as two parts, built from tables the host made from the previous
frame's readback:

  part A (``frame_step_a``): the previous frame's keyframe write -> the
    queued moves of evicted edges to the inactive store -> the new edges ->
    ``iters1`` x (update operator + BA) -> the keyframe distance (after
    iters1, where the reference reads it) -> the proximity probe's
    distances, on the state with the next frames' motion model applied
    hypothetically -> the incoming frame's encode and admission delta. It
    leaves one readback vector [kf_dist, delta, distances...].
  part B (``frame_step_b``): ``iters2`` more iterations when the keyframe
    stays -> the full-resolution disparities (``upsample``) -> the next
    frame's motion model.

The host copies A's vector back while B runs. Under speculative dispatch
(``slam/droid.py``) a frame's parts are issued before the previous frame's
vector is read: every write of both parts is gated on the device by that
vector (``spec_gate``), and the host unwinds its bookkeeping when the guess
was wrong.

On CUDA each part of each key (``FrameKey``: the sticky sizes of the
tables, the iteration counts and the options) is captured once as a
``torch.cuda.CUDAGraph``, after this frame ran eagerly on a side stream as
the capture's warm-up; later frames of the key copy their inputs into the
graphs' static inputs (one int32 table vector, one f32 vector, the image,
with RGB-D the sensor disparities) and replay the two graphs. All graphs
share one memory pool. A graph has a fixed launch sequence, so the
iteration counts JAX sets on the device become ``iters1`` / ``iters2``
captured iterations whose writes are gated: a dropped keyframe's ``iters2``
and a mis-speculated frame's whole work run and are discarded. A capture
or a replay that fails raises: on CUDA no frame silently runs another way.
A graph replay makes no Python call, so each replay adds to the kernels'
launch counts (``ops/corr_cuda.py``, ``ops/gru_cuda.py``) the launches its
capture recorded. On the CPU the same functions run eagerly.

The int table vector (static offsets; the sizes are the key's):
  [wf_index, kf_index, n_iters, n_iters2, do_next_state, spec_mode,
   probe_lead, mv_src[ea], mv_dst[ea], ae_ii[kb], ae_jj[kb], ae_c[kb],
   ae_slots[kb], up_dst[nw], pair_ii[pb], pair_jj[pb],
   the update tables (``SlotGraph.update_tables``)]
The f32 vector: [tstamp, the keyframe's intrinsics (4)].
"""

from __future__ import annotations

import gc
import time
from typing import NamedTuple

import numpy as np
import torch

from ..geom import distance as gdist
from ..ops import corr_cuda, gru_cuda
from ..state.graph import (FrameTables, add_edges, move_rows,
                           next_state_pose_disp, _row_put, row,
                           update_part_a, update_part_b)
from ..state.video import write_frame
from ..utils import trace
from .motion_filter import encode_delta

HEAD = ("wf_index", "kf_index", "n_iters", "n_iters2", "do_next_state",
        "spec_mode", "probe_lead")
# the keyframe fields a frame program writes (the motion model has already
# written the pose and the disparity)
FIELDS = {"tstamp", "intrinsics", "disps_sens", "fmaps", "nets", "inps"}


class FrameKey(NamedTuple):
    """What a captured pair of graphs is specialised to."""
    ea: int            # active slots (the pool's capacity)
    ib: int            # inactive BA edges (bucket)
    kb: int            # new edges (bucket)
    nw: int            # aggregation window (bucket)
    pb: int            # probe pairs (bucket)
    ba_shape: tuple    # the padded BA's (edges, window, rmax)
    fields: tuple      # the keyframe write's fields
    iters1: int
    iters2: int
    upsample: bool
    with_volumes: bool
    fused_epilogue: bool
    generation: int    # the pool's allocation


class Consts(NamedTuple):
    """The tracker's thresholds and factors, fixed for its lifetime."""
    beta: float        # of the keyframe and the proximity distances
    motion_damping: float
    kf_thresh: float
    adm_thresh: float
    keep_thresh: float


def _taker(vec):
    off = [0]

    def take(n):
        a = vec[off[0]:off[0] + n]
        off[0] += n
        return a
    return take


def unpack_frame(ivec, key: FrameKey):
    """The int table vector's entries (0-d or 1-d long tensors) and the
    update tables."""
    take = _taker(ivec)
    t = {name: take(1).long()[0] for name in HEAD}
    for name, n in (("mv_src", key.ea), ("mv_dst", key.ea),
                    ("ae_ii", key.kb), ("ae_jj", key.kb), ("ae_c", key.kb),
                    ("ae_slots", key.kb), ("up_dst", key.nw),
                    ("pair_ii", key.pb), ("pair_jj", key.pb)):
        t[name] = take(n).long()
    return t, FrameTables(take, key.ba_shape, key.ea, key.ib)


def spec_gate(vec, spec_mode, adm_thresh, keep_thresh):
    """The speculation gates from the previous part A's vector, still on
    the device (droid_slam_tpu/slam/fused_frame.py:82-96): spec_mode bit 0
    makes the admission gate live, bit 1 the keep gate; 0 forces both
    true. Returns (g, g_admit): g gates every write of this frame."""
    g_admit = ((spec_mode & 1) == 0) | (vec[1] > adm_thresh)
    g_keep = ((spec_mode & 2) == 0) | (vec[0] >= keep_thresh)
    return g_admit & g_keep, g_admit


class Encode:
    """The encode of the frame in flight, in fixed buffers: part A writes
    the incoming frame's here, after the keyframe write read the previous
    one (``prev`` keeps that one for a re-run)."""

    def __init__(self, video):
        c = 2 if video.stereo else 1
        z = lambda *s: torch.zeros(s, dtype=torch.bfloat16,
                                   device=video.device)
        h, w = video.h, video.w
        self.fmap, self.net, self.inp = z(c, 128, h, w), z(128, h, w), \
            z(128, h, w)
        self.prev = [z(c, 128, h, w), z(128, h, w), z(128, h, w)]

    def bufs(self):
        return [self.fmap, self.net, self.inp]


def frame_step_a(g, enc, vec, ivec, fvec, image, sens, key: FrameKey,
                 c: Consts):
    """Part A (droid_slam_tpu/slam/fused_frame.py:98-183) on the graph
    ``g`` (a ``SlotGraph``) and its video, in place. ``vec`` [2+pb]: the
    previous part A's readback on input, this one's on output. Returns the
    gate and kf_dist for part B."""
    v = g.video
    t, tabs = unpack_frame(ivec, key)
    gate, g_admit = spec_gate(vec, t["spec_mode"], c.adm_thresh,
                              c.keep_thresh)
    wf = torch.where(gate, t["wf_index"], v.buffer + 1)
    mv_dst = torch.where(gate, t["mv_dst"], g.inactive_capacity)
    ae_slots = torch.where(gate, t["ae_slots"], g.capacity)
    n_iters = torch.where(gate, t["n_iters"], 0)
    do_next = torch.where(gate, t["do_next_state"], 0)
    # after a rejected previous frame the last keyframe is one earlier
    kf_index = torch.where(g_admit, t["kf_index"],
                           (t["kf_index"] - 1).clamp(min=0))

    for p, b in zip(enc.prev, enc.bufs()):
        p.copy_(b)
    values = dict(tstamp=fvec[0], intrinsics=fvec[1:5], disps_sens=sens,
                  fmaps=enc.fmap, nets=enc.net, inps=enc.inp)
    write_frame(v, wf, values, key.fields)
    move_rows(g, t["mv_src"], mv_dst)
    add_edges(g, t["ae_ii"], t["ae_jj"], t["ae_c"], ae_slots)
    kf_dist = update_part_a(g, tabs, key.nw, key.ba_shape, key.iters1,
                            n_iters, gate, c.beta)

    # the proximity probe on the post-iters1 state, with the next frame's
    # (and under speculation the one after's) motion model applied to a
    # copy of the poses
    ns = tabs.ns_t1
    on = do_next > 0
    poses_p, disps_p = v.poses.clone(), v.disps.clone()
    for k, on_k in ((0, on), (1, on & (t["probe_lead"] > 1))):
        pose, disp = next_state_pose_disp(poses_p, disps_p, ns + k,
                                          c.motion_damping)
        _row_put(poses_p, ns + k, pose, on_k)
        _row_put(disps_p, ns + k, disp.expand(disps_p.shape[1:]), on_k)
    d = gdist.frame_distance(poses_p, disps_p, v.intrinsics[0],
                             t["pair_ii"], t["pair_jj"], c.beta)

    fmap, net, inp, delta = encode_delta(
        g.params, image, row(v.fmaps, kf_index), row(v.nets, kf_index),
        row(v.inps, kf_index))
    for b, x in zip(enc.bufs(), (fmap, net, inp)):
        b.copy_(x)
    vec.copy_(torch.cat([kf_dist[None], delta[None], d]))
    return gate, kf_dist


def frame_step_b(g, ivec, gate, kf_dist, key: FrameKey, c: Consts):
    """Part B (droid_slam_tpu/slam/fused_frame.py:185-215), gated as part
    A was."""
    t, tabs = unpack_frame(ivec, key)
    update_part_b(g, tabs, key.nw, key.ba_shape, key.iters2,
                  torch.where(gate, t["n_iters2"], 0),
                  kf_dist >= 2.0 * c.kf_thresh,
                  torch.where(gate, t["do_next_state"], 0),
                  c.motion_damping,
                  torch.where(gate, t["up_dst"], g.video.buffer + 1))


def update_step(frontend, tb):
    """An update of the frame path outside a frame program (the tracker's
    flush; droid_slam_tpu/state/graph.py::dispatch_update): both halves,
    eagerly, from tables whose moves and adds already ran. Returns the
    keyframe distance (device)."""
    g = frontend.graph
    dev = g.video.device
    take = _taker(torch.as_tensor(tb["packed"], device=dev))
    tabs = FrameTables(take, tb["ba_shape"], tb["EA"], tb["IB"])
    one = torch.ones((), dtype=torch.bool, device=dev)
    n1 = torch.tensor(frontend.iters1, device=dev)
    kf = update_part_a(g, tabs, tb["nw"], tb["ba_shape"], frontend.iters1,
                       n1, one, frontend.beta)
    up = torch.as_tensor(g.up_dst_table(tb), device=dev)
    update_part_b(g, tabs, tb["nw"], tb["ba_shape"], frontend.iters2,
                  torch.tensor(frontend.iters2, device=dev),
                  kf >= 2.0 * frontend.keyframe_thresh, one,
                  frontend.motion_damping, up)
    g.bump_age(frontend.iters1)
    return kf


def _counts():
    return [corr_cuda.LAUNCHES, gru_cuda.LAUNCHES_A, gru_cuda.LAUNCHES_B]


def _add_counts(d):
    corr_cuda.LAUNCHES += d[0]
    gru_cuda.LAUNCHES_A += d[1]
    gru_cuda.LAUNCHES_B += d[2]


class Readback:
    """Part A's vector on its way to the host: a pinned copy and the event
    that ends it (CUDA), or the vector itself (CPU)."""

    def __init__(self, vec):
        self.event = None
        if vec.device.type == "cuda":
            self.host = torch.empty(vec.shape, dtype=vec.dtype,
                                    pin_memory=True)
            self.host.copy_(vec, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vec.clone()

    def numpy(self):
        with trace.span("readback_wait"):
            if self.event is not None:
                self.event.synchronize()
        return self.host.numpy()


class _Captured:
    """A key's static inputs and its two graphs."""

    def __init__(self, ivec, fvec, image, sens):
        self.ivec, self.fvec, self.image, self.sens = ivec, fvec, image, sens
        self.a = torch.cuda.CUDAGraph()
        self.b = torch.cuda.CUDAGraph()
        self.launches_a = self.launches_b = (0, 0, 0)
        self.out = None


class FramePrograms:
    """Runs the frame programs of one tracker: on CUDA, by default, as
    replays of graphs captured per ``FrameKey``; with ``graphs`` False (the
    CPU, or an eager reference run on the card) as plain calls.

    Counters: ``captures`` (pairs of graphs), ``capture_s`` (wall seconds
    of the warm-up runs and captures), ``pool_bytes`` (device memory the
    captures reserved: the shared pool), ``replays`` (frames replayed),
    ``eager`` (frames run as plain calls), ``replayed_launches`` (the
    kernels' launches made by replays), ``capture_at`` (the frames that
    captured, counted from the first frame of the path).

    Spans: ``droid:dispatch`` (a frame: uploads and replays, or the eager
    run) and ``droid:capture`` (warm-up and capture; ``why``: a new key,
    a new pool generation, or a larger probe bucket)."""

    def __init__(self, video, consts: Consts, graphs=None):
        self.video = video
        self.consts = consts
        self.cuda = video.device.type == "cuda"
        self.graphs = self.cuda if graphs is None else graphs
        if self.graphs and not self.cuda:
            raise ValueError("CUDA graphs need the video on CUDA")
        self.enc = Encode(video)
        self.vec = torch.zeros(2, device=video.device)
        self.cache = {}
        self.pool = None
        self.captures = self.replays = self.eager = 0
        self.replayed_launches = [0, 0, 0]   # as _counts(), by replays
        self.capture_at = []   # the frames (counted from 0) that captured
        # "warn" or "error": every eager frame program and capture runs under
        # torch.cuda.set_sync_debug_mode, so a hidden host sync shows where
        self.sync_debug = None
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._bucket_grew = False   # _vec_for dropped the graphs

    def _vec_for(self, pb):
        """The readback vector for ``pb`` probe pairs; its gate entries
        carry over when the (sticky) bucket grows, and the graphs that read
        the old vector go."""
        if self.vec.shape[0] != 2 + pb:
            vec = torch.zeros(2 + pb, device=self.video.device)
            vec[:2] = self.vec[:2]
            self.vec = vec
            self._bucket_grew = bool(self.cache)
            self._drop(lambda k: True)
        return self.vec

    def _drop(self, dead):
        """Drop the graphs whose key is ``dead``; the pool goes with the
        last graph that holds it (a released pool cannot be captured into
        again)."""
        for k in [k for k in self.cache if dead(k)]:
            del self.cache[k]
        if not self.cache:
            self.pool = None

    def run(self, g, key: FrameKey, ints, floats, image, sens):
        """One frame: part A, its readback, part B. ``ints``/``floats``:
        the host vectors; ``image`` [c,H,W,3] uint8 and ``sens`` [h,w]
        (or None) numpy. Returns the ``Readback``."""
        with trace.span("dispatch"):
            return self._run(g, key, ints, floats, image, sens)

    def _run(self, g, key, ints, floats, image, sens):
        vec = self._vec_for(key.pb)
        if not self.graphs:
            dev = self.video.device
            to = lambda a: None if a is None else torch.as_tensor(a,
                                                                  device=dev)
            args = (to(ints), to(floats), to(image), to(sens))
            self.eager += 1
            with _sync_debug(self.sync_debug):
                gate, kf = frame_step_a(g, self.enc, vec, *args, key,
                                        self.consts)
                out = Readback(vec)
                frame_step_b(g, args[0], gate, kf, key, self.consts)
            return out
        cap = self.cache.get(key)
        if cap is None:
            with trace.span("capture", {"why": self._why(key)}):
                return self._capture(g, key, ints, floats, image, sens)
        self._upload(cap, ints, floats, image, sens)
        cap.a.replay()
        out = Readback(vec)
        cap.b.replay()
        for d in (cap.launches_a, cap.launches_b):
            _add_counts(d)
            self.replayed_launches = [x + y for x, y in
                                      zip(self.replayed_launches, d)]
        self.replays += 1
        return out

    def _why(self, key):
        """Why ``key`` captures: "probe_bucket" (``_vec_for`` dropped
        every graph), "generation" (the pools grew since the graphs held
        were captured) or "new_key"."""
        grew, self._bucket_grew = self._bucket_grew, False
        if grew:
            return "probe_bucket"
        if any(k.generation != key.generation for k in self.cache):
            return "generation"
        return "new_key"

    @staticmethod
    def _upload(cap, ints, floats, image, sens):
        for dst, a in ((cap.ivec, ints), (cap.fvec, floats),
                       (cap.image, image), (cap.sens, sens)):
            if dst is not None:
                dst.copy_(torch.from_numpy(np.ascontiguousarray(a))
                          .pin_memory(), non_blocking=True)

    def _capture(self, g, key, ints, floats, image, sens):
        """This frame as the warm-up (eagerly, on a side stream), then the
        capture of both parts into the shared pool."""
        dev = self.video.device
        # graphs of an earlier pool allocation read buffers that are gone
        self._drop(lambda k: k.generation != key.generation)
        empty = lambda a, dt: None if a is None else torch.empty(
            a.shape, dtype=dt, device=dev)
        cap = _Captured(empty(ints, torch.int32), empty(floats, torch.float32),
                        empty(image, torch.uint8), empty(sens, torch.float32))
        self._upload(cap, ints, floats, image, sens)
        tic = time.perf_counter()
        vec, c = self.vec, self.consts
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side), _sync_debug(self.sync_debug):
            gate, kf = frame_step_a(g, self.enc, vec, cap.ivec, cap.fvec,
                                    cap.image, cap.sens, key, c)
            out = Readback(vec)
            frame_step_b(g, cap.ivec, gate, kf, key, c)
        cur.wait_stream(side)
        self.eager += 1

        torch.cuda.synchronize(dev)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        before = _counts()
        with torch.cuda.device(dev), _sync_debug(self.sync_debug):
            with torch.cuda.graph(cap.a, pool=self.pool,
                                  capture_error_mode="thread_local"):
                cap.out = frame_step_a(g, self.enc, vec, cap.ivec, cap.fvec,
                                       cap.image, cap.sens, key, c)
            mid = _counts()
            with torch.cuda.graph(cap.b, pool=self.pool,
                                  capture_error_mode="thread_local"):
                frame_step_b(g, cap.ivec, *cap.out, key, c)
        after = _counts()
        # a capture records launches without making them
        _add_counts([b - a for a, b in zip(after, before)])
        cap.launches_a = tuple(m - b for m, b in zip(mid, before))
        cap.launches_b = tuple(a - m for a, m in zip(after, mid))
        self.pool_bytes += torch.cuda.memory_reserved(dev) - reserved
        self.capture_s += time.perf_counter() - tic
        self.capture_at.append(self.replays + self.eager - 1)
        self.captures += 1
        self.cache[key] = cap
        return out


class _sync_debug:
    """torch.cuda.set_sync_debug_mode(mode) inside, when a mode is given."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.old = None
        if self.mode is not None and torch.cuda.is_available():
            self.old = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.mode)

    def __exit__(self, *exc):
        if self.old is not None:
            torch.cuda.set_sync_debug_mode(self.old)
