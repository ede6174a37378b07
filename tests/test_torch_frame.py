"""The port's frame path (slam/fused_frame.py) against JAX's, part 1.

JAX's frame path (``DROID_FUSED_FRAME=1``, ``DROID_SPEC_FRAME=0/1``, read
when its ``Droid`` is made, as tests/test_spec_frame.py sets them) and the
port's (``DroidConfig(fused_frame=True, spec_frame=...)``, run eagerly on
the CPU) track tests/test_torch_slice.py's 14 frames at 64x96 with the
trained weights. This file holds:
  * the slot pool's tables (``SlotGraph``: slots, inactive slots, the
    deferred moves and adds, ``update_tables``' BA plan and edge tables)
    against JAX's ``FactorGraph`` over one scripted run of adds, evictions
    and a keyframe removal, padding stripped;
  * ``frame_step_a`` and ``frame_step_b`` on the inputs JAX's own frame
    programs received in the middle of a run, against their outputs;
  * the bench configuration (every frame admitted and kept) end to end,
    strict-frame and speculative: equal keyframes, edges and
    mis-speculations, poses and disparities within the slice test's
    bounds;
  * the defaults (the CPU takes the strict path; edge_parallel turns the
    frame path off) and the addresses of the buffers the frame programs
    write, which must not move between frames (a captured CUDA graph
    keeps the addresses it saw).
The reject-and-drop configuration and the speculation's self-consistency
are in test_torch_frame_spec.py, stereo and RGB-D in
test_torch_frame_modes.py, so that ``--dist loadfile`` spreads them.
"""

import os

import numpy as np
import pytest
import torch

import test_torch_slice as slice_test

H, W = slice_test.H, slice_test.W
CKPT = slice_test.CKPT
RECORD_CALL = 3   # the frame-program call whose inputs the module tests use


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _need_checkpoint():
    if not os.path.exists(CKPT):
        pytest.skip(f"needs the trained checkpoint {CKPT}")


def run_jax(cfg, frames, spec, record=None, tables=None):
    """JAX's Droid on its frame path. ``frames``: (tstamp, image, depth,
    intrinsics). ``record``: a dict that receives the numpy inputs and
    outputs of the RECORD_CALL-th call of each frame program; ``tables``:
    a list that receives each frame's table vectors and sizes."""
    from droid_slam_tpu.config import DroidConfig
    from droid_slam_tpu.slam import Droid
    from droid_slam_tpu.slam import fused_frame

    os.environ["DROID_FUSED_FRAME"] = "1"
    os.environ["DROID_SPEC_FRAME"] = "1" if spec else "0"
    try:
        droid = Droid(DroidConfig(**cfg))
    finally:
        os.environ.pop("DROID_FUSED_FRAME", None)
        os.environ.pop("DROID_SPEC_FRAME", None)
    assert droid._fused_frame and droid._spec_frame == spec

    def spy(part, fn):
        calls = [0]

        def wrapped(*args):
            calls[0] += 1
            if tables is not None and part == "a":
                a = args[1:]
                tables.append(dict(
                    packed_frame=np.asarray(a[9]), packed=np.asarray(a[13]),
                    kb=a[10], pb=a[11], nw=a[14], ea=a[15], ba_shape=a[17],
                    head=[int(a[18]), 0, int(a[20]), int(a[25]),
                          int(a[28])], icap=a[5].shape[0]))
            if tables is not None and part == "b":
                tables[-1]["head"][1] = int(args[18])
            take = record is not None and calls[0] == RECORD_CALL
            if take:   # before the call: the programs donate their inputs
                import jax
                record[part + "_in"] = jax.tree_util.tree_map(
                    np.asarray, args[1:])
            out = fn(*args)
            if take:
                import jax
                record[part + "_out"] = jax.tree_util.tree_map(np.asarray,
                                                               out)
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused_frame, "frame_step_a",
                   spy("a", fused_frame.frame_step_a))
        mp.setattr(fused_frame, "frame_step_b",
                   spy("b", fused_frame.frame_step_b))
        for t, img, depth, intr in frames:
            droid.track(t, img, depth, intrinsics=intr)
        droid.flush()
    n, g, buf = droid.video.counter, droid.frontend.graph, droid.video.buf
    return dict(tstamps=np.asarray(buf.tstamp[:n]).tolist(),
                edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
                poses=np.asarray(buf.poses[:n]),
                disps=np.asarray(buf.disps[:n]),
                disps_up=np.asarray(buf.disps_up[:n]),
                mis=getattr(droid, "_spec_mis", 0))


def run_torch(cfg, frames, spec, device="cpu", each_frame=None,
              tables=None):
    """The port's Droid on its frame path; ``tables``: a list that
    receives each frame's int table vector."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(DroidConfig(**cfg, fused_frame=True, spec_frame=spec),
                  device=device)
    if tables is not None:
        run = droid.frame_programs.run

        def spy(g, key, ints, *rest):
            tables.append(ints.copy())
            return run(g, key, ints, *rest)
        droid.frame_programs.run = spy
    for t, img, depth, intr in frames:
        droid.track(t, img, depth, intr)
        if each_frame is not None:
            each_frame(droid)
    droid.flush()
    n, g, v = droid.video.counter, droid.frontend.graph, droid.video
    snap = lambda x: None if x is None else x[:n].cpu().numpy().copy()
    return dict(tstamps=v.tstamp[:n].tolist(),
                edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
                poses=snap(v.poses), disps=snap(v.disps),
                disps_up=snap(v.disps_up), mis=droid.spec_mis,
                reruns=droid.strict_reruns, droid=droid)


def mono_frames(seed=11, n=slice_test.N_FRAMES):
    from droid_slam_tpu.data.synthetic import synthetic_stream
    return [(float(t), img[0], None, intr)
            for t, img, intr in synthetic_stream(
                n_frames=n, image_size=(H, W), seed=seed, step=0.12,
                rot_step=0.04)]


def mono_cfg(name):
    return slice_test._cfg_kwargs(name, CKPT)


def assert_same_track(got, ref, name):
    """tests/test_torch_slice.py's comparison, and the same number of
    mis-speculations."""
    slice_test._assert_same_track(got, ref, name)
    assert got["mis"] == ref["mis"]


# ---------------------------------------------------------------------------
# the bench configuration, end to end (the JAX runs also record the frame
# programs' inputs for the module tests below)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_admit_all():
    _need_checkpoint()
    frames, rec, tables = mono_frames(), {}, []
    runs = {"strict_frame": run_jax(mono_cfg("admit_all"), frames, False,
                                    record=rec, tables=tables),
            "spec": run_jax(mono_cfg("admit_all"), frames, True)}
    rec["tables"] = tables
    return runs, rec


@pytest.mark.parametrize("mode", ["strict_frame", "spec"])
def test_frame_path_matches_jax(jax_admit_all, mode):
    got = run_torch(mono_cfg("admit_all"), mono_frames(), mode == "spec")
    assert_same_track(got, jax_admit_all[0][mode], "admit_all")
    assert got["mis"] == 0 and got["reruns"] == 0


def test_packed_frames_match_jax(jax_admit_all):
    """Every frame's table vector (``packed_frame``, the update tables and
    the scalars) equal to JAX's frame by frame, its sentinels mapped."""
    want = jax_admit_all[1]["tables"]
    got = []
    run_torch(mono_cfg("admit_all"), mono_frames(), False, tables=got)
    assert len(got) == len(want) > 0
    for k, (g, t) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, port_ints(t)[0],
                                      err_msg=f"frame program {k}")


# ---------------------------------------------------------------------------
# the frame programs on JAX's recorded inputs
# ---------------------------------------------------------------------------

def port_ints(t, cap=None, icap=None):
    """JAX's two table vectors of one frame (``run_jax``'s ``tables``
    entry) as the port's one: JAX's sentinels past the pools' ends become
    the pools' sentinel rows (``cap``, ``icap``: the capacities, JAX's by
    default), the padded inactive slots the store's sentinel, and the slot
    arange JAX packs goes."""
    ea, kb, nw, pb = (int(t[k]) for k in ("ea", "kb", "nw", "pb"))
    cap = ea if cap is None else cap
    icap = int(t["icap"]) if icap is None else icap
    pf = np.asarray(t["packed_frame"], np.int64)
    o = 2
    mv_src = np.minimum(pf[o:o + ea], cap); o += ea
    mv_dst = np.minimum(pf[o:o + ea], icap); o += ea
    ae = [pf[o + k * kb:o + (k + 1) * kb] for k in range(4)]; o += 4 * kb
    ae[3] = np.minimum(ae[3], cap)
    E, NW, R = (int(x) for x in t["ba_shape"][:3])
    pk = np.asarray(t["packed"], np.int64)
    n_plan = 3 * E + NW + 2 * (NW + E) + NW * R + 3
    rest = pk[n_plan + ea:]
    ib = len(rest) - 3 * ea - 5
    in_slots = rest[3 * ea:3 * ea + ib]
    # JAX pads the inactive slots with 0, the port with its sentinel; the
    # live ones are the valid BA edges ahead of the active slots
    n_live = int(pk[2 * E:2 * E + ib].sum())
    in_slots = np.where(np.arange(ib) < n_live, in_slots, icap)
    tables = np.concatenate([pk[:n_plan], rest[:3 * ea], in_slots,
                             rest[3 * ea + ib:]])
    return np.concatenate([pf[:2], t["head"], mv_src, mv_dst, *ae,
                           pf[o:], tables]).astype(np.int32), ib


def _nchw(a):
    return torch.as_tensor(np.moveaxis(np.asarray(a, np.float32), -1, -3)
                           .copy())


def _port_state(rec, params, stage):
    """A port video, SlotGraph and frame inputs holding what JAX's part
    ``stage`` ("a" or "b") received."""
    from droid_slam_tpu_torch.slam import fused_frame as ff
    from droid_slam_tpu_torch.state.graph import FactorGraph, SlotGraph
    from droid_slam_tpu_torch.state.video import DepthVideo

    a_in, b_in = rec["a_in"], rec["b_in"]
    (buf, nets_e, target, weight, pyramid, target_inac, weight_inac,
     wf_values, wf_fields, packed_frame, kb, pb, _vol, packed, nw, ea, _li,
     ba_shape, n_iters, kf_beta, do_next, damping, beta, image, prev_vec,
     spec_mode, adm, keep, lead) = a_in
    n_iters2, kf_thresh = b_in[17], b_in[18]
    kb, pb, nw, ea = int(kb), int(pb), int(nw), int(ea)
    if stage == "b":   # part A's outputs, as part B received them
        buf, pyramid, target_inac, weight_inac = b_in[0:4]
        poses, disps, damp, nets_e, target, weight, _ = b_in[4]
    else:
        poses, disps, damp = buf.poses, buf.disps, buf.damping
    B = buf.poses.shape[0]
    video = DepthVideo((H, W), B, "cpu")
    for name, x in (("tstamp", buf.tstamp), ("poses", poses),
                    ("disps", disps), ("disps_sens", buf.disps_sens),
                    ("intrinsics", buf.intrinsics), ("damping", damp)):
        getattr(video, name).copy_(torch.as_tensor(np.asarray(x)))
    for name in ("fmaps", "nets", "inps"):
        getattr(video, name).copy_(_nchw(getattr(buf, name)))
    g = SlotGraph.from_graph(
        FactorGraph(video, params, max_factors=48),
        inactive_capacity=target_inac.shape[0])
    cap = nets_e.shape[0]
    assert g.capacity == cap
    g.net_e[:cap] = _nchw(nets_e)
    g.target_e[:cap] = torch.as_tensor(target)
    g.weight_e[:cap] = torch.as_tensor(weight)
    for p, q in zip(g.pyr_e, pyramid):
        p[:cap] = torch.as_tensor(np.asarray(q, np.float32))
    g.target_inac_p[:-1] = torch.as_tensor(target_inac)
    g.weight_inac_p[:-1] = torch.as_tensor(weight_inac)

    icap = target_inac.shape[0]
    ints, ib = port_ints(dict(
        packed_frame=packed_frame, packed=packed, kb=kb, pb=pb, nw=nw,
        ea=ea, ba_shape=ba_shape, icap=icap,
        head=[n_iters, n_iters2, do_next, spec_mode, lead]))
    E, NW, RMAX = (int(x) for x in (ba_shape.edges, ba_shape.window,
                                     ba_shape.rmax))
    key = ff.FrameKey(ea=ea, ib=ib, kb=kb,
                      nw=nw, pb=pb, ba_shape=(E, NW, RMAX),
                      fields=tuple(str(f) for f in wf_fields),
                      iters1=int(n_iters),
                      iters2=int(n_iters2), upsample=False, with_volumes=True,
                      fused_epilogue=False, generation=0)
    assert float(kf_beta) == float(beta)   # the frontend's beta, both
    consts = ff.Consts(beta=float(beta),
                       motion_damping=float(damping),
                       kf_thresh=float(kf_thresh), adm_thresh=float(adm),
                       keep_thresh=float(keep))
    enc = ff.Encode(video)
    for buf_t, name in zip(enc.bufs(), ("fmaps", "nets", "inps")):
        buf_t.copy_(_nchw(wf_values[name]))
    vec = torch.zeros(2 + pb)
    vec[:len(prev_vec)] = torch.as_tensor(prev_vec)
    fvec = torch.as_tensor(np.concatenate(
        [[wf_values["tstamp"]], wf_values["intrinsics"]]).astype(np.float32))
    return g, enc, vec, torch.as_tensor(ints), fvec, \
        torch.as_tensor(np.asarray(image)), key, consts


def _gaps(got, ref):
    """The slice test's readings on one state: largest pose gap, largest
    relative gap of a frame's mean disparity, median relative disparity
    gap, least correlation of a frame's disparity field."""
    g = {"poses": got[0], "disps": got[1]}
    r = {"poses": ref[0], "disps": ref[1]}
    return slice_test._gaps(g, r)


def _assert_slice_bounds(gaps):
    assert gaps["pose"] <= 0.05
    assert gaps["mean"] <= 0.35
    assert gaps["median"] <= 0.25
    assert gaps["corr"] >= 0.5


@pytest.fixture(scope="module")
def params():
    _need_checkpoint()
    from droid_slam_tpu_torch.models import weights
    return weights.load(CKPT, "cpu")


def test_frame_step_a_matches_jax(jax_admit_all, params):
    from droid_slam_tpu_torch.slam.fused_frame import frame_step_a

    rec = jax_admit_all[1]
    g, enc, vec, ints, fvec, image, key, c = _port_state(rec, params, "a")
    (buf, _pyr, t_inac, w_inac, state, kf_dist, gmap, net1, inp1,
     out_vec) = rec["a_out"]
    v = g.video
    with torch.no_grad():
        frame_step_a(g, enc, vec, ints, fvec, image, None, key, c)
    n = int(ints[1]) + 1   # the keyframes, the one written included
    win = slice(0, n + 2)  # and the next frames' motion-model slots
    gaps = _gaps((v.poses[win].numpy(), v.disps[:n].numpy()),
                 (state[0][win], state[1][:n]))
    print("frame_step_a", gaps)
    _assert_slice_bounds(gaps)
    # the keyframe write and the moves to the inactive store are copies
    np.testing.assert_array_equal(v.tstamp.numpy(), buf.tstamp)
    np.testing.assert_array_equal(v.intrinsics.numpy(), buf.intrinsics)
    np.testing.assert_array_equal(g.target_inac_p[:-1].numpy(), t_inac)
    # the readback: kf_dist, the admission delta, the probe's distances
    got = vec.numpy()
    print("readback", np.abs(got - out_vec).max())
    np.testing.assert_allclose(got[:2], out_vec[:2], rtol=0.05)
    np.testing.assert_allclose(got[2:], out_vec[2:], rtol=0.05, atol=0.05)
    # the incoming frame's encode: bf16 rounding apart (read: 1.3% of the
    # mean magnitude, ~0.1 in single features), the same field
    got, want = enc.fmap.float().numpy(), _nchw(gmap).numpy()
    assert np.abs(got - want).mean() <= 0.03 * np.abs(want).mean()
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.999


def test_frame_step_b_matches_jax(jax_admit_all, params):
    from droid_slam_tpu_torch.slam.fused_frame import frame_step_b, spec_gate

    rec = jax_admit_all[1]
    g, _, _, ints, _, _, key, c = _port_state(rec, params, "b")
    b_in = rec["b_in"]
    buf, nets_e, target, weight = rec["b_out"]
    prev = torch.as_tensor(b_in[19])
    gate, _ = spec_gate(prev, torch.tensor(int(b_in[20])), c.adm_thresh,
                        c.keep_thresh)
    v = g.video
    with torch.no_grad():
        frame_step_b(g, ints, gate, torch.as_tensor(b_in[5]), key, c)
    n = int(ints[1]) + 1
    gaps = _gaps((v.poses[:n + 1].numpy(), v.disps[:n].numpy()),
                 (buf.poses[:n + 1], buf.disps[:n]))
    print("frame_step_b", gaps)
    _assert_slice_bounds(gaps)
    # the next frame's motion model wrote its slot
    np.testing.assert_allclose(v.poses[n].numpy(), buf.poses[n], atol=0.05)


# ---------------------------------------------------------------------------
# the slot pool's tables against JAX's FactorGraph
# ---------------------------------------------------------------------------

def _graphs(t=10, h=8, w=12):
    """JAX's FactorGraph and the port's SlotGraph over equal random videos
    of t frames, the JAX one compacted to the port's capacity."""
    from droid_slam_tpu.state.graph import FactorGraph as JGraph
    from droid_slam_tpu.state.video import DepthVideo as JVideo
    from droid_slam_tpu_torch.state.graph import FactorGraph, SlotGraph
    from droid_slam_tpu_torch.state.video import DepthVideo

    jv = JVideo((8 * h, 8 * w), buffer=16)
    tv = DepthVideo((8 * h, 8 * w), 16, "cpu")
    jv.counter = tv.counter = t
    jg = JGraph(jv, params={}, max_factors=12, ba_inactive_bucket=16)
    jg.compact()
    tg = SlotGraph.from_graph(FactorGraph(tv, {}, max_factors=12),
                              inactive_capacity=jg.target_inac.shape[0],
                              ba_inactive_bucket=16)
    return jg, tg


def _split_jax_tables(tb):
    """JAX's packed update tables as the port packs them (without the slot
    arange), with the inactive slots' padding stripped."""
    E, NW, R = tb["ba_shape"].edges, tb["ba_shape"].window, \
        tb["ba_shape"].rmax
    pk = np.asarray(tb["packed"], np.int64)
    n_plan = 3 * E + NW + 2 * (NW + E) + NW * R + 3
    return np.concatenate([pk[:n_plan], pk[n_plan + tb["EA"]:]]), n_plan


def test_slot_tables_match_jax():
    """Adds, evictions to the inactive store (deferred), a keyframe
    removal, then a deferred frame's tables: every table equal to JAX's
    once the sentinels of the padding are stripped."""
    jg, tg = _graphs()
    for g in (jg, tg):
        ii, jj = np.meshgrid(np.arange(10), np.arange(10), indexing="ij")
        keep = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 2) & \
            (ii >= 3) & (jj >= 3)
        g.add_factors(ii[keep][:12], jj[keep][:12])
        g.rm_factors(g.ii < 5, store=True)
        g.rm_keyframe(4)
    for name in ("ii", "jj", "age", "ii_inac", "jj_inac", "inac_slots"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name),
                                      err_msg=name)
    np.testing.assert_array_equal(tg.slots, jg._slots())
    assert tg.free == jg.free and tg.inac_free == jg.inac_free

    tabs = {}
    for name, g in (("jax", jg), ("port", tg)):
        g.defer = True
        g.bump_age(5)
        g.rm_factors(np.asarray(g.ii) == max(g.ii), store=True)
        g.add_factors([5, 6, 6, 7, 7, 8, 8, 9, 9, 5, 7, 9],
                      [6, 5, 7, 6, 8, 7, 9, 8, 7, 7, 5, 5], remove=True)
        tb = g.update_tables(None, None, use_inactive=True, kf_pair=(5, 7),
                             next_state_t1=9, sens_frame=8) \
            if name == "jax" else g.update_tables(
                use_inactive=True, kf_pair=(5, 7), next_state_t1=9,
                sens_frame=8)
        tabs[name] = (tb, g.drain_deferred())
        g.defer = False
    (jt, jd), (tt, td) = tabs["jax"], tabs["port"]
    assert tuple(jt["ba_shape"][:3]) == tuple(tt["ba_shape"])
    assert (jt["nw"], jt["EA"], jt["g0"]) == (tt["nw"], tt["EA"], tt["g0"])
    want, n_plan = _split_jax_tables(jt)
    got = tt["packed"].astype(np.int64)
    np.testing.assert_array_equal(got[:n_plan], want[:n_plan])  # BA plan
    ea, ib = tt["EA"], tt["IB"]
    np.testing.assert_array_equal(got[n_plan:n_plan + 3 * ea],
                                  want[n_plan:n_plan + 3 * ea])  # ii, jj, v
    t0 = max(1, int(tg.ii.min()) + 1)
    n_in = int(((tg.ii_inac >= t0 - 3) & (tg.jj_inac >= t0 - 3)).sum())
    assert n_in > 0
    live = lambda x: x[n_plan + 3 * ea:n_plan + 3 * ea + n_in]
    np.testing.assert_array_equal(live(got), live(want))  # inactive slots
    np.testing.assert_array_equal(got[-5:], want[-5:])  # kf, g0, ns, sens
    # the deferred moves and adds, padding stripped
    n_mv = int((jd[0] < jg.capacity).sum())
    assert n_mv > 0
    for k in (0, 1):
        np.testing.assert_array_equal(td[k][:n_mv], jd[k][:n_mv])
    n_add = int((jd[5] < jg.capacity).sum())
    assert n_add > 0
    for k in (2, 3, 4, 5):
        np.testing.assert_array_equal(td[k][:n_add], jd[k][:n_add])
    assert len(td[2]) == len(jd[2])   # the same sticky add bucket


# ---------------------------------------------------------------------------
# defaults and addresses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags, fused, spec", [
    ({}, False, False),                                  # the CPU: strict
    ({"fused_frame": True}, True, False),                # JAX's CPU rule
    ({"fused_frame": True, "spec_frame": True}, True, True),
    ({"spec_frame": True}, False, False),                # spec needs fused
    ({"fused_frame": True, "spec_frame": True, "edge_parallel": 2},
     False, False),
])
def test_frame_path_defaults(flags, fused, spec):
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    kw = dict(image_size=(H, W), buffer=8)
    edge = {"edge_devices": ["cpu", "cpu"]} if flags.get("edge_parallel") \
        else {}
    droid = Droid(DroidConfig(**kw, **flags), device="cpu", **edge)
    assert (droid._fused_frame, droid._spec_frame) == (fused, spec)
    assert (droid.frame_programs is None) == (not fused)
    if fused:
        assert not droid.frame_programs.graphs   # the CPU runs them eagerly


@pytest.mark.parametrize("flags, fused, spec", [
    ({}, True, False),                  # the frame programs, no speculation
    ({"spec_frame": True}, True, True),
    ({"fused_frame": False}, False, False),
    ({"fused_frame": False, "spec_frame": True}, False, False),
    ({"spec_frame": True, "edge_parallel": 2}, False, False),
])
def test_frame_path_rule_on_cuda(flags, fused, spec):
    """The rule a tracker on CUDA takes (``slam/droid.py::frame_path``; no
    card needed to read it): the frame programs unless turned off,
    speculation only when asked for."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import frame_path

    cfg = DroidConfig(image_size=(H, W), buffer=8, **flags)
    assert frame_path(cfg, "cuda") == (fused, spec)
    assert frame_path(cfg, torch.device("cuda", 0)) == (fused, spec)


def test_frame_path_buffers_keep_their_addresses():
    """Across the 11 frame-path frames of a 20-frame run, the video's
    buffers, the slot pools and the frame programs' encode buffers stay
    where they were: the programs write them in place. The readback vector
    is reallocated only when the probe's sticky pair bucket grows, a new
    key, whose graphs are captured anew."""
    _need_checkpoint()
    seen = []

    def addresses(droid):
        from droid_slam_tpu_torch.state.graph import SlotGraph
        g = droid.frontend.graph
        if not isinstance(g, SlotGraph):
            return
        v, fp = droid.video, droid.frame_programs
        seen.append(([x.data_ptr() for x in
                      [getattr(v, n) for n in v._FIELDS
                       if getattr(v, n) is not None]
                      + g.pool_tensors() + fp.enc.bufs() + fp.enc.prev],
                     fp.vec.data_ptr(), fp.vec.shape[0], len(fp.cache)))

    run_torch(mono_cfg("admit_all"), mono_frames(n=20), True,
              each_frame=addresses)
    assert len(seen) >= 10
    assert all(s[0] == seen[0][0] for s in seen), "a buffer moved"
    for a, b in zip(seen, seen[1:]):
        assert (a[1] == b[1]) == (a[2] == b[2])


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_cuda():
    """The frame programs replayed as CUDA graphs against the same
    programs run eagerly on the card, with deterministic kernels: equal
    keyframes and edges, poses and disparities bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    _need_checkpoint()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    frames = mono_frames()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for graphs in (True, False):
            def pick(droid, graphs=graphs):
                droid.frame_programs.graphs = graphs
            from droid_slam_tpu_torch.config import DroidConfig
            from droid_slam_tpu_torch.slam.droid import Droid
            droid = Droid(DroidConfig(**mono_cfg("admit_all"),
                                      fused_frame=True, spec_frame=True),
                          device="cuda")
            pick(droid)
            for t, img, depth, intr in frames:
                droid.track(t, img, depth, intr)
            droid.flush()
            n, g = droid.video.counter, droid.frontend.graph
            runs.append((sorted(zip(g.ii.tolist(), g.jj.tolist())), n,
                         droid.video.poses[:n].cpu(),
                         droid.video.disps[:n].cpu(),
                         droid.frame_programs.replays))
    finally:
        torch.use_deterministic_algorithms(False)
    (e1, n1, p1, d1, r1), (e2, n2, p2, d2, r2) = runs
    assert r1 > 0 and r2 == 0
    assert (e1, n1) == (e2, n2)
    assert torch.equal(p1, p2) and torch.equal(d1, d2)
