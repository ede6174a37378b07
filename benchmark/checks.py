"""The comparison that decides ``correct``: what the timed window produced,
against the plain reference (``reference/``) computed afterwards on the
same inputs, in float32 networks and float64 geometry with TF32 off.

Each compared number is a gap between the program's output and the
reference's; ``limits/<workload>.json`` holds its limit. The control is the
reference put in the program's place in the precision just below the
configuration's (float8 networks for its bfloat16 ones, TF32 for its
float32 geometry, elementwise work included): its gaps are computed the
same way, on request."""

from __future__ import annotations

import contextlib

from benchmark import harness
from benchmark.reference import backend as rback
from benchmark.reference import droidnet
from benchmark.reference import tracking as rtrack


def _round_tf32(x):
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest."""
    import torch
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_mode():
    """A torch function mode that rounds every new float32 tensor an
    operation returns to TF32: float32 arithmetic computed in TF32. Views
    and in-place results are left as they are."""
    import torch
    from torch.overrides import TorchFunctionMode

    class TF32Arithmetic(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (isinstance(out, torch.Tensor)
                    and out.dtype == torch.float32 and out._base is None
                    and not any(out is a for a in args)):
                return _round_tf32(out)
            return out
    return TF32Arithmetic()


@contextlib.contextmanager
def tf32(on):
    """With ``on``, float32 work in TF32: matrix products and convolutions
    by the TF32 modes, every other result rounded (``_tf32_mode``)."""
    import torch
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    old = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = on
    try:
        with (_tf32_mode() if on else contextlib.nullcontext()):
            yield
    finally:
        for f, o in zip(flags, old):
            f.allow_tf32 = o


def _gap(x, ref, base=None):
    """|x - ref| / |ref - base| (|ref| without a base), as float64."""
    num, den = _gap_parts(x, ref, base)
    return (num / max(den, 1e-60)) ** 0.5


def _gap_parts(x, ref, base=None):
    """(|x - ref|^2, |ref - base|^2), as float64."""
    x, ref = x.double(), ref.double()
    d = ref if base is None else ref - base.double()
    return float(((x - ref) ** 2).sum()), float((d ** 2).sum())


# the reference's and the control's settings: (float8 networks, geometry
# dtype, TF32)
def _sides(control):
    import torch
    sides = [("reference", False, torch.float64, False)]
    if control:
        sides.append(("control", True, torch.float32, True))
    return sides


def tracking(cell, data, images, intr, device, control=False):
    """Readings of the tracking cells (and the control's, with
    ``control``): ``encode_gap`` (the worst keyframe row written in the
    window against the encoders), ``delta_gap_px`` (the worst admission
    delta), and over the sampled updates ``update_pose_gap``,
    ``update_disp_gap`` (the window's poses and disparities after each
    update against the reference's, relative to the reference's change of
    them, both summed over the updates: one update's change can be small,
    but a fault in any update counts) and the worst ``kf_dist_gap``."""
    import torch
    p = droidnet.load_params(harness.weights_path(cell.config), device)
    image = lambda k: torch.as_tensor(images[int(k)], device=device)
    cfg = cell.config
    keep = 2.0 * cfg["keyframe_thresh"]
    out = {"program": {}, "control": {}}

    gaps = {"program": {}, "control": {}}

    def worst(side, name, v):
        out[side][name] = max(out[side].get(name, 0.0), v)

    with torch.no_grad():
        for w in data["written"]:
            with tf32(False):
                ref = droidnet.encode(p, image(w["tstamp"])[None])
            prog = (w["fmap"], w["net"], w["inp"])
            worst("program", "encode_gap",
                  max(_gap(a, b[0]) for a, b in zip(prog, ref)))
            if control:
                with tf32(True):
                    low = droidnet.encode(p, image(w["tstamp"])[None], True)
                worst("control", "encode_gap",
                      max(_gap(a[0], b[0]) for a, b in zip(low, ref)))

        for k, a, d_prog in data["deltas"]:
            with tf32(False):
                ref = float(rtrack.admission_delta(p, image(a), image(k)))
            worst("program", "delta_gap_px", abs(d_prog - ref))
            if control:
                with tf32(True):
                    low = float(rtrack.admission_delta(p, image(a), image(k),
                                                       True))
                worst("control", "delta_gap_px", abs(low - ref))

        for s in data["samples"]:
            res = {}
            for side, low, dt, t32 in _sides(control):
                st = _state(s, dt, device)
                st["keep"] = s["kf_dist"] >= keep
                with tf32(t32):
                    res[side] = rtrack.frame_update(
                        p, st, lambda r: image(s["tstamp"][r]),
                        torch.tensor(intr / 8.0, dtype=dt, device=device),
                        cfg["beta"], cfg["motion_damping"], low=low)
            P, D, kf = res["reference"]
            outs = {"program": (s["post_poses"], s["post_disps"],
                                  s["kf_dist"])}
            if control:
                outs["control"] = res["control"]
            for side, (Px, Dx, kfx) in outs.items():
                g = gaps[side]
                for k, x, ref, base in (("pose", Px, P, s["poses"]),
                                        ("disp", Dx, D, s["disps"])):
                    num, den = _gap_parts(x, ref, base)
                    a, b = g.get(k, (0.0, 0.0))
                    g[k] = (a + num, b + den)
                worst(side, "kf_dist_gap",
                      abs(float(kfx) - float(kf)) / max(float(kf), 1e-9))
    if not data["samples"]:
        raise RuntimeError("no update frame was sampled in the window")
    for side, g in gaps.items():
        for k, (num, den) in g.items():
            out[side][f"update_{k}_gap"] = (num / max(den, 1e-60)) ** 0.5
    return out["program"], (out["control"] if control else None)


def _state(s, dt, device):
    """A snapshot's tensors for the reference: geometry in ``dt``, index
    arrays as device tensors."""
    import torch
    st = dict(s)
    for k in ("poses", "disps", "damping"):
        st[k] = s[k].to(dt)
    for k in ("ii", "jj", "ii_in", "jj_in"):
        st[k] = torch.as_tensor(s[k], dtype=torch.long, device=device)
    st["new"] = torch.as_tensor(s["new"], device=device)
    return st


def global_ba(cell, data, inputs, device, control=False):
    """Readings of the global-BA cell: ``proposal_dist_gap`` (the 99th
    percentile over the pairs within 100 px of the pass's frame distances'
    gaps, relative to the distance or to 1 px below 1 px: the few pairs in
    which a pixel's depth test flips with the rounding leave it alone),
    ``proposal_edges_differ`` (the program's edges against the reference's
    suppression on the program's distances), and ``gba_pose_gap``,
    ``gba_disp_gap`` (the pass's poses and disparities, relative to the
    reference's change)."""
    import torch
    p = droidnet.load_params(harness.weights_path(cell.config), device)
    cfg, tr = cell.config, cell.traffic
    t = data["t"]
    out = {"program": {}, "control": {}}
    d_prog = data["dist"].double()
    with torch.no_grad():
        for side, low, dt, t32 in _sides(control):
            intr = inputs["intrinsics"].to(dt)
            pre_p, pre_d = data["pre_poses"].to(dt), data["pre_disps"].to(dt)
            with tf32(t32):
                d = rback.distances(pre_p, pre_d, intr, t, cfg["beta"])
            if side == "reference":
                d_ref = d.double()
                out["program"]["proposal_dist_gap"] = _dist_gap(d_prog,
                                                                d_ref)
                want = rback.propose(d_prog.cpu().numpy(), t,
                                     cfg["backend_radius"],
                                     cfg["backend_nms"],
                                     cfg["backend_thresh"], 16 * t)
                got = set(map(tuple, data["edges"].tolist()))
                out["program"]["proposal_edges_differ"] = float(
                    len(got ^ set(map(tuple, want.tolist()))))
            else:
                out[side]["proposal_dist_gap"] = _dist_gap(d.double(),
                                                           d_ref)
                out[side]["proposal_edges_differ"] = 0.0
            ii = torch.as_tensor(data["edges"][:, 0], device=device)
            jj = torch.as_tensor(data["edges"][:, 1], device=device)
            with tf32(t32):
                P, D = rback.global_ba(
                    p, pre_p, pre_d, data["pre_damping"].to(dt),
                    inputs["fmaps"][:, 0], inputs["nets"], inputs["inps"],
                    intr, ii, jj, steps=tr["steps_per_pass"], low=low)
            if side == "reference":
                ref = (P, D)
                progs = {"program": (data["post_poses"],
                                       data["post_disps"])}
            else:
                progs = {"control": (P, D)}
            for name, (Px, Dx) in progs.items():
                out[name]["gba_pose_gap"] = _gap(Px, ref[0],
                                                 data["pre_poses"])
                out[name]["gba_disp_gap"] = _gap(Dx, ref[1],
                                                 data["pre_disps"])
    return out["program"], (out["control"] if control else None)


def _dist_gap(d, ref):
    """The 99th percentile of |d - ref| / max(ref, 1) over the pairs whose
    reference distance is at most 100 px (the proposal's cut)."""
    import torch
    near = ref <= 100
    rel = (d - ref)[near].abs() / ref[near].clamp(min=1.0)
    return float(torch.quantile(rel.float().cpu(), 0.99)) if len(rel) \
        else 0.0
