"""The comparison that decides ``correct`` in the stereo tracking cell:
``checks.tracking``'s readings, each computed the same way, against the
stereo reference (``reference/stereo.py``): both views' features of every
sampled keyframe row, the admission deltas of the left views, and the
sampled updates over the window's stereo and monocular edges. A window
whose sampled updates hold no stereo edge fails the run: the cell would
then not measure what it is for."""

from __future__ import annotations

from benchmark import harness
from benchmark.checks import _gap, _gap_parts, _sides, _state, tf32
from benchmark.reference import droidnet
from benchmark.reference import stereo as rstereo


def tracking(cell, data, images, intr, device, control=False):
    """``checks.tracking``'s readings of a stereo window (and the
    control's, with ``control``); ``encode_gap`` is the worst of the two
    views' features, the context and the GRU state. ``images``: the
    stream's pairs [N,2,H,W,3]."""
    import torch
    p = droidnet.load_params(harness.weights_path(cell.config), device)
    image = lambda k: torch.as_tensor(images[int(k)], device=device)
    cfg = cell.config
    keep = 2.0 * cfg["keyframe_thresh"]
    out = {"program": {}, "control": {}}
    gaps = {"program": {}, "control": {}}

    def worst(side, name, v):
        out[side][name] = max(out[side].get(name, 0.0), v)

    def encode_gap(got, ref):
        (f, n, i), (rf, rn, ri) = got, ref
        return max(_gap(f[0], rf[0]), _gap(f[1], rf[1]), _gap(n, rn[0]),
                   _gap(i, ri[0]))

    with torch.no_grad():
        for w in data["written"]:
            with tf32(False):
                ref = rstereo.encode_stereo(p, image(w["tstamp"]))
            worst("program", "encode_gap",
                  encode_gap((w["fmap"], w["net"], w["inp"]), ref))
            if control:
                with tf32(True):
                    f, n, i = rstereo.encode_stereo(p, image(w["tstamp"]),
                                                    True)
                worst("control", "encode_gap",
                      encode_gap((f, n[0], i[0]), ref))

        for k, a, d_prog in data["deltas"]:
            with tf32(False):
                ref = float(rstereo.admission_delta(p, image(a), image(k)))
            worst("program", "delta_gap_px", abs(d_prog - ref))
            if control:
                with tf32(True):
                    low = float(rstereo.admission_delta(p, image(a),
                                                        image(k), True))
                worst("control", "delta_gap_px", abs(low - ref))

        if not data["samples"]:
            raise RuntimeError("no update frame was sampled in the window")
        if not any((s["ii"] == s["jj"]).any() for s in data["samples"]):
            raise RuntimeError("no sampled update held a stereo edge")
        for s in data["samples"]:
            res = {}
            for side, low, dt, t32 in _sides(control):
                st = _state(s, dt, device)
                st["keep"] = s["kf_dist"] >= keep
                with tf32(t32):
                    res[side] = rstereo.frame_update(
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
    for side, g in gaps.items():
        for k, (num, den) in g.items():
            out[side][f"update_{k}_gap"] = (num / max(den, 1e-60)) ** 0.5
    return out["program"], (out["control"] if control else None)
