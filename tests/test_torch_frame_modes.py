"""The port's frame path against JAX's, part 3: stereo and RGB-D.

tests/test_torch_stereo_rgbd.py's 14 synthetic frames at 64x96 with the
trained weights (every frame admitted and kept, ``upsample``), tracked by
the two frame paths with speculative dispatch (``DROID_FUSED_FRAME=1
DROID_SPEC_FRAME=1`` in JAX; ``fused_frame=True, spec_frame=True`` in the
port, eagerly on the CPU): stereo, whose frame programs build the (i, i)
edges' volumes from the right view, and RGB-D, whose part A writes the new
keyframe's sensor disparities and overwrites the update's newest
keyframe with them, and whose part B writes the full-resolution
disparities. Equal keyframes, edges and mis-speculations; poses,
disparities and full-resolution disparities within that file's bounds
(the monocular slice's). Each mode runs JAX once, in a module fixture.
"""

import numpy as np
import pytest
import torch

import test_torch_frame as frame_test
import test_torch_stereo_rgbd as modes


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["stereo", "rgbd"])
def test_frame_path_modes_match_jax(mode):
    modes._skip_without_checkpoint()
    frames = modes._frames(mode)
    cfg = modes._cfg(mode)
    ref = frame_test.run_jax(cfg, frames, True)
    got = frame_test.run_torch(cfg, frames, True)
    assert got["tstamps"] == ref["tstamps"]
    assert len(ref["tstamps"]) == modes.N_FRAMES
    assert got["edges"] == ref["edges"]
    assert any(i == j for i, j in ref["edges"]) == (mode == "stereo")
    assert got["mis"] == ref["mis"]
    for k in ("poses", "disps", "disps_up"):
        assert np.isfinite(got[k]).all(), k
    pose = float(np.abs(got["poses"] - ref["poses"]).max())
    disps = modes._field_gaps(got["disps"], ref["disps"])
    up = modes._field_gaps(got["disps_up"], ref["disps_up"])
    print(mode, dict(pose=pose, disps=disps, disps_up=up))
    assert pose <= 0.05
    assert disps["mean"] <= 0.35
    for g in (disps, up):
        assert g["median"] <= 0.25
        assert g["corr"] >= 0.5
    if mode == "rgbd":
        v = got["droid"].video
        n = v.counter
        assert (v.disps_sens[:n] > 0).float().mean() > 0.9
