"""The asynchronous facades on the frame path, on the CPU.

``DroidAsync`` (backend thread) and ``DroidAsyncProcess`` (backend process)
take the tracker's path flags, as JAX's facades take DROID_FUSED_FRAME and
DROID_SPEC_FRAME (droid_slam_tpu/slam/async_droid.py:41-42,
droid_slam_tpu/slam/async_process.py:213-214): here
``DroidConfig(fused_frame=True)``, without and with ``spec_frame``, whose
frame programs run eagerly on the CPU. Each facade tracks
tests/test_torch_async.py's sliding scene in its LAST_CYCLE schedule (40
frames at 64x96, the backend asleep through tracking, so that its one
cycle is its last, over every keyframe), then ``terminate(stream)``. Its
backend's poses must equal, to that file's REPLAY_POSE_TOL, those of a
``DroidAsyncBackend`` driven by hand from the tracker's final keyframes,
where the same with no BA step must land beyond it: the backend read the
frame path's video as the tracker left it.
"""

import pytest
import torch

import test_torch_async as async_test


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("spec", [False, True], ids=["frame", "spec"])
@pytest.mark.parametrize("kind", ["thread", "process"])
def test_async_frame_path_matches_its_backend_driven_by_hand(kind, spec):
    from droid_slam_tpu_torch.slam.async_droid import DroidAsync
    from droid_slam_tpu_torch.slam.async_process import DroidAsyncProcess

    async_test._skip_without_checkpoint()
    traj, _, _, droid = async_test.run_bench(
        kind, fused_frame=True, spec_frame=spec, **async_test.LAST_CYCLE)
    assert isinstance(droid, {"thread": DroidAsync,
                              "process": DroidAsyncProcess}[kind])
    assert (droid._fused_frame, droid._spec_frame) == (True, spec)
    assert droid.frame_programs.eager > 0   # frames ran as frame programs
    gaps = async_test.last_cycle_gaps(droid, traj)
    print(kind, "spec" if spec else "frame", gaps)
    assert gaps["pose_gap"] <= async_test.REPLAY_POSE_TOL < \
        gaps["control_no_ba"]
    if kind == "process":
        assert not droid._proc.is_alive() and droid._proc.exitcode == 0
