"""The training data pipeline against the JAX package: the synthetic clips
and the dataset fixture writers (bit for bit), the flow-distance matrix and
the frame graphs built from it, augmentation, timestamp association, and
TartanAir read from its fixture.

The port keeps numpy copies of the JAX package's numpy modules and its own
torch flow matrix. Bounds (``python tests/test_torch_train_data.py``
prints the readings): copies bit for bit; the flow matrix to rtol 1e-4
(f32 geometry, readings ~1e-6) with the same non-covisible (inf) pairs;
graphs, covisibility walks and the sampled clips equal.
"""

import filecmp
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from droid_slam_tpu.data import augmentation as jaug
from droid_slam_tpu.data import fixtures as jfix
from droid_slam_tpu.data import graph_utils as jgraph
from droid_slam_tpu.data import rgbd_utils as jrgbd
from droid_slam_tpu.data import synthetic as jsyn
from droid_slam_tpu.data.tartan import TartanAir as JTartanAir
from droid_slam_tpu.lie import se3 as jse3

from droid_slam_tpu_torch.data import augmentation as taug
from droid_slam_tpu_torch.data import factory as tfactory
from droid_slam_tpu_torch.data import fixtures as tfix
from droid_slam_tpu_torch.data import graph_utils as tgraph
from droid_slam_tpu_torch.data import rgbd_utils as trgbd
from droid_slam_tpu_torch.data import synthetic as tsyn
from droid_slam_tpu_torch.data.tartan import TartanAir as TTartanAir

FLOW_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_synthetic_clips_and_streams_are_bit_identical():
    for kw in (dict(n_clips=2, n_frames=3, image_size=(48, 64), seed=3),
               dict(n_clips=1, n_frames=4, image_size=(40, 56), seed=0,
                    step=0.3, rot_step=0.1)):
        j, t = jsyn.SyntheticBox(**kw), tsyn.SyntheticBox(**kw)
        for i in range(kw["n_clips"]):
            assert _same(j[i], t[i])
    kw = dict(n_frames=3, image_size=(32, 48), seed=2)
    for mode in (dict(), dict(stereo=True), dict(with_depth=True)):
        for a, b in zip(jsyn.synthetic_stream(**kw, **mode),
                        tsyn.synthetic_stream(**kw, **mode)):
            assert a[0] == b[0] and _same(a[1:], b[1:])
    assert np.array_equal(jsyn.synthetic_groundtruth(**kw),
                          tsyn.synthetic_groundtruth(**kw))


def _same_tree(a, b):
    cmp = filecmp.dircmp(a, b)
    assert not cmp.left_only and not cmp.right_only, (a, b)
    _, mismatch, errors = filecmp.cmpfiles(a, b, cmp.common_files,
                                           shallow=False)
    assert not mismatch and not errors, mismatch + errors
    for d in cmp.common_dirs:
        _same_tree(os.path.join(a, d), os.path.join(b, d))


@pytest.mark.parametrize("kind", ["tartanair", "euroc", "tum", "eth3d"])
def test_fixture_writers_are_bit_identical(kind, tmp_path):
    pytest.importorskip("cv2")
    kw = {"tartanair": dict(n_scenes=2, n_frames=3, image_size=(48, 64)),
          "euroc": dict(n_frames=3, image_size=(48, 64), stereo=True),
          "tum": dict(n_frames=3, image_size=(48, 64)),
          "eth3d": dict(n_frames=3, image_size=(48, 64))}[kind]
    fn = f"write_{kind}_fixture"
    getattr(jfix, fn)(str(tmp_path / "jax"), **kw)
    getattr(tfix, fn)(str(tmp_path / "port"), **kw)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def flow_readings(seed=0):
    """The flow-distance matrix of a synthetic clip (c2w poses, 1/8
    disparities) and of a scene with far-apart poses (non-covisible
    pairs), in both packages."""
    clip = tsyn.SyntheticBox(n_clips=1, n_frames=6, image_size=(96, 128),
                             seed=seed)[0]
    rng = np.random.default_rng(seed)
    xi = (0.6 * rng.normal(size=(5, 6))).astype(np.float32)
    far = np.asarray(jse3.exp(jnp.asarray(xi)))
    out = {}
    for name, (poses, disps, intr) in {
            "clip": (clip[1], clip[2][:, 3::8, 3::8], clip[3] / 8.0),
            "far": (far, rng.uniform(0.3, 2.0, size=(5, 8, 10)),
                    np.tile([8.0, 8.0, 5.0, 4.0], (5, 1)))}.items():
        a = jrgbd.compute_distance_matrix_flow(poses, disps, intr)
        b = trgbd.compute_distance_matrix_flow(poses, disps, intr)
        fin = np.isfinite(a)
        out[name] = {"same_inf": bool(np.array_equal(fin, np.isfinite(b))),
                     "n_inf": int((~fin).sum()),
                     "rel": float(np.max(np.abs(a[fin] - b[fin])
                                         / np.maximum(np.abs(a[fin]), 1e-6)))}
    a = jrgbd.all_pairs_distance_matrix(far)
    b = trgbd.all_pairs_distance_matrix(far)
    out["all_pairs"] = float(np.abs(a - b).max())
    return out


def test_flow_distance_matrix_matches_jax():
    r = flow_readings()
    for k in ("clip", "far"):
        assert r[k]["same_inf"] and r[k]["rel"] < FLOW_RTOL, r
    assert r["far"]["n_inf"] > 0 and r["clip"]["n_inf"] < 36
    assert r["all_pairs"] < 1e-5, r


@pytest.mark.parametrize("seed", [0, 1])
def test_build_frame_graph_matches_jax(seed):
    """--edges 24 on a 7-frame clip: the |i - j| <= 2 neighbourhood and
    the covisible pairs closest in flow, in the same order."""
    clip = tsyn.SyntheticBox(n_clips=1, n_frames=7, image_size=(96, 128),
                             seed=seed)[0]
    a = jgraph.build_frame_graph(clip[1], clip[2], clip[3], num=24)
    b = tgraph.build_frame_graph(clip[1], clip[2], clip[3], num=24)
    assert a == b
    ii, jj, kk = tgraph.graph_to_edge_list(b)
    assert _same(jgraph.graph_to_edge_list(a), (ii, jj, kk))
    assert len(ii) >= 22
    assert np.array_equal(jgraph.keyframe_indicies(a),
                          tgraph.keyframe_indicies(b))
    assert _same(jgraph.neighbourhood_graph(7, 2),
                 tgraph.neighbourhood_graph(7, 2))


def test_augmentation_and_association_match_jax():
    pytest.importorskip("cv2")
    clip = tsyn.SyntheticBox(n_clips=1, n_frames=3, image_size=(64, 80),
                             seed=4)[0]
    outs = [aug((64 - 16, 80 - 16), rng=np.random.default_rng(9))(
        clip[0], clip[1], clip[2], clip[3])
        for aug in (jaug.RGBDAugmentor, taug.RGBDAugmentor)]
    assert _same(*outs)
    rng = np.random.default_rng(1)
    t_img = np.sort(rng.uniform(0, 10, 40))
    t_dep = np.sort(rng.uniform(0, 10, 35))
    t_pose = np.sort(rng.uniform(0, 10, 50))
    for args in ((t_img, t_dep), (t_img, t_dep, t_pose)):
        assert jrgbd.associate_frames(*args, max_dt=0.1) == \
            trgbd.associate_frames(*args, max_dt=0.1)
    R = np.eye(4)
    R[:3, :3] = jsyn._axis_angle_mat([1.0, 2.0, 0.5], 0.7)
    R[:3, 3] = [1.0, -2.0, 0.5]
    assert np.array_equal(jrgbd.pose_matrix_to_quaternion(R),
                          trgbd.pose_matrix_to_quaternion(R))


def test_loadtum_matches_jax(tmp_path):
    """A TUM-format directory (the ETH3D fixture plus its depth list)."""
    pytest.importorskip("cv2")
    root = str(tmp_path)
    tfix.write_eth3d_fixture(root, n_frames=12, image_size=(32, 48))
    rows = open(os.path.join(root, "rgb.txt")).read().split("\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(r.replace("rgb/", "depth/") for r in rows))
    a, b = jrgbd.loadtum(root), trgbd.loadtum(root)
    assert len(a[0]) == 3 and a[0] == b[0] and a[1] == b[1]
    assert _same(a[2], b[2]) and _same(a[3], b[3]) and a[4] == b[4]


def tartan_readings(root):
    """TartanAir on its fixture in both packages, one seeded generator
    each: scenes, covisibility index and three sampled clips."""
    jfix.write_tartanair_fixture(root, n_scenes=2, n_frames=8,
                                 image_size=(120, 160))
    kw = dict(datapath=root, n_frames=4, fmin=4.0, fmax=96.0,
              crop_size=(96, 128))
    j = JTartanAir(rng=np.random.default_rng(5),
                   cache_dir=os.path.join(root, "jax_cache"), **kw)
    t = TTartanAir(rng=np.random.default_rng(5), **kw)
    out = {"scenes": sorted(j.scenes) == sorted(t.scenes),
           "samples": j.samples == t.samples, "n_samples": len(t)}
    flow_rel = 0.0
    for sid in j.scenes:
        a, b = j.scenes[sid], t.scenes[sid]
        assert a.images == b.images and a.depths == b.depths
        assert np.array_equal(a.poses, b.poses)
        assert np.array_equal(a.covis.ptr, b.covis.ptr)
        assert np.array_equal(a.covis.idx, b.covis.idx)
        flow_rel = max(flow_rel, float(np.max(
            np.abs(a.covis.flow - b.covis.flow) / a.covis.flow)))
    out["covis_flow_rel"] = flow_rel
    out["clips_equal"] = all(_same(j[i], t[i]) for i in range(3))
    t2 = tfactory.dataset_factory(["tartan"], rng=np.random.default_rng(5),
                                  **kw)
    out["factory_len"] = len(t2)
    out["cached_index"] = os.path.isfile(
        os.path.join(root, ".index_cache", "TartanAir.index.pkl"))
    return out


def test_tartanair_on_its_fixture_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    r = tartan_readings(str(tmp_path))
    assert r["scenes"] and r["samples"] and r["n_samples"] > 0, r
    assert r["covis_flow_rel"] < FLOW_RTOL, r
    assert r["clips_equal"], r
    assert r["factory_len"] == r["n_samples"] and r["cached_index"], r


if __name__ == "__main__":
    import tempfile
    for seed in [int(a) for a in sys.argv[1:]] or [0]:
        print("flow", seed, flow_readings(seed))
    with tempfile.TemporaryDirectory() as d:
        print("tartan", tartan_readings(d))
