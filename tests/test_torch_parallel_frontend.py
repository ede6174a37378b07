"""The port's edge-parallel frontend (``parallel/frontend.py``,
``FactorGraph(mesh=...)``, ``DroidConfig(edge_parallel=N)``) on meshes of
CPU devices, against the port's serial update and against the JAX package.

* One sharded update-operator pass on ``Mesh(["cpu"] * n)`` (n = 2 and 4;
  10 edges, so n = 4 gives the uneven blocks 3, 3, 2, 2) against the port's
  one-device pass (``state/edge_update.py::edge_update`` with the slot
  lookup, as ``FactorGraph.update`` runs it) on the same inputs, with the
  default and the fused GRU epilogues (their plain twins on the CPU). Per-edge arithmetic is
  the same, but a convolution over a block of edges may round differently
  from one over all of them, and GraphAgg's bf16 sums are reassociated: the
  tolerances are those of JAX's own sharded-against-serial test
  (tests/test_parallel_frontend.py:60-70).
* The same pass against JAX's ``edge_parallel_update`` on the conftest's
  8-device virtual CPU mesh, inputs moved to the port's NCHW layout, at
  twice those tolerances (largest and mean gap): the two frameworks round
  their bf16 update operators at different places, and the port on one
  shard reads the same gaps as on 2 and 8 (largest: GRU state 0.031, two
  bf16 ulps at 2.56; target 0.14; weight 0.035; eta 0.0039; mask 0.016;
  mean: target 0.027, the rest below 0.002), so they are the frameworks'
  distance, not the sharding's.
* The per-edge state of a graph with a mesh (blocks on their devices)
  equals the serial graph's through edge additions, removals and a keyframe
  removal, bit for bit, in balanced blocks.
* ``Droid(DroidConfig(edge_parallel=2))`` tracks test_torch_slice.py's 14
  frames at 64x96 with the trained weights, against the serial port and
  against JAX's serial run, with that file's bounds and equal keyframes and
  edges.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_slice as slice_test  # noqa: E402

from droid_slam_tpu_torch.ops import corr as tcorr  # noqa: E402
from droid_slam_tpu_torch.parallel import frontend as tpf  # noqa: E402
from droid_slam_tpu_torch.parallel.mesh import Mesh  # noqa: E402

# JAX's tests/test_parallel_frontend.py:60-70: largest and mean gap
TOL = {"net": 3e-2, "target": 0.25, "weight": 3e-2, "eta": 3e-2,
       "upmask": 3e-2}
NWF, H8, W8 = 5, 16, 24


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Two intra-op threads, as the other port tests: the suite runs
    several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    import jax
    from droid_slam_tpu.models import nets as jnets
    return jnets.init_params(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def params(jax_params):
    from droid_slam_tpu_torch.models import weights as tweights
    return tweights.from_jax_params(jax_params)


def _scenario(E, seed=0):
    """JAX's scenario (tests/test_parallel_frontend.py::_scenario), drawn
    with numpy in JAX's channels-last layout."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    hw = H8 * W8
    return dict(
        fm1=f(E, H8, W8, 128) / 8, fm2=f(E, H8, W8, 128) / 8,
        poses=np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0], np.float32),
                      (NWF + 1, 1)),
        disps=np.abs(f(NWF + 1, H8, W8)) + 0.5,
        intr=np.tile(np.array([60., 60., W8 / 2, H8 / 2], np.float32),
                     (NWF + 1, 1)),
        inps=f(NWF + 1, H8, W8, 128), nets=f(E, H8, W8, 128),
        target=f(E, 2, hw), ii=rng.integers(0, NWF, E),
        jj=rng.integers(0, NWF, E))


def _nchw(a, dtype=torch.bfloat16):
    return torch.as_tensor(a).permute(0, 3, 1, 2).to(dtype).contiguous()


def _port_state(sc):
    bf = torch.bfloat16
    pyr = [p.to(bf) for p in tcorr.build_pyramid(_nchw(sc["fm1"]),
                                                _nchw(sc["fm2"]))]
    return dict(poses=torch.as_tensor(sc["poses"]),
                disps=torch.as_tensor(sc["disps"]),
                intr=torch.as_tensor(sc["intr"]), inps=_nchw(sc["inps"]),
                pyr=pyr, net=_nchw(sc["nets"]),
                target=torch.as_tensor(sc["target"]),
                ii=torch.as_tensor(sc["ii"]), jj=torch.as_tensor(sc["jj"]))


def _sharded(params, st, mesh, pre, fused=False, compute_upmask=True):
    """edge_parallel_update on ``mesh``; the outputs gathered in edge
    order, as float32 numpy."""
    from droid_slam_tpu_torch.models import nets as tnets
    sh = lambda x: tpf.shard_edges(mesh, x)
    pyr = list(zip(*[sh(p) for p in st["pyr"]]))
    ii_s = sh(st["ii"])
    tabs = tpf.EdgeTables(
        ii=ii_s, jj=sh(st["jj"]), agg_ii=ii_s,
        pre=None if not pre else [tnets.gru_context_pre(params, st["inps"][i])
                                  for i in ii_s])
    nets_e, tgts, wgts, eta, upmask = tpf.edge_parallel_update(
        mesh, params, st["poses"], st["disps"], st["intr"], st["inps"], pyr,
        sh(st["net"]), sh(st["target"]), tabs, NWF, fused_epilogue=fused,
        compute_upmask=compute_upmask)
    for blocks in (nets_e, tgts, wgts):
        assert [len(b) for b in blocks] == [len(i) for i in ii_s]
    cat = lambda xs: torch.cat(xs).float().numpy()
    return dict(net=cat(nets_e), target=cat(tgts), weight=cat(wgts),
                eta=eta.float().numpy(),
                upmask=None if upmask is None else upmask.float().numpy())


def _assert_close(got, want, scale=1.0):
    """Largest gap within scale * TOL, mean gap below a tenth of it."""
    for k, tol in TOL.items():
        if want.get(k) is None:
            continue
        gap = np.abs(got[k] - want[k])
        assert gap.max() <= scale * tol, (k, gap.max())
        assert gap.mean() < scale * tol / 10, (k, gap.mean())


@pytest.mark.parametrize("n,fused", [(2, False), (4, False), (2, True),
                                     (4, True)])
def test_edge_parallel_update_matches_the_serial_step(params, n, fused):
    """The sharded pass against the one-device edge_update (slot table,
    context precompute, the default or fused GRU) on the same edges."""
    from droid_slam_tpu_torch.models import nets as tnets
    from droid_slam_tpu_torch.ops import corr_cuda
    from droid_slam_tpu_torch.state.edge_update import edge_update

    st = _port_state(_scenario(E=10))
    slots = torch.arange(len(st["ii"]), dtype=torch.int32)
    pre = tnets.gru_context_pre(params, st["inps"][st["ii"]])
    net, tgt, wgt, eta, _ = edge_update(
        params, st["poses"], st["disps"], st["intr"], st["ii"], st["jj"],
        st["net"], st["target"],
        lambda c: corr_cuda.lookup_pyramid_slots(st["pyr"], slots,
                                                 c.contiguous()),
        pre=pre, agg=st["ii"], num_frames=NWF, fused_epilogue=fused)
    want = dict(net=net.float().numpy(), target=tgt.numpy(),
                weight=wgt.numpy(), eta=eta.float().numpy())

    got = _sharded(params, st, Mesh(["cpu"] * n), pre=True, fused=fused,
                   compute_upmask=False)
    _assert_close(got, want)


@pytest.fixture(scope="module")
def jax_sharded(jax_params):
    """JAX's edge_parallel_update on its 8-device virtual mesh (one edge a
    shard, the full context path): the scenario, JAX's pyramid and the
    outputs in the port's layout."""
    import jax
    import jax.numpy as jnp
    from droid_slam_tpu.ops import corr as jcorr
    from droid_slam_tpu.parallel import frontend as jpf

    assert len(jax.devices()) >= 8
    sc = _scenario(E=8)
    bf = jnp.bfloat16
    jt = lambda a, d=jnp.float32: jnp.asarray(a, d)
    pyr = tuple(p.astype(bf) for p in jcorr.build_pyramid(
        jt(sc["fm1"], bf), jt(sc["fm2"], bf)))
    mesh = jpf.edge_parallel_mesh(8)
    sh = lambda t: jpf.shard_edges(mesh, t)
    net, tgt, wgt, eta, upmask, _ = jpf.edge_parallel_update(
        mesh, jax_params, jt(sc["poses"]), jt(sc["disps"]), jt(sc["intr"]),
        jt(sc["inps"], bf), sh(pyr), sh(jt(sc["nets"], bf)),
        sh(jt(sc["target"])), sh(jnp.zeros_like(jt(sc["target"]))),
        sh(jnp.asarray(sc["ii"])), sh(jnp.asarray(sc["jj"])),
        sh(jnp.ones(8, bool)), jnp.asarray(0), nw=NWF, lookup_impl="gather",
        compute_upmask=True)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    want = dict(net=f32(net).transpose(0, 3, 1, 2), target=f32(tgt),
                weight=f32(wgt), eta=f32(eta),
                upmask=f32(upmask).transpose(0, 3, 1, 2))
    return sc, [f32(p) for p in pyr], want


@pytest.mark.parametrize("n", [1, 2, 8])
def test_edge_parallel_update_matches_jax(jax_sharded, params, n):
    """JAX's sharded pass against the port's on n CPU shards."""
    sc, pyr, want = jax_sharded
    st = _port_state(sc)
    # the port's pass on JAX's pyramid, so that only the update differs
    st["pyr"] = [torch.as_tensor(p).to(torch.bfloat16) for p in pyr]
    got = _sharded(params, st, Mesh(["cpu"] * n), pre=False)
    _assert_close(got, want, scale=2.0)


def _graphs_after_edits(params, mesh, device="cpu"):
    """A serial graph and one on ``mesh``, each after edges added, evicted
    with the cap, removed, and a keyframe removed; the per-edge state of
    both equal bit for bit and the mesh's blocks balanced. Returns
    (serial, sharded)."""
    from droid_slam_tpu_torch.state.graph import FactorGraph
    from droid_slam_tpu_torch.state.video import DepthVideo

    rng = np.random.default_rng(4)
    graphs = []
    for m in (None, mesh):
        video = DepthVideo((64, 96), 12, device)
        gen = torch.Generator().manual_seed(0)
        video.fmaps.copy_(torch.randn(video.fmaps.shape, generator=gen))
        video.nets.copy_(torch.randn(video.nets.shape, generator=gen))
        video.intrinsics[:] = torch.tensor([10.0, 10.0, 6.0, 4.0])
        video.counter = 10
        graphs.append(FactorGraph(video, params, max_factors=20, mesh=m))
    ii, jj = rng.integers(0, 10, 30), rng.integers(0, 10, 30)
    for g in graphs:
        g.add_factors(ii[:14], jj[:14])
        g.age[:5] += 3
        g.add_factors(ii[14:], jj[14:], remove=True)   # evicts the oldest
        g.rm_factors(g.ii == 3, store=True)
        g.rm_keyframe(6)
    serial, sharded = graphs
    assert len(serial.ii) > 6
    assert np.array_equal(serial.ii, sharded.ii)
    for name in ("net", "target", "weight", "target_inac", "weight_inac"):
        assert torch.equal(getattr(serial, name), getattr(sharded, name))
    for a, b in zip(serial.pyramid, sharded.pyramid):
        assert torch.equal(a, b)
    sizes = [len(b) for b in sharded._blocks("net")]
    assert sum(sizes) == len(serial.ii) and max(sizes) - min(sizes) <= 1
    return serial, sharded


def test_mesh_graph_keeps_the_serial_edge_state_in_blocks(params):
    """Edges added, evicted with the cap, removed, and a keyframe removed:
    the state read through a 3-shard graph equals the serial graph's bit
    for bit, held in balanced blocks that are views on one device."""
    _, sharded = _graphs_after_edits(params, Mesh(["cpu"] * 3))
    base = sharded._blocks("target")[0]._base
    assert base is not None and all(b._base is base
                                    for b in sharded._blocks("target"))


def test_edge_parallel_needs_its_devices():
    """No quiet fallback: N shards need N cards unless given devices, and
    devices need the mode."""
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    with pytest.raises(RuntimeError, match="edge_parallel=2 asks for 2"):
        Droid(DroidConfig(buffer=16, image_size=(64, 96), edge_parallel=2),
              device="cpu")
    with pytest.raises(ValueError, match="edge_parallel"):
        Droid(DroidConfig(buffer=16, image_size=(64, 96)), device="cpu",
              edge_devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="3 devices"):
        tpf.edge_parallel_mesh(2, ["cpu"] * 3)


def _run_edge_parallel(frames, weights, device="cpu",
                       edge_devices=("cpu", "cpu")):
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    droid = Droid(DroidConfig(**slice_test._cfg_kwargs("admit_all", weights),
                              edge_parallel=2), device=device,
                  edge_devices=list(edge_devices))
    for t, img, intr in frames:
        droid.track(float(t), img[0], intrinsics=intr)
    droid.flush()
    n, g, v = droid.video.counter, droid.frontend.graph, droid.video
    assert g.mesh is not None and g.mesh.size == 2
    assert all(len(b) for b in g._blocks("net"))
    return dict(tstamps=v.tstamp[:n].tolist(),
                edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
                poses=v.poses[:n].cpu().numpy(),
                disps=v.disps[:n].cpu().numpy())


def test_edge_parallel_tracking_matches_serial_and_jax():
    if not os.path.exists(slice_test.CKPT):
        pytest.skip(f"needs the trained checkpoint {slice_test.CKPT}")
    frames = slice_test._frames()
    got = _run_edge_parallel(frames, slice_test.CKPT)
    for ref in (slice_test._run_torch("admit_all", frames, slice_test.CKPT),
                slice_test._run_jax("admit_all", frames, slice_test.CKPT)):
        slice_test._assert_same_track(got, ref, "admit_all")


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the kernels have no CPU mode, "
                    "and state split across cards needs a second")


@pytest.mark.cuda
def test_mesh_graph_keeps_the_serial_edge_state_across_two_cards():
    """The edits of the CPU case with the blocks on cuda:0 and cuda:1 (the
    graph's cross-device resharding): the same state bit for bit, each
    block on its shard's card."""
    _two_cards()
    from droid_slam_tpu_torch.models import weights as tweights
    if not os.path.exists(slice_test.CKPT):
        pytest.skip(f"needs the trained checkpoint {slice_test.CKPT}")
    mesh = Mesh(["cuda:0", "cuda:1"])
    _, sharded = _graphs_after_edits(tweights.load(slice_test.CKPT,
                                                   "cuda:0"),
                                     mesh, "cuda:0")
    for name in ("net", "target", "weight", "pyr0"):
        assert [b.device for b in sharded._blocks(name)] == mesh.devices


@pytest.mark.cuda
def test_edge_parallel_tracking_across_two_cards():
    """test_edge_parallel_tracking_matches_serial_and_jax's 14 frames with
    the shards on cuda:0 and cuda:1, against the serial port on cuda:0,
    with test_torch_slice.py's bounds."""
    _two_cards()
    if not os.path.exists(slice_test.CKPT):
        pytest.skip(f"needs the trained checkpoint {slice_test.CKPT}")
    frames = slice_test._frames()
    got = _run_edge_parallel(frames, slice_test.CKPT, "cuda:0",
                             ("cuda:0", "cuda:1"))
    ref = slice_test._run_torch("admit_all", frames, slice_test.CKPT,
                                device="cuda:0")
    slice_test._assert_same_track(got, ref, "admit_all")


@pytest.mark.cuda
def test_kernels_launch_on_their_operands_card():
    """The three kernels' wrappers called with tensors on cuda:1 while
    cuda:0 is current (as the asynchronous backend's filler is called from
    the tracker's thread): each launches on its operands' card and agrees
    with its plain twin (f32: test_torch_corr.py's and test_torch_gru.py's
    bounds, 1e-4 and 1e-5)."""
    _two_cards()
    from droid_slam_tpu_torch.ops import corr_cuda, gru_cuda
    from droid_slam_tpu_torch.ops import gru as tgru

    rng = np.random.default_rng(7)
    dev = torch.device("cuda", 1)
    t = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)
                                   ).to(dev)
    h, w, E = 40, 64, 6
    pyr = [t(E, h * w, h, w)]
    for _ in range(3):
        pyr.append(tcorr.avg_pool2(pyr[-1]))
    slots = torch.arange(E, dtype=torch.int32, device=dev)
    coords = (torch.rand(E, h * w, 2, device=dev)
              * torch.tensor([w + 4.0, h + 4.0], device=dev) - 2).contiguous()
    zrc, cf, pre_zr = t(E, 256, h, w), t(E, 384, h, w), t(E, 256, h, w)
    qc, pre_q, gzr = t(E, 128, h, w), t(E, 128, h, w), t(E, 256)
    net, z = torch.tanh(t(E, 128, h, w)), torch.sigmoid(t(E, 128, h, w))
    gq = gzr[:, :128].contiguous()
    torch.cuda.synchronize(dev)
    with torch.cuda.device(0):
        got = (corr_cuda.lookup_pyramid_slots(pyr, slots, coords),
               *gru_cuda.gru_epilogue_a(zrc, cf, pre_zr, net, gzr),
               gru_cuda.gru_epilogue_b(qc, cf, pre_q, net, z, gq))
    torch.cuda.synchronize(dev)
    want = (tcorr.lookup_pyramid_plain(pyr, slots, coords),
            *tgru.gru_epilogue_a_plain(zrc, cf, pre_zr, net, gzr),
            tgru.gru_epilogue_b_plain(qc, cf, pre_q, net, z, gq))
    for g, wnt, atol in zip(got, want, (1e-4, 1e-5, 1e-5, 1e-5)):
        assert g.device == dev
        torch.testing.assert_close(g, wnt, atol=atol, rtol=0)
