"""A new edge's first state (``state/edge_update.py::new_edge_state``) is
the same through both stores: ``FactorGraph.add_factors`` (appended in
edge order: the strict path, the backend, the filler) and
``SlotGraph.add_factors`` -> ``add_edges`` (written into slots: the frame
path). Target, weight, GRU state and volume pyramid bit for bit, in mono
and in stereo, where an (i, i) edge correlates frame i's left view with
its right."""

import pytest
import torch

from droid_slam_tpu_torch.ops import corr as corr_ops
from droid_slam_tpu_torch.state.graph import FactorGraph, SlotGraph
from droid_slam_tpu_torch.state.video import DepthVideo


def _video(stereo):
    v = DepthVideo((64, 96), 12, "cpu", stereo=stereo)
    g = torch.Generator().manual_seed(3)
    t = 8
    with torch.no_grad():
        v.poses[:t, :3] = 0.1 * torch.randn(t, 3, generator=g)
        v.disps[:t] = 0.5 + 0.2 * torch.rand(t, v.h, v.w, generator=g)
        v.intrinsics[:] = torch.tensor([9.6, 9.6, 6.0, 4.0])
        for name in ("fmaps", "nets"):
            buf = getattr(v, name)
            buf[:t] = torch.randn(buf[:t].shape, generator=g).to(buf)
    v.counter = t
    return v


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_both_stores_take_the_same_first_state(stereo):
    v = _video(stereo)
    graph = FactorGraph(v, {})
    graph.add_factors([0, 1, 2], [1, 2, 1])
    slots = SlotGraph.from_graph(graph)
    ii, jj = [3, 4, 4, 5, 2, 6], [4, 3, 4, 5, 5, 6]
    graph.add_factors(ii, jj)
    slots.add_factors(ii, jj)
    assert graph.ii.tolist() == slots.ii.tolist()
    for name in ("net", "target", "weight"):
        assert torch.equal(getattr(graph, name), getattr(slots, name)), name
    assert not graph.weight.any()
    for a, b in zip(graph.pyramid, slots.pyramid, strict=True):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a, b)
    # edge (4, 4): against the right view in stereo, the left in mono
    k = 5
    want = corr_ops.build_pyramid(v.fmaps[4:5, 0],
                                  v.fmaps[4:5, int(stereo)])[0]
    assert torch.equal(graph.pyramid[0][k], want[0].to(torch.bfloat16))
