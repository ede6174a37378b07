"""What decides ``correct``: on the CPU at a small size, a run of each cell
is correct under its limits, the control (the reference in the precision
below the configuration's) is not, and neither is a run whose timed path
is broken underneath: a step that leaves its state unchanged, half of the
edges left out of the bundle adjustment, an answer altered where it is
produced (one chip: no exchange between chips to leave out). The card case
runs the cells at their own size with the control."""

import pytest
import torch

from benchmark import harness
from benchmark.tests._dry import dry_run

CELLS = [w["name"] for w in harness.spec()["workloads"]]


def _judge(readings, workload):
    return harness.judge(readings, harness.Cell(workload).limits)[0]


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload):
    r = dry_run(workload, control=True)
    assert r["correct"], r["checks"]
    assert not _judge(r["control"], workload), r["control"]


def _unchanged(monkeypatch):
    """The BA's step returns the state it was given."""
    from droid_slam_tpu_torch.ba import inference
    monkeypatch.setattr(inference, "ba_iterations",
                        lambda poses, disps, *a, **k: (poses, disps))


def _half_edges(monkeypatch):
    """Every other edge's weight is left out of the BA: its mean is taken
    over the rest."""
    from droid_slam_tpu_torch.ba import inference
    orig = inference.ba_iterations

    def half(poses, disps, sens, damping, intr, target, weight, *a, **k):
        keep = (torch.arange(len(weight), device=weight.device) % 2 == 0)
        return orig(poses, disps, sens, damping, intr, target,
                    weight * keep[:, None, None], *a, **k)
    monkeypatch.setattr(inference, "ba_iterations", half)


def _altered(monkeypatch, workload):
    """An answer off by a few percent where it is produced: the tracker's
    admission delta, or the flow revisions of the backend's update
    operator."""
    if "track" in workload:
        from droid_slam_tpu_torch.slam import fused_frame
        orig = fused_frame.encode_delta

        def enc(*a, **k):
            fmap, net, inp, delta = orig(*a, **k)
            return fmap, net, inp, delta * 1.05
        monkeypatch.setattr(fused_frame, "encode_delta", enc)
    else:
        from droid_slam_tpu_torch.models import nets
        orig = nets.update_module

        def upd(*a, **k):
            out = list(orig(*a, **k))
            out[1] = out[1] * 1.05
            return tuple(out)
        monkeypatch.setattr(nets, "update_module", upd)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_edges", "altered"])
def test_a_broken_path_is_not_correct(workload, fault, monkeypatch):
    if fault == "unchanged":
        _unchanged(monkeypatch)
    elif fault == "half_edges":
        _half_edges(monkeypatch)
    else:
        _altered(monkeypatch, workload)
    r = dry_run(workload)
    assert not r["correct"], r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_on_the_card_the_control_fails(card, workload):
    import time

    from benchmark import run
    r = run.run_cell(workload, 2 ** 31 + 17, 12.0, 0, control=True,
                     t_start=time.perf_counter())
    assert r["correct"], r["checks"]
    assert not _judge(r["control"], workload), r["control"]
