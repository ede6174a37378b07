"""Data-parallel training of the port on the CPU: gloo process groups of
spawned ranks (``parallel/mesh.py``, ``train.trainer.train_step(dp=...)``,
``train_torch.py --devices N``).

* 2 and 4 ranks, each stepping once on its contiguous block of a global
  batch of 4 clips (SyntheticBox seed 5, 4 frames at 48x64, 2 iterations,
  bf16), against one process stepping on the whole batch: parameters to the
  JAX package's data-parallel bounds (rtol 2e-4, atol 2e-5;
  tests/test_train_step.py:199-241), loss and metrics to 1e-4 relative.
  Each sample runs the same ops either way; only the gradients' sum order
  differs. Adam's first step moves each entry by about lr g/|g|, which a
  gradient off by a constant factor moves alike, so the gradients that
  reach the optimizer (averaged over the ranks) and Adam's first moment
  (0.1 x the clipped gradient) are held too, to a relative error of
  GRAD_REL_TOL = 1e-4 against one process that averages the blocks'
  gradients itself (readings 2.9e-6 and 7.2e-6 at 2 and 4 ranks).
* 2 ranks against JAX's ``make_train_step`` on a mesh of 2 of the
  conftest's virtual CPU devices (``pmean`` of gradients and metrics), on
  test_torch_train_loss.py's batch (SyntheticBox seeds 1 and 5, one clip a
  rank), both in f32: that file's bounds for one train step against JAX.
* ``train_torch.py --device cpu --devices 2`` end to end in a subprocess.
* ``--devices`` above the card count raises, and a collective whose peer
  is gone raises instead of waiting.

Every process group has a timeout, and every spawn is joined under a
deadline, after which its processes are killed and the test fails.
"""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from droid_slam_tpu_torch.parallel import mesh as pmesh
from droid_slam_tpu_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "r5_006000.npz")
B, N, SIZE, ITERS = 4, 4, (48, 64), 2
CFG = trainer.TrainConfig(n_frames=N, restart_prob=0.0)
GROUP_TIMEOUT_S = 60.0
JOIN_TIMEOUT_S = 240.0
GRAD_REL_TOL = 1e-4  # relative error of a flat gradient tree


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    """The global batch: 4 rendered clips with every pair |i - j| <= 2."""
    from droid_slam_tpu_torch.data.synthetic import SyntheticBox
    from droid_slam_tpu_torch.lie import se3

    db = SyntheticBox(n_clips=B, n_frames=N, image_size=SIZE, seed=5)
    clips = [db[k] for k in range(B)]
    pairs = [(a, b) for a in range(N) for b in range(N)
             if a != b and abs(a - b) <= 2]
    stack = lambda i: torch.as_tensor(np.stack([c[i] for c in clips]))
    return {"images": stack(0).to(torch.uint8),
            "poses": se3.inv(stack(1)), "disps": stack(2),
            "intrinsics": stack(3),
            "ii": torch.tensor([a for a, _ in pairs]),
            "jj": torch.tensor([b for _, b in pairs])}


def _params():
    from droid_slam_tpu_torch.models import weights as tweights
    return tweights.load_npz(CKPT) if os.path.exists(CKPT) else None


def _step(dp=None, case="bf16", batch_file="", block=None):
    """One train step: ``case`` "bf16" on _batch() from the checkpoint's
    weights, "f32" on the batch saved in ``batch_file`` from its ``params``
    entries; on rank ``block`` = (r, world)'s block alone when given.
    Returns (params, metrics, the gradients the optimizer was given,
    Adam's first moment), detached."""
    if case == "bf16":
        params, batch, dtype = _params(), _batch(), torch.bfloat16
    else:
        with np.load(batch_file) as f:
            data = {k: f[k] for k in f.files}
        params = {k[len("params/"):]: torch.as_tensor(v)
                  for k, v in data.items() if k.startswith("params/")}
        batch = {k: torch.as_tensor(v) for k, v in data.items()
                 if not k.startswith("params/")}
        dtype = torch.float32
    params, opt = trainer.init_train_state(CFG, params=params, device="cpu")
    if dp is not None or block is not None:
        batch = pmesh.shard_batch(batch, dp or pmesh.DataParallel(
            *block, device=torch.device("cpu"), backend="none"))
    seen, step = {}, opt.step

    def spy(grads):
        seen.update({k: v.detach().clone() for k, v in grads.items()})
        return step(grads)

    opt.step = spy
    metrics = trainer.train_step(params, opt, batch, 0, CFG, num_steps=ITERS,
                                 compute_dtype=dtype, dp=dp)
    mu = {k: opt.adam.state[p]["exp_avg"].clone() for k, p in params.items()}
    return ({k: v.detach() for k, v in params.items()}, metrics, seen, mu)


def _dp_rank(rank, world, init, out, case="bf16", batch_file=""):
    torch.set_num_threads(1)
    dp = pmesh.init_data_parallel(rank, world, "gloo", "cpu",
                                  GROUP_TIMEOUT_S, init)
    try:
        params, metrics, grads, mu = _step(dp, case, batch_file)
        if rank == 0:
            torch.save({"params": params, "metrics": metrics,
                        "grads": grads, "mu": mu}, out)
    finally:
        pmesh.shutdown_data_parallel()


def _lonely_rank(rank, world, init, out, *_):
    """Rank 1 leaves the group at once; rank 0's all-reduce must raise."""
    dp = pmesh.init_data_parallel(rank, world, "gloo", "cpu", 5.0, init)
    if rank == 0:
        pmesh.all_reduce_mean([torch.ones(3)], dp)


def _spawn(fn, world, out="", *args):
    """fn(rank, world, init, out, *args) on ``world`` spawned ranks, joined
    under JOIN_TIMEOUT_S; a rank's failure raises here."""
    init = f"tcp://localhost:{pmesh.free_port()}"
    ctx = mp.start_processes(fn, args=(world, init, out) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=2.0):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} ranks did not finish within "
                            f"{JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _flat(tree):
    return torch.cat([tree[k].double().reshape(-1) for k in sorted(tree)])


def _rel(a, b):
    """Relative error of the flat tree a against b."""
    fa, fb = _flat(a), _flat(b)
    return float(torch.linalg.norm(fa - fb) / torch.linalg.norm(fb))


@pytest.fixture(scope="module")
def single():
    return _step()


def _blockwise(world):
    """What ``world`` ranks compute, in one process: each rank's block
    stepped alone, its gradients averaged, and one optimizer step on the
    average. The update operator clips its heads' backward gradients
    (layers.py::gradient_clip), so a block's gradient is not linear in the
    1/B that scales its samples' losses: this average parts from the
    whole batch's gradient (by 0.49 relative at world 2), as JAX's
    ``pmean`` of per-device gradients does, and is what the ranks must
    reproduce."""
    grads = [_step(block=(r, world))[2] for r in range(world)]
    mean = {k: sum(g[k] for g in grads) / world for k in grads[0]}
    params, opt = trainer.init_train_state(CFG, params=_params(),
                                           device="cpu")
    opt.step(mean)
    mu = {k: opt.adam.state[p]["exp_avg"].clone() for k, p in params.items()}
    return {k: v.detach() for k, v in params.items()}, mean, mu


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_the_single_process_step(single, world, tmp_path):
    out = str(tmp_path / "rank0.pt")
    _spawn(_dp_rank, world, out)
    got = torch.load(out)
    p1, m1, g1, mu1 = single
    assert m1["grad_nanfrac"] == got["metrics"]["grad_nanfrac"] == 0.0
    for k, v in m1.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for k in p1:
        np.testing.assert_allclose(got["params"][k].numpy(), p1[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)
    start = _params() or {}
    assert all(not torch.equal(p1[k], start[k]) for k in start)
    # the averaged gradients before the norm clip, and the clipped ones
    # Adam took: a sum over the ranks left undivided would be off by a
    # factor of ``world`` in the first
    pb, gb, mub = _blockwise(world)
    grad_rel, mu_rel = _rel(got["grads"], gb), _rel(got["mu"], mub)
    print(f"world {world}: gradient rel {grad_rel:.3g}, Adam mu rel "
          f"{mu_rel:.3g}, whole batch's gradient rel {_rel(gb, g1):.3g}")
    assert grad_rel < GRAD_REL_TOL and mu_rel < GRAD_REL_TOL
    for k in pb:
        np.testing.assert_allclose(got["params"][k].numpy(), pb[k].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_dp_step_matches_jax_data_parallel_step(tmp_path):
    """Two gloo ranks against JAX's make_train_step on a 2-device mesh,
    with test_torch_train_loss.py's bounds for one step against JAX."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_train_loss as tl
    from droid_slam_tpu.parallel.mesh import (data_parallel_mesh, replicate,
                                              shard_batch)
    from droid_slam_tpu_torch.models import weights as tweights
    import jax
    import jax.numpy as jnp
    import optax

    s = tl.scene(*tl.BATCH_SEEDS)
    jparams = tl.jax_params()
    batch_file = str(tmp_path / "batch.npz")
    np.savez(batch_file, **s, **{
        f"params/{k}": v.numpy()
        for k, v in tweights.from_jax_params(jparams).items()})
    out = str(tmp_path / "rank0.pt")
    _spawn(_dp_rank, 2, out, "f32", batch_file)
    got = torch.load(out)

    jcfg = tl.jtrainer.TrainConfig(restart_prob=0.0, n_frames=N)
    orig = tl.jtrainer.sample_loss
    # make_train_step takes no compute dtype: run its samples in f32
    tl.jtrainer.sample_loss = functools.partial(orig,
                                                compute_dtype=jnp.float32)
    try:
        mesh = data_parallel_mesh(2)
        params, opt_state = tl.jtrainer.init_train_state(
            jcfg, params={k: jnp.asarray(v) for k, v in jparams.items()})
        step_fn, _ = tl.jtrainer.make_train_step(mesh, jcfg,
                                                 num_steps=ITERS)
        sb = shard_batch(mesh, {k: s[k] for k in
                                ("images", "poses", "disps", "intrinsics")})
        sb["ii"] = replicate(mesh, s["ii"])
        sb["jj"] = replicate(mesh, s["jj"])
        jp, jo, jm = step_fn(replicate(mesh, params),
                             replicate(mesh, opt_state), sb,
                             jax.random.PRNGKey(0))
        jp = {k: np.asarray(v) for k, v in jax.device_get(jp).items()}
        adam = [x for x in jax.device_get(jo)
                if isinstance(x, optax.ScaleByAdamState)][0]
        jmu = {k: torch.as_tensor(np.asarray(v)) for k, v in adam.mu.items()}
        jm = {k: float(v) for k, v in jm.items()}
    finally:
        tl.jtrainer.sample_loss = orig

    tm = got["metrics"]
    assert tm["restarts"] == 0
    assert jm["grad_nanfrac"] == tm["grad_nanfrac"] == 0.0
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    tmu = {k: torch.as_tensor(v)
           for k, v in tweights.to_jax_params(got["mu"]).items()}
    tpj = tweights.to_jax_params(got["params"])
    lr0 = trainer.onecycle_lr(CFG, 0)
    dj = np.concatenate([(jp[k] - jparams[k]).ravel()
                         for k in sorted(jparams)])
    dt = np.concatenate([(np.asarray(tpj[k]) - jparams[k]).ravel()
                         for k in sorted(jparams)])
    mu_rel = _rel(tmu, jmu)
    share = float(np.mean(np.abs(dj - dt) <= 1e-3 * lr0))
    print(f"against JAX: Adam mu rel {mu_rel:.3g}, share of updates within "
          f"1e-3 lr {share:.6f}")
    # Adam's first moment after one step is 0.1 x the processed gradient
    # (the mean over the ranks, clipped, + weight decay)
    assert mu_rel < tl.GRAD_REL_TOL
    assert np.abs(dj).mean() / lr0 > 0.5
    assert share > 0.999


def test_collective_without_its_peer_raises():
    tic = time.monotonic()
    with pytest.raises(Exception):
        _spawn(_lonely_rank, 2)
    assert time.monotonic() - tic < JOIN_TIMEOUT_S


def test_devices_above_the_card_count_raise(monkeypatch):
    sys.path.insert(0, REPO)
    import train_torch

    args = train_torch.build_parser().parse_args(["--devices", "2"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="asks for 2 CUDA devices"):
        train_torch.rank_plan(args)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    devices, backend = train_torch.rank_plan(args)
    assert backend == "nccl" and [str(d) for d in devices] == ["cuda:0",
                                                                "cuda:1"]
    args = train_torch.build_parser().parse_args(["--devices", "3",
                                                  "--device", "cpu"])
    assert train_torch.rank_plan(args) == ([torch.device("cpu")] * 3, "gloo")
    with pytest.raises(ValueError, match="does not divide"):
        train_torch.run_ranks(args, *train_torch.rank_plan(args))


def test_shard_batch_takes_contiguous_blocks():
    batch = {"images": torch.arange(6), "ii": torch.arange(3)}
    dp = pmesh.DataParallel(rank=1, world=3, device=torch.device("cpu"),
                            backend="gloo")
    got = pmesh.shard_batch(batch, dp)
    assert got["images"].tolist() == [2, 3] and got["ii"] is batch["ii"]
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch({"images": torch.arange(4)}, dp)


def test_train_cli_on_two_cpu_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "train_torch.py"), "--device",
         "cpu", "--devices", "2", "--datasets", "synthetic",
         "--synthetic_clips", "2", "--n_frames", "5", "--image_size", "96",
         "128", "--iters", "2", "--batch", "2", "--steps", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=JOIN_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    # rank 0 alone logs and writes
    assert out.stdout.count("step      1") == 1, out.stdout[-2000:]
    ck = tmp_path / "checkpoints"
    assert sorted(os.listdir(ck)) == ["droid_torch_final.npz",
                                      "droid_torch_state_final.pt"]


@pytest.mark.cuda
def test_train_cli_on_two_cards_with_nccl(tmp_path):
    """``--devices 2`` on the card: NCCL, rank r on cuda:r."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "train_torch.py"), "--devices",
         "2", "--datasets", "synthetic", "--synthetic_clips", "2",
         "--n_frames", "5", "--image_size", "96", "128", "--iters", "2",
         "--batch", "2", "--steps", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=JOIN_TIMEOUT_S)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert out.stdout.count("step      1") == 1, out.stdout[-2000:]
    assert "droid_torch_final.npz" in os.listdir(tmp_path / "checkpoints")
