"""Training CLI of the PyTorch port: DroidNet on TartanAir, or on the
synthetic box scenes, on one GPU or data-parallel over several.

    python train_torch.py --datasets synthetic [--ckpt checkpoints/r5_006000.npz]
    python train_torch.py --datasets tartan --datapath datasets/TartanAir
    python train_torch.py ... --devices 4         # 4 GPUs, one rank each
    python train_torch.py ... --device cpu        # the CPU, at small sizes

The same flags as ``train.py`` (the JAX package's CLI) plus ``--device``.
Each step draws a batch of clips, a frame graph shared by the batch (half
the time the covisibility graph of its first clip, ``build_frame_graph``,
else every pair with |i - j| <= 2), and runs ``train.trainer.train_step``.
Weights go to ``checkpoints/<name>_<step>.npz`` every ``--ckpt_every``
steps, in the JAX package's layout; the resumable state (parameters,
optimizer, step, the data generator) to ``checkpoints/<name>_state_*.pt``
every ``--state_every`` steps, at the end, and before a crash propagates.
``--resume`` continues from such a state. Paths are relative to the working
directory.

``--devices N`` trains data-parallel on N ranks (``torch.multiprocessing``
processes; one rank runs in this process): rank r on ``cuda:r`` with NCCL,
or with ``--device cpu`` N CPU ranks with gloo. N above the machine's card
count raises. Every rank draws the same global batch, which must divide by
N, and steps on its contiguous block of it; gradients and metrics are
averaged over the ranks (``train.trainer.train_step``). Rank 0 alone logs
and writes checkpoints. A rank that fails, or a collective that waits
``parallel.mesh.DEFAULT_TIMEOUT_S`` for a peer, fails the run.
"""

import argparse
import os
import time

import numpy as np


def _np_pose_inv(g):
    """SE3 inverse of [tx,ty,tz,qx,qy,qz,qw] in numpy, on the host."""
    qv, w = g[..., 3:6], g[..., 6:7]
    v = g[..., :3]
    uv = 2.0 * np.cross(-qv, v)
    t = -(v + w * uv + np.cross(-qv, uv))
    return np.concatenate([t, -qv, w], axis=-1).astype(np.float32)


def collate(samples, edges_ii, edges_jj):
    """Clips (images, c2w poses, disps, intrinsics) -> a batch of numpy
    arrays; the poses become world-to-camera."""
    return {
        "images": np.stack([s[0] for s in samples]).astype(np.uint8),
        "poses": _np_pose_inv(np.stack([s[1] for s in samples])),
        "disps": np.stack([s[2] for s in samples]).astype(np.float32),
        "intrinsics": np.stack([s[3] for s in samples]).astype(np.float32),
        "ii": np.asarray(edges_ii),
        "jj": np.asarray(edges_jj),
    }


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--name", default="droid_torch")
    parser.add_argument("--ckpt", help="weights to start from (.npz or "
                                       ".pth)")
    parser.add_argument("--datasets", nargs="+", default=["tartan"])
    parser.add_argument("--datapath", default="datasets/TartanAir")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--iters", type=int, default=15)
    parser.add_argument("--steps", type=int, default=250000)
    parser.add_argument("--lr", type=float, default=0.00025)
    parser.add_argument("--clip", type=float, default=2.5)
    parser.add_argument("--n_frames", type=int, default=7)
    parser.add_argument("--w1", type=float, default=10.0)
    parser.add_argument("--w2", type=float, default=0.01)
    parser.add_argument("--w3", type=float, default=0.05)
    parser.add_argument("--fmin", type=float, default=8.0)
    parser.add_argument("--fmax", type=float, default=96.0)
    parser.add_argument("--edges", type=int, default=24)
    parser.add_argument("--restart_prob", type=float, default=0.2)
    parser.add_argument("--devices", type=int, default=None,
                        help="data-parallel ranks (GPUs, or CPU processes "
                             "with --device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the run (cuda or cpu)")
    parser.add_argument("--synthetic_clips", type=int, default=64,
                        help="clip-bank size for --datasets synthetic")
    parser.add_argument("--synthetic_step", type=float, default=0.22,
                        help="synthetic camera translation step "
                             "(motion difficulty)")
    parser.add_argument("--synthetic_rot_step", type=float, default=0.05,
                        help="synthetic camera rotation step")
    parser.add_argument("--image_size", type=int, nargs=2,
                        default=[384, 512],
                        help="clip resolution (the crop for tartan)")
    parser.add_argument("--ckpt_every", type=int, default=10000)
    parser.add_argument("--resume",
                        help="train state .pt to resume from (parameters, "
                             "optimizer, step, data generator)")
    parser.add_argument("--state_every", type=int, default=250,
                        help="resumable train-state checkpoint interval")
    parser.add_argument("--log_every", type=int, default=25,
                        help="per-step progress print interval (the "
                             "Logger's running means print every 100)")
    return parser


class Run:
    """One training run's state: parameters, optimizer, data and step; with
    ``dp`` (a ``parallel.mesh.DataParallel``) one rank's."""

    def __init__(self, args, dp=None):
        import torch
        from droid_slam_tpu_torch.models import weights as weights_io
        from droid_slam_tpu_torch.parallel import mesh as pmesh
        from droid_slam_tpu_torch.train.trainer import (TrainConfig,
                                                        init_train_state)

        self.args = args
        self.dp = dp
        self.device = dp.device if dp is not None else torch.device(
            args.device)
        self.cfg = TrainConfig(
            lr=args.lr, steps=args.steps, iters=args.iters, clip=args.clip,
            n_frames=args.n_frames, w1=args.w1, w2=args.w2, w3=args.w3,
            edges=args.edges, restart_prob=args.restart_prob,
            fmin=args.fmin, fmax=args.fmax)
        self.rng = np.random.default_rng(12345)
        self.total_steps = 0
        state = None
        if args.resume and os.path.exists(args.resume):
            params, opt_state, self.total_steps, rng_state = \
                weights_io.load_train_state(args.resume)
            state = opt_state
            if rng_state is not None:
                self.rng.bit_generator.state = rng_state
            print(f"resumed {args.resume} at step {self.total_steps}",
                  flush=True)
        else:
            params = weights_io.load(args.ckpt, "cpu") if args.ckpt else None
        self.params, self.opt = init_train_state(self.cfg, params=params,
                                                 device=self.device)
        if dp is not None:
            pmesh.replicate(self.params.values(), dp)
        if state is not None:
            self.opt.load_state_dict(state)
        self.db = self._dataset()
        # a frame graph may be cached only where db[idx] is the same clip
        # every time (the synthetic clips); TartanAir draws a new walk and
        # augmentation per call
        self.graph_cache = {} if "synthetic" in args.datasets else None

    def _dataset(self):
        a = self.args
        if "synthetic" in a.datasets:
            from droid_slam_tpu_torch.data.synthetic import SyntheticBox
            return SyntheticBox(n_clips=a.synthetic_clips,
                                n_frames=a.n_frames,
                                image_size=tuple(a.image_size),
                                step=a.synthetic_step,
                                rot_step=a.synthetic_rot_step)
        from droid_slam_tpu_torch.data.tartan import TartanAir
        return TartanAir(datapath=a.datapath, n_frames=a.n_frames,
                         fmin=a.fmin, fmax=a.fmax,
                         crop_size=tuple(a.image_size),
                         cache_dir=os.path.join(a.datapath, ".index_cache"))

    def next_batch(self):
        """The next batch as tensors on the run's device: with ``dp``, this
        rank's block of the global batch, which every rank draws alike."""
        import torch
        from droid_slam_tpu_torch.data.graph_utils import (
            build_frame_graph, graph_to_edge_list)
        from droid_slam_tpu_torch.parallel.mesh import shard_batch

        a, N = self.args, self.args.n_frames
        idx = self.rng.integers(0, len(self.db), size=a.batch)
        samples = [self.db[int(i)] for i in idx]
        if self.rng.random() < 0.5:
            k = int(idx[0])
            cache = self.graph_cache
            graph = cache.get(k) if cache is not None else None
            if graph is None:
                s0 = samples[0]
                graph = build_frame_graph(s0[1], s0[2], s0[3], num=a.edges)
                if cache is not None:
                    cache[k] = graph
        else:
            graph = {i: [j for j in range(N) if i != j and abs(i - j) <= 2]
                     for i in range(N)}
        ii, jj, _ = graph_to_edge_list(graph)
        batch = collate(samples, ii, jj)
        if self.dp is not None:
            batch = shard_batch(batch, self.dp)
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def step(self, batch):
        from droid_slam_tpu_torch.train.trainer import train_step
        metrics = train_step(self.params, self.opt, batch, self.total_steps,
                             self.cfg, dp=self.dp)
        self.total_steps += 1
        return metrics

    def save_npz(self, path):
        from droid_slam_tpu_torch.models import weights as weights_io
        weights_io.save_npz(path, self.params)

    def save_state(self, path):
        from droid_slam_tpu_torch.models import weights as weights_io
        weights_io.save_train_state(path, self.params, self.opt.state_dict(),
                                    self.total_steps,
                                    self.rng.bit_generator.state)


def train(args, dp=None):
    """The training loop; with ``dp``, one rank's (rank 0 logs and writes
    the checkpoints)."""
    from droid_slam_tpu_torch.train.logger import Logger

    run = Run(args, dp)
    lead = dp is None or dp.rank == 0
    logger = Logger(args.name, total_steps=run.total_steps)
    os.makedirs("checkpoints", exist_ok=True)
    state_path = f"checkpoints/{args.name}_state_{{}}.pt"

    while run.total_steps < args.steps:
        t0 = time.perf_counter()
        try:
            metrics = run.step(run.next_batch())
        except Exception:
            # keep a resumable state before the failure propagates
            try:
                if lead:
                    run.save_state(state_path.format("crash"))
                    print(f"saved crash state at step {run.total_steps}",
                          flush=True)
            except Exception:
                pass
            raise
        if not lead:
            continue
        logger.push(metrics)
        n = run.total_steps
        if n <= 5 or n % args.log_every == 0:
            print(f"step {n:6d}  loss {metrics['loss']:.4f}  "
                  f"rot {metrics['rot_error']:.3f}  "
                  f"f_err {metrics['f_error']:.3f}  "
                  f"nanfrac {metrics['grad_nanfrac']:.4f}  "
                  f"restarts {metrics['restarts']}  "
                  f"{time.perf_counter() - t0:.2f}s", flush=True)
        if n % args.ckpt_every == 0:
            run.save_npz(f"checkpoints/{args.name}_{n:06d}.npz")
        if n % args.state_every == 0:
            run.save_state(state_path.format("latest"))

    if lead:
        run.save_npz(f"checkpoints/{args.name}_final.npz")
        run.save_state(state_path.format("final"))


def rank_plan(args):
    """(devices, backend) of ``--devices N``: cuda:0..N-1 with NCCL, which
    raises when the machine has fewer cards, or N CPU ranks with gloo."""
    import torch
    from droid_slam_tpu_torch.parallel.mesh import data_parallel_mesh

    if torch.device(args.device).type == "cuda":
        return data_parallel_mesh(args.devices).devices, "nccl"
    return [torch.device("cpu")] * args.devices, "gloo"


def run_ranks(args, devices, backend):
    """Train on ``len(devices)`` ranks, rank r on devices[r] (they may
    repeat): rank 0 in this process when it is the only one, else one
    spawned process each. A rank's failure raises here."""
    import torch.multiprocessing as mp
    from droid_slam_tpu_torch.parallel.mesh import free_port

    if args.batch % len(devices):
        raise ValueError(f"--batch {args.batch} does not divide over "
                         f"{len(devices)} ranks")
    init = f"tcp://localhost:{free_port()}"
    rank_args = (args, list(devices), backend, init)
    if len(devices) == 1:
        rank_main(0, *rank_args)
    else:
        mp.spawn(rank_main, args=rank_args, nprocs=len(devices), join=True)


def rank_main(rank, args, devices, backend, init_method):
    """One rank of ``run_ranks``: join the group, train, leave."""
    from droid_slam_tpu_torch.parallel import mesh as pmesh

    dp = pmesh.init_data_parallel(rank, len(devices), backend, devices[rank],
                                  init_method=init_method)
    try:
        train(args, dp)
    finally:
        pmesh.shutdown_data_parallel()


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("train_torch.py: CUDA is not available; pass "
                         "--device cpu to train on the CPU")
    if args.devices is None:
        train(args)
    else:
        run_ranks(args, *rank_plan(args))


if __name__ == "__main__":
    main()
