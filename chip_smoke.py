#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (nvcc, sm_90a), holds each kernel
against its plain PyTorch twin at the main path's shapes, then drives the
port's main paths at full network width on the bench's rolled-noise frames,
with the trained weights:

  track         monocular ``Droid.track()`` at 320x512 in the default
                configuration (corr lookup kernel; the GRU's plain
                epilogues), on the strict path (``fused_frame=False``, as
                this phase, track_fused and track_edge_parallel ran before
                the frame path existed);
  track_fused   the same frames with ``gru_fused_epilogue=True`` (all three
                kernels), 2 of its frames profiled;
  terminate     ``terminate(stream=...)`` on the track_fused instance: two
                global-BA passes (7 and 12 steps) and the trajectory filler
                over the bench's filler stream (GRU epilogues and lookup);
  track_frame   the frame path (``slam/fused_frame.py``: two frame programs
                a frame, replayed as CUDA graphs) on track_fused's frames
                and configuration: strict-frame and speculative runs timed
                (2 speculative frames profiled), then, with deterministic
                kernels, the speculative programs replayed against the
                same programs run eagerly on the card, held to
                FRAME_GRAPH_TOL, all three kernels launched inside the
                graphs. track_stereo, track_rgbd, evaluate and
                track_async_process_frame take the CUDA default (the frame
                path, without speculation) and print which path ran; the
                ``_strict`` phases, the other asynchronous phases
                (ASYNC_FUSED_FRAME) and track_edge_parallel the strict one;
  track_stereo, track_stereo_strict
                EuRoC stereo: the euroc preset at 320x512 with
                ``stereo=True`` and ``gru_fused_epilogue=True``, then
                ``terminate()`` with the filler on the stereo stacks; the
                graph must hold stereo (i, i) edges; on the frame path,
                then on the strict path (``fused_frame=False``);
  track_rgbd, track_rgbd_strict
                TUM RGB-D: the tum preset at 240x320 with a depth map per
                frame and ``upsample=True`` (default epilogues), then
                ``terminate()``; the keyframes must carry sensor
                disparities and full-resolution ``disps_up``; on both
                paths, as stereo;
  evaluate      evaluation_scripts/test_synthetic_torch.py's ``run`` at its
                defaults (the tartanair preset at 320x512, 120 synthetic
                frames, seed 7, buffer 256; the frame path): tracking,
                ``terminate()``, and
                the ATE to the exact ground truth within EVAL_ATE_BOUND;
                then the reconstruction of its final video:
                ``depth_filter`` and ``iproj_points`` on the card against
                the CPU (EVAL_COUNT_SHARE, EVAL_POINT_RTOL) and timed, the
                ``.npz`` -> ``view_reconstruction_torch.py`` -> PLY round
                trip and the screenshot (a PNG decoded here and equal to
                the render, above SHOT_FLOOR of non-background pixels), in
                a temporary directory that is removed;
  track_async_ref, track_async, track_async_process
                ``make_droid`` on N_ASYNC frames at 320x512 (the noise
                texture through a sliding window) with the fused
                epilogues: the synchronous ``Droid`` (the reference), then
                ``DroidAsync`` (global BA in a thread on its own CUDA
                stream) and ``DroidAsyncProcess`` (global BA in a spawned
                process, state in CUDA-shared tensors), each followed by
                ``terminate(stream)``. Each asynchronous facade must run at
                least 2 backend cycles before ``terminate()``, and its
                backend's poses must match its cycles replayed by hand
                from the inputs each merged, to REPLAY_POSE_TOL, where a
                replay with no BA step must not; its ATE to the
                reference's trajectory is printed. These phases run
                PyTorch's deterministic kernels;
  track_async_process_frame
                ``DroidAsyncProcess`` as above on the frame path (graph
                replays): its backend's cycles before ``terminate()`` are
                printed, not held (the faster tracker may outrun them); it
                must run a cycle, and its replay is held as above.
  train         train_torch.py's Run at its published configuration
                (TRAIN_ARGV: synthetic clips at 384x512, 7 frames, 24
                edges, 15 iterations, batch 4, bf16, restarts at 0.2) from
                the trained weights: one warm-up step, N_TRAIN_TIMED timed
                steps, one profiled step (device-busy share, top ops);
                every loss and metric finite, no non-finite gradient,
                every parameter moved and finite; the .npz read back bit
                for bit; the state saved, resumed and stepped once equal
                to one uninterrupted step (restart_prob 0, deterministic
                kernels, one sample through RESUME_ITERS iterations);
  train_parity  sample_loss and its gradient on the card against the CPU
                port on the same inputs (PARITY_*, f32, TF32 off), to the
                JAX package's own bounds (PARITY_TOL);
  track_edge_parallel
                ``DroidConfig(edge_parallel=2)`` with the fused epilogues
                on a mesh of two shards that both sit on the card
                (EP_DEVICES): all three kernels inside the sharded update;
                30 frames at 320x512 of JAX's edge-parallel test scene
                (EP_SCENE), held to the serial frontend on the same frames
                (equal keyframes and edges, poses and disparities to
                EP_TOL; both with deterministic kernels); the edges per
                shard; then, printed and not held, the same two runs on
                track_fused's rolled-noise frames beside a serial run
                whose GraphAgg sums are one unit in the last place
                larger (how far rounding of that size carries them);
  global_ba_mesh
                one ``update_lowmem`` step from that tracker's state, each
                on a fresh copy of the video: the mesh's chunks split over
                EP_DEVICES held to the same chunks on one shard
                (GBA_MESH_TOL), and the serial sweep held to that step
                (poses GBA_MESH_TOL, disparities GBA_WITNESS_X times a
                last-bit witness's gap);
  train_dp      data-parallel training at TRAIN_DP_ARGV: ``--devices 1``
                (a real NCCL group of one rank) equal bit for bit to the
                plain step on the same batch, then DP_WORLD spawned ranks
                sharing the card through gloo, one sample each, held to
                the plain step on the batch of 2 (TRAIN_DP_TOL), and
                their averaged gradients to the mean of each rank's block
                stepped alone; each rank's device and backend.
The training phases launch none of the three kernels, as JAX's training
forward runs none of its Pallas kernels; they print that (nor the
global BA's alt_corr). The machine has
one card, so the multi-device phases show the sharded arithmetic and the
NCCL path, not a speed on several cards.

The two input modes see one scene: a right view shifted by STEREO_SHIFT px
(whole feature pixels) and the depth of the fronto-parallel plane that shift
means for the rectified 0.1 baseline, depth = fx * 0.1 / STEREO_SHIFT. Each
mode's tracked median disparity must land within PLANE_DISP_TOL of the
plane's. Both use the bench's thresholds (every frame admitted and kept)
and its warm-up of 8. The lookup kernel is held against its twin at both
feature-map sizes, 40x64 and 30x40; the on-the-fly correlation kernel
(alt_corr, the global BA's) against its twin and timed at the largest
sweep chunk of the tum cell (as many edges as the sweep's cap allows at
30x40); the frame-distance kernel (frame_distance, the global BA
proposal's) against its twin and timed over every pair of the tum cell's
512 keyframes at 30x40.

Before the paths, ``ba_global`` runs the BA alone at the JAX package's
t=800 global-BA size (800 keyframes, 12802 edges, 30x40 plane, 2 GN
iterations) and prints its seconds per iteration and peak memory; then
``global_ba_tum512`` runs the whole global BA (``DroidBackend``: the
proposal over all t^2 pairs, the alt-correlation sweeps, the BA) at the
tum preset's buffer, 512 keyframes of tools/bench_global_ba_torch.py's
synthetic video at 240x320, one pass of 2 steps: it holds GBA_PAIRS
frame distances on the card to the CPU port, counts the proposal's
distance calls (one frame_distance launch a pass), checks the state's
health, and prints the edges, the stage times, seconds per step and peak
memory. Its proposals launch the frame-distance kernel and its sweeps the
on-the-fly correlation kernel (alt_corr), no other, and it fails without
either.

Kernel times count device time only (``_time_ms``), with the wrappers' host
microseconds per call beside them. Each path runs with the kernels' launch
counts set to 0 just before it and read just after, and fails if a kernel
of its path was not launched (the asynchronous paths: in tracking and in the
filler, each). Phases
print one JSON line each; then the kernel table, the card's name and power
limit, and a last line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. The run has a hard deadline. It imports neither
JAX nor the JAX package (nor cv2, Open3D or moderngl), and writes nothing
but the kernel build under droid_slam_tpu_torch/build/ and the evaluate and
training phases' temporary files, which it removes.
"""

import contextlib
import faulthandler
import json
import os
import signal
import subprocess
import sys
import time

sys.dont_write_bytecode = True  # the run writes nothing but the kernel build

# the script's own deadline, a guard against a hang: the run read 385-501 s
# before the strict stereo and RGB-D runs and the process facade on the
# frame path came, 648 s with them, and its host-bound phases vary by ~20%
# between calls (NVIDIA H100 80GB HBM3, 700 W); the run must end within
# 1200 s
DEADLINE_S = 900
ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "r5_006000.npz")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
H, W = 320, 512
N_WARM, N_TIMED, N_PROF = 16, 12, 2
BACKEND_STEPS = (7, 12)
GRU_E = 48                     # the frontend's active edges at 320x512
BA_T, BA_E, BA_PLANE, BA_ITERS = 800, 12802, (30, 40), 2  # global BA, t=800
# card against CPU at T=64 (well posed): f32 against f64 on the CPU differs
# by 1.4e-5 (poses) and 4.8e-4 (relative disparity); bounds 14x and 20x that
BA_CPU_TOL = {"pose": 2e-4, "disp_rel": 1e-2}
# px between the left and right views: six feature pixels, a plane of
# disparity 1.5 at 320x512, 1.5x from the tracker's initial disparity of 1,
# so only the stereo edges bring its median within PLANE_DISP_TOL (at 16 px,
# disparity 0.5, the stereo constraint is weak: two runs landed at 1.5x and
# 3.4x of the plane)
STEREO_SHIFT = 48
RGBD_SIZE = (240, 320)         # the tum preset's image size
# the asynchronous phases: enough frames at 320x512 for the backend, which
# starts after 32 keyframes, to run at least 2 cycles of ASYNC_ITERS global-BA
# steps before terminate(), with ASYNC_SLEEP s between cycles: 88 frames
# of cycles of 4 steps (128 frames until the evaluate phase came, 96 of
# 8 steps until the track_frame phase came; cut to keep the script inside
# its deadline: the three phases took 183 and 243 s of two 96-frame calls,
# the second call ran past 600 s). In a 128-frame run 7 of the thread's
# cycles and 5 of the process's had read no keyframe past the 96th; at 80
# frames of 8 steps the process ran 1 cycle before terminate(), at 72 of 4
# steps 2, the thread 4 (NVIDIA H100 80GB HBM3, 700 W)
N_ASYNC, ASYNC_BUFFER, ASYNC_SLEEP, ASYNC_ITERS = 88, 160, 1.0, 4
# the asynchronous phases that hold 2 backend cycles before terminate()
# track on the strict path: on the frame path the tracker outran the thread
# facade's backend (96 frames tracked while it ran 1 of its 3 cycles; its
# replay held exactly), so 2 cycles would need other frame counts and
# sleeps than the earlier records of these phases (NVIDIA H100 80GB HBM3,
# 700 W; ROADMAP.md §1 item 11). track_async_process_frame runs the
# process facade on the CUDA default, the frame path, and prints its cycles
ASYNC_FUSED_FRAME = False
# bound on the largest gap between an asynchronous facade's backend poses
# (after its last cycle) and those of the same cycles replayed by hand from
# the inputs each merged (``_replay``). With PyTorch's deterministic kernels
# the card read exactly 0 for both facades, against 9.0 and 114 for a
# replay with no BA step and 4.5 and 2.2e8 for the merge without alignment
# (NVIDIA H100 80GB HBM3, 700 W); the bound admits f32 rounding of poses
# of size ~10 and nothing more
REPLAY_POSE_TOL = 1e-5
# the track_frame phase: bound on the largest pose and disparity gap of the
# frame programs replayed as CUDA graphs against the same programs run
# eagerly on the card, both with deterministic kernels: the same kernels
# on the same inputs, so 0
FRAME_GRAPH_TOL = 0.0
# the frame path's timed runs warm up over more frames than the others:
# its graphs are captured as the sticky sizes grow (the probe's pairs at
# the 3rd frame-path frame, a frame's new edges at the 8th, the inactive
# edges at the 14th, at 64x96 on the CPU)
FRAME_WARM = 24
# the held pair's frames: 13 on the frame path, 4 of them capturing (the
# last at the 13th) and 9 replayed
FRAME_HELD = 22
# the plane's disparity 1/depth, which the sensor (RGB-D) or the fixed
# stereo baseline determines: the tracked median disparity must land within
# this factor of it
PLANE_DISP_TOL = 1.25
# the training phase: train_torch.py at its published configuration (the
# synthetic box clips at train.py's default 384x512, 7 frames, --edges 24,
# 15 iterations, batch 4, bf16, restarts at 0.2) from the trained weights
TRAIN_ARGV = ["--datasets", "synthetic", "--ckpt", CKPT, "--device", "cuda",
              "--image_size", "384", "512", "--n_frames", "7", "--edges",
              "24", "--iters", "15", "--batch", "4", "--restart_prob", "0.2",
              "--synthetic_clips", "4"]
N_TRAIN_TIMED = 1   # 3 until the multi-device phases came
# the save-and-resume check, with deterministic kernels, steps one sample
# of the batch through RESUME_ITERS iterations; the ops of one sample
# through ATTR_ITERS iterations are attributed by aten op
RESUME_ITERS = ATTR_ITERS = 2
# sample_loss on the card against the CPU port, at the scene of
# tests/test_torch_train_loss.py (N=4 at 48x64, 2 iterations, f32, TF32
# off); the bounds of the JAX package's scan-against-unrolled test
PARITY_N, PARITY_SIZE, PARITY_SEED, PARITY_ITERS = 4, (48, 64), 5, 2
PARITY_TOL = {"loss_rel": 2e-4, "grad_rel": 1e-2}
# the three kernels' TPU originals are inference-only: JAX's training
# forward reaches none of them (droid_slam_tpu/ops/gru_pallas.py:27-28,
# droid_slam_tpu/models/nets.py:166-167,185; its lookup is
# droid_slam_tpu/ops/corr.py:459-472), and the port's runs their plain
# versions under autograd
# the evaluate phase: evaluation_scripts/test_synthetic_torch.py's run at its
# own defaults (the tartanair preset at 320x512, 120 frames of the synthetic
# box scene, seed EVAL_SEED, buffer 256, filter_thresh 1.75, backend steps
# (7, 12)) with the trained weights
EVAL_ARGV = ["--weights", CKPT, "--device", "cuda"]
EVAL_SEED = 7
# bound on its ATE RMSE to the exact ground truth, in scene units: the
# trajectory spans ~2 units (0.88 x 0.85 x 2.23 for seed 7); random weights
# read 0.93 or diverge (ACCURACY.md), and the trained checkpoint read
# 0.024-0.056 on the JAX package's 80-frame 160x240 sequences; the bound is
# a tenth of the extent, 4.6x below the random weights' reading
EVAL_ATE_BOUND = 0.2
# depth_filter on the card against the CPU on the run's final video: the
# share of pixels whose count may differ (a warped pixel that lands at a
# threshold's or a pixel's edge, where the last bit of f32 decides), and
# iproj_points' gap relative to each point's size (f32 rounding)
EVAL_COUNT_SHARE = 1e-3
EVAL_POINT_RTOL = 1e-5
# the screenshot (480x640): its share of pixels that are not the background
SHOT_FLOOR = 0.02
SHOT_BACKGROUND = (22, 22, 25)  # render_offscreen's background, RGB
# the global_ba_tum512 phase: tools/bench_global_ba_torch.py's synthetic
# video filling the tum preset's buffer (512 keyframes at 240x320) and
# one DroidBackend pass of 2 steps; its proposal over all 512^2 pairs is
# GBA_DIST_CALLS frame_distance launch. The frame distance of GBA_PAIRS
# random pairs of distinct frames on the card against the CPU port: f32
# sums of 1200 pixels in another order, to GBA_DIST_RTOL;
# the quaternions stay unit to GBA_QUAT_TOL (f32 rounding: 3.6e-7 at t=500,
# NVIDIA H100 80GB HBM3, 700 W)
GBA_STEPS = (2,)   # passes of 2 and 2 steps until the multi-device phases
GBA_DIST_CALLS = 1
GBA_PAIRS, GBA_DIST_RTOL, GBA_QUAT_TOL = 4096, 1e-4, 1e-5
# the global BA's kernels: the proposal's frame distance and the sweep's
# on-the-fly correlation
GBA_KERNELS = ["alt_corr", "frame_distance"]
GBA_KERNEL_NOTE = ("alt_corr and frame_distance only, by design: the "
                   "global BA correlates on the fly (alt_lookup, XLA in JAX, "
                   "not Pallas), its proposal's distance is one kernel over "
                   "every pair (XLA in JAX), and its sweep runs the update "
                   "operator without the fused epilogues "
                   "(droid_slam_tpu/state/graph.py:522-565)")
# the tracking paths' kernels; alt_corr and frame_distance are the global
# BA's (the frame programs compute their distances with the plain twin;
# a tracking path launches frame_distance only from DepthVideo.distance:
# the strict path's proposals, a frame-path proposal whose probe missed,
# and the global BA of terminate())
TRACK_KERNELS = ["corr_lookup", "gru_epilogue_a", "gru_epilogue_b"]
# the alt_corr phase: the largest sweep chunk of tum_mono.global_ba, as
# many edges as state/graph.py::SWEEP_EDGE_PIXELS allows at 30x40 (873;
# the cell's chunks hold up to 868 of its 8194 edges, 10 chunks a step),
# from the ALT_SPAN consecutive source frames such a chunk spans (512
# keyframes in 10 chunks), into a pyramid of the tum buffer's ALT_FRAMES
# keyframes; the kernel's bound (docstring of tests/test_torch_alt_corr.py)
ALT_SPAN, ALT_FRAMES, ALT_PLANE = 52, 512, (30, 40)
# the frame_distance phase: the proposal of tum_mono.global_ba, every pair
# of the tum buffer's 512 keyframes (the tool's synthetic walk) at 30x40,
# held to the plain twin run in DepthVideo._DIST_CHUNK chunks, as
# tests/test_torch_frame_distance.py holds it (FD_ATOL px, FD_RTOL_PIXEL,
# 2 gamma_n of the sums; at most FD_SHARE_NEAR_CUT of the pairs beyond,
# those with a pixel at the depth cut); the kernel's operations per pixel
# and direction, a division or square root counted as one
# (csrc/frame_distance.cu)
FD_T, FD_PLANE = 512, (30, 40)
FD_ATOL, FD_RTOL_PIXEL, FD_SHARE_NEAR_CUT = 1e-4, 1e-5, 1e-3
FD_OPS_PER_PIXEL_DIRECTION = 72
# the multi-device phases: the edge-parallel frontend and the chunk-parallel
# global BA on a mesh of two shards that both sit on the one card, held as
# JAX holds its own (tests/test_edge_parallel_mode.py: the largest se3 log
# of the pose differences, the mean disparity gap; __graft_entry__.py:
# 254-255); data-parallel training with train_torch.py's published
# configuration at batch 2 (restarts off), DP_WORLD gloo ranks on the card
# held to the plain step at JAX's data-parallel bounds
# (tests/test_train_step.py:237-241)
EP_DEVICES = ("cuda:0", "cuda:0")
EP_TOL = {"pose_log": 3e-2, "disp_mean": 0.15}
# the edge-parallel comparison's scene: JAX's (the synthetic box stream of
# tests/test_edge_parallel_mode.py) at 320x512, N_WARM + N_TIMED + N_PROF
# frames. The bench's rolled noise amplifies rounding: there two shards
# and the serial update part in their edges (first card run), and on the
# CPU at 64x96 by 0.15 in poses, while one shard equals the serial update
# bit for bit. The phase prints those frames' gaps beside a witness (the
# serial run with its GraphAgg sums one unit in the last place larger)
# and holds only the box scene
EP_SCENE = dict(n_frames=N_WARM + N_TIMED + N_PROF, seed=11, step=0.12,
                rot_step=0.04)
GBA_MESH_TOL = {"poses": dict(rtol=2e-4, atol=2e-4),
                "disps": dict(rtol=2e-3, atol=2e-4)}
# the serial sweep against the mesh's chunks on one shard: its chunks hold
# other numbers of edges, and the card's bf16 convolutions round another
# batch otherwise (one chunk against four moved the disparities by 1.7e-3
# on an H100 at t=30, 320x512, where the split over two shards moved them
# by 5e-5); held to GBA_WITNESS_X times the gap of the one-shard step
# whose correlation is one unit in the last place larger, as
# tests/test_torch_alt_corr.py holds the kernel's step to its twin's
GBA_WITNESS_SCALE, GBA_WITNESS_X = 1 + 2.0 ** -22, 3.0
TRAIN_DP_ARGV = TRAIN_ARGV + ["--batch", "2", "--restart_prob", "0"]
DP_WORLD, DP_TIMEOUT_S, DP_JOIN_S = 2, 300.0, 240.0
TRAIN_DP_TOL = {"rtol": 2e-4, "atol": 2e-5, "loss_rel": 1e-4,
                "grad_rel": 1e-4}
TRAIN_KERNEL_NOTE = ("0 launches by design: the training forward runs the "
                     "plain lookup and GRU under autograd, as JAX's runs "
                     "none of its Pallas kernels (droid_slam_tpu/ops/"
                     "gru_pallas.py:27-28, droid_slam_tpu/ops/corr.py:"
                     "459-472)")


_T0 = time.perf_counter()


def emit(**kw):
    """One JSON line; a phase's line carries the seconds since the script
    started (``t_s``), so each phase's share of the run can be read."""
    if "phase" in kw:
        kw["t_s"] = round(time.perf_counter() - _T0, 3)
    print(json.dumps(kw), flush=True)


def _deadline(signum, frame):
    import multiprocessing
    print(json.dumps({"phase": "deadline", "ok": False,
                      "msg": f"past the {DEADLINE_S} s deadline"}),
          flush=True)
    for child in multiprocessing.active_children():
        child.kill()
    os._exit(124)


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()[:200]}"


def _time_ms(fn, n=25):
    """(device ms per call, host µs per call) of fn(), after a warm-up.

    Every function is timed one way: the summed time of the kernels and
    copies that n calls run on the card (torch.profiler's device time),
    over n. It holds no host time and no gap between kernels, whether fn
    is one kernel, a chain of small ones, or waits for the card inside.
    The host time is the wall time of the n calls' enqueue over n, with
    the profiler off: the wrapper's Python, its allocations and its
    launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - tic) / n * 1e6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type != DeviceType.CPU)
    if not device_us > 0:
        raise AssertionError("the profiler saw no device time")
    return device_us / 1e3 / n, host_us


def library_lookup(pyramid, slots, coords, radius=3):
    """The window lookup through PyTorch's own bilinear sampler (RAFT's
    CorrBlock does it so): per level, gather the edges' volumes, cast them
    to f32 and ``grid_sample`` the 7x7 offsets around coords/2^l, corners
    outside the map at zero. Only timed and checked here; the port calls
    the kernel."""
    import torch
    import torch.nn.functional as F

    EA, HW, _ = coords.shape
    rd = 2 * radius + 1
    off = torch.arange(-radius, radius + 1, device=coords.device,
                       dtype=torch.float32)
    outs = []
    for lvl, vol in enumerate(pyramid):
        _, _, h2, w2 = vol.shape
        c = coords / 2.0 ** lvl
        gx = (c[..., 0, None, None] + off[:, None]) * (2.0 / (w2 - 1)) - 1
        gy = (c[..., 1, None, None] + off[None, :]) * (2.0 / (h2 - 1)) - 1
        grid = torch.stack(torch.broadcast_tensors(gx, gy), dim=-1)
        inp = vol.index_select(0, slots).reshape(EA * HW, 1, h2, w2).float()
        # grid rows are x offsets, so the flattened window is x-offset-major
        out = F.grid_sample(inp, grid.reshape(EA * HW, rd, rd, 2),
                            mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        outs.append(out.reshape(EA, HW, rd * rd))
    return torch.cat(outs, dim=-1)


def check_lookup(dev, h, w, timed):
    """The corr-window lookup kernel against its plain twin, and PyTorch's
    ``grid_sample`` against the same twin, at the frontend update's shapes:
    48 active edges over 64 volume slots, 4 levels of an h x w feature map
    (40x64 for the 320x512 paths; 30x40 for track_rgbd's 240x320, whose
    coarser levels 15x20, 7x10 and 3x5 have odd sides). Returns the
    kernel's table row (without launches), with its times when
    ``timed``."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.ops import corr as corr_ops
    from droid_slam_tpu_torch.ops import corr_cuda

    EB, EA = 64, 48
    HW = h * w
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    slots = torch.as_tensor(rng.permutation(EB)[:EA].astype(np.int32),
                            device=dev)
    coords = torch.as_tensor(
        (rng.uniform(size=(EA, HW, 2)) * np.array([w + 8, h + 8]) - 4)
        .astype(np.float32), device=dev)
    vol0 = torch.randn((EB, HW, h, w), generator=gen, device=dev)
    row = {}
    for dtype, atol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        pyr = [vol0.to(dtype)]
        for _ in range(corr_ops.NUM_LEVELS - 1):
            pyr.append(corr_ops.avg_pool2(pyr[-1]))
        got = corr_cuda.lookup_pyramid_slots(pyr, slots, coords)
        want = corr_ops.lookup_pyramid_plain(pyr, slots, coords)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= atol:
            raise AssertionError(f"lookup kernel ({dtype}) differs from its "
                                 f"plain twin by {err} > {atol}")
        lib_err = float((library_lookup(pyr, slots, coords) - want)
                        .abs().max())
        if not lib_err <= atol:
            raise AssertionError(f"grid_sample lookup ({dtype}) differs from "
                                 f"the plain twin by {lib_err} > {atol}")
        if dtype == torch.bfloat16 and not timed:
            row.update(max_abs_err=err, library_max_abs_err=lib_err)
        elif dtype == torch.bfloat16:
            ms, host_us = _time_ms(
                lambda: corr_cuda.lookup_pyramid_slots(pyr, slots, coords))
            plain_ms, _ = _time_ms(
                lambda: corr_ops.lookup_pyramid_plain(pyr, slots, coords),
                n=5)
            library_ms, _ = _time_ms(
                lambda: library_lookup(pyr, slots, coords), n=5)
            # bytes: output + coords + slots + the volume elements the
            # windows touch (in-range taps of each 8x8 neighbourhood)
            touched = 0
            for lvl, v in enumerate(pyr):
                c = coords / 2.0 ** lvl
                lo = torch.floor(c) - 3
                nx = ((lo[..., 0] + 8).clamp(max=v.shape[3])
                      - lo[..., 0].clamp(min=0)).clamp(0, 8)
                ny = ((lo[..., 1] + 8).clamp(max=v.shape[2])
                      - lo[..., 1].clamp(min=0)).clamp(0, 8)
                touched += int((nx * ny).sum())
            nbytes = (got.numel() * 4 + coords.numel() * 4 + EA * 4
                      + touched * pyr[0].element_size())
            ops = EA * HW * len(pyr) * (49 * 7 + 8)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / F32_FLOPS_PER_S * 1e3
            row.update(max_abs_err=err, ms=ms, host_us=host_us,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_max_abs_err=lib_err,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes)
        else:
            row.update(max_abs_err_f32=err, library_max_abs_err_f32=lib_err)
    del vol0
    torch.cuda.empty_cache()
    return row


def check_alt_corr(dev):
    """The on-the-fly correlation kernel against its plain twin at the
    largest sweep chunk of the tum cell (SWEEP_EDGE_PIXELS // h*w edges
    from ALT_SPAN consecutive keyframes to keyframes within 12 of them, in
    a pyramid of ALT_FRAMES keyframes at ALT_PLANE; the warped coordinates
    within a few pixels of the source pixel, some off the map), held to
    the f32 summation bound of
    tests/test_torch_alt_corr.py. Returns the kernel's table row (without
    launches), timed against its bound and the twin."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.ops import alt_corr_cuda
    from droid_slam_tpu_torch.ops import corr as corr_ops
    from droid_slam_tpu_torch.state.graph import SWEEP_EDGE_PIXELS

    h, w = ALT_PLANE
    HW = h * w
    E = SWEEP_EDGE_PIXELS // HW
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    pyr = corr_ops.build_fmap_pyramid(torch.randn(
        (ALT_FRAMES, 128, h, w), generator=gen, device=dev)
        .to(torch.bfloat16))
    ii = rng.integers(200, 200 + ALT_SPAN, E)
    jj = ii + rng.choice([-12, -6, -3, -2, -1, 1, 2, 3, 6, 12], E)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([xs, ys], -1).reshape(1, HW, 2)
    coords = torch.as_tensor(
        (grid + rng.normal(scale=3.0, size=(E, HW, 2))).astype(np.float32),
        device=dev)
    ii_t = torch.as_tensor(ii, device=dev)
    jj_t = torch.as_tensor(jj, device=dev)
    kernel = lambda: alt_corr_cuda.alt_lookup(pyr, coords, ii_t, jj_t)
    plain = lambda: corr_ops.alt_lookup(pyr, coords, ii_t, jj_t)
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    norm = max(float(p.float().norm(dim=-1).max()) for p in pyr)
    u = 2.0 ** -24
    atol = (2 * 128 * u / (1 - 128 * u) * norm * norm / 16
            + 8 * u * float(want.abs().max()))
    if not err <= atol:
        raise AssertionError(f"alt_corr kernel differs from its plain twin "
                             f"by {err} > {atol}")
    ms, host_us = _time_ms(kernel)
    plain_ms, _ = _time_ms(plain, n=3)
    # operations: 128 multiply-adds per grid point, 64 points a level;
    # bytes, each read once: the source frames' level-0 rows, the target
    # frames' maps at every level, coords, rows and the f32 output
    ops = 2 * E * HW * len(pyr) * 64 * 128
    per_frame = sum(p[0].numel() * p.element_size() for p in pyr)
    nbytes = (len(np.unique(ii)) * pyr[0][0].numel() * 2
              + len(np.unique(jj)) * per_frame + coords.numel() * 4
              + 2 * E * 8 + got.numel() * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    del pyr, got, want
    torch.cuda.empty_cache()
    return dict(edges=E, source_frames=ALT_SPAN, plane=list(ALT_PLANE),
                max_abs_err=err, atol=atol,
                ms=ms, host_us=host_us, plain_ms=plain_ms,
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=ops)


def check_gru(dev):
    """Both GRU epilogue kernels against their plain twins at the frontend
    update's shapes (48 edges, 40x64), bf16 and f32. Returns their table
    rows (without launches)."""
    import torch
    from droid_slam_tpu_torch.ops import gru as gru_ops
    from droid_slam_tpu_torch.ops import gru_cuda

    E, h, w = GRU_E, H // 8, W // 8
    HW = h * w
    gen = torch.Generator(device=dev).manual_seed(1)

    def planes(c, dtype, scale=2.0):
        return (scale * torch.randn((E, c, h, w), generator=gen,
                                    device=dev)).to(dtype)

    rows = {"gru_epilogue_a": {}, "gru_epilogue_b": {}}
    for dtype, atol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        zrc, cf, pre_zr = planes(256, dtype), planes(384, dtype), \
            planes(256, dtype)
        qc, pre_q = planes(128, dtype), planes(128, dtype)
        net = torch.tanh(planes(128, dtype))
        z = torch.sigmoid(planes(128, dtype))
        gzr = (2.0 * torch.randn((E, 256), generator=gen, device=dev)) \
            .to(dtype)
        gq = gzr[:, :128].contiguous()
        args = {"gru_epilogue_a": (zrc, cf, pre_zr, net, gzr),
                "gru_epilogue_b": (qc, cf, pre_q, net, z, gq)}
        fns = {"gru_epilogue_a": (gru_cuda.gru_epilogue_a,
                                  gru_ops.gru_epilogue_a_plain),
               "gru_epilogue_b": (gru_cuda.gru_epilogue_b,
                                  gru_ops.gru_epilogue_b_plain)}
        for name, (kernel, plain) in fns.items():
            got, want = kernel(*args[name]), plain(*args[name])
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(float((g.float() - x.float()).abs().max())
                      for g, x in zip(got, want))
            if not err <= atol:
                raise AssertionError(f"{name} kernel ({dtype}) differs from "
                                     f"its plain twin by {err} > {atol}")
            if dtype == torch.float32:
                rows[name].update(max_abs_err_f32=err)
                continue
            a = args[name]
            ms, host_us = _time_ms(lambda: kernel(*a))
            plain_ms, _ = _time_ms(lambda: plain(*a))
            # bytes: the channels each function reads (A: zrc, cf[:256],
            # pre_zr, net; B: qc, cf[256:], pre_q, net, z) and writes
            # (A: z, r*net; B: the new state), plus the gate biases;
            # operations: ~16 (A) and ~12 (B) f32 flops per output element
            ch_in, ch_out, flops = ((256 * 3 + 128, 256, 16)
                                    if name == "gru_epilogue_a" else
                                    (128 * 5, 128, 12))
            nbytes = (E * HW * (ch_in + ch_out) * net.element_size()
                      + a[-1].numel() * a[-1].element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = E * 128 * HW * flops / F32_FLOPS_PER_S * 1e3
            rows[name].update(
                max_abs_err=err, ms=ms, host_us=host_us, plain_ms=plain_ms,
                library_ms=None,
                library_why="no single PyTorch call computes a 4-way sum, "
                            "an activation and a product",
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes)
    emit(phase="gru", edges=E, plane=[h, w], **{
        k: {kk: v[kk] for kk in ("max_abs_err", "max_abs_err_f32", "ms",
                                 "host_us", "plain_ms", "bound_ms", "bytes")}
        for k, v in rows.items()})
    torch.cuda.empty_cache()
    return rows


def ba_problem(dev, T, E, h, w, seed=0, well_posed=False):
    """A synthetic global BA as bench_ba.py builds one: poses near the
    identity, unit disparities, random edges among T keyframes, targets
    uniform over the plane, unit weights; free poses [1, T). Such targets
    fit no geometry, so the step is large and its f32 rounding chaotic;
    ``well_posed`` puts them at the current reprojection plus 0.5 px of
    noise, with random weights, for comparisons between devices."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.ba import inference as ba_inf
    from droid_slam_tpu_torch.geom import projective as pops
    from droid_slam_tpu_torch.lie import se3

    rng = np.random.default_rng(seed)
    hw = h * w
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    poses = se3.exp(t(0.01 * rng.normal(size=(T, 6))))
    disps = torch.ones((T, h, w), device=dev)
    damping = 1e-6 * torch.ones((T, h, w), device=dev)
    intr = t([320.0, 320.0, w / 2, h / 2])
    ii = rng.integers(0, T, size=E)
    jj = rng.integers(0, T, size=E)
    jj = np.where(jj == ii, (ii + 1) % T, jj)
    target = t(rng.uniform(0, w, size=(E, 2, hw)))
    weight = torch.ones((E, 2, hw), device=dev)
    if well_posed:
        coords, _, _ = pops.projective_transform(
            poses, disps, intr.expand(T, 4), torch.as_tensor(ii, device=dev),
            torch.as_tensor(jj, device=dev))
        target = (coords.reshape(E, hw, 2).transpose(1, 2)
                  + t(0.5 * rng.normal(size=(E, 2, hw))))
        weight = t(rng.uniform(0, 1, size=(E, 2, hw)))
    plan = ba_inf.build_plan(ii, jj, 1, T, dev)
    return poses, disps, damping, intr, target, weight, plan


def run_ba_global(dev):
    """``ba_iterations`` on the JAX package's t=800 global-BA case
    (BENCH_BA_t800.json: 800 keyframes, 12802 edges, 240x320 images, so a
    30x40 feature plane), 2 GN iterations with the global BA's damping.
    The Schur complement is assembled from the row table; the dense form it
    replaced would have held E_k [NW,6P,HW] twice and a [NW,6P,6P] batch.
    Checked: finite state, a step taken, and a well-posed problem at T=64
    on the card against the CPU."""
    import torch
    from droid_slam_tpu_torch.ba import inference as ba_inf

    def run(dev, T, E, iters, timed=False, well_posed=False):
        p, d, damp, intr, tgt, wgt, plan = ba_problem(
            dev, T, E, *BA_PLANE, well_posed=well_posed)
        if timed:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        # no sensor values: the zeros select the damping, as in the tracker
        out = ba_inf.ba_iterations(p, d, torch.zeros_like(d), damp, intr,
                                   tgt, wgt, plan, lm=1e-5, ep=1e-2,
                                   iters=iters)
        if timed:
            torch.cuda.synchronize()
        return p, d, out, time.perf_counter() - tic, plan

    _, _, _, first_s, _ = run(dev, BA_T, BA_E, 1, timed=True)
    p0, _, (p, d), secs, plan = run(dev, BA_T, BA_E, BA_ITERS, timed=True)
    peak = torch.cuda.max_memory_allocated()
    NW, P = plan.k_valid.shape[0], BA_T - 1
    hw = BA_PLANE[0] * BA_PLANE[1]
    dense_bytes = 2 * NW * 6 * P * hw * 4 + NW * (6 * P) ** 2 * 4
    finite = bool(torch.isfinite(p).all() and torch.isfinite(d).all())
    moved = float((p - p0).abs().max())

    # the same problem at T=64 on the card and on the CPU
    (_, _, (pg, dg), _, _), (_, _, (pc, dc), _, _) = (
        run(dev, 64, 1024, BA_ITERS, well_posed=True),
        run("cpu", 64, 1024, BA_ITERS, well_posed=True))
    pose_gap = float((pg.cpu() - pc).abs().max())
    disp_gap = float(((dg.cpu() - dc).abs() / dc.abs().clamp(min=1.0)).max())
    emit(phase="ba_global", keyframes=BA_T, edges=BA_E, plane=list(BA_PLANE),
         iters=BA_ITERS, rmax=int(plan.rk_idx.shape[1]),
         first_call_1iter_s=first_s, s_per_iter=secs / BA_ITERS,
         peak_mem_gb=peak / 2 ** 30, dense_form_gb=dense_bytes / 2 ** 30,
         finite=finite, pose_step=moved, small_t64_vs_cpu=dict(
             pose_gap=pose_gap, disp_rel_gap=disp_gap, tol=BA_CPU_TOL))
    if not finite or not moved > 0:
        raise AssertionError(f"global BA: finite={finite}, step={moved}")
    if not (pose_gap <= BA_CPU_TOL["pose"]
            and disp_gap <= BA_CPU_TOL["disp_rel"]):
        raise AssertionError(f"global BA at T=64: card and CPU differ by "
                             f"{pose_gap} (poses), {disp_gap} (disparities)")
    torch.cuda.empty_cache()


def check_frame_distance(dev):
    """The frame-distance kernel against its plain twin at the proposal of
    the tum cell: every pair of FD_T keyframes of the global-BA tool's
    synthetic walk at FD_PLANE, the twin in DepthVideo._DIST_CHUNK chunks
    (the port's path before the kernel). Returns the kernel's table row
    (without launches), timed against its bound and the twin."""
    import torch
    from droid_slam_tpu_torch.geom import distance as gdist
    from droid_slam_tpu_torch.ops import frame_distance_cuda
    from droid_slam_tpu_torch.state.video import DepthVideo

    h, w = FD_PLANE
    t, HW = FD_T, h * w
    tool = _script("tools", "bench_global_ba_torch.py")
    video = tool["synthetic_video"](t, (8 * h, 8 * w), dev)
    poses, disps = video.poses[:t].contiguous(), video.disps[:t].contiguous()
    intr = video.intrinsics[0]
    del video
    ii, jj = torch.meshgrid(torch.arange(t, device=dev),
                            torch.arange(t, device=dev), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    E, chunk = len(ii), DepthVideo._DIST_CHUNK
    kernel = lambda: frame_distance_cuda.frame_distance(poses, disps, intr,
                                                        ii, jj, 0.3)
    plain = lambda: torch.cat([
        gdist.frame_distance(poses, disps, intr, ii[s:s + chunk],
                             jj[s:s + chunk], 0.3)
        for s in range(0, E, chunk)])
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    u = 2.0 ** -24
    tol = ((2 * HW * u / (1 - HW * u) + FD_RTOL_PIXEL) * want.abs()
           + FD_ATOL)
    gap = (got - want).abs()
    beyond = int((~(gap <= tol)).sum())
    err = float(gap[gap <= tol].max())
    if not beyond <= FD_SHARE_NEAR_CUT * E:
        raise AssertionError(f"frame_distance kernel parts from its plain "
                             f"twin beyond the bound on {beyond} of {E} "
                             f"pairs")
    ms, host_us = _time_ms(kernel)
    plain_ms, _ = _time_ms(plain, n=3)
    ops = FD_OPS_PER_PIXEL_DIRECTION * E * HW * 2
    # bytes, each read once: the frames' disparities and poses, the
    # intrinsics, the pairs' rows and the f32 output
    nbytes = (disps.numel() * 4 + poses.numel() * 4 + 16
              + E * (ii.element_size() + jj.element_size()) + E * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    del got, want, gap, tol
    torch.cuda.empty_cache()
    return dict(pairs=E, keyframes=t, plane=list(FD_PLANE),
                max_abs_err=err, beyond_bound=beyond,
                ms=ms, host_us=host_us, plain_ms=plain_ms,
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=ops)


def run_global_ba_tum(dev):
    """The global BA at the tum preset's buffer: tools/bench_global_ba_torch.py
    on its synthetic video of 512 keyframes at 240x320 with the preset's
    backend settings, passes of GBA_STEPS steps (the first normalizes).
    Checked: GBA_PAIRS distances on the card against the CPU port, the
    proposal's GBA_DIST_CALLS distance calls in each pass, edges beyond the
    neighbours, and a healthy state (finite poses, finite positive
    disparities, unit quaternions)."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.geom import distance as gdist

    tool = _script("tools", "bench_global_ba_torch.py")
    cfg = PRESETS["tum"]
    t, size = cfg.buffer, cfg.image_size
    if any(getattr(cfg, k) != v for k, v in tool["BACKEND"].items()):
        raise AssertionError(f"the tum preset's backend settings are not "
                             f"the tool's {tool['BACKEND']}")
    video = tool["synthetic_video"](t, size, dev)

    rng = np.random.default_rng(1)
    ii = rng.integers(0, t, GBA_PAIRS)
    jj = (ii + rng.integers(1, t, GBA_PAIRS)) % t
    d_card = video.distance(ii, jj, beta=cfg.beta).cpu()
    d_cpu = gdist.frame_distance(
        video.poses.cpu(), video.disps.cpu(), video.intrinsics[0].cpu(),
        torch.as_tensor(ii), torch.as_tensor(jj), cfg.beta)
    dist_rel = float(((d_card - d_cpu).abs() / d_cpu.abs()).max())

    _reset_counts()
    rec = tool["run"](t, size, GBA_STEPS, dev, video=video)
    counts = _counts()
    passes = [rec["stages"][f"pass{i}"] for i in range(len(GBA_STEPS))]
    health = rec["health"]
    emit(phase="global_ba_tum512", keyframes=t, image_size=list(size),
         steps=list(GBA_STEPS), edges=[p["edges"] for p in passes],
         dist_chunks=[p["dist_chunks"] for p in passes],
         s_per_step=rec["value"], step_times_s=rec["step_times_s"],
         stages=rec["stages"], graph=rec["graph"], health=health,
         memory=rec["memory"], distance_card_vs_cpu=dict(
             pairs=GBA_PAIRS, max_rel=dist_rel, rtol=GBA_DIST_RTOL),
         launches=counts, launches_note=GBA_KERNEL_NOTE)
    _require_launches(counts, GBA_KERNELS, "global_ba_tum512")
    if not dist_rel <= GBA_DIST_RTOL:
        raise AssertionError(f"global_ba_tum512: distances on the card part "
                             f"from the CPU's by {dist_rel}")
    chunks = [p["dist_chunks"] for p in passes]
    if (chunks != [GBA_DIST_CALLS] * len(GBA_STEPS)
            or counts["frame_distance"] != sum(chunks)):
        raise AssertionError(f"global_ba_tum512: distance calls {chunks} "
                             f"and launches {counts['frame_distance']}, "
                             f"not {GBA_DIST_CALLS} per pass")
    if not min(p["edges"] for p in passes) > 6 * t:
        raise AssertionError(f"global_ba_tum512: edges {rec['graph']}")
    if not (health["poses_finite"] and health["disps_finite_pos"]
            and health["quat_norm_max_err"] <= GBA_QUAT_TOL):
        raise AssertionError(f"global_ba_tum512: unhealthy state {health}")
    del video
    torch.cuda.empty_cache()
    return counts


def _reset_counts():
    from droid_slam_tpu_torch.ops import (alt_corr_cuda, corr_cuda,
                                          frame_distance_cuda, gru_cuda)
    corr_cuda.LAUNCHES = gru_cuda.LAUNCHES_A = gru_cuda.LAUNCHES_B = 0
    alt_corr_cuda.LAUNCHES = frame_distance_cuda.LAUNCHES = 0


def _counts():
    from droid_slam_tpu_torch.ops import (alt_corr_cuda, corr_cuda,
                                          frame_distance_cuda, gru_cuda)
    return {"corr_lookup": corr_cuda.LAUNCHES,
            "gru_epilogue_a": gru_cuda.LAUNCHES_A,
            "gru_epilogue_b": gru_cuda.LAUNCHES_B,
            "alt_corr": alt_corr_cuda.LAUNCHES,
            "frame_distance": frame_distance_cuda.LAUNCHES}


def _require_launches(counts, names, phase):
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{phase} launched {missing} 0 times: {counts}")


def profile_frames(fn, frame_ms):
    """Device time of fn() by kernel (torch.profiler), per frame: the idle
    share of the profiled frames' own wall time (``idle_share``; the
    profiler slows the host, not the kernels, so this is an upper bound),
    beside the share of the mean un-profiled frame time ``frame_ms`` of
    the frames before (``idle_share_vs_unprofiled``, the script's earlier
    reading: another window of frames, so it may even go negative), the
    lookup kernel's part and the five largest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3 / N_PROF
    dev = _device_ms(prof)[0]
    per_frame = sum(dev.values()) / N_PROF
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:5]
    part = lambda key: sum(v for k, v in dev.items() if key in k) / N_PROF
    rec = dict(frames=N_PROF, frame_ms=frame_ms,
               profiled_frame_ms=wall_ms, device_ms_per_frame=per_frame,
               idle_share=1.0 - per_frame / wall_ms,
               idle_share_vs_unprofiled=1.0 - per_frame / frame_ms,
               lookup_ms_per_frame=part("corr_lookup"),
               gru_epilogue_a_ms_per_frame=part("epilogue_a_kernel"),
               gru_epilogue_b_ms_per_frame=part("epilogue_b_kernel"),
               top_ms_per_frame=[[k[:48], round(v / N_PROF, 3)]
                                 for k, v in top])
    emit(phase="profile", **rec)
    return rec


def _frame(base, t):
    import numpy as np
    return np.roll(base, 4 * t, axis=1)


def _intrinsics(h, w):
    """The bench's pinhole (fx = 0.625 W, centred) at image size h x w."""
    import numpy as np
    return np.array([0.625 * w, 0.625 * w, w / 2, h / 2], np.float32)


def run_track(dev, fused, profile):
    """Droid.track() at 320x512 on the bench's rolled-noise frames, with the
    launch counts set to 0 before and read after. Returns the tracker, the
    frames' base image and intrinsics, and the counts."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    if not os.path.exists(CKPT):
        raise FileNotFoundError(f"the trained checkpoint {CKPT} is missing")
    cfg = DroidConfig(buffer=64, image_size=(H, W), warmup=8,
                      filter_thresh=-1.0, keyframe_thresh=-1.0,
                      frontend_window=20, frontend_thresh=17.5,
                      frontend_radius=2, frontend_nms=1, weights=CKPT,
                      gru_fused_epilogue=fused, fused_frame=False)
    torch.cuda.reset_peak_memory_stats()
    droid = Droid(cfg, device=dev)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(H, W, 3)).astype(np.uint8)
    intr = np.array([320.0, 320.0, W / 2, H / 2], np.float32)

    _reset_counts()
    for t in range(N_WARM):
        droid.track(float(t), _frame(base, t), intrinsics=intr)
    torch.cuda.synchronize()
    kf0 = droid.video.counter
    tic = time.perf_counter()
    for t in range(N_WARM, N_WARM + N_TIMED):
        droid.track(float(t), _frame(base, t), intrinsics=intr)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - tic
    kf_timed = droid.video.counter - kf0
    t_end = N_WARM + N_TIMED
    if profile:
        t_end += N_PROF
        profile_frames(lambda: [droid.track(float(t), _frame(base, t),
                                            intrinsics=intr)
                                for t in range(N_WARM + N_TIMED, t_end)],
                       frame_ms=elapsed * 1e3 / N_TIMED)
    droid.flush()
    torch.cuda.synchronize()
    counts = _counts()

    n = droid.video.counter
    poses, disps = droid.video.poses[:n], droid.video.disps[:n]
    finite = bool(torch.isfinite(poses).all() and torch.isfinite(disps).all())
    phase = "track_fused" if fused else "track"
    emit(phase=phase, weights=os.path.basename(CKPT), frames=t_end,
         keyframes=n, edges=int(len(droid.frontend.graph.ii)),
         timed_frames=N_TIMED, timed_keyframes=kf_timed, timed_s=elapsed,
         kf_per_s=kf_timed / elapsed, finite=finite, launches=counts,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    _require_launches(counts, ["corr_lookup"] + (
        ["gru_epilogue_a", "gru_epilogue_b"] if fused else []), phase)
    if not fused and (counts["gru_epilogue_a"] or counts["gru_epilogue_b"]):
        raise AssertionError(f"the default configuration launched the GRU "
                             f"epilogue kernels: {counts}")
    if not finite:
        raise AssertionError("non-finite poses or disparities")
    if n != t_end or tuple(disps.shape) != (n, H // 8, W // 8):
        raise AssertionError(f"expected {t_end} keyframes of "
                             f"{H // 8}x{W // 8}, got {tuple(disps.shape)}")
    return droid, base, intr, counts, kf_timed / elapsed


def _path_of(droid):
    """Which tracking path a tracker took, and its frame programs'
    counters."""
    fp = droid.frame_programs
    if fp is None:
        return {"path": "strict"}
    return {"path": "frame+spec" if droid._spec_frame else "frame",
            "graphs": fp.graphs, "captures": fp.captures,
            "capture_s": fp.capture_s, "pool_gib": fp.pool_bytes / 2 ** 30,
            "replays": fp.replays, "eager_frames": fp.eager,
            "spec_mis": droid.spec_mis, "strict_reruns": droid.strict_reruns,
            "spec_dist_miss": droid.spec_dist_miss}


def run_track_frame(dev, base, intr, strict_kf_per_s):
    """The frame path (``slam/fused_frame.py``) at 320x512 on track_fused's
    rolled-noise frames with the fused epilogues. Timed, with PyTorch's
    default kernels as track_fused: strict-frame (``spec_frame=False``)
    and speculative, as CUDA graph replays, over N_TIMED frames after
    FRAME_WARM (the graphs' captures fall in the warm-up: ``capture_at``),
    the speculative run with N_PROF more frames profiled. Held, with
    deterministic kernels on FRAME_HELD frames: the
    speculative programs replayed as graphs against the same programs run
    eagerly on the card (equal keyframes and edges, poses and disparities
    to FRAME_GRAPH_TOL, the same mis-speculations and strict re-runs), and
    every kernel launched inside the replayed graphs. Printed: kf/s of the
    strict path (track_fused's run, ``strict_kf_per_s``), strict-frame and
    spec; the device's idle share of the profiled frames; captures, their
    seconds and the pool's GiB. Returns the launch counts of the held
    replayed run."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam.droid import Droid

    def track(spec, graphs=True, profile=False, timed=True):
        warm = FRAME_WARM if timed else N_WARM
        n_frames = warm + N_TIMED + N_PROF if timed else FRAME_HELD
        cfg = DroidConfig(buffer=64, image_size=(H, W), warmup=8,
                          filter_thresh=-1.0, keyframe_thresh=-1.0,
                          frontend_window=20, frontend_thresh=17.5,
                          frontend_radius=2, frontend_nms=1, weights=CKPT,
                          gru_fused_epilogue=True, fused_frame=True,
                          spec_frame=spec)
        torch.cuda.reset_peak_memory_stats()
        droid = Droid(cfg, device=dev)
        droid.frame_programs.graphs = graphs
        droid.frame_programs.sync_debug = "error"   # a hidden sync raises
        _reset_counts()
        rec, stamps = {}, []
        for t in range(n_frames):
            if t == warm:
                torch.cuda.synchronize()
                tic, kf0 = time.perf_counter(), droid.video.counter
            if t == warm + N_TIMED:
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - tic
                rec["kf_per_s"] = (droid.video.counter - kf0) / elapsed
                rec["frame_ms"] = list(np.diff([tic] + stamps) * 1e3)
                if profile:
                    rec["profile"] = profile_frames(
                        lambda: [droid.track(float(k), _frame(base, k),
                                             intrinsics=intr)
                                 for k in range(t, n_frames)],
                        frame_ms=elapsed * 1e3 / N_TIMED)
                    break
            droid.track(float(t), _frame(base, t), intrinsics=intr)
            if warm <= t < warm + N_TIMED:
                stamps.append(time.perf_counter())
        droid.flush()
        torch.cuda.synchronize()
        n, g = droid.video.counter, droid.frontend.graph
        rec.update(counts=_counts(), keyframes=n, frames=n_frames,
                   capture_at=list(droid.frame_programs.capture_at),
                   edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
                   poses=droid.video.poses[:n].cpu(),
                   disps=droid.video.disps[:n].cpu(),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                   replayed=list(droid.frame_programs.replayed_launches),
                   **_path_of(droid))
        del droid
        torch.cuda.empty_cache()
        return rec

    plain = track(spec=False)
    timed = track(spec=True, profile=True)
    torch.use_deterministic_algorithms(True)
    try:
        spec = track(spec=True, timed=False)
        eager = track(spec=True, graphs=False, timed=False)
    finally:
        torch.use_deterministic_algorithms(False)
    same = spec["edges"] == eager["edges"] and \
        spec["keyframes"] == eager["keyframes"]
    gap = {"pose": float((spec["poses"] - eager["poses"]).abs().max()),
           "disp": float((spec["disps"] - eager["disps"]).abs().max())} \
        if same else None
    finite = all(bool(torch.isfinite(r[k]).all()) for r in (plain, timed, spec)
                 for k in ("poses", "disps"))
    names = ("corr_lookup", "gru_epilogue_a", "gru_epilogue_b")
    replayed = dict(zip(names, spec["replayed"]))
    keep = ("kf_per_s", "frame_ms", "frames", "keyframes", "peak_mem_gb",
            "path", "captures", "capture_at", "capture_s", "pool_gib",
            "replays", "eager_frames", "spec_mis", "strict_reruns",
            "spec_dist_miss", "counts")
    emit(phase="track_frame", weights=os.path.basename(CKPT),
         timed_frames=N_TIMED, strict_kf_per_s=strict_kf_per_s,
         strict_frame={k: plain[k] for k in keep if k in plain},
         spec={k: timed[k] for k in keep if k in timed},
         held_deterministic={"replayed": {k: spec[k] for k in keep
                                          if k in spec},
                             "eager": {k: eager[k] for k in keep
                                       if k in eager}},
         idle_share=timed["profile"]["idle_share"],
         device_ms_per_frame=timed["profile"]["device_ms_per_frame"],
         profiled_frame_ms=timed["profile"]["profiled_frame_ms"],
         edges=len(spec["edges"]), replayed_launches=replayed,
         graphs_vs_eager={"same_keyframes_and_edges": same, "gap": gap},
         spec_vs_strict_frame_edges_equal=timed["edges"] == plain["edges"],
         finite=finite)
    _require_launches(spec["counts"], list(names), "track_frame")
    _require_launches(replayed, list(names), "track_frame (graph replays)")
    if not (finite and same and spec["replays"] > 0
            and eager["replays"] == 0):
        raise AssertionError(f"track_frame: finite={finite}, replays "
                             f"{spec['replays']}, the replayed run's "
                             f"keyframes or edges differ from the eager "
                             f"run's: {same}")
    if not (gap["pose"] <= FRAME_GRAPH_TOL and
            gap["disp"] <= FRAME_GRAPH_TOL):
        raise AssertionError(f"track_frame: replayed against eager {gap}")
    if (spec["spec_mis"], spec["strict_reruns"]) != \
            (eager["spec_mis"], eager["strict_reruns"]):
        raise AssertionError("track_frame: the replayed and the eager run "
                             "speculated differently")
    return spec["counts"]


def _track_gaps(got, ref):
    """Two tracked states (``run_track``'s) compared as JAX's
    tests/test_edge_parallel_mode.py does: equal keyframes and edges, the
    largest se3 log of the pose differences, the mean disparity gap."""
    import torch
    from droid_slam_tpu_torch.lie import se3

    same_kf = len(got["poses"]) == len(ref["poses"])
    same = same_kf and got["edges"] == ref["edges"]
    out = dict(same_keyframes_and_edges=same,
               keyframes=[len(got["poses"]), len(ref["poses"])],
               edges=[len(got["edges"]), len(ref["edges"])],
               edges_in_one_only=len(set(got["edges"])
                                     ^ set(ref["edges"])),
               pose_log_gap=float("inf"), mean_disp_gap=float("inf"),
               tol=EP_TOL)
    if same_kf:
        with torch.no_grad():
            dp = se3.log(se3.mul(se3.inv(ref["poses"].double()),
                                 got["poses"].double()))
        out.update(pose_log_gap=float(dp.abs().max()),
                   mean_disp_gap=float((got["disps"] - ref["disps"])
                                       .abs().mean()))
    return out


@contextlib.contextmanager
def _nudged_graph_agg():
    """Inside, every GraphAgg sum is one unit in the last place larger
    (the sums follow a ReLU, so they are >= 0 and the next representable
    value is the bit pattern plus one): a change of the size of the
    rounding by which the sharded sums part from the serial ones."""
    import torch
    from droid_slam_tpu_torch.models import nets

    orig = nets.graph_agg_sums
    bits = {torch.bfloat16: torch.int16, torch.float16: torch.int16,
            torch.float32: torch.int32}

    def nudged(*a, **k):
        counts, sums = orig(*a, **k)
        sums = sums.clone()
        sums.view(bits[sums.dtype]).add_(1)
        return counts, sums

    nets.graph_agg_sums = nudged
    try:
        yield
    finally:
        nets.graph_agg_sums = orig


def run_track_edge_parallel(dev, base, intr):
    """The edge-parallel frontend at 320x512, held to the serial one: JAX's
    edge-parallel test scene (EP_SCENE: the synthetic box stream) tracked
    by ``Droid`` with the fused epilogues and the bench's thresholds,
    serial and with ``DroidConfig(edge_parallel=2)`` on EP_DEVICES (both
    shards on the one card), each with deterministic kernels; equal
    keyframes and edges, poses and disparities to EP_TOL. Launch counts
    are set to 0 before the sharded run and read after. Then, printed and
    not held: the same two runs on track_fused's rolled-noise frames
    (``base``, ``intr``), and beside them the serial run with its GraphAgg
    sums nudged by one unit in the last place (``_nudged_graph_agg``)
    against the plain serial run, which shows how far rounding of that
    size alone carries those frames. Returns the sharded tracker of the
    box scene and its counts."""
    import torch
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.data.synthetic import synthetic_stream
    from droid_slam_tpu_torch.slam.droid import Droid

    tic = time.perf_counter()
    frames = list(synthetic_stream(image_size=(H, W), workers=8, **EP_SCENE))
    render_s = time.perf_counter() - tic
    rolled = [(t, _frame(base, t)[None], intr)
              for t in range(N_WARM + N_TIMED + N_PROF)]
    devices = [torch.device(d) for d in EP_DEVICES]

    def track(edge_devices, frames=frames):
        cfg = DroidConfig(buffer=64, image_size=(H, W), warmup=8,
                          filter_thresh=-1.0, keyframe_thresh=-1.0,
                          frontend_window=20, frontend_thresh=17.5,
                          frontend_radius=2, frontend_nms=1, weights=CKPT,
                          gru_fused_epilogue=True, fused_frame=False,
                          edge_parallel=len(edge_devices or ()))
        torch.cuda.reset_peak_memory_stats()
        droid = Droid(cfg, device=dev, edge_devices=edge_devices)
        _reset_counts()
        for k, (t, img, intr) in enumerate(frames):
            if k == N_WARM:
                torch.cuda.synchronize()
                tic, kf0 = time.perf_counter(), droid.video.counter
            droid.track(float(t), img[0], intrinsics=intr)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        rate = (droid.video.counter - kf0) / secs
        droid.flush()
        torch.cuda.synchronize()
        n, g = droid.video.counter, droid.frontend.graph
        return droid, _counts(), rate, dict(
            edges=sorted(zip(g.ii.tolist(), g.jj.tolist())),
            poses=droid.video.poses[:n].cpu(),
            disps=droid.video.disps[:n].cpu(),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)

    torch.use_deterministic_algorithms(True)
    try:
        serial, _, serial_rate, ref = track(None)
        del serial
        torch.cuda.empty_cache()
        droid, counts, rate, got = track(devices)
        rolled_runs = {}
        for name, edge_devices, nudge in (("serial", None, False),
                                          ("sharded", devices, False),
                                          ("nudged_serial", None, True)):
            with (_nudged_graph_agg() if nudge
                  else contextlib.nullcontext()):
                rolled_runs[name] = track(edge_devices, rolled)[3]
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    g = droid.frontend.graph
    gaps = _track_gaps(got, ref)
    r_ref = rolled_runs["serial"]
    rolled_gaps = {k: _track_gaps(rolled_runs[k], r_ref)
                   for k in ("sharded", "nudged_serial")}
    finite = bool(torch.isfinite(got["poses"]).all()
                  and torch.isfinite(got["disps"]).all())
    emit(phase="track_edge_parallel", weights=os.path.basename(CKPT),
         scene=EP_SCENE, frames=len(frames), render_s=render_s,
         devices=[str(d) for d in g.mesh.devices],
         edges_per_shard=[len(b) for b in g._blocks("net")],
         keyframes=int(droid.video.counter), edges=len(got["edges"]),
         kf_per_s=rate, serial_kf_per_s=serial_rate,
         timed_frames=len(frames) - N_WARM, deterministic=True,
         finite=finite, launches=counts, vs_serial=gaps,
         peak_mem_gb=got["peak_mem_gb"],
         serial_peak_mem_gb=ref["peak_mem_gb"],
         rolled_noise_vs_serial=rolled_gaps)
    _require_launches(counts, TRACK_KERNELS, "track_edge_parallel")
    if not finite or not gaps["same_keyframes_and_edges"]:
        raise AssertionError(f"track_edge_parallel: finite={finite}, "
                             f"keyframes or edges differ from the serial "
                             f"run's: {gaps}")
    if not (gaps["pose_log_gap"] < EP_TOL["pose_log"]
            and gaps["mean_disp_gap"] < EP_TOL["disp_mean"]):
        raise AssertionError(f"track_edge_parallel against the serial run: "
                             f"{gaps}")
    return droid, counts


def _video_copy(v):
    """A fresh DepthVideo holding v's keyframes."""
    import torch
    from droid_slam_tpu_torch.state.video import DepthVideo

    out = DepthVideo((8 * v.h, 8 * v.w), v.buffer, v.device, stereo=v.stereo,
                     upsample=v.disps_up is not None)
    with torch.no_grad():
        for name in DepthVideo._FIELDS:
            if getattr(v, name) is not None:
                getattr(out, name).copy_(getattr(v, name))
    out.counter = v.counter
    return out


def run_global_ba_mesh(droid):
    """One global-BA step (``update_lowmem``) from the edge-parallel
    tracker's state, each on a fresh copy of the video, with JAX's
    proposal: the mesh's chunks of 8 frames split over EP_DEVICES, held to
    the same chunks on a mesh of one shard with JAX's tolerances
    (__graft_entry__.py:234-256, GBA_MESH_TOL); and the serial sweep, whose
    chunks the sweep's cap sizes, held to that one-shard step (poses to
    GBA_MESH_TOL, disparities to GBA_WITNESS_X times a witness's gap: the
    one-shard step with its correlation one unit in the last place larger,
    as other chunk sizes round the bf16 convolutions otherwise on the
    card). Returns the counts."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.ops import alt_corr_cuda
    from droid_slam_tpu_torch.parallel.mesh import Mesh
    from droid_slam_tpu_torch.slam.droid import f32_matmuls
    from droid_slam_tpu_torch.state.graph import FactorGraph

    mesh = Mesh(EP_DEVICES)
    one = Mesh(EP_DEVICES[:1])
    plain = alt_corr_cuda.alt_lookup
    out = {}
    _reset_counts()
    for name, m in (("serial", None), ("one_shard", one), ("mesh", mesh),
                    ("witness", one)):
        v = _video_copy(droid.video)
        g = FactorGraph(v, droid.params, max_factors=16 * v.counter,
                        corr_impl="alt", mesh=m)
        # JAX's proposal there: every pair the cap admits
        g.add_proximity_factors(rad=2, nms=1, thresh=1e9, beta=0.3)
        edges = sorted(zip(g.ii.tolist(), g.jj.tolist()))
        if name == "witness":
            alt_corr_cuda.alt_lookup = \
                lambda *a: plain(*a) * GBA_WITNESS_SCALE
        torch.cuda.synchronize()
        tic = time.perf_counter()
        try:
            with torch.no_grad(), f32_matmuls():
                g.update_lowmem(steps=1)
            torch.cuda.synchronize()
        finally:
            alt_corr_cuda.alt_lookup = plain
        out[name] = dict(edges=edges, s=time.perf_counter() - tic,
                         chunks=g.sweep_chunks,
                         poses=v.poses[:v.counter].cpu().numpy(),
                         disps=v.disps[:v.counter].cpu().numpy())
        del g, v
    counts = _counts()
    ref = out["one_shard"]

    def gaps(name):
        x = out[name]
        return dict(pose=float(np.abs(x["poses"] - ref["poses"]).max()),
                    disp=float(np.abs(x["disps"] - ref["disps"]).max()))

    gap = {k: gaps(k) for k in ("mesh", "serial", "witness")}
    mesh_ok = (
        np.allclose(out["mesh"]["poses"], ref["poses"],
                    **GBA_MESH_TOL["poses"])
        and np.allclose(out["mesh"]["disps"], ref["disps"],
                        **GBA_MESH_TOL["disps"]))
    serial_ok = (
        np.allclose(out["serial"]["poses"], ref["poses"],
                    **GBA_MESH_TOL["poses"])
        and 0 < gap["witness"]["disp"]
        and gap["serial"]["disp"] <= GBA_WITNESS_X * gap["witness"]["disp"])
    n_edges = len(ref["edges"])
    same_edges = all(out[k]["edges"] == ref["edges"] for k in out)
    emit(phase="global_ba_mesh", keyframes=int(droid.video.counter),
         devices=[str(d) for d in mesh.devices], edges=n_edges,
         edges_equal=same_edges,
         seconds={k: x["s"] for k, x in out.items()},
         chunks={k: x["chunks"] for k, x in out.items()},
         gaps_to_one_shard=gap, tol=GBA_MESH_TOL,
         witness_x=GBA_WITNESS_X, launches=counts,
         launches_note=GBA_KERNEL_NOTE)
    _require_launches(counts, GBA_KERNELS, "global_ba_mesh")
    if not (same_edges and n_edges > mesh.size):
        raise AssertionError(f"global_ba_mesh: {n_edges} edges, equal "
                             f"{same_edges}")
    if not mesh_ok:
        raise AssertionError("global_ba_mesh: the mesh step parts from the "
                             "one-shard one")
    if not serial_ok:
        raise AssertionError("global_ba_mesh: the serial step parts from "
                             "the one-shard one")
    torch.cuda.empty_cache()
    return counts


def run_terminate(droid, base, intr):
    """terminate() with bench.py's filler stream (one fresh non-keyframe
    for every two keyframes), launch counts set to 0 before, read after."""
    import numpy as np
    import torch

    t = droid.video.counter

    def stream():
        for k in range(0, t, 2):
            yield k + 0.5, _frame(base, k if k % 4 else k + 1), intr

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    traj = droid.terminate(stream=stream(), backend_steps=BACKEND_STEPS)
    torch.cuda.synchronize()
    counts = _counts()
    st = droid.terminate_stats
    n = droid.video.counter
    finite = bool(np.isfinite(traj).all()
                  and torch.isfinite(droid.video.poses[:n]).all()
                  and torch.isfinite(droid.video.disps[:n]).all())
    emit(phase="terminate", keyframes=n, filler_frames=(t + 1) // 2,
         backend_steps=list(BACKEND_STEPS), backend_s=st["backend_s"],
         backend_edges=st["backend_edges"], filler_s=st["filler_s"],
         total_s=st["total_s"], traj_shape=list(traj.shape),
         traj_finite=finite, launches=counts,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    _require_launches(counts, list(counts), "terminate")
    if not finite or traj.shape != ((t + 1) // 2, 7):
        raise AssertionError(f"terminate returned {traj.shape}, "
                             f"finite={finite}")
    if not all(e > 0 for e in st["backend_edges"]):
        raise AssertionError(f"a global BA pass had no edges: {st}")
    return counts


def _stereo_frame(base, t):
    """Left and right views [2,H,W,3]: the right one sees the plane
    STEREO_SHIFT px further left, as a rectified pair at baseline 0.1."""
    import numpy as np
    left = _frame(base, t)
    return np.stack([left, np.roll(left, -STEREO_SHIFT, axis=1)])


def run_mode(dev, mode, fused_frame=None):
    """Stereo or RGB-D tracking from a preset, then terminate(), with the
    launch counts set to 0 before and read after; ``fused_frame`` None
    takes the CUDA default (the frame path), False the strict path (phase
    ``track_{mode}_strict``). Returns the counts."""
    import dataclasses

    import numpy as np
    import torch
    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.slam.droid import Droid

    stereo = mode == "stereo"
    preset, (h, w) = ("euroc", (H, W)) if stereo else ("tum", RGBD_SIZE)
    cfg = dataclasses.replace(
        PRESETS[preset], image_size=(h, w), buffer=64, warmup=8,
        filter_thresh=-1.0, keyframe_thresh=-1.0, weights=CKPT,
        stereo=stereo, depth=not stereo, upsample=not stereo,
        gru_fused_epilogue=stereo, fused_frame=fused_frame)
    phase = f"track_{mode}" + ("_strict" if fused_frame is False else "")
    intr = _intrinsics(h, w)
    plane = float(intr[0]) * 0.1 / STEREO_SHIFT     # depth of the plane
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(h, w, 3)).astype(np.uint8)
    depth = np.full((h, w), plane, np.float32)
    image = (lambda t: _stereo_frame(base, t)) if stereo else \
        (lambda t: _frame(base, t))

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    droid = Droid(cfg, device=dev)
    for t in range(N_WARM):
        droid.track(float(t), image(t), None if stereo else depth, intr)
    torch.cuda.synchronize()
    kf0, tic = droid.video.counter, time.perf_counter()
    for t in range(N_WARM, N_WARM + N_TIMED):
        droid.track(float(t), image(t), None if stereo else depth, intr)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - tic
    kf_timed = droid.video.counter - kf0
    droid.flush()
    v, g = droid.video, droid.frontend.graph
    n = v.counter
    edges, stereo_edges = len(g.ii), int((g.ii == g.jj).sum())
    sens_share = float((v.disps_sens[:n] > 0).float().mean())
    track_disp = float(v.disps[:n].median())

    def stream():
        for k in range(0, n, 2):
            yield k + 0.5, image(k if k % 4 else k + 1), intr

    traj = droid.terminate(stream=stream(), backend_steps=BACKEND_STEPS)
    torch.cuda.synchronize()
    counts = _counts()
    st = droid.terminate_stats
    finite = bool(np.isfinite(traj).all()
                  and torch.isfinite(v.poses[:n]).all()
                  and torch.isfinite(v.disps[:n]).all())
    up_shape = None if v.disps_up is None else [n, h, w]
    up_finite = v.disps_up is not None and \
        bool(torch.isfinite(v.disps_up[:n]).all())
    emit(phase=phase, preset=preset, image_size=[h, w],
         weights=os.path.basename(CKPT), frames=N_WARM + N_TIMED,
         keyframes=n, timed_frames=N_TIMED, timed_keyframes=kf_timed,
         timed_s=elapsed, kf_per_s=kf_timed / elapsed, edges=edges,
         stereo_edges=stereo_edges, sensor_share=sens_share,
         plane_disp=1.0 / plane, median_disp_tracked=track_disp,
         median_disp_terminated=float(v.disps[:n].median()),
         disps_up_shape=up_shape, disps_up_finite=up_finite,
         terminate_stats=st, traj_shape=list(traj.shape), finite=finite,
         launches=counts, **_path_of(droid),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    need = ["corr_lookup", "alt_corr"] + (
        ["gru_epilogue_a", "gru_epilogue_b"] if stereo else [])
    _require_launches(counts, need, phase)
    if not stereo and (counts["gru_epilogue_a"] or counts["gru_epilogue_b"]):
        raise AssertionError(f"the default configuration launched the GRU "
                             f"epilogue kernels: {counts}")
    if not finite or traj.shape != ((n + 1) // 2, 7):
        raise AssertionError(f"{phase}: terminate returned "
                             f"{traj.shape}, finite={finite}")
    if n != N_WARM + N_TIMED or not all(e > 0 for e in st["backend_edges"]):
        raise AssertionError(f"{phase}: {n} keyframes, backend edges "
                             f"{st['backend_edges']}")
    path = _path_of(droid)
    if path["path"] != ("strict" if fused_frame is False else "frame") or \
            (fused_frame is None and not path["replays"]):
        raise AssertionError(f"{phase}: tracked on {path}")
    if stereo and stereo_edges == 0:
        raise AssertionError(f"{phase}: no (i, i) edges among {edges}")
    if not stereo and not (sens_share > 0.9 and up_finite
                           and tuple(v.disps_up[:n].shape) == (n, h, w)):
        raise AssertionError(f"{phase}: sensor share {sens_share}, "
                             f"disps_up finite={up_finite}")
    if not abs(np.log(track_disp * plane)) <= np.log(PLANE_DISP_TOL):
        raise AssertionError(f"{phase}: median disparity {track_disp} "
                             f"is not within {PLANE_DISP_TOL}x of the "
                             f"plane's {1.0 / plane}")
    del droid
    torch.cuda.empty_cache()
    return counts


def _slide_frame(base, t):
    """Frame t of the asynchronous phases' scene: the bench's noise texture,
    4 * N_ASYNC px wider, seen through a W-px window that moves 4 px a
    frame. The bench rolls its image around instead, a motion no camera
    makes."""
    import numpy as np
    return np.ascontiguousarray(base[:, 4 * t:4 * t + W])


def _async_stream(base, intr, n):
    for k in range(0, n, 2):
        yield k + 0.5, _slide_frame(base, k if k % 4 else k + 1), intr


def _rel_ate(traj, ref):
    """ATE of traj against ref (camera positions, scaled Umeyama
    alignment), over ref's RMS spread about its centroid."""
    import numpy as np
    from droid_slam_tpu_torch.eval.ate import ate_rmse
    spread = np.sqrt(((ref[:, :3] - ref[:, :3].mean(0)) ** 2).sum(1).mean())
    return float(ate_rmse(traj[:, :3], ref[:, :3])[0] / spread)


def _host_copy(x):
    return x.to("cpu", copy=True)


def _record_backend_inputs(droid, kind):
    """Keep on the host what the facade's backend merges, for ``_replay``.
    thread: each cycle's (t0, tracker poses [0, t1), frames [t0, t1)) as
    ``merge_frames`` receives them; process: each numbered push's slab
    contents (poses and disparities over [0, t1), the other frame fields
    over [t0, t1)), from which ``_process_inputs`` rebuilds what each cycle
    read. Returns (the record, a function that ends the recording)."""
    from droid_slam_tpu_torch.slam import async_droid
    from droid_slam_tpu_torch.state.video import DepthVideo

    fields, rec = DepthVideo.FRAME_FIELDS, []
    if kind == "thread":
        merge = async_droid.merge_frames

        def recording_merge(video2, t0, poses1, frames):
            rec.append((t0, _host_copy(poses1),
                        {k: _host_copy(frames[k]) for k in fields}))
            return merge(video2, t0, poses1, frames)

        async_droid.merge_frames = recording_merge
        return rec, lambda: setattr(async_droid, "merge_frames", merge)
    push = droid._push

    def recording_push():
        t0, t1 = push()
        slab = droid._slab
        rec.append((droid._ctl["pushes"].value, t0, t1, {
            k: _host_copy(slab[k][:t1] if k in ("poses", "disps")
                          else slab[k][t0:t1]) for k in fields}))
        return t0, t1

    droid._push = recording_push
    return rec, lambda: None


def _process_inputs(droid, pushes):
    """Each process cycle's input, (t0, poses [0, t1), frames [t0, t1)), as
    the backend read it: the input slab as it stood after the push that the
    cycle records it merged, rebuilt from the numbered pushes."""
    import torch
    from droid_slam_tpu_torch.state.video import DepthVideo

    seqs = [p[0] for p in pushes]
    if seqs != list(range(1, len(seqs) + 1)):
        raise AssertionError(f"the recorded pushes are not 1..n: {seqs}")
    slab = {k: torch.zeros(getattr(droid.video, k).shape,
                           dtype=getattr(droid.video, k).dtype)
            for k in DepthVideo.FRAME_FIELDS}
    done, out = 0, []
    for c in droid.cycles:
        for _, t0, t1, frames in pushes[done:c["push"]]:
            for k, v in frames.items():
                if k in ("poses", "disps"):
                    slab[k][:t1] = v
                else:
                    slab[k][t0:t1] = v
        done = max(done, c["push"])
        t0, t1 = c["t0"], c["t1"]
        out.append((t0, slab["poses"][:t1].clone(),
                    {k: v[t0:t1].clone() for k, v in slab.items()}))
    return out


def _replay(droid, inputs, iters, align=True):
    """The facade's backend cycles again, by hand on the default stream: a
    fresh video and ``DroidAsyncBackend`` take each cycle's input in order
    (``merge_frames``, then ``iters`` global-BA steps). ``align=False``
    merges without the alignment (scale 1, dG the identity): a planted
    fault. Returns (poses [n,7] on the host, edges per cycle)."""
    import torch
    from droid_slam_tpu_torch.slam.async_droid import merge_frames
    from droid_slam_tpu_torch.slam.backend import DroidAsyncBackend
    from droid_slam_tpu_torch.slam.droid import f32_matmuls
    from droid_slam_tpu_torch.state.video import DepthVideo

    cfg, dev = droid.config, droid.device
    v2 = DepthVideo(cfg.image_size, cfg.buffer, dev, stereo=cfg.stereo,
                    upsample=cfg.upsample)
    backend = DroidAsyncBackend(droid.params, v2, cfg)
    edges = []
    with torch.no_grad(), f32_matmuls():
        for t0, poses1, frames in inputs:
            poses1 = poses1.to(dev)
            frames = {k: v.to(dev) for k, v in frames.items()}
            if align:
                merge_frames(v2, t0, poses1, frames)
            else:
                frames["poses"] = poses1[t0:]
                v2.write_frames(t0, frames)
            edges.append(backend(iters, normalize=False))
    poses = v2.poses[:v2.counter].cpu()
    del backend, v2
    torch.cuda.empty_cache()
    return poses, edges


def _replay_check(droid, kind, rec):
    """The facade's backend poses after its last cycle against its cycles
    replayed by hand (``_replay``), and two planted faults: no BA step and
    the merge without alignment. Returns the readings."""
    inputs = rec if kind == "thread" else _process_inputs(droid, rec)
    if len(inputs) != len(droid.cycles):
        raise AssertionError(f"{len(inputs)} recorded inputs for "
                             f"{len(droid.cycles)} backend cycles")
    n = droid.video2.counter
    got = droid.video2.poses[:n].cpu()

    def gap(poses):
        return (float((poses - got).abs().max())
                if poses.shape == got.shape else float("inf"))

    sound, edges = _replay(droid, inputs, ASYNC_ITERS)
    return dict(
        pose_gap=gap(sound),
        control_no_ba_gap=gap(_replay(droid, inputs, 0)[0]),
        control_no_align_gap=gap(
            _replay(droid, inputs, ASYNC_ITERS, align=False)[0]),
        edges_equal=edges == [c["edges"] for c in droid.cycles],
        bound=REPLAY_POSE_TOL)


def run_async(dev, kind, ref_traj=None, fused_frame=ASYNC_FUSED_FRAME):
    """``make_droid`` with the bench's thresholds at 320x512 on the
    sliding scene (``_slide_frame``), fused epilogues, N_ASYNC frames, then
    ``terminate(stream)``. kind:
    "sync" (``Droid``: the reference trajectory), "thread" (``DroidAsync``)
    or "process" (``DroidAsyncProcess``, with DROID_ASYNC_PROCESS=1; its
    tracking starts once the backend process is ready). The launch
    counts are set to 0 before tracking and before terminate(), and
    read after each. An asynchronous facade's backend poses must match its
    cycles replayed by hand (``_replay_check``) to REPLAY_POSE_TOL, where a
    replay with no BA step must not; its ATE to the reference trajectory is
    printed. With ``fused_frame`` None (the CUDA default: the frame path)
    the phase is ``{phase}_frame``; there the backend's cycles before
    terminate() are printed and not held (the frame path's tracker may
    outrun them), and its replay is held when it ran a cycle. Returns
    (trajectory, counts)."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.config import DroidConfig
    from droid_slam_tpu_torch.slam import make_droid

    phase = {"sync": "track_async_ref", "thread": "track_async",
             "process": "track_async_process"}[kind]
    phase += "_frame" if fused_frame is None else ""
    cfg = DroidConfig(buffer=ASYNC_BUFFER, image_size=(H, W), warmup=8,
                      filter_thresh=-1.0, keyframe_thresh=-1.0,
                      frontend_window=20, frontend_thresh=17.5,
                      frontend_radius=2, frontend_nms=1, weights=CKPT,
                      gru_fused_epilogue=True, asynchronous=kind != "sync",
                      fused_frame=fused_frame)
    kw = {} if kind == "sync" else dict(sleep_time=ASYNC_SLEEP,
                                        backend_iters=ASYNC_ITERS)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, size=(H, W + 4 * N_ASYNC, 3)) \
        .astype(np.uint8)
    intr = _intrinsics(H, W)

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    saved = os.environ.pop("DROID_ASYNC_PROCESS", None)
    if kind == "process":
        os.environ["DROID_ASYNC_PROCESS"] = "1"
    try:
        t_made = time.perf_counter()
        droid = make_droid(cfg, device=dev, **kw)
    finally:
        os.environ.pop("DROID_ASYNC_PROCESS", None)
        if saved is not None:
            os.environ["DROID_ASYNC_PROCESS"] = saved
    rec, stop_recording = ([], lambda: None) if kind == "sync" else \
        _record_backend_inputs(droid, kind)
    if kind == "process":   # tracking starts with the backend ready
        while not droid.backend_startup_s:
            droid._check()
            if time.perf_counter() - t_made > 300:
                raise TimeoutError(f"{phase}: the backend process was not "
                                   f"ready 300 s after its spawn")
            time.sleep(0.05)
    stamps = []
    try:
        for t in range(N_ASYNC):
            droid.track(float(t), _slide_frame(base, t), intrinsics=intr)
            stamps.append(time.time())
        torch.cuda.current_stream().synchronize()   # the tracker's stream
        stamps[-1] = time.time()
        c_track = _counts()
        cycles_before = 0 if kind == "sync" else droid.backend_cycles

        _reset_counts()
        tic = time.perf_counter()
        traj = droid.terminate(stream=_async_stream(base, intr, N_ASYNC),
                               backend_steps=BACKEND_STEPS)
        torch.cuda.synchronize()
        term_s = time.perf_counter() - tic
        c_term = _counts()
    finally:
        stop_recording()

    # tracking rate over the frames after the backend started (the sync
    # reference: after the frame at which it would have started)
    if kind == "sync":
        start = stamps[32]
    else:
        start = droid.cycles[0]["start"] if droid.cycles else stamps[-1]
    after = sum(1 for st in stamps if st > start)
    n = droid.video.counter
    finite = bool(np.isfinite(traj).all()
                  and torch.isfinite(droid.video.poses[:n]).all()
                  and torch.isfinite(droid.video.disps[:n]).all())
    same_keyframes = True
    if kind != "sync":   # the backend's video holds every keyframe
        v2, m = droid.video2, droid.video2.counter
        finite = finite and bool(torch.isfinite(v2.poses[:m]).all()
                                 and torch.isfinite(v2.disps[:m]).all())
        same_keyframes = m == n and bool(
            (v2.tstamp[:n] == droid.video.tstamp[:n]).all())
    rel_ate = None if ref_traj is None else _rel_ate(traj, ref_traj)
    cycles = [] if kind == "sync" else [
        {k: c[k] for k in ("t0", "t1", "scale", "edges", "s")}
        for c in droid.cycles]
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    replay = None if kind == "sync" or not droid.cycles else \
        _replay_check(droid, kind, rec)
    extra = {}
    if kind == "process":
        extra = dict(backend_startup_s=droid.terminate_stats["startup_s"],
                     backend_peak_mem_gb=max(c["peak_gb"]
                                             for c in droid.cycles))
    emit(phase=phase, weights=os.path.basename(CKPT), frames=N_ASYNC,
         keyframes=n, kf_per_s_after_backend_start=(
             after / (stamps[-1] - start) if after else None),
         backend_cycles_before_terminate=cycles_before, cycles=cycles,
         terminate_s=term_s, terminate_stats=droid.terminate_stats,
         traj_shape=list(traj.shape), finite=finite,
         backend_has_every_keyframe=same_keyframes, rel_ate=rel_ate,
         replay=replay, launches={"track": c_track, "terminate": c_term},
         peak_mem_gb=peak_gb, **_path_of(droid), **extra)
    _require_launches(c_track, TRACK_KERNELS, f"{phase} (tracking)")
    # the synchronous terminate() runs the global BA here; the facades'
    # last cycles run it in their backends
    _require_launches(c_term, TRACK_KERNELS + (
        ["alt_corr"] if kind == "sync" else []), f"{phase} (terminate)")
    if not finite or traj.shape != ((N_ASYNC + 1) // 2, 7):
        raise AssertionError(f"{phase}: terminate returned {traj.shape}, "
                             f"finite={finite}")
    if not same_keyframes:
        raise AssertionError(f"{phase}: the backend's keyframes differ from "
                             f"the tracker's {n}")
    if fused_frame is None and droid.frame_programs.replays == 0:
        raise AssertionError(f"{phase}: no frame was a graph replay")
    if kind != "sync" and fused_frame is None and not droid.cycles:
        raise AssertionError(f"{phase}: the backend ran no cycle")
    if kind != "sync" and fused_frame is not None and cycles_before < 2:
        raise AssertionError(f"{phase}: the backend ran {cycles_before} "
                             f"cycles before terminate(), fewer than 2")
    if replay is not None and not (replay["pose_gap"] <= REPLAY_POSE_TOL
                                   and replay["edges_equal"]):
        raise AssertionError(f"{phase}: the backend's poses differ from its "
                             f"cycles replayed by hand: {replay}")
    if replay is not None and \
            not replay["control_no_ba_gap"] > REPLAY_POSE_TOL:
        raise AssertionError(f"{phase}: a replay with no BA step lands "
                             f"within {REPLAY_POSE_TOL} too: {replay}")
    del droid
    torch.cuda.empty_cache()
    return traj, {k: c_track[k] + c_term[k] for k in c_track}


def _script(*parts):
    """A script of the repository run as a module (not as __main__)."""
    import runpy
    return runpy.run_path(os.path.join(ROOT, *parts), run_name="chip_smoke")


def _device_ms(prof):
    """({kernel or copy name: device ms}, {aten op: device ms of the kernels
    it launched itself}, {aten op: host ms of its own}) of a torch.profiler
    run."""
    from torch.autograd import DeviceType
    dev, by_op, host = {}, {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            dev[e.key] = dev.get(e.key, 0.0) + e.self_device_time_total / 1e3
        elif e.key.startswith("aten::"):
            by_op[e.key] = e.self_device_time_total / 1e3
            host[e.key] = e.self_cpu_time_total / 1e3
    return dev, by_op, host


def _kernel_ms(prof):
    """{kernel or copy name: device ms} of a torch.profiler run, summed
    from its raw events: the per-op summary (``key_averages``) of a whole
    training step's trace takes minutes to build."""
    from torch.autograd import DeviceType
    try:
        events = prof.profiler.kineto_results.events()
        dev = {}
        for e in events:
            if e.device_type() != DeviceType.CPU:
                dev[e.name()] = dev.get(e.name(), 0.0) + e.duration_ns() / 1e6
        return dev
    except AttributeError:      # a PyTorch without these raw accessors
        return _device_ms(prof)[0]


def _top(d, n):
    return [[k[:60], round(v, 3)] for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _attribute_ops(run, batch):
    """Device and host ms by aten op of one sample's sample_loss and
    backward through ATTR_ITERS iterations at the run's configuration
    (torch.profiler with the host's ops): the step's ops in small. The
    gradients are dropped; the optimizer does not step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from droid_slam_tpu_torch.slam.droid import f32_matmuls
    from droid_slam_tpu_torch.train import trainer

    b = {k: v if k in ("ii", "jj") else v[0] for k, v in batch.items()}
    g0, d0 = trainer.default_init(b["poses"], b["disps"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, f32_matmuls():
        loss, _ = trainer.sample_loss(run.params, b["images"], b["poses"],
                                      b["disps"], b["intrinsics"], g0, d0,
                                      b["ii"], b["jj"], run.cfg, ATTR_ITERS)
        loss.backward()
        torch.cuda.synchronize()
    for p in run.params.values():
        p.grad = None
    dev_ms, op_dev_ms, op_host_ms = _device_ms(prof)
    return op_dev_ms, op_host_ms, sum(dev_ms.values())


def run_train(dev):
    """train_torch.py's Run at TRAIN_ARGV: one warm-up step, N_TRAIN_TIMED
    timed steps, one profiled step; then its .npz read back, and its state
    saved, resumed and stepped once against one uninterrupted step
    (restart_prob 0, deterministic kernels), which must agree exactly."""
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from droid_slam_tpu_torch.models import weights as weights_io

    mod = _script("train_torch.py")
    parser = mod["build_parser"]()
    tic = time.perf_counter()
    run = mod["Run"](parser.parse_args(TRAIN_ARGV))
    batches = [run.next_batch() for _ in range(N_TRAIN_TIMED + 2)]
    prep_s = time.perf_counter() - tic
    start = {k: v.detach().clone() for k, v in run.params.items()}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()

    def step(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = run.step(batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, m

    warm_s, warm_m = step(batches[0])
    timed = [step(b) for b in batches[1:1 + N_TRAIN_TIMED]]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the whole step's kernels only: with the host's ops too, its trace
    # holds millions of events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_s, prof_m = step(batches[-1])
    t0 = time.perf_counter()
    dev_ms = _kernel_ms(prof)
    summary_s = time.perf_counter() - t0
    op_dev_ms, op_host_ms, attr_ms = _attribute_ops(run, batches[-1])
    counts = _counts()
    runs = [1 + m["restarts"] for _, m in timed]
    s_per_run = sum(t for t, _ in timed) / sum(runs)
    prof_runs = 1 + prof_m["restarts"]
    busy_ms = sum(dev_ms.values())
    metrics = [m for _, m in [(warm_s, warm_m)] + timed + [(prof_s, prof_m)]]
    finite_metrics = all(np.isfinite(v) for m in metrics for v in m.values())
    nanfrac = max(m["grad_nanfrac"] for m in metrics)
    unchanged = [k for k, v in run.params.items()
                 if torch.equal(v.detach(), start[k])]
    nonfinite = [k for k, v in run.params.items()
                 if not bool(torch.isfinite(v).all())]
    s_step = [t for t, _ in timed]
    B = int(batches[0]["images"].shape[0])
    iters = run.cfg.iters

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "weights.npz")
        run.save_npz(npz)
        ref = weights_io.to_jax_params(run.params)
        with np.load(npz) as d:
            npz_exact = (set(d.files) == set(ref) and all(
                np.array_equal(d[k], ref[k]) for k in ref))
        state = os.path.join(tmp, "state.pt")
        one = {k: v if k in ("ii", "jj") else v[:1]
               for k, v in batches[1].items()}
        run.cfg.restart_prob, run.cfg.iters = 0.0, RESUME_ITERS
        torch.use_deterministic_algorithms(True)
        try:
            run.save_state(state)
            t0 = time.perf_counter()
            run.step(one)
            resume_step_s = time.perf_counter() - t0
            resumed = mod["Run"](parser.parse_args(
                TRAIN_ARGV + ["--restart_prob", "0", "--iters",
                              str(RESUME_ITERS), "--resume", state]))
            resumed.step(one)
        finally:
            torch.use_deterministic_algorithms(False)
        resume_gap = max(float((run.params[k] - resumed.params[k]).detach()
                               .abs().max()) for k in run.params)
        resume_exact = (resumed.total_steps == run.total_steps and all(
            torch.equal(run.params[k], resumed.params[k])
            for k in run.params))
    del run, resumed
    torch.cuda.empty_cache()

    emit(phase="train", image_size=[int(x) for x in
                                    batches[0]["images"].shape[2:4]],
         frames=int(batches[0]["images"].shape[1]), batch=B,
         edges=[int(b["ii"].numel()) for b in batches], iters=iters,
         compute="bf16", prep_s=prep_s, warmup_s=warm_s, s_per_step=s_step,
         restarts=[m["restarts"] for _, m in timed],
         samples_per_s=B * len(s_step) / sum(s_step),
         s_per_unroll=s_per_run, unroll_samples_per_s=B / s_per_run,
         loss=[m["loss"] for m in metrics],
         metrics=[{k: v for k, v in m.items() if k != "loss"}
                  for m in metrics],
         grad_nanfrac=nanfrac, peak_mem_gb=peak,
         profile={"step_s": prof_s, "unrolls": prof_runs,
                  "device_ms": busy_ms,
                  "busy_share": busy_ms / 1e3 / prof_runs / s_per_run,
                  "busy_share_profiled_step": busy_ms / 1e3 / prof_s,
                  "top_ms": _top(dev_ms, 5), "summary_s": summary_s,
                  "attributed": {"batch": 1, "iters": ATTR_ITERS,
                                 "device_ms": attr_ms,
                                 "top_ops_device_ms": _top(op_dev_ms, 8),
                                 "top_ops_host_ms": _top(op_host_ms, 8),
                                 "ops_host_ms": sum(op_host_ms.values())}},
         launches=counts, launches_note=TRAIN_KERNEL_NOTE,
         params_unchanged=unchanged, params_nonfinite=nonfinite,
         npz_read_back_exact=npz_exact, resume_exact=resume_exact,
         resume_max_gap=resume_gap, resume_step_s=resume_step_s,
         resume_step={"batch": 1, "iters": RESUME_ITERS,
                      "deterministic": True})
    if not finite_metrics or nanfrac != 0.0:
        raise AssertionError(f"train: non-finite metrics or grad_nanfrac "
                             f"{nanfrac}")
    if unchanged or nonfinite:
        raise AssertionError(f"train: parameters unchanged {unchanged} or "
                             f"non-finite {nonfinite}")
    if not npz_exact or not resume_exact:
        raise AssertionError(f"train: npz read back exact {npz_exact}, "
                             f"resumed step exact {resume_exact} (gap "
                             f"{resume_gap})")
    return counts


def _spy_grads(opt):
    """The gradients ``opt.step`` is given (before its norm clip), copied
    to the host into the dict returned, on each call."""
    seen, step = {}, opt.step

    def spy(grads):
        seen.update({k: v.detach().float().cpu() for k, v in grads.items()})
        return step(grads)

    opt.step = spy
    return seen


def _grad_rel(a, b):
    """Relative error of the flat gradient tree a against b."""
    import torch
    flat = lambda t: torch.cat([t[k].double().reshape(-1) for k in sorted(t)])
    fa, fb = flat(a), flat(b)
    return float(torch.linalg.norm(fa - fb) / torch.linalg.norm(fb))


def _train_dp_rank(rank, argv, init, out, device):
    """One of train_dp's spawned ranks: gloo on ``device``, one step of
    train_torch's Run on its block of the global batch; it writes its
    device, backend and (rank 0) the stepped parameters, the metrics and
    the averaged gradients the optimizer took."""
    import torch
    sys.path.insert(0, ROOT)
    import train_torch
    from droid_slam_tpu_torch.parallel import mesh as pmesh

    torch.use_deterministic_algorithms(True)
    args = train_torch.build_parser().parse_args(argv)
    dp = pmesh.init_data_parallel(rank, DP_WORLD, "gloo", device,
                                  DP_TIMEOUT_S, init)
    try:
        run = train_torch.Run(args, dp)
        grads = _spy_grads(run.opt)
        batch = run.next_batch()
        metrics = run.step(batch)
        rec = dict(rank=rank, device=str(dp.device), backend=dp.backend,
                   samples=int(batch["images"].shape[0]))
        if rank == 0:
            rec.update(metrics=metrics, grads=grads, params={
                k: v.detach().cpu() for k, v in run.params.items()})
        torch.save(rec, f"{out}.{rank}")
    finally:
        pmesh.shutdown_data_parallel()


def run_train_dp(dev):
    """Data-parallel training at train_torch.py's published configuration
    (TRAIN_DP_ARGV: batch 2, restarts off, deterministic kernels):
    (a) ``--devices 1``, a real NCCL group of one rank (train_torch's own
    device and backend choice), held bit for bit to the plain step on the
    same batch; (b) DP_WORLD spawned ranks sharing the card through gloo,
    one sample each, held to the plain step on the whole batch
    (TRAIN_DP_TOL), and their averaged gradients, before the optimizer's
    norm clip, to the mean of the gradients of each rank's block stepped
    alone in this process (TRAIN_DP_TOL["grad_rel"]: Adam's first step
    moves each entry by about lr g/|g| and would hide a gradient off by a
    constant factor; the update operator's clipped backward makes a
    block's gradient differ from the whole batch's share, as JAX's pmean
    does). Returns the counts (the training path launches none of the
    three kernels)."""
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp
    sys.path.insert(0, ROOT)
    import train_torch
    from droid_slam_tpu_torch.parallel import mesh as pmesh

    parser = train_torch.build_parser()
    _reset_counts()
    torch.use_deterministic_algorithms(True)
    try:
        plain = train_torch.Run(parser.parse_args(TRAIN_DP_ARGV))
        t0 = time.perf_counter()
        m_plain = plain.step(plain.next_batch())
        plain_s = time.perf_counter() - t0
        args = parser.parse_args(TRAIN_DP_ARGV + ["--devices", "1"])
        devices, backend = train_torch.rank_plan(args)
        dp = pmesh.init_data_parallel(
            0, 1, backend, devices[0], DP_TIMEOUT_S,
            f"tcp://localhost:{pmesh.free_port()}")
        try:
            one = train_torch.Run(args, dp)
            t0 = time.perf_counter()
            m_one = one.step(one.next_batch())
            one_s = time.perf_counter() - t0
        finally:
            pmesh.shutdown_data_parallel()
    finally:
        torch.use_deterministic_algorithms(False)
    exact = all(torch.equal(plain.params[k], one.params[k])
                for k in plain.params) and m_plain == m_one
    ref = {k: v.detach().cpu() for k, v in plain.params.items()}
    del plain, one
    torch.cuda.empty_cache()
    # each rank's block alone: the gradients the ranks must average to
    blocks = []
    torch.use_deterministic_algorithms(True)
    try:
        for r in range(DP_WORLD):
            run = train_torch.Run(parser.parse_args(TRAIN_DP_ARGV))
            seen = _spy_grads(run.opt)
            run.step(pmesh.shard_batch(run.next_batch(), pmesh.DataParallel(
                r, DP_WORLD, torch.device(dev), "none")))
            blocks.append(seen)
            del run
    finally:
        torch.use_deterministic_algorithms(False)
    block_mean = {k: sum(b[k] for b in blocks) / DP_WORLD for k in blocks[0]}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        init = f"tcp://localhost:{pmesh.free_port()}"
        t0 = time.perf_counter()
        ctx = mp.start_processes(_train_dp_rank,
                                 args=(TRAIN_DP_ARGV, init, out, dev),
                                 nprocs=DP_WORLD, join=False,
                                 start_method="spawn")
        try:
            while not ctx.join(timeout=1.0):
                if time.perf_counter() - t0 > DP_JOIN_S:
                    raise TimeoutError(f"train_dp: the ranks did not finish "
                                       f"within {DP_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{out}.{r}") for r in range(DP_WORLD)]
    counts = _counts()
    got = ranks[0]
    gap = max(float((got["params"][k] - ref[k]).abs().max()) for k in ref)
    close = all(np.allclose(got["params"][k].numpy(), ref[k].numpy(),
                            rtol=TRAIN_DP_TOL["rtol"],
                            atol=TRAIN_DP_TOL["atol"]) for k in ref)
    loss_rel = abs(got["metrics"]["loss"] - m_plain["loss"]) \
        / abs(m_plain["loss"])
    grad_rel = _grad_rel(got["grads"], block_mean)
    emit(phase="train_dp", argv=TRAIN_DP_ARGV,
         nccl_world_1=dict(device=str(devices[0]), backend=backend,
                           exact=exact, plain_step_s=plain_s,
                           dp_step_s=one_s, loss=m_one["loss"]),
         gloo_ranks=dict(ranks=[{k: r[k] for k in ("rank", "device",
                                                    "backend", "samples")}
                                for r in ranks],
                         spawn_to_join_s=spawn_s, param_max_gap=gap,
                         params_close=close, loss=got["metrics"]["loss"],
                         plain_loss=m_plain["loss"], loss_rel=loss_rel,
                         grad_rel_to_blocks=grad_rel),
         tol=TRAIN_DP_TOL, launches=counts, launches_note=TRAIN_KERNEL_NOTE)
    if not exact:
        raise AssertionError("train_dp: the NCCL step of one rank differs "
                             "from the plain step")
    if not (close and loss_rel <= TRAIN_DP_TOL["loss_rel"]
            and grad_rel <= TRAIN_DP_TOL["grad_rel"]):
        raise AssertionError(f"train_dp: {DP_WORLD} gloo ranks part from the "
                             f"plain step: params {gap}, loss {loss_rel}, "
                             f"gradients {grad_rel}")
    return counts


def run_train_parity(dev):
    """sample_loss and its gradient on the card against the CPU port on the
    same inputs (PARITY_*), in f32 with TF32 off."""
    import numpy as np
    import torch
    from droid_slam_tpu_torch.data.synthetic import SyntheticBox
    from droid_slam_tpu_torch.lie import se3
    from droid_slam_tpu_torch.models import weights as weights_io
    from droid_slam_tpu_torch.slam.droid import f32_matmuls
    from droid_slam_tpu_torch.train import trainer

    N, (h, w) = PARITY_N, PARITY_SIZE
    images, poses, disps, intr = SyntheticBox(
        n_clips=1, n_frames=N, image_size=(h, w), seed=PARITY_SEED)[0]
    pairs = [(a, b) for a in range(N) for b in range(N)
             if a != b and abs(a - b) <= 2]
    inputs = [torch.from_numpy(images.astype(np.uint8)),
              se3.inv(torch.from_numpy(poses)), torch.from_numpy(disps),
              torch.from_numpy(intr)]
    ii = torch.tensor([a for a, _ in pairs])
    jj = torch.tensor([b for _, b in pairs])
    cfg = trainer.TrainConfig(n_frames=N)
    _reset_counts()
    out = []
    for d in ("cpu", dev):
        params = {k: v.to(d).requires_grad_(True)
                  for k, v in weights_io.load_npz(CKPT).items()}
        x = [t.to(d) for t in inputs]
        g0, d0 = trainer.default_init(x[1], x[2])
        t0 = time.perf_counter()
        with f32_matmuls():
            loss, _ = trainer.sample_loss(params, *x, g0, d0, ii.to(d),
                                          jj.to(d), cfg, PARITY_ITERS,
                                          compute_dtype=torch.float32)
            loss.backward()
        flat = np.concatenate([params[k].grad.double().cpu().numpy().ravel()
                               for k in sorted(params)])
        out.append((float(loss.detach()), flat, time.perf_counter() - t0))
    counts = _counts()
    (lc, gc, tc), (lg, gg, tg) = out
    loss_rel = abs(lg - lc) / abs(lc)
    grad_rel = float(np.linalg.norm(gg - gc) / np.linalg.norm(gc))
    emit(phase="train_parity", frames=N, image_size=[h, w],
         iters=PARITY_ITERS, edges=len(pairs), seed=PARITY_SEED,
         loss_cpu=lc, loss_cuda=lg, loss_rel=loss_rel, grad_rel=grad_rel,
         tol=PARITY_TOL, cpu_s=tc, cuda_s=tg, launches=counts,
         launches_note=TRAIN_KERNEL_NOTE)
    if not (loss_rel < PARITY_TOL["loss_rel"]
            and grad_rel < PARITY_TOL["grad_rel"]):
        raise AssertionError(f"train_parity: loss {loss_rel}, gradient "
                             f"{grad_rel} against {PARITY_TOL}")
    return counts


def _read_png(path):
    """An 8-bit RGB PNG as save_screenshot writes it (one IDAT stream, rows
    without a filter), decoded with the standard library, each chunk's CRC
    checked: [H,W,3] uint8."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise AssertionError(f"{path}: bad CRC in {kind}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    W, H, depth, ctype = hdr[:4]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    if depth != 8 or ctype != 2 or raw[:, 0].any():
        raise AssertionError(f"{path}: not 8-bit RGB rows without a filter")
    return raw[:, 1:].reshape(H, W, 3)


def run_evaluate(dev):
    """The synthetic evaluation end to end on the card, then the
    reconstruction from its final video: ``test_synthetic_torch.run``
    (tracking, then ``terminate()`` over every frame), its ATE against the
    ground truth held to EVAL_ATE_BOUND; ``depth_filter`` and
    ``iproj_points`` on the card held to the same functions on a CPU copy
    of the state, and timed; the ``.npz`` saved with
    ``demo_torch.save_reconstruction``, turned into a PLY by
    ``view_reconstruction_torch.py``, the PLY's vertices read back; the
    screenshot written, decoded and held to the render. Files go to a
    temporary directory that is removed. The launch counts are set to 0
    before the run and read after tracking, around the filler and after
    ``terminate()``; the lookup must launch in tracking and in the
    filler."""
    import tempfile

    import numpy as np
    import torch
    from droid_slam_tpu_torch.eval import viewer, visualization as vis
    from droid_slam_tpu_torch.geom.filters import depth_filter, iproj_points

    syn = _script("evaluation_scripts", "test_synthetic_torch.py")
    args = syn["build_parser"]().parse_args(EVAL_ARGV)
    counts = {}

    def on_tracked(droid):
        counts["track"] = _counts()
        filler = droid.traj_filler

        def counted_filler(stream):
            before = _counts()
            out = filler(stream)
            after = _counts()
            counts["filler"] = {k: after[k] - before[k] for k in after}
            return out

        droid.traj_filler = counted_filler

    report = {"on_tracked": on_tracked}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ate = float(syn["run"](args, EVAL_SEED, weights=CKPT, report=report))
    torch.cuda.synchronize()
    total = _counts()
    counts["terminate"] = {k: total[k] - counts["track"][k] for k in total}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    droid = report["droid"]
    video = droid.video

    # the reconstruction's two functions on the card and on the CPU
    snap = vis.snapshot(video)
    t = snap["counter"]
    on_dev = (snap["poses"], snap["disps"], snap["intrinsics"],
              torch.arange(t, device=dev),
              0.005 * snap["disps"][:t].mean(dim=(1, 2)))
    on_cpu = tuple(x.cpu() for x in on_dev)
    cnt_dev, cnt_cpu = depth_filter(*on_dev), depth_filter(*on_cpu)
    count_share = float((cnt_dev.cpu() != cnt_cpu).float().mean())
    pts_dev = iproj_points(*on_dev[:3])
    pts_cpu = iproj_points(*on_cpu[:3])
    point_gap = float(((pts_dev.cpu() - pts_cpu).abs()
                       / pts_cpu.abs().clamp(min=1.0)).max())
    filter_ms, filter_host_us = _time_ms(lambda: depth_filter(*on_dev))
    iproj_ms, iproj_host_us = _time_ms(lambda: iproj_points(*on_dev[:3]))
    # least times: the bytes each must move (disparities and poses read
    # once, the counts or points written once) and its f32 operations
    # (~60 a pixel and neighbour for the filter, ~30 a pixel for iproj)
    N, h, w = snap["disps"].shape
    px = t * h * w
    bounds = {}
    for name, nbytes, ops in (
            ("depth_filter", N * h * w * 4 + N * 28 + px * 4, px * 6 * 60),
            ("iproj_points", N * h * w * 4 + N * 28 + N * h * w * 12,
             N * h * w * 30)):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS_PER_S * 1e3
        bounds[name] = dict(bound_ms=max(tb, to),
                            bound_by="bytes" if tb >= to else "operations",
                            bytes=nbytes)
    tic = time.perf_counter()
    points, colors = vis.reconstruction_point_cloud(video)
    cloud_s = time.perf_counter() - tic

    # the files: .npz -> PLY, and the screenshot
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "reconstruction.npz")
        _script("demo_torch.py")["save_reconstruction"](droid, npz)
        ply = os.path.join(tmp, "reconstruction.ply")
        _script("view_reconstruction_torch.py")["main"](
            ["--reconstruction_path", npz, "--ply", ply, "--device", "cuda"])
        with open(ply) as f:
            lines = f.read().splitlines()
        header = int(lines[2].split()[-1])
        ply_vertices = len(lines) - lines.index("end_header") - 1
        png = os.path.join(tmp, "screenshot.png")
        tic = time.perf_counter()
        shot = viewer.save_screenshot(png, video)
        shot_s = time.perf_counter() - tic
        img = _read_png(png) if shot else None
        render = viewer.render_offscreen(viewer.build_scene(video))
    left_behind = os.path.exists(tmp)
    png_is_render = img is not None and np.array_equal(img, render)
    shot_share = 0.0 if img is None else float(
        (img != np.array(SHOT_BACKGROUND, np.uint8)).any(axis=-1).mean())

    st = droid.terminate_stats
    emit(phase="evaluate", weights=os.path.basename(CKPT), seed=EVAL_SEED,
         frames=args.n_frames, image_size=[args.height, args.width],
         buffer=args.buffer, filter_thresh=args.filter_thresh,
         keyframes=report["keyframes"], track_s=report["track_s"],
         kf_per_s=report["kf_per_s"], **_path_of(droid),
         frames_per_s=args.n_frames / report["track_s"],
         terminate_stats=st, ate_rmse=ate, ate_bound=EVAL_ATE_BOUND,
         launches=counts, peak_mem_gb=peak_gb,
         reconstruction=dict(
             points=len(points), colors_shape=list(colors.shape),
             cloud_s=cloud_s, count_differ_share=count_share,
             count_tol=EVAL_COUNT_SHARE, point_rel_gap=point_gap,
             point_tol=EVAL_POINT_RTOL,
             depth_filter=dict(ms=filter_ms, host_us=filter_host_us,
                               **bounds["depth_filter"]),
             iproj_points=dict(ms=iproj_ms, host_us=iproj_host_us,
                               **bounds["iproj_points"]),
             npz_ply_vertices=ply_vertices, ply_header_vertices=header,
             screenshot=shot, screenshot_s=shot_s,
             png_equals_render=png_is_render,
             screenshot_non_background=shot_share, shot_floor=SHOT_FLOOR,
             files_left=left_behind))
    _require_launches(counts["track"], ["corr_lookup"], "evaluate (tracking)")
    _require_launches(counts.get("filler", {"corr_lookup": 0}),
                      ["corr_lookup"], "evaluate (filler)")
    _require_launches(counts["terminate"], ["alt_corr"],
                      "evaluate (terminate)")
    if total["gru_epilogue_a"] or total["gru_epilogue_b"]:
        raise AssertionError(f"the default configuration launched the GRU "
                             f"epilogue kernels: {total}")
    if _path_of(droid)["path"] != "frame":
        raise AssertionError(f"evaluate: tracked on {_path_of(droid)}, not "
                             f"the CUDA default (the frame path)")
    if not ate <= EVAL_ATE_BOUND:      # false for NaN and inf too
        raise AssertionError(f"evaluate: ATE RMSE {ate} is not within "
                             f"{EVAL_ATE_BOUND}")
    if not (count_share <= EVAL_COUNT_SHARE
            and point_gap <= EVAL_POINT_RTOL):
        raise AssertionError(f"evaluate: the card's depth_filter counts "
                             f"differ from the CPU's at {count_share} of the "
                             f"pixels, iproj_points by {point_gap}")
    if not (len(points) > 0 and ply_vertices == header > 0):
        raise AssertionError(f"evaluate: {len(points)} points, PLY "
                             f"{ply_vertices} vertices of {header}")
    if not (shot and png_is_render and shot_share >= SHOT_FLOOR):
        raise AssertionError(f"evaluate: screenshot {shot}, equal to the "
                             f"render {png_is_render}, non-background share "
                             f"{shot_share} (floor {SHOT_FLOOR})")
    if left_behind:
        raise AssertionError(f"evaluate: {tmp} was not removed")
    del droid, video, report
    torch.cuda.empty_cache()
    return total


def main():
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    faulthandler.dump_traceback_later(DEADLINE_S + 30, exit=True)
    t_start = time.perf_counter()

    # cuBLAS's deterministic mode, which the asynchronous phases take, needs
    # a fixed workspace before its first handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from droid_slam_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smi = _smi()
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), smi=smi)

    _build.build(timeout=DEADLINE_S - 60)
    _build.lib()
    emit(phase="build", nvcc_s=_build.last_build_seconds,
         lib=os.path.relpath(_build.LIB_PATH, ROOT))

    try:
        lookup = check_lookup(dev, H // 8, W // 8, timed=True)
        lookup_rgbd = check_lookup(dev, RGBD_SIZE[0] // 8, RGBD_SIZE[1] // 8,
                                   timed=False)
        gru = check_gru(dev)
        alt = check_alt_corr(dev)
        fdist = check_frame_distance(dev)
        run_ba_global(dev)
        c_gba = run_global_ba_tum(dev)
        droid, _, _, c_default, _ = run_track(dev, fused=False,
                                              profile=False)
        del droid
        torch.cuda.empty_cache()
        droid, base, intr, c_track, strict_rate = run_track(
            dev, fused=True, profile=True)
        c_term = run_terminate(droid, base, intr)
        del droid
        torch.cuda.empty_cache()
        c_frame = run_track_frame(dev, base, intr, strict_rate)
        droid, c_ep = run_track_edge_parallel(dev, base, intr)
        c_gba_mesh = run_global_ba_mesh(droid)
        del droid
        torch.cuda.empty_cache()
        c_stereo = run_mode(dev, "stereo")
        c_stereo_strict = run_mode(dev, "stereo", fused_frame=False)
        c_rgbd = run_mode(dev, "rgbd")
        c_rgbd_strict = run_mode(dev, "rgbd", fused_frame=False)
        c_eval = run_evaluate(dev)
        # the asynchronous phases run PyTorch's deterministic kernels (sums
        # without atomics): the backend's cycles amplify the last bit of a
        # sum without bound on this scene, so that only a replay that
        # repeats each sum bit for bit can hold a facade to its own cycles
        torch.use_deterministic_algorithms(True)
        try:
            ref, c_async_ref = run_async(dev, "sync")
            _, c_async = run_async(dev, "thread", ref)
            _, c_async_proc = run_async(dev, "process", ref)
            _, c_async_proc_frame = run_async(dev, "process", ref,
                                              fused_frame=None)
        finally:
            torch.use_deterministic_algorithms(False)
        c_train = run_train(dev)
        c_train_dp = run_train_dp(dev)
        c_parity = run_train_parity(dev)
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()

    # launches over every path; each path's own counts beside them
    paths = {"track": c_default, "track_fused": c_track,
             "terminate": c_term, "track_frame": c_frame,
             "track_stereo": c_stereo, "track_stereo_strict": c_stereo_strict,
             "track_rgbd": c_rgbd, "track_rgbd_strict": c_rgbd_strict,
             "evaluate": c_eval, "track_async_ref": c_async_ref,
             "track_async": c_async, "track_async_process": c_async_proc,
             "track_async_process_frame": c_async_proc_frame,
             "train": c_train, "train_parity": c_parity,
             "global_ba_tum512": c_gba, "track_edge_parallel": c_ep,
             "global_ba_mesh": c_gba_mesh, "train_dp": c_train_dp}
    src = "droid_slam_tpu_torch/csrc/"
    meta = {"corr_lookup": ("corr_lookup.cu",
                            "droid_slam_tpu/ops/corr_pallas.py:84",
                            dict(atol_bf16=2e-2, atol_f32=1e-4, **lookup,
                                 checked_at_30x40=lookup_rgbd)),
            "gru_epilogue_a": ("gru_epilogue.cu",
                               "droid_slam_tpu/ops/gru_pallas.py:72",
                               dict(atol_bf16=1e-2, atol_f32=1e-5,
                                    **gru["gru_epilogue_a"])),
            "gru_epilogue_b": ("gru_epilogue.cu",
                               "droid_slam_tpu/ops/gru_pallas.py:93",
                               dict(atol_bf16=1e-2, atol_f32=1e-5,
                                    **gru["gru_epilogue_b"])),
            "alt_corr": ("alt_corr.cu",
                         "none: JAX's global BA correlates on the fly in XLA "
                         "(droid_slam_tpu/ops/corr.py:538)", alt),
            "frame_distance": ("frame_distance.cu",
                               "none: JAX's frame distance is XLA "
                               "(droid_slam_tpu/geom/distance.py, "
                               "droid_slam_tpu/state/video.py:225-250)",
                               fdist)}
    kernels = [dict(name=name, route="cuda", source=src + f, replaces=rep,
                    launches=sum(c[name] for c in paths.values()),
                    launches_by_path={p: c[name] for p, c in paths.items()},
                    **row)
               for name, (f, rep, row) in meta.items()]
    emit(kernels=kernels, wall_s=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
